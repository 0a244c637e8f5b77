"""Ensemble-campaign launcher of the port (paper §3 production run)::

    PYTHONPATH=src python -m repro_torch.launch.campaign --waves 100 --nt 16000 \\
        --kset 2 [--ckpt-dir DIR --ckpt-every 500] [--out shards/] \\
        [--method proposed2] [--device cpu]

Scenario sweeps (``repro_torch.scenario``)::

    PYTHONPATH=src python -m repro_torch.launch.campaign --sweep sweep.json \\
        [--autotune [--probe]] [--out shards/] [--ckpt-dir DIR]
    PYTHONPATH=src python -m repro_torch.launch.campaign --scenario ricker-soft-basin

Scheduled (elastic) sweeps — plan groups become leased jobs on disk; workers
join/leave freely and the surrogate can train on shards mid-sweep::

    PYTHONPATH=src python -m repro_torch.launch.campaign --sweep sweep.json \\
        --schedule --workers 2 --out shards/ --ckpt-dir DIR \\
        [--lease-s 30] [--train-while-generating]
    # or manage workers yourself (same queue, any time):
    PYTHONPATH=src python -m repro_torch.launch.campaign --sweep sweep.json \\
        --schedule --worker-id w0 --out shards/ --ckpt-dir DIR

Several devices in one process — the case mesh: ``--devices N`` runs the
first N cards of ``torch.cuda.device_count()`` (default: every card),
``--host-devices N`` N CPU entries; each entry owns ``--kset`` lanes of
every round (rounds of ``kset × N``) and runs in a host thread and on a
CUDA stream of its own::

    PYTHONPATH=src python -m repro_torch.launch.campaign --waves 100 --nt 16000 \\
        --kset 1 --devices 2 --ckpt-dir DIR --ckpt-every 500 --out shards/

Multi-process campaigns — one command per process, the same flags but
``--process-id``; each process owns a contiguous slice of every round's
cases, runs it on its own device and writes ``OUT/pNN/``::

    PYTHONPATH=src python -m repro_torch.launch.campaign --waves 100 --nt 16000 \\
        --kset 1 --ckpt-dir DIR --ckpt-every 500 --out shards/ \\
        --coordinator 127.0.0.1:PORT --num-processes 2 --process-id 0   # and 1

It runs on the card unless ``--device`` names another device (``cpu``).
Kill it anywhere and relaunch it with the same arguments: it resumes from
the latest atomic checkpoint bit-identically (on the same number of
processes; another world size is refused).

Flags (as the JAX package's ``repro.launch.campaign``)
------------------------------------------------------
``--waves / --nt / --mesh-n / --nspring / --seed``
    Ensemble shape: how many band-limited bedrock waves, time steps per
    case, basin mesh cells, springs per quadrature point, wave RNG seed.
``--scenario``
    Run one named catalog scenario (``repro_torch.scenario.CATALOG``) — its
    wave family / soil profile / observation grid, with the ensemble-shape
    flags above still setting ``n_cases``/``nt``/``mesh_n``/``nspring``/
    ``seed``.
``--sweep``
    A sweep spec (JSON file path or inline JSON) expanded by the planner
    into compile-signature groups, each run as one campaign.  Writes a
    ``plan.json`` manifest next to the checkpoint dir (or into ``--out``),
    and per-scenario shard dirs under ``--out/<scenario>/``.
``--scenarios``
    A serving feedback log (JSONL written by ``repro_torch.launch.serve
    --feedback-out``): the scenarios the surrogate was least sure about,
    consumed exactly like a sweep — the active-learning loop closes here.
``--schedule / --workers / --lease-s / --worker-id / --max-jobs``
    Run the sweep through the elastic work queue
    (``repro_torch.scenario.scheduler``) instead of the serial planner loop:
    compile groups become leased jobs next to ``plan.json``, ``--workers N``
    spawns N worker subprocesses of this launcher (monitored by the
    heartbeat watchdog), a killed worker's group is requeued by lease
    takeover and resumed from its checkpoint by any survivor.
    ``--worker-id NAME`` instead joins the queue as a single in-process
    worker; ``--max-jobs`` caps how many groups such a worker takes before
    leaving.  The workers share the parent's device.
``--train-while-generating [--train-steps N]``
    Overlap surrogate training with generation: the parent streams
    committed scenario shards out of ``--out`` in plan order
    (``ShardStream``) and runs ``fit_stream`` while the workers are still
    producing — the result equals a post-hoc ``fit_shards``.
``--autotune / --probe / --calibration``
    Pick ``(method, npart, kset)`` per plan group with the cost model
    (``--autotune``); ``--probe`` additionally times the shortlisted
    candidates on the device; ``--calibration`` names a
    ``BENCH_kernels.json``-format table whose measured kernel rates replace
    the model's constants.  Without ``--autotune``, ``--method``/``--kset``
    apply to every group.
``--kset``
    Cases advanced together per round (the generalized 2SET residency).
``--method``
    One of ``repro_torch.fem.methods.METHODS`` (default ``proposed2``).
``--kernel-backend / --ebe-backend / --ms-backend / --tile-e / --tile-p``
    Kernel dispatch (``repro_torch.fem.backend``): ``auto`` (default) runs
    the CUDA kernels on the card and their plain versions on the CPU;
    ``cuda`` and ``torch`` state which the caller expects and are refused
    on the other device.  The tile flags are the CUDA kernels' launch knobs
    (``tile_e`` a multiple of 4 in [4, 64], ``tile_p`` in [1, 8]).  The
    resolved backend is folded into the campaign signature: resuming a
    checkpoint under a different backend is refused.
``--warm-start / --no-warm-start / --precond-every``
    Solver amortization: warm-start each step's CG from the previous δu
    (default on), and refresh the EBE block-Jacobi preconditioner every N
    steps.  Both are signature-bearing.
``--ckpt-dir / --ckpt-every``
    Checkpoint directory and cadence in time steps.
``--out / --shard-size``
    Write completed responses as ``.npz`` dataset shards.
``--trajectories [--obs-every N]``
    Harvest the observation time series strided by ``--obs-every``; the
    shard manifest records ``{"trajectories": true, "obs_every": N}``.
    Plain campaign path only.
``--stop-after-steps``
    Fault injection: exit cleanly right after a mid-campaign checkpoint,
    exactly as a SIGKILL at that point would leave the directory.
``--health / --no-health``
    Per-case numerical-health guards (``repro_torch.core.health``, default
    on): a case that goes non-finite is frozen, excluded from the shards and
    recorded in the shard manifest's (or, for sweeps, the plan manifest's)
    quarantine list.  Signature-bearing.
``--inject``
    Deterministic fault injection (``repro_torch.core.faults``), e.g.
    ``--inject nan_at_step=5,case=1``.  Part of the wave data, hence of the
    campaign signature.  Plain campaign path only.
``--device``
    Where the campaign runs (default: the card).
``--coordinator / --num-processes / --process-id``
    A multi-process campaign (plain campaign path only): process 0 hosts
    the ``torch.distributed`` store at ``--coordinator`` (host:port) and
    every process joins it; the processes share nothing but barriers
    (``repro_torch.parallel.distributed``).
``--cpu-backend``
    Run on the CPU (the same as ``--device cpu``): the rehearsal of a
    multi-process launch without a card.
``--devices / --host-devices``
    The case mesh of one process: the first ``N`` cards (``--devices``;
    default every card, one a process under a process group; more than
    there are exit non-zero with the reference's ``requested N devices,
    have M``), or ``N`` CPU entries (``--host-devices``, the reference's
    forced host devices).  One process runs them all, an entry a host
    thread; with ``--num-processes P`` every process owns as many, and the
    mesh has ``P × N`` entries.  (The train CLI's ``--host-devices`` is
    another thing: it launches one process a device, as its DTensor mesh
    needs.)

Each chunk prints a ``[chunk]`` line, each checkpoint a ``[checkpoint]``
line and the run its kernel launches (``[launches]``), as JSON objects.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from repro_torch.kernels.ebe_matvec.ebe_matvec import TILE_E
from repro_torch.kernels.multispring.multispring import TILE_P


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.campaign")
    ap.add_argument("--waves", type=int, default=8)
    ap.add_argument("--nt", type=int, default=64)
    ap.add_argument("--mesh-n", default="3x3x3", help="basin mesh cells, e.g. 3x3x3")
    ap.add_argument("--nspring", type=int, default=12)
    ap.add_argument("--kset", type=int, default=2, help="cases per round")
    ap.add_argument("--method", default="proposed2")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernel-backend", default="auto", choices=["auto", "cuda", "torch"],
                    help="kernel dispatch (repro_torch.fem.backend)")
    ap.add_argument("--ebe-backend", default="", help="override the EBE kernel backend only")
    ap.add_argument("--ms-backend", default="", help="override the multispring kernel backend only")
    ap.add_argument("--tile-e", type=int, default=TILE_E, help="CUDA EBE kernel: elements per tile")
    ap.add_argument("--tile-p", type=int, default=TILE_P, help="CUDA multispring kernel: points per block")
    ap.add_argument("--warm-start", action=argparse.BooleanOptionalAction, default=True,
                    help="warm-start each step's CG from the previous δu")
    ap.add_argument("--precond-every", type=int, default=1, help="refresh the EBE preconditioner every N steps")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0, help="time steps between mid-round checkpoints")
    ap.add_argument("--out", default=None, help="dataset shard directory")
    ap.add_argument("--shard-size", type=int, default=16)
    ap.add_argument("--trajectories", action="store_true",
                    help="harvest obs-every-strided response histories into --out")
    ap.add_argument("--obs-every", type=int, default=1, help="with --trajectories: record every Nth time step")
    ap.add_argument("--stop-after-steps", type=int, default=None,
                    help="fault injection: exit after this many global steps")
    ap.add_argument("--health", action=argparse.BooleanOptionalAction, default=True,
                    help="per-case numerical-health guards (repro_torch.core.health)")
    ap.add_argument("--inject", default=None, metavar="SPEC",
                    help="deterministic fault injection (repro_torch.core.faults), e.g. 'nan_at_step=5,case=1'")
    ap.add_argument("--device", default=None, help="where the campaign runs (default: the card)")
    ap.add_argument("--calibration", default=None,
                    help="BENCH_kernels.json-format table feeding the --autotune cost model")
    ap.add_argument("--scenario", default=None, help="named catalog scenario (repro_torch.scenario.CATALOG)")
    ap.add_argument("--sweep", default=None, help="scenario sweep spec: JSON file path or inline JSON")
    ap.add_argument("--scenarios", default=None, metavar="FEEDBACK",
                    help="serving feedback log (JSONL of high-uncertainty scenarios) consumed as a sweep")
    ap.add_argument("--autotune", action="store_true", help="pick (method, npart, kset) per plan group")
    ap.add_argument("--probe", action="store_true", help="with --autotune: on-device microbenchmark probe")
    ap.add_argument("--schedule", action="store_true", help="run the sweep through the elastic work queue")
    ap.add_argument("--workers", type=int, default=0,
                    help="with --schedule: spawn N monitored worker subprocesses (0/1 = single worker)")
    ap.add_argument("--lease-s", type=float, default=30.0, help="job lease lifetime; an expired lease is requeued")
    ap.add_argument("--worker-id", default=None,
                    help="with --schedule: join the queue as this single worker (user-managed pool)")
    ap.add_argument("--max-jobs", type=int, default=0, help="with --worker-id: leave after completing N groups")
    ap.add_argument("--train-while-generating", action="store_true",
                    help="overlap fit_stream with generation (needs --out)")
    ap.add_argument("--train-steps", type=int, default=120,
                    help="fit_stream optimizer steps for --train-while-generating")
    # the multi-process topology (repro_torch.launch.bootstrap)
    ap.add_argument("--cpu-backend", action="store_true", help="run on the CPU (multi-process rehearsal)")
    ap.add_argument("--devices", type=int, default=0,
                    help="cards on the case axis (default: all visible), one host thread each in this process")
    ap.add_argument("--host-devices", type=int, default=0,
                    help="N CPU entries on the case axis, one host thread each in this process (the train CLI's "
                         "--host-devices launches processes instead)")
    ap.add_argument("--coordinator", default=None, help="process 0's torch.distributed store, host:port")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    return ap


def _refuse_unported(args, tag: str) -> None:
    """Exit non-zero, before any process group or device is touched, naming
    the first flag whose mode the port lacks or the reference refuses.
    Under a process group each process owns ``--host-devices`` CPU entries
    or one device, so the global case mesh has ``num_processes`` times as
    many."""
    n_proc = args.num_processes
    if args.cpu_backend and args.device not in (None, "cpu"):
        raise SystemExit(f"{tag} --cpu-backend runs on the CPU; drop --device {args.device}")
    if args.host_devices and args.device not in (None, "cpu"):
        raise SystemExit(f"{tag} --host-devices {args.host_devices} runs CPU entries; drop --device {args.device}")
    n_global = n_proc * max(1, args.host_devices)
    if n_proc > 1 and args.devices and args.devices != n_global:
        raise SystemExit(f"{tag} --devices {args.devices} with {n_proc} processes: a multi-host campaign must "
                         f"use every device on the global case mesh ({n_global}); drop --devices")
    if n_proc > 1 and (args.sweep or args.scenario or args.scenarios):
        raise SystemExit(f"{tag} --scenario/--sweep are single-process for now (multi-host campaigns take the "
                         f"plain flag path); drop the distributed flags")


def main(argv=None, result: dict | None = None) -> int:
    """Run the campaign the flags describe; returns the exit code.  A caller
    that passes a ``result`` dict gets the :class:`~repro_torch.campaign.
    CampaignResult` under ``"campaign"`` (and what was written to the shards
    under ``"waves"`` and ``"responses"``); a sweep's
    :class:`~repro_torch.scenario.PlanRunResult` under ``"plan_run"``; a
    scheduled parent's worker exit codes (``"rcs"``), queue state
    (``"settled"``, ``"dead"``) and trainer outcome
    (``"train"``); a worker's :class:`~repro_torch.scenario.WorkerSummary`
    under ``"worker"``."""
    args = _parser().parse_args(argv)
    multi = args.num_processes > 1
    tag = f"[campaign p{args.process_id}]" if multi else "[campaign]"
    _refuse_unported(args, tag)
    if args.cpu_backend or args.host_devices:
        args.device = "cpu"
    if args.trajectories and args.obs_every < 1:
        raise SystemExit(f"{tag} --obs-every must be ≥ 1, got {args.obs_every}")
    if args.sweep or args.scenario or args.scenarios:
        if args.trajectories:
            raise SystemExit(f"{tag} --trajectories rides the plain campaign path; drop --scenario/--sweep/--scenarios")
        if args.inject:
            raise SystemExit(f"{tag} --inject rides the plain campaign path (scenario sweeps generate their own "
                             f"waves); drop --scenario/--sweep/--scenarios")
        return _run_scenarios(args, tag, result)

    import json

    from repro_torch import kernels
    from repro_torch.campaign import CampaignConfig, run_campaign
    from repro_torch.core import faults, health as health_mod
    from repro_torch.device import resolve_device
    from repro_torch.fem import backend as fem_backend, meshgen
    from repro_torch.launch.bootstrap import DistributedArgs, distributed_init
    from repro_torch.surrogate.dataset import (EnsembleConfig, random_band_limited_waves, save_shards,
                                               simulation_config)

    device = resolve_device(args.device)  # no card and no --device cpu: raise before joining the group
    distributed_init(DistributedArgs(coordinator=args.coordinator, num_processes=args.num_processes,
                                     process_id=args.process_id, cpu_backend=args.cpu_backend))
    pid = args.process_id
    dmesh = _case_mesh(args, tag, device)
    n_dev = 1 if dmesh is None else dmesh.devices.size
    local = n_dev // args.num_processes  # this process's entries
    cfg = EnsembleConfig(n_waves=args.waves, nt=args.nt, mesh_n=tuple(int(x) for x in args.mesh_n.split("x")),
                         nspring=args.nspring, seed=args.seed, kset=args.kset)
    print(f"{tag} {args.waves} waves × {args.nt} steps, method={args.method}, "
          f"{n_dev} device(s) × kset={args.kset} → rounds of {args.kset * n_dev}"
          + (f" across {args.num_processes} processes" if multi else "") + f" on {device}"
          + (f" ({local} entries here, a host thread each)" if local > 1 else ""), flush=True)
    sim = simulation_config(cfg, backend=args.kernel_backend, ebe_backend=args.ebe_backend,
                            ms_backend=args.ms_backend, tile_e=args.tile_e, tile_p=args.tile_p,
                            warm_start=args.warm_start, precond_every=args.precond_every, health=args.health)
    kb = fem_backend.resolve(sim, device=device)
    print(f"{tag} kernel backend: {kb.describe()} warm_start={sim.warm_start} "
          f"precond_every={sim.precond_every} health={sim.health}")
    mesh = meshgen.generate(*cfg.mesh_n, pad_elems_to=8)
    waves = random_band_limited_waves(cfg)
    inject = faults.parse(args.inject)
    if inject is not None:
        waves = faults.apply_wave_fault(inject, waves)
        print(f"{tag} [inject] {inject.describe()}")
    obs = mesh.surface[len(mesh.surface) // 2: len(mesh.surface) // 2 + 1]

    def on_chunk(info):
        row = dict(info, s_per_step_per_case=info["seconds"] / ((info["t1"] - info["t0"]) * args.kset * local))
        print(f"{tag} [chunk] {json.dumps(row)}", flush=True)

    res = run_campaign(
        mesh, sim, waves, observe=obs,
        campaign=CampaignConfig(kset=args.kset, method=args.method, seed=args.seed,
                                checkpoint_dir=args.ckpt_dir, checkpoint_every=args.ckpt_every),
        device=device, device_mesh=dmesh, stop_after_steps=args.stop_after_steps, on_chunk=on_chunk,
    )
    if result is not None:
        result["campaign"] = res
    for rec in res.checkpoints:
        print(f"{tag} [checkpoint] {json.dumps(rec)}")
    print(f"{tag} [launches] {json.dumps({**kernels.launch_counts(), **kernels.instance_counts()})}", flush=True)
    if res.resumed_from is not None:
        print(f"{tag} [resume] from checkpoint step {res.resumed_from}")
    if not res.completed:
        print(f"{tag} [stopped] after {res.steps_done} global steps "
              f"({res.rounds_done} rounds banked) — relaunch to resume")
        return 0
    y = res.velocity_history[:, :, 0, :]
    # a process can own only padded lanes (waves ≤ its round offset): no responses
    stats = (f", peak |v| = {np.abs(y).max():.3e} m/s, mean solver iters {res.iters.mean():.1f}"
             if len(y) else "")
    print(f"{tag} [done] {len(y)} responses"
          + (f" (cases {res.case_indices.min()}–{res.case_indices.max()} of {args.waves})" if multi and len(y) else "")
          + stats)
    diverged = np.zeros(0, np.int64)
    keep = np.ones(len(y), bool)
    if res.health.size:
        diverged = res.diverged_cases()
        keep = ~health_mod.diverged(res.health).numpy()
        print(f"{tag} [health] {len(res.health)} case(s) guarded, {diverged.size} diverged, "
              f"{int(res.nonconverged.sum())} non-converged solver step(s)")
        for c in diverged:
            i = int(np.argwhere(res.case_indices == c)[0, 0])
            print(f"{tag} [quarantine] case {int(c)}: {health_mod.describe(res.health[i])} — excluded from "
                  f"shard output")
    if args.out:
        out_dir = os.path.join(args.out, f"p{pid:02d}") if multi else args.out
        y_out, meta = y, None
        if args.trajectories:
            # the trajectory surrogate's target: the same history, strided —
            # the wave stays full-rate (the model strides it at train time)
            y_out = y[:, ::args.obs_every]
            meta = {"trajectories": True, "obs_every": args.obs_every}
        if diverged.size:  # quarantine record rides the shard manifest
            meta = {**(meta or {}), "quarantine": [int(c) for c in diverged]}
        x_out = waves[res.case_indices[keep]].astype(np.float32)
        y_out = y_out[keep].astype(np.float32)
        paths = save_shards(out_dir, x_out, y_out, shard_size=args.shard_size, meta=meta)
        if result is not None:
            result["waves"], result["responses"] = x_out, y_out
        kind = f"trajectory (obs_every={args.obs_every}) " if args.trajectories else ""
        print(f"{tag} [shards] wrote {len(paths)} {kind}shard(s) to {out_dir}")
    return 0


def _case_mesh(args, tag, device):
    """The case mesh the flags name (``None``: one device), or exit
    non-zero with the reference's message where it asks for more devices
    than there are."""
    from repro_torch.launch.mesh import make_case_mesh

    try:
        return make_case_mesh(args.devices or None, device=device, host_devices=args.host_devices)
    except ValueError as e:
        raise SystemExit(f"{tag} {e}") from e


def _sim_knobs(args) -> dict:
    """CLI kernel-backend + solver-amortization flags → SeismicConfig fields."""
    return dict(backend=args.kernel_backend, ebe_backend=args.ebe_backend, ms_backend=args.ms_backend,
                tile_e=args.tile_e, tile_p=args.tile_p, warm_start=args.warm_start,
                precond_every=args.precond_every)


def _run_scenarios(args, tag, result) -> int:
    """--scenario / --sweep / --scenarios: plan + run compile-grouped scenario campaigns."""
    import dataclasses

    from repro_torch import scenario as sc
    from repro_torch.device import resolve_device
    from repro_torch.fem import backend as fem_backend, methods

    if sum(map(bool, (args.sweep, args.scenario, args.scenarios))) > 1:
        raise SystemExit(f"{tag} pass one of --scenario / --sweep / --scenarios")
    if args.schedule and not (args.ckpt_dir or args.out):
        raise SystemExit(f"{tag} --schedule needs --ckpt-dir or --out to host the on-disk queue")
    if args.schedule and not args.worker_id and args.train_while_generating and not args.out:
        raise SystemExit(f"{tag} --train-while-generating streams shards from --out; pass --out")
    if args.scenarios:
        from repro_torch.serving.feedback import feedback_plan

        plan = feedback_plan(args.scenarios)
    elif args.sweep:
        plan = sc.make_plan(sc.sweep_from_json(args.sweep))
    else:
        scn = dataclasses.replace(
            sc.get(args.scenario), n_cases=args.waves, nt=args.nt, seed=args.seed,
            mesh_n=tuple(int(x) for x in args.mesh_n.split("x")), nspring=args.nspring,
        )
        plan = sc.make_plan([scn])
    device = resolve_device(args.device)
    dmesh = _case_mesh(args, tag, device)
    kb = fem_backend.resolve(methods.SeismicConfig(
        backend=args.kernel_backend, ebe_backend=args.ebe_backend, ms_backend=args.ms_backend,
        tile_e=args.tile_e, tile_p=args.tile_p), device=device)
    print(f"{tag} plan: {plan.n_scenarios} scenario(s) in {len(plan.groups)} "
          f"compile group(s), {plan.n_cases} case(s) on {device}"
          + (f" × {dmesh.devices.size} entries" if dmesh is not None else "")
          + (" [autotune]" if args.autotune else f" method={args.method}"))
    print(f"{tag} kernel backend: {kb.describe()} "
          f"warm_start={args.warm_start} precond_every={args.precond_every}")
    if args.schedule:
        return _run_scheduled(args, tag, plan, device, dmesh, result)
    run = sc.run_plan(
        plan, autotune=args.autotune, probe=args.probe,
        method=args.method, kset=args.kset, health=args.health,
        calibration=args.calibration, **_sim_knobs(args),
        device=device, device_mesh=dmesh, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        out_dir=args.out, shard_size=args.shard_size,
        stop_after_steps=args.stop_after_steps,
        log=lambda m: print(f"{tag} {m}"),
    )
    if result is not None:
        result["plan_run"] = run
    if len(run.scenarios) < plan.n_scenarios:
        print(f"{tag} [stopped] {len(run.scenarios)}/{plan.n_scenarios} "
              f"scenario(s) finished — relaunch to resume")
        return 0
    for name, sr in run.scenarios.items():
        peak = float(np.abs(sr.responses).max()) if sr.responses.size else 0.0
        print(f"{tag} [done] {name}: {len(sr.waves)} case(s), "
              f"peak |v| = {peak:.3e} m/s"
              + (f", shards → {sr.shard_dir}" if sr.shard_dir else ""))
    if run.manifest_path:
        print(f"{tag} [plan] manifest → {run.manifest_path}")
    return 0


def _group_knobs(args) -> dict:
    """CLI flags → ``run_worker``/``run_plan`` group-execution keywords."""
    return dict(
        autotune=args.autotune, probe=args.probe,
        method=args.method, kset=args.kset, calibration=args.calibration,
        ckpt_every=args.ckpt_every, health=args.health, **_sim_knobs(args),
    )


def _worker_cmd(args, worker: str) -> list:
    """Re-invocation of this launcher as one queue worker child."""
    cmd = [sys.executable, "-m", "repro_torch.launch.campaign",
           "--schedule", "--worker-id", worker,
           "--lease-s", str(args.lease_s),
           "--waves", str(args.waves), "--nt", str(args.nt),
           "--mesh-n", args.mesh_n, "--nspring", str(args.nspring),
           "--seed", str(args.seed), "--kset", str(args.kset),
           "--method", args.method,
           "--kernel-backend", args.kernel_backend,
           "--tile-e", str(args.tile_e), "--tile-p", str(args.tile_p),
           "--precond-every", str(args.precond_every),
           "--shard-size", str(args.shard_size)]
    cmd += ["--warm-start"] if args.warm_start else ["--no-warm-start"]
    cmd += ["--health"] if args.health else ["--no-health"]
    for flag, val in (("--sweep", args.sweep), ("--scenario", args.scenario),
                      ("--scenarios", args.scenarios),
                      ("--ebe-backend", args.ebe_backend),
                      ("--ms-backend", args.ms_backend),
                      ("--calibration", args.calibration),
                      ("--ckpt-dir", args.ckpt_dir), ("--out", args.out),
                      ("--device", args.device)):
        if val:
            cmd += [flag, str(val)]
    if args.ckpt_every:
        cmd += ["--ckpt-every", str(args.ckpt_every)]
    for flag, on in (("--autotune", args.autotune), ("--probe", args.probe)):
        if on:
            cmd.append(flag)
    for flag, n in (("--host-devices", args.host_devices), ("--devices", args.devices)):
        if n:
            cmd += [flag, str(n)]
    return cmd


def _child_env() -> dict:
    """The environment of a worker child: this one, with the directory that
    holds ``repro_torch`` first on ``PYTHONPATH``, so the child imports the
    package its parent runs."""
    import repro_torch

    src = os.path.dirname(os.path.dirname(os.path.abspath(repro_torch.__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([src] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    return env


def _run_scheduled(args, tag, plan, device, dmesh, result) -> int:
    """--schedule: the elastic queue path (worker child, or parent pool)."""
    import subprocess
    import threading
    import time

    from repro_torch.scenario import scheduler as sched

    cfg = sched.SchedulerConfig(lease_s=args.lease_s)

    if args.worker_id:  # ---- I am one worker of a user-managed pool ----
        s = sched.run_worker(
            plan, worker=args.worker_id, scheduler=cfg, device=device, device_mesh=dmesh,
            ckpt_dir=args.ckpt_dir, out_dir=args.out,
            shard_size=args.shard_size, max_jobs=args.max_jobs,
            stop_after_steps=args.stop_after_steps,
            log=lambda m: print(f"{tag} {m}", flush=True), **_group_knobs(args),
        )
        if result is not None:
            result["worker"] = s
        print(f"{tag} [worker {s.worker}] done={len(s.done)} "
              f"failed={len(s.failed)} preempted={len(s.preempted)} "
              f"quarantined={len(s.quarantined)} settled={s.settled}"
              + (f" DEAD groups: {s.dead}" if s.dead else ""))
        return 1 if s.dead else 0

    # ---- parent: spawn a monitored worker pool -----------------------------
    n = max(1, args.workers)
    names = [f"w{i}" for i in range(n)]
    qdir = sched.queue_dir_for(args.ckpt_dir, args.out)
    os.makedirs(qdir, exist_ok=True)
    print(f"{tag} [schedule] {len(plan.groups)} job(s), {n} worker(s), "
          f"lease {args.lease_s:.0f}s, queue → {qdir}")
    procs, logs = [], []
    env = _child_env()
    for w in names:
        lp = os.path.join(qdir, f"{w}.log")
        lf = open(lp, "w")
        procs.append(subprocess.Popen(_worker_cmd(args, w), stdout=lf, stderr=subprocess.STDOUT, env=env))
        logs.append((lp, lf))

    trainer: dict = {}

    def train():
        from repro_torch.surrogate.dataset import ShardStream
        from repro_torch.surrogate.model import SurrogateConfig
        from repro_torch.surrogate.train import fit_stream

        order = [s.name for g in plan.groups for s in g.scenarios]
        stream = ShardStream.from_cache(args.out, order, timeout_s=max(600.0, args.lease_s * 40))
        try:
            trainer["params"], trainer["info"] = fit_stream(
                SurrogateConfig(), stream, steps=args.train_steps, device=device)
        except Exception as e:  # noqa: BLE001 — surface, don't kill the sweep
            trainer["error"] = f"{type(e).__name__}: {e}"

    tthread = None
    try:
        if args.train_while_generating:
            tthread = threading.Thread(target=train, daemon=True)
            tthread.start()
            print(f"{tag} [schedule] fit_stream training concurrently "
                  f"({args.train_steps} steps)")

        watch = sched.QueueWatch(qdir, names)
        while any(p.poll() is None for p in procs):
            time.sleep(min(2.0, max(0.5, args.lease_s / 3)))
            rep = watch.poll()
            if rep and rep.slow_hosts:
                slow = ", ".join(names[i] for i in rep.slow_hosts)
                print(f"{tag} [watchdog] straggler(s): {slow} (heartbeat "
                      f"{rep.worst_s:.1f}s vs median {rep.median_s:.1f}s)")
        rcs = [p.wait() for p in procs]
    finally:
        for p in procs:  # an interrupted parent stops its workers
            if p.poll() is None:
                p.kill()
                p.wait()
        for _, lf in logs:
            lf.close()
    if tthread is not None:
        tthread.join()
        if "error" in trainer:
            print(f"{tag} [train] FAILED: {trainer['error']}")
        else:
            info = trainer["info"]
            print(f"{tag} [train] val MAE {info['val_mae']:.4f} over "
                  f"{info['n_shards']} shard(s), waited "
                  f"{info['stream_wait_s']:.1f}s on generation")

    q = sched.JobQueue(qdir, cfg)
    dead = [g.key for g in plan.groups if q.state(g.key) == "dead"]
    ok = q.settled(plan) and not dead and not any(rcs)
    if result is not None:
        result.update(rcs=rcs, settled=q.settled(plan), dead=dead, train=dict(trainer))
    for w, rc, (lp, _) in zip(names, rcs, logs):
        if rc:
            with open(lp) as f:
                tail = f.readlines()[-20:]
            print(f"{tag} [schedule] worker {w} exited rc={rc} — see {lp}; its last lines:\n" + "".join(tail))
    if dead:
        print(f"{tag} [schedule] DEAD group(s) after retries: {dead}")
    print(f"{tag} [schedule] {'plan settled' if ok else 'plan NOT settled'}; "
          f"manifest → {os.path.join(args.ckpt_dir or args.out, 'plan.json')}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
