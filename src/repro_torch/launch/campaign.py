"""Ensemble-campaign launcher of the port (paper §3 production run)::

    PYTHONPATH=src python -m repro_torch.launch.campaign --waves 100 --nt 16000 \\
        --kset 2 [--ckpt-dir DIR --ckpt-every 500] [--out shards/] \\
        [--method proposed2] [--device cpu]

It runs on the card unless ``--device`` names another device (``cpu``).
Kill it anywhere and relaunch it with the same arguments: it resumes from
the latest atomic checkpoint bit-identically.

Flags (as the JAX package's ``repro.launch.campaign``)
------------------------------------------------------
``--waves / --nt / --mesh-n / --nspring / --seed``
    Ensemble shape: how many band-limited bedrock waves, time steps per
    case, basin mesh cells, springs per quadrature point, wave RNG seed.
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
``--stop-after-steps``
    Fault injection: exit cleanly right after a mid-campaign checkpoint,
    exactly as a SIGKILL at that point would leave the directory.
``--health / --no-health``
    Per-case numerical-health guards (``repro_torch.core.health``, default
    on): a case that goes non-finite is frozen, excluded from the shards and
    recorded in the shard manifest's quarantine list.  Signature-bearing.
``--inject``
    Deterministic fault injection (``repro_torch.core.faults``), e.g.
    ``--inject nan_at_step=5,case=1``.  Part of the wave data, hence of the
    campaign signature.
``--device``
    Where the campaign runs (default: the card).

The JAX package's scenario, sweep, scheduler, autotune and surrogate-
training modes, and its multi-device and multi-process campaigns, are not
ported yet: their flags are accepted and exit non-zero saying so.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch.kernels.ebe_matvec.ebe_matvec import TILE_E
from repro_torch.kernels.multispring.multispring import TILE_P

#: flags of the JAX package's launcher whose modes are not ported yet
UNPORTED_MODES = ("--sweep", "--scenario", "--scenarios", "--schedule", "--workers", "--worker-id", "--autotune",
                  "--probe", "--calibration", "--train-while-generating", "--cpu-backend")


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
    # the JAX package's other modes and its topology flags: accepted, refused below
    for flag in ("--sweep", "--scenario", "--scenarios", "--worker-id", "--calibration"):
        ap.add_argument(flag, default=None, help="not ported yet")
    for flag in ("--schedule", "--autotune", "--probe", "--train-while-generating", "--cpu-backend"):
        ap.add_argument(flag, action="store_true", help="not ported yet")
    ap.add_argument("--workers", type=int, default=0, help="not ported yet")
    ap.add_argument("--devices", type=int, default=0, help="devices on the case axis: 1 (more are not ported)")
    ap.add_argument("--host-devices", type=int, default=0, help="not ported (the port has one device)")
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-processes", type=int, default=1, help="processes: 1 (more are not ported)")
    ap.add_argument("--process-id", type=int, default=0)
    return ap


def _refuse_unported(args) -> None:
    """Exit non-zero naming the first flag whose mode the port lacks."""
    for flag in UNPORTED_MODES:
        if getattr(args, flag[2:].replace("-", "_")):
            raise SystemExit(f"[campaign] {flag} is not ported yet: the port runs the plain campaign path only")
    for flag, n in (("--devices", args.devices), ("--host-devices", args.host_devices),
                    ("--num-processes", args.num_processes)):
        if n > 1:
            raise SystemExit(f"[campaign] {flag} {n} is not ported yet: the port runs one process on one device")


def main(argv=None, result: dict | None = None) -> int:
    """Run the campaign the flags describe; returns the exit code.  A caller
    that passes a ``result`` dict gets the :class:`~repro_torch.campaign.
    CampaignResult` under ``"campaign"`` (and what was written to the shards
    under ``"waves"`` and ``"responses"``)."""
    args = _parser().parse_args(argv)
    _refuse_unported(args)
    if args.trajectories and args.obs_every < 1:
        raise SystemExit(f"[campaign] --obs-every must be ≥ 1, got {args.obs_every}")

    from repro_torch.campaign import CampaignConfig, run_campaign
    from repro_torch.core import faults, health as health_mod
    from repro_torch.device import resolve_device
    from repro_torch.fem import backend as fem_backend, meshgen
    from repro_torch.launch.bootstrap import DistributedArgs, distributed_init
    from repro_torch.surrogate.dataset import (EnsembleConfig, random_band_limited_waves, save_shards,
                                               simulation_config)

    tag = "[campaign]"
    distributed_init(DistributedArgs(coordinator=args.coordinator, num_processes=args.num_processes,
                                     process_id=args.process_id))
    device = resolve_device(args.device)
    cfg = EnsembleConfig(n_waves=args.waves, nt=args.nt, mesh_n=tuple(int(x) for x in args.mesh_n.split("x")),
                         nspring=args.nspring, seed=args.seed, kset=args.kset)
    print(f"{tag} {args.waves} waves × {args.nt} steps, method={args.method}, "
          f"1 device(s) × kset={args.kset} → rounds of {args.kset} on {device}")
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
    res = run_campaign(
        mesh, sim, waves, observe=obs,
        campaign=CampaignConfig(kset=args.kset, method=args.method, seed=args.seed,
                                checkpoint_dir=args.ckpt_dir, checkpoint_every=args.ckpt_every),
        device=device, stop_after_steps=args.stop_after_steps,
    )
    if result is not None:
        result["campaign"] = res
    if res.resumed_from is not None:
        print(f"{tag} [resume] from checkpoint step {res.resumed_from}")
    if not res.completed:
        print(f"{tag} [stopped] after {res.steps_done} global steps "
              f"({res.rounds_done} rounds banked) — relaunch to resume")
        return 0
    y = res.velocity_history[:, :, 0, :]
    stats = (f", peak |v| = {np.abs(y).max():.3e} m/s, mean solver iters {res.iters.mean():.1f}"
             if len(y) else "")
    print(f"{tag} [done] {len(y)} responses" + stats)
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
        paths = save_shards(args.out, x_out, y_out, shard_size=args.shard_size, meta=meta)
        if result is not None:
            result["waves"], result["responses"] = x_out, y_out
        kind = f"trajectory (obs_every={args.obs_every}) " if args.trajectories else ""
        print(f"{tag} [shards] wrote {len(paths)} {kind}shard(s) to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
