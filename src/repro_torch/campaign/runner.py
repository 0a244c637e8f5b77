"""Ensemble campaigns with checkpoint/resume (the paper's §3 run) over the
entries of a case mesh.

A campaign advances ``M`` independent earthquake cases through the chosen
solution method in *rounds* of ``B = kset × n_dev`` cases, where ``n_dev``
counts the entries of the case mesh (:mod:`repro_torch.launch.mesh`), each
a process and a device:

* each entry owns a contiguous block of ``kset`` lanes of every round (entry
  ``d`` lanes ``d·kset … d·kset + kset − 1``) and advances it as one native
  k-set (``methods.make_ensemble_step``): every carry leaf leads with the
  member axis, and each matvec and multispring pass is one k-set kernel
  launch for all members (the paper's 2SET, Algorithm 4).  A process runs
  each entry it owns (:func:`case_topology`) with its carry on the entry's
  device, in a host thread and on a CUDA stream of its own (the CG loops
  sync the host once an iteration, so entries sharing a thread would run
  one after another); entries on one device share its operators.  Cases
  never communicate, so processes exchange nothing but barriers
  (:mod:`repro_torch.parallel.distributed`): node-parallelism as the paper
  runs its production ensemble;
* time stepping is chunked at ``checkpoint_every`` steps; at every chunk
  boundary the campaign state — round index, time index, the k-set carry
  (this process's entries' carries as one array a leaf,
  :func:`repro_torch.training.checkpoint.spread`) and this round's
  observations — goes through
  :class:`~repro_torch.training.checkpoint.CheckpointManager`, so a killed
  campaign resumes *bit-identically*.  Several processes checkpoint their
  own shards (``step_<n>.pNN/``) and process 0 commits the step between
  two barriers.  Completed rounds are banked once as
  ``rounds/round_NNNNN.npz`` (several processes: ``round_NNNNN.pNN.npz``
  each, made visible by process 0's ``round_NNNNN.ok``).  A killed
  N-process campaign resumes on N processes and refuses any other world
  size;
* ``M`` need not divide ``B``: the tail round is padded with repeats of the
  last case (``core.stream.pad_kset``) and the padded lanes are masked out
  of every returned array.  Each process returns only the cases it owns
  (``CampaignResult.case_indices``); a process that owns only padded lanes
  returns none.

The port's counterpart of the JAX package's ``campaign/runner.py``, with
its checkpoint layout and signature rules.  It differs where PyTorch
differs from a device mesh and ``jit``:

* the reference ``shard_map``s one program over a process's local mesh; the
  port runs one k-set a local entry, each in its thread (``exec_mesh`` is
  the :class:`~repro_torch.launch.mesh.CaseMesh` of those entries).  An
  exception in an entry's thread is raised in the caller;
* a chunk is a python loop over the step, not a compiled ``scan``;
* each round starts from a fresh initial carry, built when the round
  starts, and a checkpoint at a round boundary (``t == 0``) stores no carry:
  that carry is the initial one, a function of what the signature covers.
  A resume restores a mid-round carry in place into a fresh one.  So one
  k-set carry an entry lives on the device at a time: at full size it is
  14.9 GB of θ for two members.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import time
import zlib
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import health as health_mod
from repro_torch.core.stream import pad_kset
from repro_torch.fem import backend as fem_backend, methods
from repro_torch.launch.mesh import CaseMesh, EntryPool, entry_device
from repro_torch.parallel import distributed as dist
from repro_torch.training.checkpoint import CheckpointCorruptError, CheckpointManager, spread, unspread


@dataclasses.dataclass(frozen=True)
class CampaignConfig:
    """Campaign shape + fault-tolerance policy (simulation physics lives in
    :class:`~repro_torch.fem.methods.SeismicConfig`).

    ``kset``              ensemble members advanced together per round.
    ``method``            one of :data:`~repro_torch.fem.methods.METHODS`.
    ``checkpoint_dir``    None disables checkpointing entirely.
    ``checkpoint_every``  time steps between mid-round checkpoints
                          (0 → checkpoint only at round boundaries).
    ``keep``              checkpoints retained (older ones GC'd).
    ``seed``              recorded in every checkpoint and verified on
                          resume — a checkpoint from a different wave set
                          must not silently splice into this campaign.
    ``scenario_sig``      opaque scenario identity (:mod:`repro_torch.
                          scenario`) folded into the campaign signature.
                          Scenario changes that alter the *mesh* (soil
                          perturbations) are invisible to the wave and config
                          fields; this string is how they still refuse a
                          foreign checkpoint.
    """

    kset: int = 2
    method: str = "proposed2"
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0
    keep: int = 3
    seed: int = 0
    scenario_sig: str = ""

    def __post_init__(self):
        if self.kset < 1:
            raise ValueError(f"kset must be ≥ 1, got {self.kset}")
        if self.checkpoint_every < 0:
            raise ValueError("checkpoint_every must be ≥ 0")


class CampaignResult(NamedTuple):
    velocity_history: np.ndarray  # [M_local, nt, n_obs, 3] owned cases only
    iters: np.ndarray             # [M_local, nt] outer solver iterations per step
    rounds_done: int
    steps_done: int               # global time steps advanced (across rounds)
    completed: bool
    resumed_from: Optional[int]   # checkpoint step number, if resumed
    case_indices: np.ndarray = np.zeros(0, np.int64)
    """Global ``waves`` row of each returned case.  One process owns every
    case (``arange(M)`` once the campaign has completed); each process of a
    multi-process campaign gets only its owned cases, in global order."""
    health: np.ndarray = np.zeros(0, np.int32)
    """Per-case health word (:mod:`repro_torch.core.health` bitmask); all
    zeros when every case stayed healthy.  Empty unless the campaign ran
    with ``cfg.health`` guards enabled."""
    nonconverged: np.ndarray = np.zeros(0, np.int64)
    """Per-case count of CG solves that hit ``maxiter`` above tolerance.
    Empty unless ``cfg.health`` guards were enabled."""
    checkpoints: tuple = ()
    """One record per checkpoint saved or restored in this call: bytes and
    seconds of the host copy, the write, the CRC and the restore
    (:attr:`~repro_torch.training.checkpoint.CheckpointManager.log`)."""

    def diverged_cases(self) -> np.ndarray:
        """Global wave rows of cases that tripped a fatal health bit."""
        if len(self.health) == 0:
            return np.zeros(0, np.int64)
        return self.case_indices[health_mod.diverged(torch.as_tensor(self.health)).numpy()]


@dataclasses.dataclass(frozen=True)
class CaseTopology:
    """Which slice of every round this process owns, and how to execute it.

    ``n_dev``      entries on the case axis (over every process).
    ``offset``     first case lane (within a round) owned by this process.
    ``local``      cases per round owned here (``kset × local entries``).
    ``exec_mesh``  the process's own entries, which it runs one a thread
                   (``None`` → a single local entry, run on the caller's
                   thread).
    """

    n_dev: int
    process_index: int
    process_count: int
    offset: int
    local: int
    exec_mesh: Any


def case_topology(device_mesh, kset: int) -> CaseTopology:
    """This process's case ownership on ``device_mesh``.

    ``None`` is one device owning every lane.  A mesh (``launch.mesh.
    make_case_mesh``) lists its entries, each with the ``process_index``
    that owns it; this process owns the contiguous block of lanes on its
    entries, in mesh order (process-major), and runs them as its local
    mesh.  A mesh that skips this process, gives processes unequal entry
    counts or interleaves them raises :class:`ValueError`."""
    if device_mesh is None:
        return CaseTopology(1, 0, 1, 0, kset, None)
    devs = list(device_mesh.devices.flat)
    procs = sorted({d.process_index for d in devs})
    if len(procs) == 1:
        return CaseTopology(len(devs), 0, 1, 0, kset * len(devs), device_mesh if len(devs) > 1 else None)
    me = dist.process_index()
    if me not in procs:
        raise ValueError(f"case mesh spans processes {procs} but process {me} owns none "
                         f"of its devices — every process must participate")
    counts = {p: sum(1 for d in devs if d.process_index == p) for p in procs}
    if len(set(counts.values())) != 1:
        raise ValueError(f"case mesh is unbalanced across processes ({counts}); equal "
                         f"per-process device counts are required for uniform rounds")
    mine = [i for i, d in enumerate(devs) if d.process_index == me]
    if mine != list(range(mine[0], mine[0] + len(mine))):
        raise ValueError("case mesh interleaves processes; build it with "
                         "launch.mesh.make_case_mesh (process-major device order)")
    exec_mesh = None
    if len(mine) > 1:
        local = np.empty(len(mine), dtype=object)
        local[:] = [devs[i] for i in mine]
        exec_mesh = CaseMesh(local, tuple(device_mesh.axis_names))
    return CaseTopology(n_dev=len(devs), process_index=me, process_count=len(procs),
                        offset=kset * mine[0], local=kset * len(mine), exec_mesh=exec_mesh)


def entry_devices(topo: CaseTopology, device_mesh, device=None) -> list[torch.device]:
    """The device of each entry this process runs, in lane order: an
    entry's own device, or ``device`` (``None``: the card) where the entry
    names none."""
    if topo.exec_mesh is not None:
        entries = list(topo.exec_mesh.devices.flat)
    elif device_mesh is not None:
        entries = [d for d in device_mesh.devices.flat if d.process_index == topo.process_index][:1]
    else:
        entries = [None]
    return [entry_device(e, device) for e in entries]


def _sync(devices, n_ent: int) -> None:
    """Wait for every CUDA device of ``devices`` when several entries run:
    what this thread made there is read on the entries' own streams."""
    for dev in devices:
        if dev.type == "cuda" and n_ent > 1:
            torch.cuda.synchronize(dev)


def _chunk_bounds(nt: int, every: int) -> list[tuple[int, int]]:
    if every <= 0 or every >= nt:
        return [(0, nt)]
    return [(t, min(t + every, nt)) for t in range(0, nt, every)]


def _campaign_sig(campaign: CampaignConfig, cfg, waves: np.ndarray, B: int, obs,
                  kernel_backend: str = "") -> np.ndarray:
    """Campaign identity, verified on resume.

    Covers everything that shapes the trajectory: the wave *data* itself
    (not just the seed), round geometry, the method, every field of the
    :class:`~repro_torch.fem.methods.SeismicConfig` (dt/tol/npart/nspring/…,
    the solver-amortization knobs, the health guards, the stream schedule;
    the dtype by name), the resolved kernel backend in place of the backend
    specs (``auto`` and ``cuda`` resolve alike on the card; the CUDA kernels
    and their plain versions agree only to rounding) and the observation
    set — so a checkpoint can never silently splice into a run computed
    under different inputs."""
    M, nt = waves.shape[0], waves.shape[1]
    specs = ("backend", "ebe_backend", "ms_backend", "tile_e", "tile_p")  # in ``kernel_backend``
    knobs = sorted((f.name, getattr(cfg, f.name)) for f in dataclasses.fields(cfg) if f.name not in specs)
    knobs = [(k, str(v) if isinstance(v, torch.dtype) else v) for k, v in knobs]
    ident = repr((
        campaign.seed, campaign.kset, campaign.method, campaign.scenario_sig, M, nt, B, knobs, kernel_backend,
        np.asarray(obs).tolist(), zlib.crc32(np.ascontiguousarray(waves).tobytes()),
    ))
    # every entry masked to the positive int32 range, as the reference does
    # (the exact seed still participates via the crc over ``ident``)
    return np.asarray([campaign.seed & 0x7FFFFFFF, M, nt, B, zlib.crc32(ident.encode()) & 0x7FFFFFFF], np.int64)


def _round_path(ckpt_dir: str, r: int, topo: CaseTopology) -> str:
    shard = f".p{topo.process_index:02d}" if topo.process_count > 1 else ""
    return os.path.join(ckpt_dir, "rounds", f"round_{r:05d}{shard}.npz")


def _round_ok_path(ckpt_dir: str, r: int) -> str:
    return os.path.join(ckpt_dir, "rounds", f"round_{r:05d}.ok")


def _bank_round(
    ckpt_dir: str, r: int, vel: np.ndarray, iters: np.ndarray, topo: CaseTopology,
    health: Optional[np.ndarray] = None, nonconverged: Optional[np.ndarray] = None,
) -> None:
    """Persist one completed round atomically — banked rounds are immutable,
    so they are written exactly once instead of into every later checkpoint
    (which would make checkpoint volume grow quadratically).

    Several processes: each banks its own lanes (``round_NNNNN.pNN.npz``);
    after a barrier confirms every shard is on disk, process 0 commits the
    round with an ``.ok`` marker, as the checkpoint manifest is committed —
    a kill between shard writes leaves the round uncommitted."""
    os.makedirs(os.path.join(ckpt_dir, "rounds"), exist_ok=True)
    path = _round_path(ckpt_dir, r, topo)
    tmp = path + ".tmp"
    extra = {} if health is None else {"health": health, "nonconverged": nonconverged}
    with open(tmp, "wb") as f:
        np.savez(f, vel=vel, iters=iters, **extra)
    os.replace(tmp, path)
    if topo.process_count > 1:
        dist.barrier("bank_round")
        if topo.process_index == 0:
            ok = _round_ok_path(ckpt_dir, r)
            with open(ok + ".tmp", "w") as f:
                f.write(f"{topo.process_count}\n")
            os.replace(ok + ".tmp", ok)


def _load_banked_round(
    ckpt_dir: str, r: int, r0: int, topo: CaseTopology
) -> tuple[np.ndarray, np.ndarray, Optional[np.ndarray], Optional[np.ndarray]]:
    path = _round_path(ckpt_dir, r, topo)
    if topo.process_count > 1 and not os.path.exists(_round_ok_path(ckpt_dir, r)):
        raise ValueError(
            f"checkpoint says round {r0} but banked round {r} was never "
            f"committed (missing {_round_ok_path(ckpt_dir, r)}) — checkpoint "
            f"directory corrupt"
        )
    if not os.path.exists(path):
        raise ValueError(
            f"checkpoint says round {r0} but banked round file {path} is "
            f"missing — checkpoint directory corrupt"
        )
    with np.load(path) as z:
        return (z["vel"], z["iters"], z["health"] if "health" in z.files else None,
                z["nonconverged"] if "nonconverged" in z.files else None)


def make_campaign_chunk(
    ops: methods.FemOperators,
    method: str,
    obs_idx,
    *,
    kset: int,
):
    """``(chunk_fn, new_carry)``: one entry's chunk of the campaign, and a
    function that builds a fresh ``kset``-member carry on ``ops.device``.

    ``chunk_fn(box, wave_chunk)`` advances the k-set carry handed over in
    the one-element list ``box`` through ``wave_chunk [kset, ct, 3]`` (a
    tensor on ``ops.device``), one step after another, and returns
    ``(carry', (vel [kset, ct, n_obs, 3], iters [kset, ct]))``: ``vel`` on
    the device, ``iters`` on the host.  The chunk empties ``box``, so the
    caller holds no reference to the chunk's first carry: at full size a
    k-set carry is 14.9 GB, and a caller's reference would keep it on the
    card beside every later step's.  A process runs one such chunk for each
    case-mesh entry it owns (:func:`run_campaign`).

    With ``ops.cfg.health`` the k-set step is wrapped by
    :func:`repro_torch.core.health.guard_step`: the carry becomes
    ``(inner_carry, health_word, nonconverged)`` — all three checkpoint
    together — and a case whose step goes non-finite is frozen at its last
    healthy carry, so NaN cannot march forward in time.
    """
    step = methods.ensemble_step(ops, method)
    guarded = bool(ops.cfg.health)
    if guarded:
        step = health_mod.guard_step(step)

    def new_carry():
        carry0 = methods.initial_ensemble_carry(ops, method, kset=kset)
        return health_mod.initial_guard_carry(carry0) if guarded else carry0

    obs = torch.as_tensor(np.asarray(obs_idx), dtype=torch.long, device=ops.device)

    def chunk(box, wave_chunk):
        carry = box.pop()
        vel, iters = [], []
        for f_t in wave_chunk.unbind(1):  # f_t: [kset, 3]
            carry, aux = step(carry, f_t)
            nm = carry[0][0] if guarded else carry[0]
            vel.append(nm.v[:, obs])
            iters.append(aux.iters)
        return carry, (torch.stack(vel, dim=1), torch.stack(iters, dim=1))

    return chunk, new_carry


def run_campaign(
    mesh,
    cfg: methods.SeismicConfig,
    waves,  # [M, nt, 3] bedrock input velocities
    *,
    observe: np.ndarray | None = None,
    campaign: CampaignConfig = CampaignConfig(),
    device=None,
    device_mesh=None,
    stop_after_steps: Optional[int] = None,
    on_chunk: Optional[Callable[[dict], None]] = None,
) -> CampaignResult:
    """Run (or resume) an ensemble campaign over ``waves`` on ``device``
    (``None`` → the card; the CPU only when asked).

    ``device_mesh`` is ``None`` (one device) or a case mesh
    (``launch.mesh.make_case_mesh()``): this process runs each entry it
    owns (:func:`case_topology`) on the entry's device (``device`` where
    the entry names none), each in its own host thread and CUDA stream.  A
    mesh spanning several processes makes this a multi-process campaign:
    every process calls ``run_campaign`` with the same arguments and
    returns only its own cases (``CampaignResult.case_indices``).
    ``stop_after_steps`` aborts the campaign at the first chunk boundary at
    or past that many global time steps *after* writing its checkpoint —
    the fault-injection hook of the kill-and-resume tests (a real SIGKILL
    anywhere is no worse: the previous checkpoint is atomic on disk).
    ``on_chunk(info)``, when given, is called after each chunk (its
    observations copied to the host, so the devices have finished it) with
    ``round``, the chunk's steps ``t0`` and ``t1``, its wall ``seconds``,
    and on cards ``peak_device_bytes``: the peaks of the entries' cards,
    summed, over the chunk (the cards' peak statistics are reset once the
    operators are built and after each call).
    """
    waves = np.asarray(waves)
    M, nt = waves.shape[0], waves.shape[1]
    topo = case_topology(device_mesh, campaign.kset)
    if topo.process_count == 1 and campaign.checkpoint_dir and dist.is_distributed():
        # N uncoordinated processes checkpointing one-process layouts into one
        # directory would race each other's renames and splice trajectories
        raise ValueError(
            f"running under torch.distributed with {dist.process_count()} "
            f"processes but the case mesh spans only this one; pass a "
            f"spanning mesh (launch.mesh.make_case_mesh()) or give each "
            f"process its own checkpoint_dir"
        )
    B = campaign.kset * topo.n_dev  # global round size
    padded, valid = pad_kset(waves, B)
    n_rounds = padded.shape[0] // B
    obs = np.asarray(observe if observe is not None else mesh.surface[:1])
    n_obs = len(obs)

    # ---- the entries: one operator set a device, one chunk and carry an entry
    devices = entry_devices(topo, device_mesh, device)
    n_ent, kset = len(devices), campaign.kset
    ops_of: dict[torch.device, methods.FemOperators] = {}
    for dev in devices:
        if dev not in ops_of:
            ops_of[dev] = fem_backend.make_operators(mesh, cfg, device=dev)
            if n_ent > 1 and campaign.method != "proposed2":
                ops_of[dev].bcsr  # made on first use: before the entries' threads share it
    chunks = [make_campaign_chunk(ops_of[dev], campaign.method, obs, kset=kset) for dev in devices]
    waves_of = {dev: torch.as_tensor(padded, dtype=cfg.rdtype, device=dev) for dev in ops_of}
    _sync(ops_of, n_ent)  # the constants above are made on this thread's streams, read on the entries'
    pool = EntryPool(devices)
    cards = sorted({d.index for d in devices if d.type == "cuda"}) if on_chunk is not None else []
    for c in cards:  # each chunk's peak is its own (the operators' constants stay in it)
        torch.cuda.reset_peak_memory_stats(c)
    bounds = _chunk_bounds(nt, campaign.checkpoint_every)
    vdt = np.dtype(str(cfg.rdtype).removeprefix("torch."))
    sig = _campaign_sig(campaign, cfg, waves, B, obs, ops_of[devices[0]].kernel_backend.describe())
    mgr = (CheckpointManager(campaign.checkpoint_dir, keep=campaign.keep, process_index=topo.process_index,
                             process_count=topo.process_count) if campaign.checkpoint_dir else None)

    def new_carries():
        return pool.map(lambda ch: ch[1](), chunks)

    def joined(carries):  # the entries' carries as one tree: each leaf one array of every local lane
        return carries[0] if n_ent == 1 else spread(carries)

    def parted(carry):
        return [carry] if n_ent == 1 else [unspread(carry, d) for d in range(n_ent)]

    # ---- resume ------------------------------------------------------------
    # Mutable campaign state splits in two: completed rounds are immutable
    # and banked once as rounds/round_NNNNN.npz; the checkpoint carries only
    # what still changes (the in-flight carry + this round's partial
    # observations), so checkpoint volume stays O(round), not O(campaign).
    r0, t0 = 0, 0
    carries = None  # one k-set carry an entry
    guarded = bool(cfg.health)
    done_rounds: list[tuple] = []  # (vel, iters, health|None, nonconverged|None) per completed round
    cur_vel: list[np.ndarray] = []
    cur_iters: list[np.ndarray] = []
    resumed_from = None
    if mgr is not None:
        template = None  # fresh carries that a mid-round checkpoint restores into
        meta_like = {"meta": {"sig": sig, "round": np.zeros((), np.int64), "t": np.zeros((), np.int64)}}
        bad_steps: set[int] = set()
        while True:
            restored = mgr.restore_latest(meta_like, skip=bad_steps)
            if restored is None:
                break
            ckpt_step, head = restored
            # verify the signature BEFORE restoring the carry: a mismatched
            # campaign must produce this error, not a structure one
            if not np.array_equal(np.asarray(head["meta"]["sig"]), sig):
                raise ValueError(
                    f"checkpoint in {campaign.checkpoint_dir} belongs to a "
                    f"different campaign (sig {np.asarray(head['meta']['sig'])} "
                    f"vs {sig}) — refusing to splice trajectories"
                )
            r_ck, t_ck = int(head["meta"]["round"]), int(head["meta"]["t"])
            if t_ck > 0 and template is None:
                template = joined(new_carries())
            try:
                st = mgr.restore(ckpt_step, {
                    "carry": template if t_ck > 0 else None,  # a round boundary stores no carry
                    "vel": np.zeros(()),  # structure-only (shape varies)
                    "iters": np.zeros(()),
                }, in_place=True)
            except CheckpointCorruptError as e:
                # the meta head verified but a carry/obs leaf is corrupt —
                # same degradation as restore_latest: lose one chunk, not the campaign
                print(
                    f"[checkpoint] step {ckpt_step} failed checksum "
                    f"verification ({e}) — falling back to the previous "
                    f"committed step",
                    file=sys.stderr,
                )
                bad_steps.add(ckpt_step)
                continue
            r0, t0 = r_ck, t_ck
            if t0 > 0:
                carries = parted(st.pop("carry"))  # ``template``'s tensors, filled
            for rr in range(r0):
                done_rounds.append(_load_banked_round(campaign.checkpoint_dir, rr, r0, topo))
            if t0 > 0:
                cur_vel = [np.asarray(st["vel"])]
                cur_iters = [np.asarray(st["iters"])]
            resumed_from = ckpt_step
            break
        template = None  # a carry restored into it is ``carries``; a partly filled one is dropped
        _sync(ops_of, n_ent)  # restored on this thread's streams, read on the entries'

    def _save(r_next: int, t_next: int, carry_next, blocking: bool = False):
        if mgr is None:
            return
        state = {
            "carry": carry_next,
            "vel": (np.concatenate(cur_vel, axis=1) if cur_vel
                    else np.zeros((topo.local, 0, n_obs, 3), vdt)),
            "iters": (np.concatenate(cur_iters, axis=1) if cur_iters
                      else np.zeros((topo.local, 0), np.int64)),
            "meta": {"sig": sig, "round": np.int64(r_next), "t": np.int64(t_next)},
        }
        # the JSON meta is the cross-shard agreement key restore_latest
        # validates: all processes must have saved the same (round, t)
        mgr.save(r_next * nt + t_next, state, blocking=blocking, meta={"round": int(r_next), "t": int(t_next)})

    box: list = [None] * n_ent  # each entry's carry, handed to its chunk and taken back

    def run_entry(d: int, lo: int, a: int, b: int):
        handed = [box[d] if box[d] is not None else chunks[d][1]()]  # the chunk holds the only reference
        box[d] = None
        wave = waves_of[devices[d]][lo + d * kset: lo + (d + 1) * kset, a:b]
        box[d], (vel, iters) = chunks[d][0](handed, wave)
        return vel.cpu().numpy(), iters.numpy().astype(np.int64)

    # ---- rounds ------------------------------------------------------------
    steps_done = r0 * nt + t0
    completed = r0 >= n_rounds
    stopped = False
    if carries is not None:
        box[:] = carries
    carries = None
    try:
        for r in range(r0, n_rounds):
            if r > r0:
                box[:] = [None] * n_ent  # free the last round's carries before building the next
                cur_vel, cur_iters, t0 = [], [], 0
            lo = r * B + topo.offset
            for a, b in bounds:
                if b <= t0:
                    continue  # already restored past this chunk
                a = max(a, t0)
                tc = time.perf_counter()
                outs = pool.map(run_entry, range(n_ent), [lo] * n_ent, [a] * n_ent, [b] * n_ent)
                cur_vel.append(np.concatenate([v for v, _ in outs]))
                cur_iters.append(np.concatenate([it for _, it in outs]))
                if on_chunk is not None:
                    info = {"round": r, "t0": a, "t1": b, "seconds": time.perf_counter() - tc}
                    if cards:
                        info["peak_device_bytes"] = sum(torch.cuda.max_memory_allocated(c) for c in cards)
                    on_chunk(info)
                    for c in cards:
                        torch.cuda.reset_peak_memory_stats(c)
                steps_done = r * nt + b
                if b == nt:  # round complete → bank it once
                    round_vel = np.concatenate(cur_vel, axis=1)
                    round_iters = np.concatenate(cur_iters, axis=1)
                    if guarded:  # final guarded carry = (inner, word, ncg)
                        round_health = np.concatenate([c[1].cpu().numpy() for c in box]).astype(np.int32)
                        round_ncg = np.concatenate([c[2].cpu().numpy() for c in box]).astype(np.int64)
                    else:
                        round_health = round_ncg = None
                    done_rounds.append((round_vel, round_iters, round_health, round_ncg))
                    if mgr is not None:
                        _bank_round(campaign.checkpoint_dir, r, round_vel, round_iters, topo, round_health,
                                    round_ncg)
                    cur_vel, cur_iters = [], []
                    completed = r + 1 == n_rounds
                    _save(r + 1, 0, None, blocking=completed)
                else:
                    _save(r, b, joined(box))
                if stop_after_steps is not None and steps_done >= stop_after_steps and not completed:
                    stopped = True
                    break
            if stopped or completed:
                break
    finally:
        box[:] = [None] * n_ent
        pool.close()
    if mgr is not None:
        mgr.wait()

    nr_done = len(done_rounds)
    # global waves row of each case held here, before masking out padding
    ids = (np.concatenate([r * B + topo.offset + np.arange(topo.local) for r in range(nr_done)])
           if nr_done else np.zeros(0, np.int64))
    vmask = valid[ids]
    done_vel = (np.stack([v for v, _, _, _ in done_rounds]) if nr_done
                else np.zeros((0, topo.local, nt, n_obs, 3), vdt))
    done_iters = (np.stack([it for _, it, _, _ in done_rounds]) if nr_done
                  else np.zeros((0, topo.local, nt), np.int64))
    if guarded:
        # a banked round without health words cannot appear here: the health
        # knob is in the signature, so such a resume refuses before this point
        done_health = (np.stack([h for _, _, h, _ in done_rounds]) if nr_done
                       else np.zeros((0, topo.local), np.int32))
        done_ncg = (np.stack([c for _, _, _, c in done_rounds]) if nr_done
                    else np.zeros((0, topo.local), np.int64))
        health_flat = done_health.reshape(nr_done * topo.local)[vmask]
        ncg_flat = done_ncg.reshape(nr_done * topo.local)[vmask]
    else:
        health_flat = np.zeros(0, np.int32)
        ncg_flat = np.zeros(0, np.int64)
    return CampaignResult(
        velocity_history=done_vel.reshape(nr_done * topo.local, nt, n_obs, 3)[vmask],
        iters=done_iters.reshape(nr_done * topo.local, nt)[vmask],
        rounds_done=nr_done,
        steps_done=steps_done,
        completed=completed,
        resumed_from=resumed_from,
        case_indices=ids[vmask],
        health=health_flat,
        nonconverged=ncg_flat,
        checkpoints=tuple(mgr.log) if mgr is not None else (),
    )
