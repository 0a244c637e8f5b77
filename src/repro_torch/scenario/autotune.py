"""Per-plan-group method autotuner: pick ``(method, npart, kset)``.

The port's copy of the JAX package's ``scenario/autotune.py``: the same
ranking constants, candidates, scores and shortlist, so both packages
choose alike from the model.  Two stages:

1. **Cost-model ranking** — every feasible ``(method, npart, kset)``
   candidate is scored with :func:`repro_torch.core.pipeline.stream_time`
   (the Algorithm-3 analytical model: double-buffered transfer/compute
   overlap, prefetch, k-set amortization) plus a flop model of the solver
   phase.  Feasibility is a device-memory budget: resident methods must
   hold all ``kset`` members' spring state in device memory; streamed
   methods hold only two blocks (Algorithm 3's bound).
2. **On-device probe** (optional, ``probe=True``) — the model's shortlist
   is timed for real: each candidate's campaign chunk
   (:func:`repro_torch.campaign.make_campaign_chunk`) runs a few steps on
   the device, and the fastest measured per-case time wins.

The model constants below are *ranking* constants — they encode the shape
of the method trade-offs (constitutive update is memory-bound and
k-set-amortizable; CRS pays a per-step assembly the EBE path avoids;
streaming pays transfers the resident path avoids), not any machine's
absolute timings; ``DEFAULT_DEVICE_GB`` and ``DEFAULT_LINK_GBPS`` are the
reference's budget and link, not the card's.  Passing ``calibration=`` (a
:class:`~repro_torch.core.pipeline.KernelCalibration` or the path of a
``BENCH_kernels.json``-format table) replaces the constitutive and matvec
rates with measured per-unit timings.  On-device truth still comes from
the probe.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import pipeline
from repro_torch.fem import quadrature as quad

# ranking constants (see module docstring)
MODEL_FLOPS = 2.0e11          # effective device throughput [flop/s]
MS_FLOPS_PER_SPRING = 80.0    # constitutive flops per (point, spring)
MATVEC_FLOPS_PER_ELEM = 2.0 * 30 * 30 * quad.NPOINT
SOLVER_ITERS = 40.0           # modeled PCG iterations per time step
CRS_ASSEMBLY_FACTOR = 12.0    # UpdateCRS + BCSR assembly, in matvec units
EBE_MATVEC_FACTOR = 1.3       # matrix-free matvec premium per iteration
EBE_PRECOND_ITERS = 0.5       # outer-iteration cut from the fp32 inner PCG
KSET_COMPUTE_MARGINAL = 0.6   # marginal compute of one more k-set member
DEFAULT_LINK_GBPS = 900.0     # the reference's host link (a ranking constant)
DEFAULT_DEVICE_GB = 4.0       # modeled device memory available for state


@dataclasses.dataclass(frozen=True)
class TuneChoice:
    """The tuned knobs + how they were arrived at (recorded in the plan
    manifest, so a sweep's choices are auditable after the fact).  The
    reference's fields in its order: manifests cross packages."""

    method: str
    npart: int
    kset: int
    source: str = "default"            # default | model | probe
    modeled_case_s: Optional[float] = None
    probed_case_s: Optional[float] = None
    considered: int = 0
    calibration: Optional[str] = None  # calibration table's backend, if used


def spring_state_bytes(mesh, cfg) -> int:
    """Bytes of multi-spring state for one ensemble member (all points),
    counted as the reference counts them: 4 real + 2 int32 leaves."""
    item = torch.empty((), dtype=cfg.rdtype).element_size()
    npts = mesh.n_elem * quad.NPOINT
    return npts * cfg.nspring * (4 * item + 2 * 4)  # 4 real + 2 int32 leaves


def candidate_nparts(npts: int, cap: int = 8) -> list[int]:
    """Divisors of the quadrature-point count up to ``cap`` — the only legal
    streaming splits."""
    return [p for p in range(1, cap + 1) if npts % p == 0]


def _model_scores(mesh, cfg, *, n_cases, n_devices, methods, kset_cap,
                  npart_cap, link_gbps, device_budget_bytes, calibration=None):
    """Yield ``(per_case_s, method, npart, kset)`` for every feasible combo."""
    npts = mesh.n_elem * quad.NPOINT
    state_bytes = spring_state_bytes(mesh, cfg)
    if calibration is not None:
        ms_s = calibration.multispring_s(npts, cfg.nspring)
        matvec_s = calibration.ebe_matvec_s(mesh.n_elem)
    else:
        ms_s = npts * cfg.nspring * MS_FLOPS_PER_SPRING / MODEL_FLOPS
        matvec_s = mesh.n_elem * MATVEC_FLOPS_PER_ELEM / MODEL_FLOPS
    solve_crs_s = SOLVER_ITERS * matvec_s + CRS_ASSEMBLY_FACTOR * matvec_s
    solve_ebe_s = SOLVER_ITERS * EBE_PRECOND_ITERS * EBE_MATVEC_FACTOR * matvec_s
    kmax = max(1, min(kset_cap, math.ceil(n_cases / max(1, n_devices))))

    for method in methods:
        for k in range(1, kmax + 1):
            kscale = 1.0 + (k - 1) * KSET_COMPUTE_MARGINAL
            if method == "proposed2":
                # resident EBE 2SET: all k members' state lives on device
                if k * state_bytes > device_budget_bytes:
                    continue
                total = (solve_ebe_s + ms_s) * kscale
                yield total / k, method, 1, k
            elif method == "proposed1":
                # streamed CRS (Alg. 3): two blocks of k members resident
                for npart in candidate_nparts(npts, npart_cap):
                    if 2 * k * state_bytes / npart > device_budget_bytes:
                        continue
                    st = pipeline.stream_time(
                        compute_s_per_block=ms_s / npart,
                        bytes_in_per_block=state_bytes / npart,
                        bytes_out_per_block=state_bytes / npart,
                        link_gbps=link_gbps,
                        npart=npart,
                        kset=k,
                        kset_compute_marginal=KSET_COMPUTE_MARGINAL,
                    )
                    total = solve_crs_s * kscale + st.pipelined_s
                    yield total / k, method, npart, k
            elif method in ("baseline1", "baseline2"):
                # host-resident constitutive law: no device budget pressure,
                # but the constitutive phase runs at host speed and baseline2
                # round-trips δu/D
                host_penalty = 8.0
                total = solve_crs_s * kscale + ms_s * host_penalty * kscale
                if method == "baseline2":
                    total += 2 * k * state_bytes / (link_gbps * 1e9)
                yield total / k, method, cfg.npart, k
            else:
                raise KeyError(f"autotune does not model method {method!r}")


def _probe_shortlist(scored, probe_top: int):
    """Candidates worth a real measurement: the best-modeled candidate of
    **every** distinct method first (the probe exists to arbitrate *between*
    methods, where the model is least trustworthy), then best-overall
    fill-ins up to ``probe_top`` — never fewer than one per method even if
    one method's candidates dominate the top of the ranking."""
    per_method: list = []
    seen: set = set()
    for c in scored:
        if c[1] not in seen:
            per_method.append(c)
            seen.add(c[1])
    shortlist = list(per_method)
    for c in scored:
        if len(shortlist) >= probe_top:
            break
        if c not in shortlist:
            shortlist.append(c)
    return shortlist


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _probe_case_s(mesh, cfg, method, npart, kset, waves, obs, *, steps, reps=2, device=None):
    """Measure seconds/case/step of one candidate's campaign chunk on
    ``device`` (``None``: the card).

    The chunk pops its carry from the one-element list it is handed, so
    every rep gets a fresh carry, built (and synchronised) outside the timed
    window; one warm call runs first.  The candidate's operators are
    released before the caller builds the next candidate's."""
    from repro_torch.campaign import make_campaign_chunk
    from repro_torch.core.stream import pad_kset
    from repro_torch.fem import backend as fem_backend

    cfg = dataclasses.replace(cfg, npart=npart)
    ops = fem_backend.make_operators(mesh, cfg, device=device)
    dev = ops.device
    chunk_fn, new_carry = make_campaign_chunk(ops, method, obs, kset=kset)
    padded, _ = pad_kset(np.asarray(waves)[:kset, :steps], kset)
    w = torch.as_tensor(padded[:kset], dtype=cfg.rdtype, device=dev)
    chunk_fn([new_carry()], w)  # warm
    _synchronize(dev)
    total = 0.0
    for _ in range(reps):
        box = [new_carry()]
        _synchronize(dev)
        t0 = time.perf_counter()
        out = chunk_fn(box, w)
        _synchronize(dev)
        total += time.perf_counter() - t0
        del out
    del ops, chunk_fn, new_carry, w
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return total / (reps * kset * steps)


def choose(
    mesh,
    cfg,
    *,
    n_cases: int,
    n_devices: int = 1,
    methods: Sequence[str] = ("proposed2", "proposed1"),
    kset_cap: int = 4,
    npart_cap: int = 8,
    link_gbps: float = DEFAULT_LINK_GBPS,
    device_gb: float = DEFAULT_DEVICE_GB,
    probe: bool = False,
    probe_top: int = 2,
    probe_steps: int = 2,
    waves: Optional[np.ndarray] = None,
    obs: Optional[np.ndarray] = None,
    calibration=None,
    device=None,
) -> TuneChoice:
    """Pick ``(method, npart, kset)`` for one plan group.

    Rank every feasible candidate with the cost model; with ``probe=True``
    (requires ``waves`` and ``obs``) the ``probe_top`` best-modeled
    candidates are additionally timed on ``device`` (``None``: the card) and
    the measured winner is returned.  ``calibration`` — a
    :class:`~repro_torch.core.pipeline.KernelCalibration` or a table path
    (missing file → constants) — replaces the hard-coded kernel rates with
    measured ones.  Raises if no candidate fits the memory budget (then the
    budget, not the tuner, is the problem to fix).
    """
    if isinstance(calibration, str):
        calibration = pipeline.load_kernel_calibration(calibration)
    cal_tag = calibration.backend if calibration is not None else None
    scored = sorted(
        _model_scores(
            mesh, cfg, n_cases=n_cases, n_devices=n_devices, methods=methods,
            kset_cap=kset_cap, npart_cap=npart_cap, link_gbps=link_gbps,
            device_budget_bytes=device_gb * 1e9, calibration=calibration,
        ),
        key=lambda c: (c[0], c[1], c[2], c[3]),
    )
    if not scored:
        raise ValueError(
            f"no (method, npart, kset) candidate fits device_gb={device_gb} "
            f"for this mesh ({mesh.n_elem} elems × nspring={cfg.nspring})"
        )
    if not probe:
        s, m, p, k = scored[0]
        return TuneChoice(method=m, npart=p, kset=k, source="model",
                          modeled_case_s=s, considered=len(scored),
                          calibration=cal_tag)
    if waves is None or obs is None:
        raise ValueError("probe=True needs the group's waves and obs arrays")
    best = None
    for s, m, p, k in _probe_shortlist(scored, probe_top):
        measured = _probe_case_s(mesh, cfg, m, p, k, waves, obs, steps=probe_steps, device=device)
        if best is None or measured < best[0]:
            best = (measured, s, m, p, k)
    measured, s, m, p, k = best
    return TuneChoice(method=m, npart=p, kset=k, source="probe",
                      modeled_case_s=s, probed_case_s=measured,
                      considered=len(scored), calibration=cal_tag)
