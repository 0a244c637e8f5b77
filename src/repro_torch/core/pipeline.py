"""Analytical model of the double-buffered streaming pipeline (Algorithm 3).

The port's copy of the JAX package's ``core/pipeline.py`` (framework-free):
the same formulas, the same floats.  The autotuner
(:mod:`repro_torch.scenario.autotune`) ranks its candidates with
:func:`stream_time`; :func:`breakeven_link_gbps` gives the host-link
bandwidth below which a streamed block loop turns transfer-bound.  No
machine's times are built in: measured kernel rates come in through
:class:`KernelCalibration`, read from a ``BENCH_kernels.json``-format table
(:func:`load_kernel_calibration`).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional


@dataclasses.dataclass(frozen=True)
class StreamCost:
    """Per-step cost breakdown of a streamed block loop."""

    compute_s: float          # Σ_j compute time of block j
    transfer_s: float         # Σ_j (in+out) transfer time of block j
    pipelined_s: float        # with double-buffer overlap
    serial_s: float           # without overlap (transfer then compute)
    bound: str                # "compute" | "transfer"

    @property
    def speedup_from_overlap(self) -> float:
        return self.serial_s / self.pipelined_s


def pipeline_time(
    *,
    compute_s_per_block: float,
    bytes_in_per_block: float,
    bytes_out_per_block: float,
    link_gbps: float,
    npart: int,
    duplex: bool = True,
) -> StreamCost:
    """Time of the Algorithm-3 pipeline.

    With double buffering, steady state costs ``max(t_c, t_xfer)`` per block.
    ``duplex=True`` models a full-duplex host link: in/out transfers overlap
    each other → ``t_xfer = max(t_in, t_out)``.  ``duplex=False`` models a
    shared half-duplex link where the two directions serialize → ``t_xfer =
    t_in + t_out``.  Pipeline fill adds one transfer-in, drain adds one
    transfer-out.
    """
    t_in = bytes_in_per_block / (link_gbps * 1e9)
    t_out = bytes_out_per_block / (link_gbps * 1e9)
    t_xfer = max(t_in, t_out) if duplex else t_in + t_out
    t_c = compute_s_per_block
    steady = max(t_c, t_xfer)
    pipelined = t_in + npart * steady + t_out
    serial = npart * (t_in + t_c + t_out)
    return StreamCost(
        compute_s=npart * t_c,
        transfer_s=npart * (t_in + t_out),
        pipelined_s=pipelined,
        serial_s=serial,
        bound="compute" if t_c >= t_xfer else "transfer",
    )


@dataclasses.dataclass(frozen=True)
class StreamCostExt(StreamCost):
    """:class:`StreamCost` extended with prefetch-depth and k-set terms."""

    fill_s: float               # pipeline fill: first block's transfer-in
    drain_s: float              # pipeline drain: last block's transfer-out
    stall_s: float              # Σ expected per-block stall from transfer jitter
    device_blocks: int          # device-resident block buffers (prefetch+1)
    kset: int                   # ensemble members advanced per pass

    @property
    def pipelined_per_member_s(self) -> float:
        """Wall time per ensemble member — the k-set amortization metric."""
        return self.pipelined_s / self.kset


def stream_time(
    *,
    compute_s_per_block: float,
    bytes_in_per_block: float,
    bytes_out_per_block: float,
    link_gbps: float,
    npart: int,
    prefetch: int = 1,
    kset: int = 1,
    shared_bytes_per_block: float = 0.0,
    kset_compute_marginal: float = 1.0,
    jitter_frac: float = 0.0,
    duplex: bool = True,
) -> StreamCostExt:
    """Cost model for a :class:`repro_torch.core.stream.StreamPlan` execution.

    Extends :func:`pipeline_time` along the two axes the StreamEngine adds:

    *Prefetch depth* (``prefetch`` ≥ 1).  With deterministic per-block times,
    depth beyond 1 cannot beat the double buffer.  What deeper prefetch buys
    is *jitter absorption*: with per-block transfer-time variation of
    ``jitter_frac·t_xfer``, a depth-``k`` queue averages the variation over
    ``k`` in-flight copies, so the expected per-block stall is modeled as
    ``jitter_frac·t_xfer/k``.  The price is memory: ``prefetch+1``
    device-resident block buffers.

    *k-set ensembles* (``kset`` ≥ 1).  Each block carries ``kset`` members'
    state (transfer scales ×kset) plus ``shared_bytes_per_block`` of operands
    fetched once regardless of k (the 2SET amortization).  Per-block compute
    scales as ``1 + (kset-1)·kset_compute_marginal``: marginal < 1 models the
    batching win of memory-bound constitutive kernels.  Divide
    ``pipelined_s`` by ``kset`` (``pipelined_per_member_s``) to compare
    against unbatched passes.
    """
    if npart < 1 or prefetch < 1 or kset < 1:
        raise ValueError(f"npart={npart}, prefetch={prefetch}, kset={kset} must be ≥ 1")
    if not 0.0 <= jitter_frac:
        raise ValueError(f"jitter_frac must be ≥ 0, got {jitter_frac}")
    bw = link_gbps * 1e9
    t_in = (kset * bytes_in_per_block + shared_bytes_per_block) / bw
    t_out = kset * bytes_out_per_block / bw
    t_xfer = max(t_in, t_out) if duplex else t_in + t_out
    t_c = compute_s_per_block * (1.0 + (kset - 1) * kset_compute_marginal)
    stall = jitter_frac * t_xfer / prefetch
    steady = max(t_c, t_xfer) + stall
    pipelined = t_in + npart * steady + t_out
    serial = npart * (t_in + t_c + t_out)
    return StreamCostExt(
        compute_s=npart * t_c,
        transfer_s=npart * (t_in + t_out),
        pipelined_s=pipelined,
        serial_s=serial,
        bound="compute" if t_c >= t_xfer else "transfer",
        fill_s=t_in,
        drain_s=t_out,
        stall_s=npart * stall,
        device_blocks=prefetch + 1,
        kset=kset,
    )


@dataclasses.dataclass(frozen=True)
class KernelCalibration:
    """Measured per-unit kernel rates feeding the stream/solver cost models.

    The autotuner's ranking constants encode the *shape* of the method
    trade-offs but no machine's absolute speed.  A kernel-benchmark table
    (the ``BENCH_kernels.json`` format: per kernel, its unit count and each
    backend's ``us_per_call``) turns into per-unit seconds here, which the
    autotuner then uses in place of its constants.  Rates scale linearly in
    their unit counts (points×springs for the constitutive update, elements
    for the EBE product) — exact at the measured shape, a calibrated linear
    model elsewhere, which is all a *ranking* needs.
    """

    multispring_s_per_point_spring: float  # s per (quadrature point × spring)
    ebe_s_per_elem: float                  # s per element per EBE matvec
    backend: str = "jnp"                   # backend the rates were measured on
    source: str = "constants"              # file the table came from

    def multispring_s(self, npts: int, nspring: int) -> float:
        return npts * nspring * self.multispring_s_per_point_spring

    def ebe_matvec_s(self, n_elem: int) -> float:
        return n_elem * self.ebe_s_per_elem


def _pick_backend(backends: dict, prefer: Optional[str]) -> tuple[str, dict]:
    if prefer and prefer in backends:
        return prefer, backends[prefer]
    name = min(backends, key=lambda b: backends[b]["us_per_call"])
    return name, backends[name]


def load_kernel_calibration(
    path: str, backend: Optional[str] = None
) -> Optional[KernelCalibration]:
    """Kernel-benchmark table → :class:`KernelCalibration`, or ``None`` if
    the file does not exist (callers fall back to model constants).

    ``backend`` prefers one backend's measured rates (``cuda`` for the
    port's kernels, ``torch`` for their plain versions); default is the
    fastest measured one per kernel — what ``backend="auto"`` dispatch
    would execute.
    """
    if not path or not os.path.exists(path):
        return None
    with open(path) as f:
        table = json.load(f)
    kernels = table.get("kernels", {})
    try:
        ms, ebe = kernels["multispring"], kernels["ebe_matvec"]
        ms_name, ms_entry = _pick_backend(ms["backends"], backend)
        ebe_name, ebe_entry = _pick_backend(ebe["backends"], backend)
        return KernelCalibration(
            multispring_s_per_point_spring=ms_entry["us_per_call"] * 1e-6 / ms["units"],
            ebe_s_per_elem=ebe_entry["us_per_call"] * 1e-6 / ebe["units"],
            backend=ms_name if ms_name == ebe_name else f"{ebe_name}+{ms_name}",
            source=os.path.abspath(path),
        )
    except (KeyError, TypeError, ZeroDivisionError) as e:
        raise ValueError(f"malformed kernel-benchmark table {path}: {e}") from None


def breakeven_link_gbps(*, compute_s_per_block: float, bytes_per_block: float) -> float:
    """Link bandwidth at which transfer time equals compute time per block.

    Below this bandwidth the pipeline is transfer-bound and the technique's
    advantage decays toward the host-resident baseline.
    """
    return bytes_per_block / compute_s_per_block / 1e9
