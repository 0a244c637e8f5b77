"""The campaign's case mesh: one device a process.

The JAX package shards a campaign's case axis over a 1-D device mesh that
spans every process of a ``jax.distributed`` launch.  The port runs one
device in each process: with one process the case "mesh" is no mesh at
all (``None``, which the runner reads as "one device"); under a process
group (:func:`repro_torch.launch.bootstrap.distributed_init`) it is a
:class:`CaseMesh` of one entry a process, in process-major order, which
:func:`repro_torch.campaign.runner.case_topology` turns into each
process's contiguous block of case lanes.  Several devices in one process
raise until a machine with several cards is supported.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

MULTI_DEVICE = "the port runs a campaign on one device; the case mesh over several devices is not ported yet"


@dataclasses.dataclass(frozen=True)
class CaseDevice:
    """One entry of a :class:`CaseMesh`: the process that owns it and the
    device it runs on, as the launch names it (every process of a launch
    resolves the same flags, each to its own card)."""

    process_index: int
    device: Any


@dataclasses.dataclass(frozen=True)
class CaseMesh:
    """The case axis over the processes of a launch: ``devices`` is a numpy
    object array of :class:`CaseDevice`, one a process, process-major."""

    devices: np.ndarray
    axis_names: tuple = ("case",)


def make_case_mesh(n_devices: int | None = None, axis: str = "case", device=None):
    """The case mesh of this launch.  One process: ``None`` (one device).
    Under a process group: a :class:`CaseMesh` over every process, each
    entry on ``device`` (``None``: the card, resolved by the runner).
    ``n_devices`` may name that many devices (the world size); more devices
    than processes raise :class:`NotImplementedError`."""
    from repro_torch.parallel import distributed as dist

    world = dist.process_count()
    n = world if n_devices is None else n_devices
    if n < 1:
        raise ValueError(f"n_devices must be ≥ 1, got {n}")
    if n != world:
        if n > world:
            raise NotImplementedError(f"make_case_mesh({n}) over {world} process(es): {MULTI_DEVICE}")
        raise ValueError(f"make_case_mesh({n}) under {world} processes: the case mesh spans every process")
    if world == 1:
        return None
    entries = np.empty(world, dtype=object)
    entries[:] = [CaseDevice(p, device) for p in range(world)]
    return CaseMesh(entries, (axis,))
