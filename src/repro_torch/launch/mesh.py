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

The production meshes of the JAX package, (16, 16) over (data, model) and
(2, 16, 16) over (pod, data, model), and its small host mesh are
:class:`LogicalMesh` layouts here: named axes and their sizes, no devices.
The dry run (:mod:`repro_torch.launch.dryrun`) accounts for a cell over
one of them, per device; nothing is placed.  :func:`make_card_mesh` is the
one card, (1, 1).
"""
from __future__ import annotations

import dataclasses
import math
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


@dataclasses.dataclass(frozen=True)
class LogicalMesh:
    """Named axes of ``shape`` devices, for accounting: what the JAX package's
    ``jax.make_mesh`` describes, without the devices.  ``shape`` plays the
    part of ``mesh.devices.shape``."""

    shape: tuple[int, ...]
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if len(self.shape) != len(self.axis_names) or len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} over axes {self.axis_names}: one distinct name an axis")
        if any(not isinstance(n, int) or n < 1 for n in self.shape):
            raise ValueError(f"mesh shape {self.shape}: every axis needs a size ≥ 1")

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def sizes(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    @property
    def name(self) -> str:
        return "x".join(map(str, self.shape))


def make_production_mesh(*, multi_pod: bool = False) -> LogicalMesh:
    """(16, 16) over (data, model), or (2, 16, 16) over (pod, data, model)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return LogicalMesh(shape, axes)


def make_host_mesh(shape=(2, 4), axes=("data", "model")) -> LogicalMesh:
    """The JAX package's small mesh for its multi-device host tests."""
    return LogicalMesh(tuple(shape), tuple(axes))


def make_card_mesh() -> LogicalMesh:
    """One card: (1, 1) over (data, model)."""
    return LogicalMesh((1, 1), ("data", "model"))


def parse_mesh(spec: str) -> LogicalMesh:
    """``"1x1"``, ``"2x4"``, … over (data, model), with ``pod`` in front for
    three sizes."""
    shape = tuple(int(n) for n in spec.lower().split("x"))
    return LogicalMesh(shape, ("pod", "data", "model") if len(shape) == 3 else ("data", "model"))
