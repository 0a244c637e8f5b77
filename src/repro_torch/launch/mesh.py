"""Meshes of the port: the training mesh over a process group, the
campaign's case mesh, and logical layouts for accounting.

The training mesh (:func:`make_auto_mesh`, :func:`make_host_mesh`,
:func:`make_production_mesh`) is a ``torch.distributed`` ``DeviceMesh``
with one device a process: its size must be the process group's world
size, and each process is one of its coordinates.  On the CPU the processes
are the ones ``--host-devices N`` launches
(:func:`repro_torch.launch.bootstrap.force_host_devices`); on the card
each process takes the card, and several processes may share one.

The JAX package shards a campaign's case axis over a 1-D device mesh that
spans every process of a ``jax.distributed`` launch.  The port's case mesh
(:func:`make_case_mesh`) is a :class:`CaseMesh`: a list of
:class:`CaseDevice` entries, each a process and a torch device, in
process-major order.  A process may own several entries: the cards of
``torch.cuda.device_count()``, or ``host_devices`` CPU entries (the
reference's forced host devices).  The runner
(:func:`repro_torch.campaign.runner.case_topology`) gives each process the
contiguous block of case lanes on its entries and runs each entry it owns
in a host thread of its own, on a CUDA stream of its own.  One entry in all
is no mesh (``None``, "one device").

The dry run (:mod:`repro_torch.launch.dryrun`) accounts for a cell over
the production meshes without running it: there they are
:class:`LogicalMesh` layouts (:func:`logical_production_mesh`,
:func:`logical_host_mesh`, :func:`parse_mesh`), named axes and their sizes
and no devices.  :func:`make_card_mesh` is the one card, (1, 1).
"""
from __future__ import annotations

import dataclasses
import math
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable

import numpy as np

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")), True: ((2, 16, 16), ("pod", "data", "model"))}


@dataclasses.dataclass(frozen=True)
class CaseDevice:
    """One entry of a :class:`CaseMesh`: the process that owns it and the
    device it runs on (``None``: the card, resolved by the runner).  Every
    process of a launch resolves the same flags, so it lists its peers'
    entries on devices named as its own."""

    process_index: int
    device: Any


@dataclasses.dataclass(frozen=True)
class CaseMesh:
    """The case axis: ``devices`` is a numpy object array of
    :class:`CaseDevice`, process-major (each process's entries together)."""

    devices: np.ndarray
    axis_names: tuple = ("case",)


def local_case_devices(device=None, host_devices: int = 0) -> list:
    """The case-mesh devices this process owns: ``host_devices`` CPU entries
    when that is above 0; else ``device`` itself when it names one device
    (``"cpu"``, ``"cuda:1"``) or when the process is one of a group (each
    owns one device); else (``None`` or ``"cuda"``) every card of
    ``torch.cuda.device_count()``, or one entry left to the runner (which
    refuses it) where there is none."""
    import torch

    from repro_torch.parallel import distributed as dist

    if host_devices > 0:
        return [torch.device("cpu")] * host_devices
    if dist.process_count() > 1 or (device is not None and (torch.device(device).type != "cuda"
                                                            or torch.device(device).index is not None)):
        return [device]
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [torch.device("cuda", i) for i in range(n)] or [device]


def make_case_mesh(n_devices: int | None = None, axis: str = "case", device=None, host_devices: int = 0):
    """The case mesh of this launch: every process's entries
    (:func:`local_case_devices`: one process owns every card, a process of
    a group its own device; either owns ``host_devices`` CPU entries when
    that is above 0), process-major, cut to the first ``n_devices``
    (default: all).  More than there are raise the reference's
    :class:`ValueError`; under a process group the mesh spans every device
    of every process.  One entry in all is ``None``."""
    from repro_torch.parallel import distributed as dist

    world = dist.process_count()
    local = local_case_devices(device, host_devices)
    total = world * len(local)
    n = total if n_devices is None else n_devices
    if n < 1:
        raise ValueError(f"n_devices must be ≥ 1, got {n}")
    if n > total:
        raise ValueError(f"requested {n} devices, have {total}")
    if world > 1 and n != total:
        raise ValueError(f"make_case_mesh({n}) under {world} processes of {len(local)} device(s) each: the case "
                         f"mesh spans every device of every process ({total})")
    if n == 1:
        return None
    entries = np.empty(n, dtype=object)
    entries[:] = [CaseDevice(p, d) for p in range(world) for d in local][:n]
    return CaseMesh(entries, (axis,))


def entry_device(entry, device=None):
    """The torch device an entry runs on, its index fixed: the entry's own
    device, or ``device`` (``None``: the card) where it names none."""
    import torch

    from repro_torch.device import resolve_device

    own = getattr(entry, "device", None)
    dev = resolve_device(device if own is None else own)
    return torch.device("cuda", torch.cuda.current_device()) if dev.type == "cuda" and dev.index is None else dev


class EntryPool:
    """Runs a function once for each entry of a process's case mesh, each in
    its own host thread, under the entry's device and a CUDA stream of its
    own (on the CPU: the thread alone); one entry runs on the caller's
    thread, under what is current there.  :meth:`map` returns the results
    in entry order and raises in the caller what an entry's call raised
    (after every entry's call has ended)."""

    def __init__(self, devices: list):
        import torch

        self.devices = list(devices)
        several = len(self.devices) > 1
        self.streams = [torch.cuda.Stream(d) if several and d.type == "cuda" else None for d in self.devices]
        self._pool = ThreadPoolExecutor(len(self.devices)) if several else None

    def _call(self, i: int, fn: Callable, args: tuple):
        import torch

        if self.streams[i] is None:
            return fn(*args)
        with torch.cuda.device(self.devices[i]), torch.cuda.stream(self.streams[i]):
            return fn(*args)

    def map(self, fn: Callable, *arg_lists) -> list:
        calls = list(zip(*arg_lists))
        if self._pool is None:
            return [fn(*calls[0])]
        futures = [self._pool.submit(self._call, i, fn, a) for i, a in enumerate(calls)]
        for i, e in enumerate([f.exception() for f in futures]):
            if e is not None:
                e.add_note(f"raised in case-mesh entry {i} on {self.devices[i]}")
                raise e
        return [f.result() for f in futures]

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None


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


def mesh_axes(shape) -> tuple[str, ...]:
    """(data, model) for two sizes, (pod, data, model) for three."""
    return ("pod", "data", "model") if len(shape) == 3 else ("data", "model")


def make_auto_mesh(shape, axes, device_type: str | None = None):
    """The ``DeviceMesh`` of ``shape`` over ``axes`` on the process group,
    one device a process, ranks laid out row-major.  ``device_type`` is
    ``"cpu"`` or ``"cuda"`` (``None``: the card).  The mesh's size must be
    the world size (:class:`ValueError` otherwise, naming both)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.parallel import distributed as dist

    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    LogicalMesh(shape, axes)  # the same checks of names and sizes
    world = dist.process_count()
    if math.prod(shape) != world:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh over {axes} needs {math.prod(shape)} processes, "
                         f"one a device; this launch has a world size of {world}")
    if not dist.group_up():
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs a process group: bring one up first "
                         f"(launch.bootstrap.distributed_init)")
    return init_device_mesh(device_type or "cuda", shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type: str | None = None):
    """(16, 16) over (data, model), or (2, 16, 16) over (pod, data, model):
    256 or 512 processes."""
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    return make_auto_mesh(shape, axes, device_type)


def make_host_mesh(shape=(2, 4), axes=("data", "model"), device_type: str = "cpu"):
    """The JAX package's small mesh for its multi-device host tests: here
    over as many CPU processes."""
    return make_auto_mesh(shape, axes, device_type)


def mesh_coordinates(mesh) -> dict[str, int]:
    """This process's coordinate on each axis of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def logical_production_mesh(*, multi_pod: bool = False) -> LogicalMesh:
    """The layout of :func:`make_production_mesh`, for accounting."""
    return LogicalMesh(*PRODUCTION_SHAPES[multi_pod])


def logical_host_mesh(shape=(2, 4), axes=("data", "model")) -> LogicalMesh:
    """The layout of :func:`make_host_mesh`, for accounting."""
    return LogicalMesh(tuple(shape), tuple(axes))


def make_card_mesh() -> LogicalMesh:
    """One card: (1, 1) over (data, model)."""
    return LogicalMesh((1, 1), ("data", "model"))


def parse_mesh(spec: str) -> LogicalMesh:
    """``"1x1"``, ``"2x4"``, … over (data, model), with ``pod`` in front for
    three sizes."""
    shape = tuple(int(n) for n in spec.lower().split("x"))
    return LogicalMesh(shape, mesh_axes(shape))
