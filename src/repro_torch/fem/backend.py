"""Kernel-backend dispatch of the port: the CUDA kernels on the card, their
plain PyTorch versions on the CPU.

The kernel is chosen by the device the tensors live on.  A spec only states
what the caller expects, and is refused where it disagrees with the device:

``auto``   the CUDA kernel on a CUDA device, the plain version on the CPU;
``cuda``   the CUDA kernel (a CUDA device is required);
``torch``  the plain version (the CPU is required).

No spec puts the plain version on a CUDA tensor, and nothing falls back
from a kernel to its plain version.  ``tile_e``/``tile_p`` are the CUDA
launch knobs (elements per tile of the EBE kernel's persistent grid, four
threads each, a multiple of 4 in [4, 64]; points per block of the
multispring kernel, one warp each, in [1, 8]).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.ebe_matvec.ebe_matvec import TILE_E, check_tile_e
from repro_torch.kernels.multispring.multispring import TILE_P, check_tile_p

BACKEND_SPECS = ("auto", "cuda", "torch")
_RESOLVED = ("cuda", "torch")


def resolve_spec(spec: str, device) -> str:
    """One spec → one resolved backend name (no ``auto`` left) for ``device``."""
    if spec not in BACKEND_SPECS:
        raise ValueError(f"unknown kernel backend {spec!r}; one of {BACKEND_SPECS}")
    kind = torch.device(device).type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"no kernel backend for device {device}")
    resolved = "cuda" if kind == "cuda" else "torch"
    if spec not in ("auto", resolved):
        raise ValueError(
            f"kernel backend {spec!r} cannot run on device {device}: the kernel is "
            f"chosen by the device (CUDA kernel on cuda, plain PyTorch on cpu)"
        )
    return resolved


@dataclasses.dataclass(frozen=True)
class KernelBackend:
    """Resolved per-kernel backend choice + CUDA launch knobs."""

    ebe: str = "torch"
    multispring: str = "torch"
    tile_e: int = TILE_E
    tile_p: int = TILE_P

    def __post_init__(self):
        for field in ("ebe", "multispring"):
            v = getattr(self, field)
            if v not in _RESOLVED:
                raise ValueError(f"KernelBackend.{field}={v!r} is not resolved; one of {_RESOLVED}")
        check_tile_e(self.tile_e)
        check_tile_p(self.tile_p)

    @property
    def name(self) -> str:
        """Collapsed label for logs: the common name, or ``mixed``."""
        return self.ebe if self.ebe == self.multispring else "mixed"

    def describe(self) -> str:
        """Stable identity string, folded into the campaign signature."""
        return f"ebe={self.ebe},ms={self.multispring},tile_e={self.tile_e},tile_p={self.tile_p}"

    # The wrappers pick the kernel from the tensors' device; the resolved
    # names above record (and were checked against) that device.
    def element_kernel(self) -> Callable:
        from repro_torch.kernels.ebe_matvec import ops as ebe_ops

        return functools.partial(ebe_ops.element_kernel, tile_e=self.tile_e)

    def multispring_fn(self) -> Callable:
        from repro_torch.kernels.multispring import ops as ms_ops

        return functools.partial(ms_ops.update, tile_p=self.tile_p)

    def element_kernel_kset(self) -> Callable:
        from repro_torch.kernels.ebe_matvec import ops as ebe_ops

        return functools.partial(ebe_ops.element_kernel_kset, tile_e=self.tile_e)

    def multispring_kset_fn(self) -> Callable:
        from repro_torch.kernels.multispring import ops as ms_ops

        return functools.partial(ms_ops.update_kset, tile_p=self.tile_p)


def resolve(cfg, *, device=None) -> KernelBackend:
    """Resolve a :class:`~repro_torch.fem.methods.SeismicConfig`'s backend knobs
    for ``device`` (``None`` → the card).  Per kernel: the per-kernel override (``ebe_backend``/
    ``ms_backend``, "" = inherit) > the global ``backend``."""
    device = resolve_device(device)
    return KernelBackend(
        ebe=resolve_spec(cfg.ebe_backend or cfg.backend, device),
        multispring=resolve_spec(cfg.ms_backend or cfg.backend, device),
        tile_e=cfg.tile_e,
        tile_p=cfg.tile_p,
    )


def make_operators(mesh, cfg, *, device=None):
    """The production ``FemOperators`` constructor: resolve ``cfg``'s backend
    spec for ``device`` (``None`` → the card, see ``device.resolve_device``),
    wire the chosen kernels in, and attach the resolved
    :class:`KernelBackend` as ``ops.kernel_backend``."""
    from repro_torch.fem import methods

    device = resolve_device(device)
    kb = resolve(cfg, device=device)
    ops = methods.FemOperators(mesh, cfg, device=device, element_kernel=kb.element_kernel(),
                               multispring_fn=kb.multispring_fn(), element_kernel_kset=kb.element_kernel_kset(),
                               multispring_kset_fn=kb.multispring_kset_fn())
    ops.kernel_backend = kb
    return ops
