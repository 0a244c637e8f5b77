"""Public entry of the EBE element kernel, in ``spmv.ebe_matvec``'s
``element_kernel`` calling convention.

The kernel is chosen by the tensors' device: on a CPU tensor
``element_kernel`` runs the plain version (``ref.ebe_element_matvec_ref``);
on a CUDA tensor it launches ``csrc/ebe_matvec.cu`` or raises.  There is no
fallback from one to the other.
"""
from __future__ import annotations

from repro_torch.kernels.ebe_matvec.ebe_matvec import (
    TILE_E,
    counter_f32,
    counter_f64,
    ebe_element_matvec_cuda,
)
from repro_torch.kernels.ebe_matvec.ref import ebe_element_matvec_ref


def element_kernel(u_e, D, Jinv, wdet, coef=None, *, tile_e: int = TILE_E):
    """``f_e [E,10,3]`` for the element product."""
    if u_e.device.type == "cpu":
        return ebe_element_matvec_ref(u_e, D, Jinv, wdet, coef)
    return ebe_element_matvec_cuda(u_e, D, Jinv, wdet, coef, tile_e=tile_e)


__all__ = ["element_kernel", "ebe_element_matvec_cuda", "ebe_element_matvec_ref",
           "counter_f32", "counter_f64", "TILE_E"]
