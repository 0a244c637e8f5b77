"""Public entry of the EBE element kernel, in ``spmv.ebe_matvec``'s
``element_kernel`` calling convention: ``(x, conn, D, Jinv, wdet, coef)``.

The kernel is chosen by the tensors' device: on a CPU tensor
``element_kernel`` gathers ``x[conn]`` and runs the plain version
(``ref.ebe_element_matvec_ref``); on a CUDA tensor it launches
``csrc/ebe_matvec.cu``, which reads ``x`` through ``conn`` itself, or
raises.  There is no fallback from one to the other.
"""
from __future__ import annotations

from repro_torch.fem.spmv import gather_elem
from repro_torch.kernels.ebe_matvec.ebe_matvec import TILE_E, counter_f32, counter_f64, ebe_matvec_cuda
from repro_torch.kernels.ebe_matvec.ref import ebe_element_matvec_ref


def element_kernel(x, conn, D, Jinv, wdet, coef=None, *, tile_e: int = TILE_E):
    """``f_e [E,10,3]`` = K_e·x[conn_e] for every element."""
    if x.device.type == "cpu":
        return ebe_element_matvec_ref(gather_elem(x, conn), D, Jinv, wdet, coef)
    return ebe_matvec_cuda(x, conn, D, Jinv, wdet, coef, tile_e=tile_e)


__all__ = ["element_kernel", "ebe_matvec_cuda", "ebe_element_matvec_ref", "counter_f32", "counter_f64",
           "TILE_E"]
