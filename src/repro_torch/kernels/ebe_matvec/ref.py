"""Plain version of the EBE element product: ``repro_torch.fem.spmv``'s
``ebe_element_matvec`` (einsum over the on-the-fly physical gradients), and
its k-set form, one member after another."""
import torch

from repro_torch.fem.spmv import ebe_element_matvec as ebe_element_matvec_ref
from repro_torch.fem.spmv import gather_elem


def ebe_element_matvec_kset_ref(x, conn, D, Jinv, wdet, coef=None):
    """``f_e [k,E,10,3]`` for ``x [k,N,3]``, ``D [k,E,4,6,6]``, ``coef [k,E]``."""
    return torch.stack([ebe_element_matvec_ref(gather_elem(x[i], conn), D[i], Jinv, wdet,
                                               None if coef is None else coef[i])
                        for i in range(x.shape[0])])


__all__ = ["ebe_element_matvec_ref", "ebe_element_matvec_kset_ref"]
