"""Physical gradients, B-matrices, element stiffness and dense assembly.

The EBE path (``spmv``) never stores B or K_e; ``element_stiffness`` and
``dense_assemble`` exist to verify it on small meshes.  BCSR assembly (the
CRS rungs) is not ported yet.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.fem import quadrature as quad


@functools.lru_cache(maxsize=None)
def gradn_ref(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``quad.GRADN_REF [P,10,3]`` on ``device`` in ``dtype``, uploaded once."""
    return torch.as_tensor(quad.GRADN_REF, dtype=dtype, device=device)


def physical_gradients(Jinv: torch.Tensor) -> torch.Tensor:
    """∇_x N at Gauss points ``[E,P,10,3]`` (on the fly from J⁻¹)."""
    return torch.einsum("pnk,ekj->epnj", gradn_ref(Jinv.dtype, Jinv.device), Jinv)


def b_matrices(Jinv: torch.Tensor) -> torch.Tensor:
    """Voigt B ``[E,P,6,30]`` built on the fly (engineering shear rows)."""
    g = physical_gradients(Jinv)  # [E,P,10,3]
    E, P = g.shape[:2]
    gx, gy, gz = g[..., 0], g[..., 1], g[..., 2]
    z = torch.zeros_like(gx)
    rows = [
        torch.stack([gx, z, z], -1),
        torch.stack([z, gy, z], -1),
        torch.stack([z, z, gz], -1),
        torch.stack([gy, gx, z], -1),
        torch.stack([z, gz, gy], -1),
        torch.stack([gz, z, gx], -1),
    ]
    return torch.stack(rows, dim=2).reshape(E, P, 6, quad.NDOF)


def element_stiffness(D: torch.Tensor, Jinv: torch.Tensor, wdet: torch.Tensor) -> torch.Tensor:
    """K_e ``[E,30,30]`` = Σ_p wdet_p Bᵖᵀ Dᵖ Bᵖ  (paper Eq. 2)."""
    B = b_matrices(Jinv)
    DB = torch.einsum("epkl,eplj->epkj", D, B)
    return torch.einsum("ep,epki,epkj->eij", wdet, B, DB)


def dense_assemble(K_e: torch.Tensor, elem_dofs, ndof: int) -> torch.Tensor:
    """Dense assembly for small verification problems only (CPU)."""
    idx = torch.as_tensor(elem_dofs, dtype=torch.long, device=K_e.device)  # [E,30]
    rows = idx[:, :, None].expand(-1, -1, quad.NDOF)
    cols = idx[:, None, :].expand(-1, quad.NDOF, -1)
    A = torch.zeros((ndof, ndof), dtype=K_e.dtype, device=K_e.device)
    return A.index_put_((rows, cols), K_e, accumulate=True)
