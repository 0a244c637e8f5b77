"""Sparse products: matrix-free element-by-element (EBE), gather → element
product → deterministic scatter, and the stored BCSR 3×3 matrix of the CRS
rungs.

The paper's Proposed Method 2 replaces the stored-matrix SpMV with
on-the-fly element products (EBE, [8]): more flops, far less memory traffic,
no stored matrix.  The gather and the element product are one CUDA kernel
(``repro_torch.kernels.ebe_matvec``) on the card, and :func:`gather_elem`
+ :func:`ebe_element_matvec` (plain PyTorch) on the CPU.

The scatter-add is a gather through a precomputed slot table followed by a
sum over a fixed axis, never ``index_add_``/``scatter_add_``: their CUDA
atomics change the last bits from run to run, which would break the bitwise
contracts (serial ≡ prefetch, streamed ≡ resident).

Every function here also takes a k-set: fields with a leading member axis
(``x [k,N,3]``, ``D [k,E,4,6,6]``, BCSR ``values [k,nnzb,3,3]``) over the one
mesh, each member summed as it would be alone, in the same fixed order.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.fem import quadrature as quad
from repro_torch.fem.assembly import RUN_CHUNK, RunSlots, physical_gradients


def slot_table(ids: np.ndarray, n: int) -> np.ndarray:
    """``[n, maxdeg]`` positions of each target id in ``ids``, ascending.

    Row ``t`` lists every ``i`` with ``ids[i] == t`` in increasing ``i`` (the
    order of the stable sort the reference's sorted segment-sum uses); short
    rows are padded with ``len(ids)``, which callers point at a zero.
    """
    ids = np.asarray(ids).ravel()
    perm = np.argsort(ids, kind="stable")
    sorted_ids = ids[perm]
    counts = np.bincount(ids, minlength=n)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    col = np.arange(ids.size) - starts[sorted_ids]
    table = np.full((n, max(1, int(counts.max()))), ids.size, dtype=np.int64)
    table[sorted_ids, col] = perm
    return table


@dataclasses.dataclass(frozen=True)
class MeshMaps:
    """Device-resident index maps and geometry of a mesh, in one dtype.

    Built once per (mesh, dtype, device) so no matvec uploads or recasts
    anything: ``conn [E,10]`` for the gather, the same as int32 in
    ``conn32`` for the EBE kernel (which gathers itself), ``dof_slots [ndof,maxdeg]``
    into ``f_e.flatten()`` and ``node_slots [N,maxdeg]`` into
    ``conn.flatten()`` for the deterministic scatters, and ``Jinv``/``wdet``.
    """

    conn: torch.Tensor
    conn32: torch.Tensor
    dof_slots: torch.Tensor
    node_slots: torch.Tensor
    Jinv: torch.Tensor
    wdet: torch.Tensor

    @staticmethod
    def from_mesh(mesh, dtype: torch.dtype, device) -> "MeshMaps":
        def idx(a):
            return torch.as_tensor(a, dtype=torch.long, device=device)

        return MeshMaps(
            conn=idx(mesh.conn),
            conn32=torch.as_tensor(mesh.conn, dtype=torch.int32, device=device),
            dof_slots=idx(slot_table(mesh.elem_dofs, mesh.ndof)),
            node_slots=idx(slot_table(mesh.conn, mesh.n_nodes)),
            Jinv=torch.as_tensor(mesh.Jinv, dtype=dtype, device=device),
            wdet=torch.as_tensor(mesh.wdet, dtype=dtype, device=device),
        )

    def astype(self, dtype: torch.dtype) -> "MeshMaps":
        """The same maps with the geometry in ``dtype`` (index maps shared)."""
        return dataclasses.replace(self, Jinv=self.Jinv.to(dtype), wdet=self.wdet.to(dtype))

    @property
    def n_elem(self) -> int:
        return self.conn.shape[0]


@dataclasses.dataclass(frozen=True)
class BcsrMaps:
    """Device-resident maps of a mesh's BCSR 3×3 matrix (the CRS rungs).

    ``col_idx [nnzb]`` for the gather of x, ``row_lengths [N]`` (blocks per
    row; the rows are contiguous runs of blocks) for the row sum,
    ``diag_slots [N]``, and ``entry_slots`` (:class:`RunSlots`) from element
    blocks to BCSR blocks.  Padded elements (``mesh.npad``, all mapped to
    block 0 with zero stiffness) are left out of ``entry_slots``: they add
    exact zeros in the reference.  Built once per mesh and device, and only
    by the CRS rungs: Proposed 2 never holds them.
    """

    col_idx: torch.Tensor
    row_lengths: torch.Tensor
    diag_slots: torch.Tensor
    entry_slots: RunSlots

    @staticmethod
    def from_mesh(mesh, device, chunk: int = RUN_CHUNK) -> "BcsrMaps":
        def idx(a):
            return torch.as_tensor(a, dtype=torch.long, device=device)

        nnzb = mesh.col_idx.shape[0]
        real = mesh.entry_map[:mesh.n_elem - mesh.npad]
        return BcsrMaps(
            col_idx=idx(mesh.col_idx),
            row_lengths=idx(np.diff(mesh.row_ptr)),
            diag_slots=idx(mesh.diag_slots),
            entry_slots=RunSlots.build(real, nnzb, device, chunk),
        )

    @property
    def nnzb(self) -> int:
        return self.col_idx.shape[0]


def bcsr_matvec(values: torch.Tensor, maps: BcsrMaps, x: torch.Tensor) -> torch.Tensor:
    """``y [N,3]``, ``y_i = Σ_j A_ij x_j`` over the 3×3 blocks ``values
    [nnzb,3,3]``: the gather ``x[col_idx]``, the block products (a product
    and a sum over 3: ``einsum`` would go through a batched GEMM of 3×3
    matrices, far slower on the card, ``PERF.md``), then each row's sum by
    ``torch.segment_reduce`` over the row lengths, in a fixed order per row
    (no atomics).  A k-set (``values [k,nnzb,3,3]``, ``x [k,N,3]``) sums
    each member's rows in the same order."""
    if values.dim() == 3:
        prod = (values * x[maps.col_idx][:, None, :]).sum(-1)
        return torch.segment_reduce(prod, "sum", lengths=maps.row_lengths)
    prod = (values * x[:, maps.col_idx, None, :]).sum(-1)  # [k,nnzb,3]
    y = torch.segment_reduce(prod.movedim(0, 1).contiguous(), "sum", lengths=maps.row_lengths)
    return y.movedim(1, 0)


def gather_elem(u: torch.Tensor, conn: torch.Tensor) -> torch.Tensor:
    """Nodal values per element ``[...,E,10,3]`` from ``u [...,N,3]``."""
    return u[..., conn, :]


def segment_sum(values: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """``out[t] = Σ_k values[slots[t,k]]`` over the leading axis of ``values``
    (padding slots read an appended zero): a deterministic segment-sum."""
    flat = values.reshape(values.shape[0], -1)
    padded = F.pad(flat, (0, 0, 0, 1))
    out = padded[slots].sum(dim=1)
    return out.reshape((slots.shape[0],) + values.shape[1:])


def scatter_add(f_e: torch.Tensor, dof_slots: torch.Tensor) -> torch.Tensor:
    """Σ per dof of element vectors ``f_e [E,10,3]`` → ``[N,3]``; a k-set
    ``[k,E,10,3]`` → ``[k,N,3]`` takes each member's slots along its last axis."""
    if f_e.dim() == 3:
        return segment_sum(f_e.reshape(-1), dof_slots).reshape(-1, 3)
    lead = f_e.shape[:-3]
    flat = F.pad(f_e.reshape(*lead, -1), (0, 1))  # padding slots read the appended zero
    return flat[..., dof_slots].sum(-1).reshape(*lead, -1, 3)


def elem_strain(u_e: torch.Tensor, Jinv: torch.Tensor) -> torch.Tensor:
    """Voigt strain at Gauss points ``[...,E,P,6]`` from ``u_e [...,E,10,3]``.

    ε = sym(∇u); engineering shear (γ = 2ε_offdiag) to match B-matrices.
    """
    g = physical_gradients(Jinv)                      # [E,P,10,3]
    H = torch.einsum("epnj,...eni->...epij", g, u_e)  # ∂u_i/∂x_j
    return torch.stack(
        [H[..., 0, 0], H[..., 1, 1], H[..., 2, 2],
         H[..., 0, 1] + H[..., 1, 0], H[..., 1, 2] + H[..., 2, 1], H[..., 2, 0] + H[..., 0, 2]],
        dim=-1,
    )


def elem_internal_force(sigma: torch.Tensor, Jinv: torch.Tensor, wdet: torch.Tensor) -> torch.Tensor:
    """f_e ``[...,E,10,3]`` = Σ_p wdet_p B_pᵀ σ_p, via the ∇N contraction."""
    g = physical_gradients(Jinv)        # [E,P,10,3]
    s = sigma * wdet[..., None]         # fold weights
    sxx, syy, szz, sxy, syz, szx = (s[..., k] for k in range(6))
    gx, gy, gz = g[..., 0], g[..., 1], g[..., 2]

    def c(ga, sa):
        return torch.einsum("epn,...ep->...en", ga, sa)

    fx = c(gx, sxx) + c(gy, sxy) + c(gz, szx)
    fy = c(gx, sxy) + c(gy, syy) + c(gz, syz)
    fz = c(gx, szx) + c(gy, syz) + c(gz, szz)
    return torch.stack([fx, fy, fz], dim=-1)


def ebe_element_matvec(u_e, D, Jinv, wdet, coef_e=None):
    """K_e u_e without forming K_e: ε → Dε → Bᵀ (plain version of the kernel)."""
    eps = elem_strain(u_e, Jinv)                       # [E,P,6]
    sig = torch.einsum("epab,epb->epa", D, eps)        # [E,P,6]
    w = wdet if coef_e is None else wdet * coef_e[:, None]
    return elem_internal_force(sig, Jinv, w)


def ebe_matvec(x: torch.Tensor, D: torch.Tensor, maps: MeshMaps, coef_e=None,
               element_kernel=None) -> torch.Tensor:
    """Full matrix-free K·x ``[N,3]`` (gather → element product → scatter).

    ``maps`` must hold its geometry in ``x.dtype`` (see :meth:`MeshMaps.astype`).
    The element product defaults to the kernel wrapper (its k-set entry for
    ``x [k,N,3]``), which picks the CUDA kernel (the gather fused in) or
    ``gather_elem`` + the plain version by ``x``'s device; it is called as
    ``element_kernel(x, conn32, D, Jinv, wdet, coef)``.
    """
    if element_kernel is None:
        from repro_torch.kernels.ebe_matvec import ops

        element_kernel = ops.element_kernel if x.dim() == 2 else ops.element_kernel_kset
    f_e = element_kernel(x, maps.conn32, D, maps.Jinv, maps.wdet, coef_e)
    return scatter_add(f_e, maps.dof_slots)


def strain_at_points(u: torch.Tensor, maps: MeshMaps) -> torch.Tensor:
    """Total strain at all evaluation points ``[...,E*P, 6]`` (multispring input)."""
    eps = elem_strain(gather_elem(u, maps.conn), maps.Jinv)
    return eps.flatten(-3, -2)


def internal_force(sigma_pts: torch.Tensor, maps: MeshMaps) -> torch.Tensor:
    """Assembled internal force q ``[...,N,3]`` from point stresses ``[...,E*P,6]``."""
    sig = sigma_pts.unflatten(-2, (maps.n_elem, quad.NPOINT))
    return scatter_add(elem_internal_force(sig, maps.Jinv, maps.wdet), maps.dof_slots)
