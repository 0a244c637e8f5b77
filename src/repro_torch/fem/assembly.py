"""Physical gradients, B-matrices, element stiffness, BCSR 3×3 assembly and
block Jacobi: the CRS rungs' ``UpdateCRS``.

The EBE path (``spmv``) never stores B or K_e.  The CRS rungs assemble K_e
into BCSR values every step, as a deterministic run sum (:func:`run_sum`):
no ``index_add_``/``scatter_add_``, whose CUDA atomics change the last bits
from run to run.  ``dense_assemble`` exists to verify both on small meshes.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

from repro_torch.fem import quadrature as quad

RUN_CHUNK = 1 << 21  # targets per chunk of run_sum (bounds its temporaries)


@dataclasses.dataclass(frozen=True)
class RunSlots:
    """Plan of a deterministic sum of many sources into ``n`` targets that
    each take a few (a BCSR block takes 2.55 element blocks on average, at
    most 24).

    A source's *rank* is its place among its target's sources, in ascending
    source order.  ``src``/``dst`` list every source and its target rank by
    rank (rank 0 of every target, in target order, then rank 1 of the
    targets that have one, …).  Targets go in chunks of ``chunk``:
    ``cuts[c, k]`` is where chunk ``c``'s sources of rank ``k`` start in
    ``src`` (a host array, so slicing never waits for the device)."""

    src: torch.Tensor
    dst: torch.Tensor
    cuts: np.ndarray  # [n_chunks + 1, n_ranks] int64
    n: int
    chunk: int

    @staticmethod
    def build(ids: np.ndarray, n: int, device, chunk: int = RUN_CHUNK) -> "RunSlots":
        """The plan for sources ``i`` with targets ``ids[i]``, every target in
        ``range(n)`` taking at least one."""
        ids = np.asarray(ids, dtype=np.int64).ravel()
        counts = np.bincount(ids, minlength=n)
        if counts.shape[0] != n or counts.min() < 1 or counts.max() >= 2**15:
            raise ValueError(f"every target in range({n}) needs between 1 and 2^15 - 1 sources")
        by_target = np.argsort(ids, kind="stable")
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        rank = (np.arange(ids.size) - starts[ids[by_target]]).astype(np.int16)
        order = by_target[np.argsort(rank, kind="stable")]  # rank-major, targets ascending
        dst = ids[order]
        level = np.concatenate([[0], np.cumsum(np.bincount(rank))])
        bounds = np.minimum(np.arange(0, n + chunk, chunk), n)  # chunk c is [bounds[c], bounds[c+1])
        cuts = np.stack([level[k] + np.searchsorted(dst[level[k]:level[k + 1]], bounds)
                         for k in range(level.size - 1)], axis=1)

        def idx(a):
            return torch.as_tensor(a, dtype=torch.long, device=device)

        return RunSlots(src=idx(order), dst=idx(dst), cuts=cuts, n=n, chunk=chunk)


def run_sum(values: Callable[[torch.Tensor], torch.Tensor], slots: RunSlots) -> torch.Tensor:
    """``out[t] = Σ values(sources of t)`` in ascending source order.

    ``values(src)`` returns the sources' values ``[len(src), …]``.  Each
    target starts from its rank-0 value and adds the next rank's value, one
    rank at a time, through an indexed write whose indices are unique: a
    fixed order of plain additions, the same on every device and for every
    ``chunk``, with no atomics."""
    cuts = slots.cuts
    n_chunks = cuts.shape[0] - 1
    out = None
    for c in range(n_chunks):
        t0 = c * slots.chunk
        acc = values(slots.src[cuts[c, 0]:cuts[c + 1, 0]])  # rank 0 of every target in the chunk
        for k in range(1, cuts.shape[1]):
            lo, hi = int(cuts[c, k]), int(cuts[c + 1, k])
            if lo == hi:  # no target of the chunk has more sources
                break
            t = slots.dst[lo:hi] - t0
            acc[t] = acc[t] + values(slots.src[lo:hi])
        if n_chunks == 1:
            return acc
        if out is None:
            out = acc.new_empty((slots.n, *acc.shape[1:]))
        out[t0:t0 + acc.shape[0]] = acc
    return out


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


def element_stiffness(D: torch.Tensor, Jinv: torch.Tensor, wdet: torch.Tensor,
                      chunk: int | None = None) -> torch.Tensor:
    """K_e ``[E,30,30]`` = Σ_p wdet_p Bᵖᵀ Dᵖ Bᵖ  (paper Eq. 2).

    With ``chunk``, B is built for ``chunk`` elements at a time, so the
    temporaries stay bounded (the whole ``[E,P,6,30]`` B is 1.7 GB in fp64
    at 294,912 elements, the whole einsum ``[E,P,30,30]`` 8.5 GB)."""
    E = D.shape[0]
    if chunk is None or chunk >= E:
        B = b_matrices(Jinv)
        DB = torch.einsum("epkl,eplj->epkj", D, B)
        return torch.einsum("ep,epki,epkj->eij", wdet, B, DB)
    out = torch.empty((E, quad.NDOF, quad.NDOF), dtype=D.dtype, device=D.device)
    for s in range(0, E, chunk):
        sl = slice(s, min(s + chunk, E))
        out[sl] = element_stiffness(D[sl], Jinv[sl], wdet[sl])
    return out


def assemble_bcsr(K_e: torch.Tensor, entry_slots: RunSlots, coef: torch.Tensor | None = None) -> torch.Tensor:
    """Element stiffness ``[E,30,30]`` (times ``coef [E]`` per element) summed
    into BCSR 3×3 ``values [nnzb,3,3]``: the paper's ``UpdateCRS``, run every
    step because the multi-spring D changes, and the cost Proposed 2 removes.

    ``entry_slots`` (``BcsrMaps.entry_slots``) lists every element block
    ``(e, a, b)`` by its position ``100e + 10a + b``; each BCSR block sums
    its element blocks in ascending element order.  The product by ``coef``
    is the reference's ``K_e * coef``, taken on each block as it is read."""
    E = K_e.shape[0]
    blocks = K_e.view(E, quad.NNODE, 3, quad.NNODE, 3).permute(0, 1, 3, 2, 4)  # [E,10,10,3,3] view

    def values(pos):
        e, ab = pos // (quad.NNODE * quad.NNODE), pos % (quad.NNODE * quad.NNODE)
        v = blocks[e, ab // quad.NNODE, ab % quad.NNODE]
        return v if coef is None else v * coef[e][:, None, None]

    return run_sum(values, entry_slots)


def add_diag(values: torch.Tensor, diag_slots: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """``values`` with the per-node 3-vector ``d [N,3]`` added onto the
    diagonal blocks (a new tensor; the slots are unique, so the indexed
    write is deterministic)."""
    eye = torch.eye(3, dtype=values.dtype, device=values.device)
    return values.index_put((diag_slots,), values[diag_slots] + d[:, :, None] * eye[None])


def block_jacobi_inverse(values: torch.Tensor, diag_slots: torch.Tensor) -> torch.Tensor:
    """Inverted 3×3 diagonal blocks ``[N,3,3]`` (the paper's preconditioner)."""
    eye = torch.eye(3, dtype=values.dtype, device=values.device)
    return torch.linalg.inv(values[diag_slots] + 1e-30 * eye[None])


def dense_assemble(K_e: torch.Tensor, elem_dofs, ndof: int) -> torch.Tensor:
    """Dense assembly for small verification problems only (CPU)."""
    idx = torch.as_tensor(elem_dofs, dtype=torch.long, device=K_e.device)  # [E,30]
    rows = idx[:, :, None].expand(-1, -1, quad.NDOF)
    cols = idx[:, None, :].expand(-1, quad.NDOF, -1)
    A = torch.zeros((ndof, ndof), dtype=K_e.dtype, device=K_e.device)
    return A.index_put_((rows, cols), K_e, accumulate=True)
