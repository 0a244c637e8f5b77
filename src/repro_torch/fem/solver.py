"""Conjugate-gradient solvers, for one right-hand side ``b [n]`` or a k-set
``b [k,n]`` (k independent systems, the paper's 2SET).

* :func:`pcg` — 3×3 block-Jacobi preconditioned CG (the paper's CRS-PCG).
* :func:`fcg` — flexible CG whose preconditioner is an *inner*, lower-
  precision, block-Jacobi-PCG solve (EBE-IPCG).  The inner solve runs in
  fp32 while the outer iteration keeps the solution precision; flexible
  (Polak–Ribière) β tolerates the inexact preconditioner.

The outer loops are Python loops that read the relative residual back from
the device to decide whether to go on: one host sync per outer iteration.
The inner preconditioner runs a fixed number of sweeps and never syncs.

A k-set solve takes every dot product per lane, over the last axis only:
nothing reduces across lanes.  A lane is live while ``relres > tol`` and
its iterations are below ``maxiter`` (NaN compares False, so a poisoned
lane stops at once); the loop runs while any lane is live, and a lane that
has stopped keeps its iterate, residual, direction and count exactly as
they were (a per-lane ``torch.where``).  That is what ``jax.vmap`` of the
reference's ``while_loop`` does, so each lane takes the iterations of its
system solved alone.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class CGResult(NamedTuple):
    x: torch.Tensor
    iters: int | torch.Tensor
    relres: float | torch.Tensor
    converged: bool | torch.Tensor = True
    """``relres ≤ tol`` at loop exit.  False when the solve hit ``maxiter``
    still above tolerance or went non-finite (NaN compares False).  For a
    k-set, ``iters``, ``relres`` and ``converged`` are CPU tensors ``[k]``."""


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-lane dot product over the last axis, kept as a ``[..., 1]`` axis."""
    return torch.sum(a * b, dim=-1, keepdim=True)


def _tiny(x: torch.Tensor) -> float:
    """Dtype-aware denominator guard: ``finfo.tiny`` (smallest normal) is
    representable in every float dtype, so an fp32 zero residual never
    divides by exactly zero."""
    return float(torch.finfo(x.dtype).tiny)


class _Lanes:
    """Loop control of a (k-set) outer CG: per-lane iterations and relres,
    read back once per iteration."""

    def __init__(self, r: torch.Tensor, bnorm: torch.Tensor, tol: float, maxiter: int):
        self.bnorm, self.tol, self.maxiter = bnorm, tol, maxiter
        self.kset = r.dim() > 1
        self.iters = [0] * (r.shape[0] if self.kset else 1)
        self.read(r)

    def read(self, r: torch.Tensor) -> None:
        self.relres = (torch.sqrt(_vdot(r, r)) / self.bnorm).reshape(-1).tolist()  # host sync
        self.live = [rel > self.tol and it < self.maxiter for rel, it in zip(self.relres, self.iters)]

    def keep(self, new: tuple, old: tuple) -> tuple:
        """``new`` on the live lanes, ``old`` on the others."""
        if all(self.live):
            return new
        mask = torch.tensor(self.live, device=new[0].device)[:, None]
        return tuple(torch.where(mask, n, o) for n, o in zip(new, old))

    def advance(self, r: torch.Tensor) -> None:
        self.iters = [it + live for it, live in zip(self.iters, self.live)]
        self.read(r)

    def result(self, x: torch.Tensor) -> CGResult:
        conv = [rel <= self.tol for rel in self.relres]
        if not self.kset:
            return CGResult(x=x, iters=self.iters[0], relres=self.relres[0], converged=conv[0])
        return CGResult(x=x, iters=torch.tensor(self.iters, dtype=torch.int32),
                        relres=torch.tensor(self.relres, dtype=torch.float64), converged=torch.tensor(conv))


def pcg(matvec: Callable[[torch.Tensor], torch.Tensor], b: torch.Tensor,
        precond: Callable[[torch.Tensor], torch.Tensor], *, tol: float = 1e-8,
        maxiter: int = 3000, x0: torch.Tensor | None = None) -> CGResult:
    """Standard PCG on ‖r‖/‖b‖ ≤ tol."""
    x = torch.zeros_like(b) if x0 is None else x0
    eps = _tiny(b)
    r = b - matvec(x)
    z = precond(r)
    p = z
    rz = _vdot(r, z)
    bnorm = torch.sqrt(_vdot(b, b)) + eps
    lanes = _Lanes(r, bnorm, tol, maxiter)
    while any(lanes.live):  # one host sync per iteration
        Ap = matvec(p)
        alpha = rz / (_vdot(p, Ap) + eps)
        x_new = x + alpha * p
        r_new = r - alpha * Ap
        z = precond(r_new)
        rz_new = _vdot(r_new, z)
        beta = rz_new / (rz + eps)
        x, r, p, rz = lanes.keep((x_new, r_new, z + beta * p, rz_new), (x, r, p, rz))
        lanes.advance(r)
    return lanes.result(x)


def fcg(matvec: Callable[[torch.Tensor], torch.Tensor], b: torch.Tensor,
        inner_precond: Callable[[torch.Tensor], torch.Tensor], *, tol: float = 1e-8,
        maxiter: int = 3000, x0: torch.Tensor | None = None) -> CGResult:
    """Flexible CG: β via Polak–Ribière so an inexact (iterative, mixed-
    precision) preconditioner is admissible."""
    x = torch.zeros_like(b) if x0 is None else x0
    eps = _tiny(b)
    r = b - matvec(x)
    z = inner_precond(r)
    p = z
    bnorm = torch.sqrt(_vdot(b, b)) + eps
    lanes = _Lanes(r, bnorm, tol, maxiter)
    while any(lanes.live):  # one host sync per iteration
        Ap = matvec(p)
        alpha = _vdot(r, z) / (_vdot(p, Ap) + eps)
        x_new = x + alpha * p
        r_new = r - alpha * Ap
        z_new = inner_precond(r_new)
        # Polak–Ribière (flexible): β = z_new·(r_new − r) / z·r
        beta = _vdot(z_new, r_new - r) / (_vdot(z, r) + eps)
        x, r, p, z = lanes.keep((x_new, r_new, z_new + beta * p, z_new), (x, r, p, z))
        lanes.advance(r)
    return lanes.result(x)


def make_inner_pcg_preconditioner(
    matvec32: Callable[[torch.Tensor], torch.Tensor],
    block_jacobi32: Callable[[torch.Tensor], torch.Tensor],
    *,
    inner_iters: int = 8,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Fixed-iteration fp32 block-Jacobi PCG as a preconditioner M⁻¹r.

    The paper's multigrid preconditioner [9] uses a cheap low-precision
    inner solve; here the same-level variant: ``inner_iters`` fp32 PCG
    sweeps, on every lane of a k-set.  The fixed count keeps it (almost)
    linear and free of host syncs; flexible outer CG absorbs the rest.
    """

    def apply(r: torch.Tensor) -> torch.Tensor:
        r32 = r.to(torch.float32)
        eps = _tiny(r32)
        x = torch.zeros_like(r32)
        rr = r32
        z = block_jacobi32(rr)
        p = z
        rz = _vdot(rr, z)
        for _ in range(inner_iters):
            Ap = matvec32(p)
            alpha = rz / (_vdot(p, Ap) + eps)
            x = x + alpha * p
            rr = rr - alpha * Ap
            z = block_jacobi32(rr)
            rz_new = _vdot(rr, z)
            beta = rz_new / (rz + eps)
            p = z + beta * p
            rz = rz_new
        return x.to(r.dtype)

    return apply


def block_jacobi_apply(Minv: torch.Tensor) -> Callable[[torch.Tensor], torch.Tensor]:
    """``[..., N,3,3]`` inverted diagonal blocks → preconditioner on flat ``[..., N*3]``."""

    def apply(r: torch.Tensor) -> torch.Tensor:
        z = torch.einsum("...nab,...nb->...na", Minv.to(r.dtype), r.unflatten(-1, (-1, 3)))
        return z.reshape(r.shape)

    return apply
