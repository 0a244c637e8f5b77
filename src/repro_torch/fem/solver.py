"""Conjugate-gradient solvers.

* :func:`pcg` — 3×3 block-Jacobi preconditioned CG (the paper's CRS-PCG).
* :func:`fcg` — flexible CG whose preconditioner is an *inner*, lower-
  precision, block-Jacobi-PCG solve (EBE-IPCG).  The inner solve runs in
  fp32 while the outer iteration keeps the solution precision; flexible
  (Polak–Ribière) β tolerates the inexact preconditioner.

The outer loops are Python loops that read the relative residual back from
the device to decide whether to go on: one host sync per outer iteration.
The inner preconditioner runs a fixed number of sweeps and never syncs.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class CGResult(NamedTuple):
    x: torch.Tensor
    iters: int
    relres: float
    converged: bool = True
    """``relres ≤ tol`` at loop exit.  False when the solve hit ``maxiter``
    still above tolerance or went non-finite (NaN compares False)."""


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b)


def _tiny(x: torch.Tensor) -> float:
    """Dtype-aware denominator guard: ``finfo.tiny`` (smallest normal) is
    representable in every float dtype, so an fp32 zero residual never
    divides by exactly zero."""
    return float(torch.finfo(x.dtype).tiny)


def _relres(r: torch.Tensor, bnorm: torch.Tensor) -> float:
    return float(torch.sqrt(_vdot(r, r)) / bnorm)  # host sync


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
    it = 0
    relres = _relres(r, bnorm)
    while relres > tol and it < maxiter:  # one host sync per iteration
        Ap = matvec(p)
        alpha = rz / (_vdot(p, Ap) + eps)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = _vdot(r, z)
        beta = rz_new / (rz + eps)
        p = z + beta * p
        rz = rz_new
        it += 1
        relres = _relres(r, bnorm)
    return CGResult(x=x, iters=it, relres=relres, converged=relres <= tol)


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
    it = 0
    relres = _relres(r, bnorm)
    while relres > tol and it < maxiter:  # one host sync per iteration
        Ap = matvec(p)
        alpha = _vdot(r, z) / (_vdot(p, Ap) + eps)
        x = x + alpha * p
        r_new = r - alpha * Ap
        z_new = inner_precond(r_new)
        # Polak–Ribière (flexible): β = z_new·(r_new − r) / z·r
        beta = _vdot(z_new, r_new - r) / (_vdot(z, r) + eps)
        p = z_new + beta * p
        r, z = r_new, z_new
        it += 1
        relres = _relres(r, bnorm)
    return CGResult(x=x, iters=it, relres=relres, converged=relres <= tol)


def make_inner_pcg_preconditioner(
    matvec32: Callable[[torch.Tensor], torch.Tensor],
    block_jacobi32: Callable[[torch.Tensor], torch.Tensor],
    *,
    inner_iters: int = 8,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Fixed-iteration fp32 block-Jacobi PCG as a preconditioner M⁻¹r.

    The paper's multigrid preconditioner [9] uses a cheap low-precision
    inner solve; here the same-level variant: ``inner_iters`` fp32 PCG
    sweeps.  The fixed count keeps it (almost) linear and free of host
    syncs; flexible outer CG absorbs the rest.
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
    """[N,3,3] inverted diagonal blocks → preconditioner on flat [N*3]."""

    def apply(r: torch.Tensor) -> torch.Tensor:
        z = torch.einsum("nab,nb->na", Minv.to(r.dtype), r.reshape(-1, 3))
        return z.reshape(r.shape)

    return apply
