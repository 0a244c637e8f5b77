"""Newmark-β (β=1/4) recurrences of the paper's Eq. (1).

    A δu = f^n − q^{n−1} + C v^{n−1} + M (a^{n−1} + 4/dt v^{n−1})
    A    = 4/dt² M + 2/dt C + K
    u^n  = u^{n−1} + δu
    v^n  = −v^{n−1} + 2/dt δu
    a^n  = −a^{n−1} − 4/dt v^{n−1} + 4/dt² δu

C = α M + Σ_e β_e K_e + diag(dashpot): Rayleigh damping from the current
hysteretic damping levels (α global, β_e element-wise) plus the Lysmer
absorbing dashpots.  q is the assembled internal force from the multi-spring
stresses.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.device import resolve_device


class NewmarkState(NamedTuple):
    u: torch.Tensor  # [N,3]
    v: torch.Tensor
    a: torch.Tensor
    q: torch.Tensor  # internal force [N,3]


def init_state(n_nodes: int, dtype=torch.float64, device=None) -> NewmarkState:
    """Zero state on ``device`` (``None`` → the card)."""
    z = torch.zeros((n_nodes, 3), dtype=dtype, device=resolve_device(device))
    return NewmarkState(u=z, v=z, a=z, q=z)


def rhs(state: NewmarkState, f_ext: torch.Tensor, mass: torch.Tensor, dt: float,
        cv_matvec: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    m = mass[:, None]
    return f_ext - state.q + cv_matvec(state.v) + m * (state.a + (4.0 / dt) * state.v)


def advance(state: NewmarkState, du: torch.Tensor, q_new: torch.Tensor, dt: float) -> NewmarkState:
    v_new = -state.v + (2.0 / dt) * du
    a_new = -state.a - (4.0 / dt) * state.v + (4.0 / dt**2) * du
    return NewmarkState(u=state.u + du, v=v_new, a=a_new, q=q_new)


def a_coefficients(dt: float, alpha):
    """(c_m, c_d): A = c_m·diag(m) + c_d·diag(dash) + Σ_e (1+2β_e/dt) K_e.

    c_m folds the mass term and the α-Rayleigh part of C (``alpha`` a float,
    or a tensor of one α a k-set lane); c_d is the dashpot's 2/dt factor.
    """
    return 4.0 / dt**2 + 2.0 * alpha / dt, 2.0 / dt
