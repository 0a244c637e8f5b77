"""Multi-spring constitutive model (Iai 1993) with modified Ramberg–Osgood
backbone + Masing hysteresis — the memory-capacity-bound part of the paper.

Per material evaluation point, ``NSPRING`` 1-D nonlinear springs in fixed
strain-space directions carry the deviatoric response; an elastic bulk term
carries the volumetric response.  State per spring is exactly the paper's
40 bytes: 4 doubles (γ_rev, τ_rev, γ_prev, γ_max) + 2 int32 flags
(loading direction, on-virgin-backbone).  With 150 springs × 4 evaluation
points that is 24 KB/element — the array the heterogeneous memory manager
keeps in host memory and streams (Algorithm 3).

Directions follow Iai's multiple-mechanism form, 3 shear-plane families ×
``nang`` angles: mechanism θ on plane (i,j) senses
γ(θ) = (ε_ii − ε_jj)·cosθ + γ_ij·sinθ.

This module is the plain torch oracle; ``repro_torch.kernels.multispring``
holds the CUDA kernel that is held against it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

NSPRING_DEFAULT = 150
STATE_KEYS = ("gamma_rev", "tau_rev", "gamma_prev", "gamma_max", "direction", "virgin")
FLAG_KEYS = ("direction", "virgin")


def spring_directions(nspring: int = NSPRING_DEFAULT) -> tuple[np.ndarray, np.ndarray]:
    """Direction Voigt vectors ``n [S,6]`` and weights ``w [S]`` (numpy).

    Weights are normalized per plane family so the small-strain response to
    pure shear γ_ij recovers G0 exactly:  Σ_k w_k sin²θ_k = 1.
    Voigt order: xx yy zz xy yz zx (engineering shear).
    """
    if nspring % 3:
        raise ValueError(f"nspring={nspring} must be divisible by the 3 shear planes")
    nang = nspring // 3
    theta = (np.arange(nang) + 0.5) * np.pi / nang
    planes = [((0, 1), 3), ((1, 2), 4), ((2, 0), 5)]  # (normal pair, shear slot)
    n = np.zeros((nspring, 6))
    for f, ((i, j), s) in enumerate(planes):
        rows = slice(f * nang, (f + 1) * nang)
        n[rows, i] = np.cos(theta)
        n[rows, j] = -np.cos(theta)
        n[rows, s] = np.sin(theta)
    w = np.full((nspring,), 2.0 / nang)  # Σ w sin² = 1 per family
    return n, w


@dataclasses.dataclass(frozen=True)
class SpringParams:
    """Per-evaluation-point material constants (``[P]`` tensors)."""

    G0: torch.Tensor       # small-strain shear modulus
    gamma_r: torch.Tensor  # reference strain
    beta: torch.Tensor     # backbone exponent
    bulk: torch.Tensor     # elastic bulk modulus
    g_min_frac: float = 1e-3  # tangent floor (fraction of G0), keeps D PSD

    def slice(self, s: slice) -> "SpringParams":
        return SpringParams(self.G0[s], self.gamma_r[s], self.beta[s], self.bulk[s],
                            self.g_min_frac)


def init_state(n_points: int, nspring: int = NSPRING_DEFAULT, dtype=torch.float64,
               device="cpu", pin_memory: bool = False) -> dict[str, torch.Tensor]:
    """Fresh (virgin) spring state for ``n_points`` evaluation points."""
    def full(value, dt):
        x = torch.empty((n_points, nspring), dtype=dt, device=device, pin_memory=pin_memory)
        return x.fill_(value)

    state = {k: full(0, dtype) for k in STATE_KEYS[:4]}
    state["direction"] = full(0, torch.int32)
    state["virgin"] = full(1, torch.int32)
    return state


def state_bytes_per_spring(state: dict[str, torch.Tensor]) -> int:
    return sum(v.element_size() for v in state.values())  # 4*8 + 2*4 = 40 in fp64


def _backbone(gamma, G0, gamma_r, beta):
    """Modified R-O-type backbone τ(γ) = G0 γ / (1 + |γ/γr|^β)."""
    x = torch.abs(gamma) / gamma_r
    return G0 * gamma / (1.0 + x**beta)


def _backbone_tangent(gamma, G0, gamma_r, beta):
    """dτ/dγ of the backbone (analytic)."""
    x = torch.abs(gamma) / gamma_r
    den = 1.0 + x**beta
    return G0 * (1.0 + (1.0 - beta) * x**beta) / (den * den)


def update(eps: torch.Tensor, state: dict[str, torch.Tensor], params: SpringParams,
           n: torch.Tensor, w: torch.Tensor):
    """One constitutive update: (σ [P,6], D_tan [P,6,6], new state).

    Per spring, fully predicated:
      1. detect reversal (direction change) → new Masing branch anchored at
         the previous point,
      2. virgin (|γ| ≥ γ_max) → backbone, else Masing curve
         τ = τ_rev + 2 f((γ−γ_rev)/2),
      3. tangent = branch derivative, floored at g_min_frac·G0.
    """
    G0 = params.G0[:, None]
    gr = params.gamma_r[:, None]
    be = params.beta[:, None]

    gamma = eps @ n.T  # [P,S]
    g_prev = state["gamma_prev"]
    moving = torch.sign(gamma - g_prev).to(torch.int32)
    dir_old = state["direction"]
    # previous branch stress at γ_prev (needed as the new reversal anchor)
    tau_prev_virgin = _backbone(g_prev, G0, gr, be)
    tau_prev_masing = state["tau_rev"] + 2.0 * _backbone(
        0.5 * (g_prev - state["gamma_rev"]), G0, gr, be
    )
    virgin_old = state["virgin"] == 1
    tau_prev = torch.where(virgin_old, tau_prev_virgin, tau_prev_masing)

    reversal = (moving != 0) & (dir_old != 0) & (moving != dir_old)
    gamma_rev = torch.where(reversal, g_prev, state["gamma_rev"])
    tau_rev = torch.where(reversal, tau_prev, state["tau_rev"])
    direction = torch.where(moving != 0, moving, dir_old)
    virgin = torch.where(reversal, torch.zeros_like(dir_old), state["virgin"])

    # rejoin the backbone when exceeding historic maximum strain
    gmax = state["gamma_max"]
    rejoin = torch.abs(gamma) >= gmax
    virgin = torch.where(rejoin, torch.ones_like(virgin), virgin)
    gamma_max = torch.maximum(gmax, torch.abs(gamma))

    on_bb = virgin == 1
    tau_bb = _backbone(gamma, G0, gr, be)
    tau_ms = tau_rev + 2.0 * _backbone(0.5 * (gamma - gamma_rev), G0, gr, be)
    tau = torch.where(on_bb, tau_bb, tau_ms)
    gt_bb = _backbone_tangent(gamma, G0, gr, be)
    gt_ms = _backbone_tangent(0.5 * (gamma - gamma_rev), G0, gr, be)
    g_tan = torch.where(on_bb, gt_bb, gt_ms)
    g_tan = torch.maximum(g_tan, params.g_min_frac * G0)

    # assemble stress and consistent tangent
    P, S = gamma.shape
    sigma_dev = (tau * w[None, :]) @ n                        # [P,6]
    nn = (n[:, :, None] * n[:, None, :]).reshape(S, 36)       # [S,36]
    D_dev = ((g_tan * w[None, :]) @ nn).reshape(P, 6, 6)

    vol_eps = eps[:, :3].sum(dim=1)
    one = torch.tensor([1.0, 1.0, 1.0, 0.0, 0.0, 0.0], dtype=eps.dtype, device=eps.device)
    sigma = sigma_dev + params.bulk[:, None] * vol_eps[:, None] * one[None, :]
    D = D_dev + params.bulk[:, None, None] * (one[:, None] * one[None, :])[None]

    new_state = {
        "gamma_rev": gamma_rev,
        "tau_rev": tau_rev,
        "gamma_prev": gamma,
        "gamma_max": gamma_max,
        "direction": direction,
        "virgin": virgin,
    }
    for k in FLAG_KEYS:
        assert new_state[k].dtype == torch.int32, (k, new_state[k].dtype)
    return sigma, D, new_state


def hysteretic_damping(state: dict[str, torch.Tensor], params: SpringParams) -> torch.Tensor:
    """Equivalent damping ratio h per evaluation point (drives Rayleigh C^n).

    Hardin–Drnevich style estimate from the secant-modulus degradation at
    the historic max strain: h = h_max·(1 − G_sec/G0); here h_max is folded
    by the caller (material table)."""
    gr = params.gamma_r[:, None]
    be = params.beta[:, None]
    x = (state["gamma_max"] / gr) ** be
    gsec_ratio = 1.0 / (1.0 + x)  # G_sec/G0 on the backbone
    return (1.0 - gsec_ratio).mean(dim=1)  # [P] in [0,1); caller scales by h_max


def material_params_for_mesh(mesh, dtype=torch.float64, device="cpu") -> SpringParams:
    """Broadcast the per-element material table to evaluation points [E*P]."""
    P = mesh.wdet.shape[1]

    def rep(attr):
        a = np.array([getattr(m, attr) for m in mesh.materials])[mesh.mat_id]
        return torch.as_tensor(np.repeat(a, P), dtype=dtype, device=device)

    return SpringParams(G0=rep("G0"), gamma_r=rep("gamma_r"), beta=rep("beta"), bulk=rep("bulk"))
