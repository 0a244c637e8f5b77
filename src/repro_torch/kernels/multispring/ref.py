"""Plain version of the multispring kernel: the torch oracle of
``repro_torch.fem.multispring`` plus the damping fraction the kernel returns."""
from __future__ import annotations

from repro_torch.fem import multispring as ms


def multispring_ref(eps, state, params, n, w):
    """(σ [P,6], D [P,6,6], new_state, frac [P]) in plain PyTorch."""
    sigma, D, new_state = ms.update(eps, state, params, n, w)
    return sigma, D, new_state, ms.hysteretic_damping(new_state, params)
