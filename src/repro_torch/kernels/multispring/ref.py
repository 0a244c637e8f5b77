"""Plain version of the multispring kernel: the torch oracle of
``repro_torch.fem.multispring`` plus the damping fraction the kernel
returns, and its k-set form, one member after another."""
from __future__ import annotations

import torch

from repro_torch.fem import multispring as ms


def multispring_ref(eps, state, params, n, w):
    """(σ [P,6], D [P,6,6], new_state, frac [P]) in plain PyTorch."""
    sigma, D, new_state = ms.update(eps, state, params, n, w)
    return sigma, D, new_state, ms.hysteretic_damping(new_state, params)


def multispring_kset_ref(eps, state, params, n, w):
    """(σ [k,P,6], D [k,P,6,6], new_state [k,P,S], frac [k,P]) in plain PyTorch."""
    outs = [multispring_ref(eps[i], {key: v[i] for key, v in state.items()}, params, n, w)
            for i in range(eps.shape[0])]
    sigma, D, new, frac = zip(*outs)
    return (torch.stack(sigma), torch.stack(D), {key: torch.stack([s[key] for s in new]) for key in new[0]},
            torch.stack(frac))
