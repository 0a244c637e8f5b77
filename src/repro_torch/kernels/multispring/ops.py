"""Public entry of the multispring kernel: ``update`` → (σ, D, new_state, frac).

The kernel is chosen by the tensors' device: on a CPU tensor ``update`` runs
the plain version (``ref.multispring_ref``); on a CUDA tensor it launches
``csrc/multispring.cu`` (``multispring.multispring_cuda``) or raises.  There
is no fallback from one to the other.  ``update_kset`` is the same for ``k``
members sharing the material parameters, in one launch.
"""
from __future__ import annotations

from repro_torch.kernels.multispring.multispring import (TILE_P, counter, counter_kset, kset_size,
                                                         multispring_cuda, multispring_kset_cuda)
from repro_torch.kernels.multispring.ref import multispring_kset_ref, multispring_ref


def update(eps, state, params, n, w, *, tile_p: int = TILE_P):
    """(σ [P,6], D [P,6,6], new_state, frac [P]) for one constitutive update."""
    if eps.device.type == "cpu":
        return multispring_ref(eps, state, params, n, w)
    return multispring_cuda(eps, state, params, n, w, tile_p=tile_p)


def update_kset(eps, state, params, n, w, *, tile_p: int = TILE_P):
    """(σ [k,P,6], D [k,P,6,6], new_state [k,P,S], frac [k,P]) for ``k`` members."""
    kset_size(eps, state)
    if eps.device.type == "cpu":
        return multispring_kset_ref(eps, state, params, n, w)
    return multispring_kset_cuda(eps, state, params, n, w, tile_p=tile_p)


__all__ = ["update", "update_kset", "multispring_cuda", "multispring_kset_cuda", "multispring_ref",
           "multispring_kset_ref", "counter", "counter_kset", "TILE_P"]
