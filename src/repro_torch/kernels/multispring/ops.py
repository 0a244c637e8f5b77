"""Public entry of the multispring kernel: ``update`` → (σ, D, new_state, frac).

The kernel is chosen by the tensors' device: on a CPU tensor ``update`` runs
the plain version (``ref.multispring_ref``); on a CUDA tensor it launches
``csrc/multispring.cu`` (``multispring.multispring_cuda``) or raises.  There
is no fallback from one to the other.
"""
from __future__ import annotations

from repro_torch.kernels.multispring.multispring import TILE_P, counter, multispring_cuda
from repro_torch.kernels.multispring.ref import multispring_ref


def update(eps, state, params, n, w, *, tile_p: int = TILE_P):
    """(σ [P,6], D [P,6,6], new_state, frac [P]) for one constitutive update."""
    if eps.device.type == "cpu":
        return multispring_ref(eps, state, params, n, w)
    return multispring_cuda(eps, state, params, n, w, tile_p=tile_p)


__all__ = ["update", "multispring_cuda", "multispring_ref", "counter", "TILE_P"]
