"""Binding of ``csrc/multispring.cu`` (ctypes, plain C interface).

Launches on the tensors' device (made the thread's current one for the
launch) and on that device's current stream; outputs are allocated here with
``torch.empty``; every argument is checked before its pointer is passed.
The k-set launches (k members' points in one launch) are counted apart
from the one-member ones.
"""
from __future__ import annotations

import torch

from repro_torch.fem.multispring import FLAG_KEYS, STATE_KEYS, SpringParams
from repro_torch.kernels import LaunchCounter, check_arg, on_device

TILE_P = 4  # evaluation points (one warp each) per CUDA block
TILE_P_RANGE = (1, 8)  # the kernel's launch bound: 256 threads
counter = LaunchCounter("multispring")
counter_kset = LaunchCounter("multispring_kset")


def check_tile_p(tile_p: int) -> None:
    lo, hi = TILE_P_RANGE
    if not lo <= tile_p <= hi:
        raise ValueError(f"multispring: tile_p={tile_p} must be in [{lo}, {hi}]")


def _check(name, x, shape, dtype, device):
    check_arg("multispring", name, x, shape, dtype, device)


def kset_size(eps: torch.Tensor, state: dict[str, torch.Tensor]) -> int:
    """``k`` of a k-set call: ``eps [k,P,6]`` and every state leaf ``[k,P,S]``
    must carry the same leading member axis."""
    if eps.dim() != 3:
        raise ValueError(f"multispring (k-set): eps must be [k,P,6], got {tuple(eps.shape)}")
    k = eps.shape[0]
    for key in STATE_KEYS:
        if state[key].dim() != 3 or state[key].shape[0] != k:
            raise ValueError(f"multispring (k-set): {key} must be [k={k},P,S], got {tuple(state[key].shape)}")
    return k


def _launch(eps, state, params, n, w, tile_p, k):
    """Check and launch for ``k`` members (``None``: one, without the axis)."""
    dt, dev = eps.dtype, eps.device
    if dt not in (torch.float32, torch.float64):
        raise ValueError(f"multispring: dtype {dt} not supported (float32, float64)")
    P, S = state["gamma_rev"].shape[-2:]
    lead = () if k is None else (k,)
    _check("eps", eps, (*lead, P, 6), dt, dev)
    for key in STATE_KEYS:
        _check(key, state[key], (*lead, P, S), torch.int32 if key in FLAG_KEYS else dt, dev)
    for key in ("G0", "gamma_r", "beta", "bulk"):
        _check(key, getattr(params, key), (P,), dt, dev)
    _check("n", n, (S, 6), dt, dev)
    _check("w", w, (S,), dt, dev)
    check_tile_p(tile_p)
    if dev.type != "cuda":
        raise ValueError(f"multispring: the CUDA kernel needs CUDA tensors, got {dev}")

    from repro_torch.kernels import _build

    sig = torch.empty((*lead, P, 6), dtype=dt, device=dev)
    D = torch.empty((*lead, P, 6, 6), dtype=dt, device=dev)
    frac = torch.empty((*lead, P), dtype=dt, device=dev)
    new = {key: torch.empty_like(state[key]) for key in STATE_KEYS}
    fn = getattr(_build.library(), "ms_update_" + ("f64" if dt == torch.float64 else "f32"))
    with on_device(dev):
        err = fn(
            eps.data_ptr(), *(state[key].data_ptr() for key in STATE_KEYS),
            params.G0.data_ptr(), params.gamma_r.data_ptr(), params.beta.data_ptr(),
            params.bulk.data_ptr(), n.data_ptr(), w.data_ptr(), float(params.g_min_frac),
            P, S, 1 if k is None else k, tile_p, sig.data_ptr(), D.data_ptr(), frac.data_ptr(),
            *(new[key].data_ptr() for key in STATE_KEYS),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, "multispring")
    (counter if k is None else counter_kset).add()
    return sig, D, new, frac


def multispring_cuda(eps: torch.Tensor, state: dict[str, torch.Tensor], params: SpringParams,
                     n: torch.Tensor, w: torch.Tensor, *, tile_p: int = TILE_P):
    """(σ [P,6], D [P,6,6], new_state, frac [P]) from the CUDA kernel."""
    return _launch(eps, state, params, n, w, tile_p, None)


def multispring_kset_cuda(eps: torch.Tensor, state: dict[str, torch.Tensor], params: SpringParams,
                          n: torch.Tensor, w: torch.Tensor, *, tile_p: int = TILE_P):
    """(σ [k,P,6], D [k,P,6,6], new_state [k,P,S], frac [k,P]) for ``k``
    members in one launch over k × P points; ``params [P]`` shared."""
    return _launch(eps, state, params, n, w, tile_p, kset_size(eps, state))
