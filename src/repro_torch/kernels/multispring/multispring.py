"""Binding of ``csrc/multispring.cu`` (ctypes, plain C interface).

Launches on the current CUDA stream; outputs are allocated here with
``torch.empty``; every argument is checked before its pointer is passed.
"""
from __future__ import annotations

import torch

from repro_torch.fem.multispring import FLAG_KEYS, STATE_KEYS, SpringParams
from repro_torch.kernels import LaunchCounter, check_arg

TILE_P = 4  # evaluation points (one warp each) per CUDA block
TILE_P_RANGE = (1, 8)  # the kernel's launch bound: 256 threads
counter = LaunchCounter("multispring")


def check_tile_p(tile_p: int) -> None:
    lo, hi = TILE_P_RANGE
    if not lo <= tile_p <= hi:
        raise ValueError(f"multispring: tile_p={tile_p} must be in [{lo}, {hi}]")


def _check(name, x, shape, dtype, device):
    check_arg("multispring", name, x, shape, dtype, device)


def multispring_cuda(eps: torch.Tensor, state: dict[str, torch.Tensor], params: SpringParams,
                     n: torch.Tensor, w: torch.Tensor, *, tile_p: int = TILE_P):
    """(σ [P,6], D [P,6,6], new_state, frac [P]) from the CUDA kernel."""
    dt, dev = eps.dtype, eps.device
    if dt not in (torch.float32, torch.float64):
        raise ValueError(f"multispring: dtype {dt} not supported (float32, float64)")
    P, S = state["gamma_rev"].shape
    _check("eps", eps, (P, 6), dt, dev)
    for k in STATE_KEYS:
        _check(k, state[k], (P, S), torch.int32 if k in FLAG_KEYS else dt, dev)
    for k in ("G0", "gamma_r", "beta", "bulk"):
        _check(k, getattr(params, k), (P,), dt, dev)
    _check("n", n, (S, 6), dt, dev)
    _check("w", w, (S,), dt, dev)
    check_tile_p(tile_p)
    if dev.type != "cuda":
        raise ValueError(f"multispring: the CUDA kernel needs CUDA tensors, got {dev}")

    from repro_torch.kernels import _build

    sig = torch.empty((P, 6), dtype=dt, device=dev)
    D = torch.empty((P, 6, 6), dtype=dt, device=dev)
    frac = torch.empty((P,), dtype=dt, device=dev)
    new = {k: torch.empty_like(state[k]) for k in STATE_KEYS}
    fn = getattr(_build.library(), "ms_update_" + ("f64" if dt == torch.float64 else "f32"))
    err = fn(
        eps.data_ptr(), *(state[k].data_ptr() for k in STATE_KEYS),
        params.G0.data_ptr(), params.gamma_r.data_ptr(), params.beta.data_ptr(),
        params.bulk.data_ptr(), n.data_ptr(), w.data_ptr(), float(params.g_min_frac),
        P, S, tile_p, sig.data_ptr(), D.data_ptr(), frac.data_ptr(),
        *(new[k].data_ptr() for k in STATE_KEYS),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "multispring")
    counter.add()
    return sig, D, new, frac
