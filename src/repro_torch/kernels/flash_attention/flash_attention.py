"""Binding of ``csrc/flash_attention.cu`` (ctypes, plain C interface).

Launches on the current CUDA stream; the output ``[B,Hq,Sq,dv]`` is
allocated here with ``torch.empty``.  q, k and v are passed with their batch,
head and row strides, so the transposed projections of the attention layer
go in without a copy; the last dimension must have unit stride.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import LaunchCounter

MAX_HEAD_DIM = 256
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
counter = LaunchCounter("flash_attention")


def _fail(msg: str):
    raise ValueError(f"flash_attention: {msg}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                         window: int | None = None, softcap: float | None = None,
                         scale: float | None = None) -> torch.Tensor:
    """``o [B,Hq,Sq,dv]`` from the CUDA kernel (see the plain version for the function)."""
    if q.device.type != "cuda":
        _fail(f"the CUDA kernel needs CUDA tensors, got {q.device}")
    dt, dev = q.dtype, q.device
    if dt not in _SUFFIX:
        _fail(f"dtype {dt} not supported (float32, bfloat16)")
    for name, x in (("k", k), ("v", v)):
        if x.device != dev or x.dtype != dt:
            _fail(f"{name} is {x.dtype} on {x.device}, q is {dt} on {dev}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        _fail("q, k and v must be 4-d [B,H,S,d]")
    B, Hq, Sq, dh = q.shape
    Hkv, Skv, dv = k.shape[1], k.shape[2], v.shape[3]
    if tuple(k.shape) != (B, Hkv, Skv, dh) or tuple(v.shape) != (B, Hkv, Skv, dv):
        _fail(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} do not match")
    if Hkv < 1 or Hq % Hkv:
        _fail(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    if not (1 <= dh <= MAX_HEAD_DIM and 1 <= dv <= MAX_HEAD_DIM):
        _fail(f"head dims dh={dh}, dv={dv} must be in [1, {MAX_HEAD_DIM}]")
    if Skv < 1 or Sq < 1 or ((causal or window is not None) and Sq > Skv):
        _fail(f"need 1 ≤ Sq ≤ Skv for a causal or windowed mask, got Sq={Sq}, Skv={Skv}")
    if window is not None and window < 1:
        _fail(f"window={window} must be ≥ 1")
    if softcap is not None and softcap < 0:
        _fail(f"softcap={softcap} must be ≥ 0")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1:
            _fail(f"{name} must have unit stride in its last dimension, got strides {x.stride()}")

    from repro_torch.kernels import _build

    out = torch.empty((B, Hq, Sq, dv), dtype=dt, device=dev)
    fn = getattr(_build.library(), "flash_attention_" + _SUFFIX[dt])
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hq, Hkv, Sq, Skv, dh, dv,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        float(dh**-0.5 if scale is None else scale), int(causal), int(window or 0),
        float(softcap or 0.0), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "flash_attention")
    counter.add()
    return out
