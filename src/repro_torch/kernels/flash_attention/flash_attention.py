"""Binding of the flash attention kernels (ctypes, plain C interface).

The dtype alone chooses the kernel, and both are hand-written:

* bfloat16 → ``csrc/flash_attention_wgmma.cu``: wgmma on the tensor cores,
  q, k and v brought in by TMA through a ring of shared-memory stages, in
  one of four instances by head dims (:func:`wgmma_instance`);
* float32 → ``csrc/flash_attention.cu``: mma.sync on the tensor cores in
  3×TF32 (each operand split into a TF32 high part and the rest, three
  products), which holds the reference's fp32 tolerance where one TF32
  pass does not; K and V come by cp.async through a two-stage ring.

Each launches on the current CUDA stream; the output ``[B,Hq,Sq,dv]`` is
allocated here with ``torch.empty``.  q, k and v are passed with their batch,
head and row strides, so the transposed projections of the attention layer
go in without a copy; the last dimension must have unit stride.  TMA needs
more: a 16-byte aligned base and strides and head dims that are multiples
of 8 elements.  :func:`pad_for_tma` copies a bf16 input that breaks that
into a zero-padded contiguous one first, and the same kernel runs on it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import LaunchCounter

MAX_HEAD_DIM = 256
# the wgmma kernel's instances, (DK, DV): Q·Kᵀ's depth and P·V's width
WGMMA_INSTANCES = ((64, 64), (128, 128), (192, 128), (256, 256))
TMA_ELEMS = 8  # 16 bytes of bf16: TMA's unit of address, stride and row
# C entry point of each dtype's kernel
ENTRY = {torch.bfloat16: "flash_attention_wgmma_bf16", torch.float32: "flash_attention_f32"}
counter = LaunchCounter("flash_attention")  # every flash launch, of either kernel
COUNTERS = {torch.bfloat16: LaunchCounter("flash_attention_bf16", parent=counter),
            torch.float32: LaunchCounter("flash_attention_f32", parent=counter)}
# the bf16 kernel's launches by the instance (DK, DV) passed to its C entry
WGMMA_COUNTERS = {(dk, dv): LaunchCounter(f"flash_attention_bf16_{dk}x{dv}", parent=COUNTERS[torch.bfloat16])
                  for dk, dv in WGMMA_INSTANCES}


def _fail(msg: str):
    raise ValueError(f"flash_attention: {msg}")


def wgmma_instance(dh: int, dv: int) -> tuple[int, int]:
    """The wgmma kernel's instance for head dims ``dh`` (q, k) and ``dv`` (v):
    (192, 128) for 128 < dh ≤ 192 with dv ≤ 128 (MLA's heads), else the
    smallest (D, D) with D ≥ max(dh, dv).  TMA zero-fills the columns past
    dh or dv inside the instance.  The only place that picks one."""
    if not (1 <= dh <= MAX_HEAD_DIM and 1 <= dv <= MAX_HEAD_DIM):
        _fail(f"head dims dh={dh}, dv={dv} must be in [1, {MAX_HEAD_DIM}]")
    if 128 < dh <= 192 and dv <= 128:
        return 192, 128
    d = max(dh, dv)
    return next((D, D) for D in (64, 128, 256) if d <= D)


def tma_strides(x: torch.Tensor) -> tuple[int, int, int]:
    """Batch, head and row strides of ``x [B,H,S,d]`` for a tensor map.  A
    dimension of extent 1 is never stepped, so it takes the stride it would
    have if contiguous over the dimensions inside it."""
    strides = list(x.stride())
    for i in (2, 1, 0):
        if x.shape[i] == 1:
            strides[i] = strides[i + 1] * x.shape[i + 1]
    return strides[0], strides[1], strides[2]


def tma_ready(x: torch.Tensor) -> bool:
    """Whether TMA can read ``x [B,H,S,d]`` in place: unit stride in ``d``,
    a 16-byte aligned base, and ``d`` and the other strides multiples of 8."""
    return (x.stride(3) == 1 and x.data_ptr() % (TMA_ELEMS * x.element_size()) == 0
            and x.shape[3] % TMA_ELEMS == 0 and all(s % TMA_ELEMS == 0 for s in tma_strides(x)))


def pad_for_tma(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """The layout step before the wgmma kernel: each of q, k, v as it is where
    TMA can read it, else copied into a contiguous tensor whose head dim is
    zero-padded to a multiple of 8 (q and k to the same one).  Zero columns
    of q and k add nothing to the scores; zero columns of v give output
    columns that the caller slices off.  The caller passes the scale of the
    unpadded dh explicitly."""
    def fit(x, d):
        if x.shape[3] == d and tma_ready(x):
            return x
        out = x.new_zeros((*x.shape[:3], d))
        out[..., :x.shape[3]] = x
        return out

    def up(d):
        return -(-d // TMA_ELEMS) * TMA_ELEMS

    dh, dv = up(q.shape[3]), up(v.shape[3])
    return fit(q, dh), fit(k, dh), fit(v, dv)


def wgmma_blocks_per_sm() -> dict[tuple[int, int], int]:
    """Blocks of each wgmma instance that fit on one SM of the current card
    at once (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``): registers,
    shared memory and threads as each instance launches."""
    from repro_torch.kernels import _build

    lib = _build.library()
    out = {inst: lib.flash_attention_wgmma_blocks_per_sm_bf16(*inst) for inst in WGMMA_INSTANCES}
    for n in out.values():
        _build.check(max(0, -n), "flash_attention blocks per SM")
    return out


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                         window: int | None = None, softcap: float | None = None,
                         scale: float | None = None) -> torch.Tensor:
    """``o [B,Hq,Sq,dv]`` from the CUDA kernel of q's dtype (see the plain version for the function).

    The output is written by the kernel into a new tensor, so it carries no
    gradient: with grad mode on, q, k or v that require one are refused
    (the trainable attention, ``models/layers.FlashAttentionFn``, calls this
    from its forward, where grad mode is off, and recomputes the plain
    version for the backward)."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        _fail("q, k or v requires a gradient, which the kernel's output would not carry: "
              "call models.layers.FlashAttentionFn, or the kernel under torch.no_grad()")
    if q.device.type != "cuda":
        _fail(f"the CUDA kernel needs CUDA tensors, got {q.device}")
    dt, dev = q.dtype, q.device
    if dt not in ENTRY:
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

    scale = float(dh**-0.5 if scale is None else scale)
    if dt == torch.bfloat16:
        q, k, v = pad_for_tma(q, k, v)
    out = torch.empty((B, Hq, Sq, v.shape[3]), dtype=dt, device=dev)
    inst = wgmma_instance(q.shape[3], v.shape[3]) if dt == torch.bfloat16 else None
    dims = (q.shape[3], v.shape[3], *inst) if inst else (dh, dv)
    err = getattr(_build.library(), ENTRY[dt])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hq, Hkv, Sq, Skv, *dims,
        *tma_strides(q), *tma_strides(k), *tma_strides(v),
        scale, int(causal), int(window or 0), float(softcap or 0.0), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "flash_attention")
    (WGMMA_COUNTERS[inst] if inst else COUNTERS[dt]).add()
    return out if out.shape[3] == dv else out[..., :dv].contiguous()
