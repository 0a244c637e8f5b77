"""Public entry of the flash attention kernel.

The kernel is chosen by the tensors' device: on a CPU tensor
:func:`flash_attention` runs the plain version (``ref.flash_attention_ref``);
on a CUDA tensor it launches the kernel of its dtype (bf16:
``csrc/flash_attention_wgmma.cu``, fp32: ``csrc/flash_attention.cu``) or
raises.  There is no fallback from one to the other.

The entry is one operator, ``torch.ops.repro_torch.flash_attention``
(``torch.library.custom_op``), so PyTorch's tracing modes see the kernel
as one op: on ``meta`` tensors its fake returns the output's shape and runs
neither the plain version nor the kernel (the dry run traces whole models
so), and ``FlopCounterMode`` counts it by :func:`flash_flops`, the
kernel's work, where the ctypes launch inside would show it nothing.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.flash_attention.flash_attention import (COUNTERS, ENTRY, WGMMA_COUNTERS, WGMMA_INSTANCES,
                                                                  counter, flash_attention_cuda, pad_for_tma,
                                                                  tma_ready, tma_strides, wgmma_blocks_per_sm,
                                                                  wgmma_instance)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


def wgmma_launch_counts() -> dict[tuple[int, int], int]:
    """The bf16 kernel's launches by instance (DK, DV) since the counts were last reset."""
    return {inst: c.n for inst, c in WGMMA_COUNTERS.items()}


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         schema="(Tensor q, Tensor k, Tensor v, bool causal, int? window, float? softcap, "
                                "float? scale) -> Tensor")
def _flash_attention_op(q, k, v, causal, window, softcap, scale):
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window, softcap=softcap, scale=scale)
    return flash_attention_cuda(q, k, v, causal=causal, window=window, softcap=softcap, scale=scale)


@_flash_attention_op.register_fake
def _(q, k, v, causal, window, softcap, scale):
    return q.new_empty((q.shape[0], q.shape[1], q.shape[2], v.shape[3]))


def visible_pairs(Sq: int, Skv: int, causal: bool, window: int | None) -> int:
    """(query, key) pairs that the causal mask (queries aligned to the last
    Sq keys) and the window leave visible: the score entries the kernel
    computes."""
    p = torch.arange(Skv - Sq, Skv, dtype=torch.int64)  # each query's position among the keys
    hi = torch.clamp(p + 1, max=Skv) if causal else torch.full_like(p, Skv)
    lo = torch.clamp(p - window + 1, min=0) if window else torch.zeros_like(p)
    return int((hi - lo).clamp(min=0).sum())


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def flash_flops(q_shape, k_shape, v_shape, causal, window=None, softcap=None, scale=None, *args, **kwargs) -> int:
    """2·B·Hq·(visible score entries)·(dh + dv): Q·Kᵀ and P·V over the pairs
    the mask leaves, the count the kernel rows' "operations" bound uses."""
    B, Hq, Sq, dh = q_shape
    return 2 * B * Hq * visible_pairs(Sq, k_shape[2], causal, window) * (dh + v_shape[3])


def flash_attention(q, k, v, *, causal: bool = True, window: int | None = None,
                    softcap: float | None = None, scale: float | None = None):
    """``o [B,Hq,Sq,dv]`` for ``q [B,Hq,Sq,dh]``, ``k [B,Hkv,Skv,dh]``, ``v [B,Hkv,Skv,dv]``."""
    return torch.ops.repro_torch.flash_attention(
        q, k, v, bool(causal), None if window is None else int(window),
        None if softcap is None else float(softcap), None if scale is None else float(scale))


__all__ = ["flash_attention", "flash_attention_cuda", "flash_attention_ref", "flash_flops", "pad_for_tma", "tma_ready",
           "tma_strides", "visible_pairs", "wgmma_blocks_per_sm", "wgmma_instance", "wgmma_launch_counts",
           "WGMMA_INSTANCES", "WGMMA_COUNTERS", "counter", "COUNTERS", "ENTRY"]
