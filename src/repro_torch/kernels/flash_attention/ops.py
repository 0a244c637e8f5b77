"""Public entry of the flash attention kernel.

The kernel is chosen by the tensors' device: on a CPU tensor
:func:`flash_attention` runs the plain version (``ref.flash_attention_ref``);
on a CUDA tensor it launches the kernel of its dtype (bf16:
``csrc/flash_attention_wgmma.cu``, fp32: ``csrc/flash_attention.cu``) or
raises.  There is no fallback from one to the other.
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention.flash_attention import (COUNTERS, ENTRY, WGMMA_COUNTERS, WGMMA_INSTANCES,
                                                                  counter, flash_attention_cuda, pad_for_tma,
                                                                  tma_ready, tma_strides, wgmma_blocks_per_sm,
                                                                  wgmma_instance)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


def wgmma_launch_counts() -> dict[tuple[int, int], int]:
    """The bf16 kernel's launches by instance (DK, DV) since the counts were last reset."""
    return {inst: c.n for inst, c in WGMMA_COUNTERS.items()}


def flash_attention(q, k, v, *, causal: bool = True, window: int | None = None,
                    softcap: float | None = None, scale: float | None = None):
    """``o [B,Hq,Sq,dv]`` for ``q [B,Hq,Sq,dh]``, ``k [B,Hkv,Skv,dh]``, ``v [B,Hkv,Skv,dv]``."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window, softcap=softcap, scale=scale)
    return flash_attention_cuda(q, k, v, causal=causal, window=window, softcap=softcap, scale=scale)


__all__ = ["flash_attention", "flash_attention_cuda", "flash_attention_ref", "pad_for_tma", "tma_ready", "tma_strides",
           "wgmma_blocks_per_sm", "wgmma_instance", "wgmma_launch_counts", "WGMMA_INSTANCES", "WGMMA_COUNTERS",
           "counter", "COUNTERS", "ENTRY"]
