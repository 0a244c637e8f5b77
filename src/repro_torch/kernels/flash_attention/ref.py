"""Plain version of the flash attention kernel: the blocked online softmax of
the JAX package's ``models/layers.flash_attention_jnp``, in PyTorch.

Blocks over q and kv, fp32 running max / sum / accumulator, masked scores
-1e30, ``p`` rounded to ``v``'s dtype before P·V, output in ``q``'s dtype.
Memory stays O(S·block), on the CPU and on the card alike.  It is made of
differentiable operations: :func:`attend_rows` is also the recompute of the
trainable attention's backward (``models/layers.FlashAttentionFn``).
"""
from __future__ import annotations

import torch

NEG = -1e30
BLOCK_Q, BLOCK_K = 512, 1024  # flash_attention_jnp's defaults


def attend_rows(
    qb: torch.Tensor,  # [B,Hkv,G,n,dh]: query rows q0 … q0+n−1, head h·G+g reading KV head h
    k: torch.Tensor,   # [B,Hkv,Skv,dh]
    v: torch.Tensor,   # [B,Hkv,Skv,dv]
    q0: int,
    *,
    causal: bool,
    window: int | None,
    softcap: float | None,
    scale: float,
    offset: int,
    p_dtype: torch.dtype,
    block_k: int = BLOCK_K,
    skip_masked: bool = False,
) -> torch.Tensor:
    """One query block's attention, normalised, in fp32 ``[B,Hkv,G,n,dv]``:
    the scan over key blocks of ``block_k`` with the running max, sum and
    accumulator in fp32 and ``p`` rounded to ``p_dtype`` before P·V.

    ``skip_masked`` leaves out key blocks that the mask hides from every
    row of the block (past the causal diagonal, or older than the window
    for all of them): the result is bitwise the same, since such a block
    adds exact zeros to a row that has seen a key, and a row that has seen
    none is reset to exact zeros by the first block it sees."""
    B, Hkv, G, n, _ = qb.shape
    Skv, dv = k.shape[2], v.shape[3]
    dev = qb.device
    qf = qb.float()
    qpos = torch.arange(q0, q0 + n, device=dev) + offset
    first, last = q0 + offset, q0 + n - 1 + offset
    m = torch.full((B, Hkv, G, n), NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hkv, G, n), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hkv, G, n, dv), dtype=torch.float32, device=dev)
    for k0 in range(0, Skv, block_k):
        k1 = min(k0 + block_k, Skv)
        if skip_masked and ((causal and k0 > last) or (window is not None and first - (k1 - 1) >= window)):
            continue
        kb = k[:, :, k0:k1].float()
        vb = v[:, :, k0:k1]
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kb) * scale
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        kpos = torch.arange(k0, k1, device=dev)
        msk = torch.ones((n, k1 - k0), dtype=torch.bool, device=dev)
        if causal:
            msk &= kpos[None, :] <= qpos[:, None]
        if window is not None:
            msk &= qpos[:, None] - kpos[None, :] < window
        s = torch.where(msk, s, NEG)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bhgqk,bhkd->bhgqd", p.to(p_dtype).float(), vb.float())
        m = m_new
    return acc / (l[..., None] + 1e-30)


def flash_attention_ref(
    q: torch.Tensor,  # [B,Hq,Sq,dh]
    k: torch.Tensor,  # [B,Hkv,Skv,dh]
    v: torch.Tensor,  # [B,Hkv,Skv,dv]
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    scale: float | None = None,
    block_q: int = BLOCK_Q,
    block_k: int = BLOCK_K,
) -> torch.Tensor:
    B, Hq, Sq, dh = q.shape
    Hkv, Skv, dv = k.shape[1], k.shape[2], v.shape[3]
    G = Hq // Hkv
    scale = dh**-0.5 if scale is None else scale
    qg = q.reshape(B, Hkv, G, Sq, dh)  # query head h reads KV head h // G
    out = torch.empty((B, Hkv, G, Sq, dv), dtype=q.dtype, device=q.device)
    for q0 in range(0, Sq, block_q):
        qb = qg[:, :, :, q0:q0 + block_q]
        out[:, :, :, q0:q0 + qb.shape[3]] = attend_rows(
            qb, k, v, q0, causal=causal, window=window, softcap=softcap, scale=scale,
            offset=Skv - Sq, p_dtype=v.dtype, block_k=block_k).to(q.dtype)  # offset: decode / chunked prefill
    return out.reshape(B, Hq, Sq, dv)
