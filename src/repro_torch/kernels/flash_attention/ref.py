"""Plain version of the flash attention kernel: the blocked online softmax of
the JAX package's ``models/layers.flash_attention_jnp``, in PyTorch.

Blocks over q and kv, fp32 running max / sum / accumulator, masked scores
-1e30, ``p`` rounded to ``v``'s dtype before P·V, output in ``q``'s dtype.
Memory stays O(S·block), on the CPU and on the card alike.
"""
from __future__ import annotations

import torch

NEG = -1e30


def flash_attention_ref(
    q: torch.Tensor,  # [B,Hq,Sq,dh]
    k: torch.Tensor,  # [B,Hkv,Skv,dh]
    v: torch.Tensor,  # [B,Hkv,Skv,dv]
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    scale: float | None = None,
    block_q: int = 512,
    block_k: int = 1024,
) -> torch.Tensor:
    B, Hq, Sq, dh = q.shape
    Hkv, Skv, dv = k.shape[1], k.shape[2], v.shape[3]
    G = Hq // Hkv
    scale = dh**-0.5 if scale is None else scale
    offset = Skv - Sq  # decode / chunked-prefill alignment
    dev = q.device
    qg = q.reshape(B, Hkv, G, Sq, dh)  # query head h reads KV head h // G
    out = torch.empty((B, Hkv, G, Sq, dv), dtype=q.dtype, device=dev)
    for q0 in range(0, Sq, block_q):
        qb = qg[:, :, :, q0:q0 + block_q].float()
        n = qb.shape[3]
        qpos = torch.arange(q0, q0 + n, device=dev) + offset
        m = torch.full((B, Hkv, G, n), NEG, dtype=torch.float32, device=dev)
        l = torch.zeros((B, Hkv, G, n), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, Hkv, G, n, dv), dtype=torch.float32, device=dev)
        for k0 in range(0, Skv, block_k):
            kb = k[:, :, k0:k0 + block_k].float()
            vb = v[:, :, k0:k0 + block_k]
            s = torch.einsum("bhgqd,bhkd->bhgqk", qb, kb) * scale
            if softcap:
                s = softcap * torch.tanh(s / softcap)
            kpos = torch.arange(k0, k0 + kb.shape[2], device=dev)
            msk = torch.ones((n, kb.shape[2]), dtype=torch.bool, device=dev)
            if causal:
                msk &= kpos[None, :] <= qpos[:, None]
            if window is not None:
                msk &= qpos[:, None] - kpos[None, :] < window
            s = torch.where(msk, s, NEG)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype).float(), vb.float())
            m = m_new
        out[:, :, :, q0:q0 + n] = (acc / (l[..., None] + 1e-30)).to(q.dtype)
    return out.reshape(B, Hq, Sq, dv)
