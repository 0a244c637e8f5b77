"""Core layers in PyTorch: norms, rotary, attention (GQA), MLP.

The JAX package's ``models/layers.py`` with the same public names, layouts
and rounding points:

* parameters are plain tensors in ``cfg.param_dtype``, cast to the
  activation dtype ``cfg.dtype`` where they are used;
* activations run in ``cfg.dtype`` (bf16 on the card), softmax statistics
  and norm reductions in fp32;
* attention never forms S×S: the prefill goes through
  :func:`flash_attention` (the hand-written CUDA kernel on the card, its
  plain version on the CPU), the decode through :func:`decode_attention`
  over the cache.

There is no sharding on one card, so ``proj`` is a plain matmul.  MLA
(DeepSeek-V2) is not ported yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import NEG
_LATER = "is not ported yet (ROADMAP.md, 'Modules still to port')"


def dt(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def pdt(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def normal(generator: torch.Generator, shape, dtype, device, scale=0.02) -> torch.Tensor:
    """``scale · N(0, 1)`` drawn in fp32 from ``generator``, stored in ``dtype``."""
    x = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
    return x.mul_(scale).to(dtype)


def ones(shape, dtype, device) -> torch.Tensor:
    return torch.ones(shape, dtype=dtype, device=device)


def zeros(shape, dtype, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def init_rmsnorm(d, cfg, stack: tuple = (), *, device) -> torch.Tensor:
    return ones(stack + (d,), pdt(cfg), device)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Variance in fp32, then ``x · inv · scale`` in ``x``'s dtype."""
    var = x.float().square().mean(-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * scale.to(x.dtype)


def init_layernorm(d, cfg, stack: tuple = (), *, device) -> dict:
    return {"scale": ones(stack + (d,), pdt(cfg), device), "bias": zeros(stack + (d,), pdt(cfg), device)}


def layernorm(x: torch.Tensor, p: dict, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y.to(x.dtype) * p["scale"].to(x.dtype)) + p["bias"].to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embedding (interleaved pairs, as the JAX package — not rotate-half)
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x [..., S, d] with d even; positions [S] or broadcastable [..., S]."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    ang = positions.to(torch.float32)[..., :, None] * freqs  # [..., S, d/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.stack([y1, y2], dim=-1).reshape(x.shape).to(x.dtype)


def proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum('bsd,d...->bs...')`` as one matmul."""
    return (x @ w.reshape(w.shape[0], -1)).reshape(*x.shape[:-1], *w.shape[1:])


# ---------------------------------------------------------------------------
# decode attention over a (possibly rolling) cache
# ---------------------------------------------------------------------------


def decode_attention(
    q: torch.Tensor,        # [B,Hq,1,dh]
    k_cache: torch.Tensor,  # [B,Hkv,S,dh]
    v_cache: torch.Tensor,  # [B,Hkv,S,dv]
    length_mask: torch.Tensor,  # [B,S] bool — valid cache slots
    *,
    softcap: float | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Single-token attention: scores in fp32, p in the cache's dtype."""
    B, Hq, _, dh = q.shape
    Hkv = k_cache.shape[1]
    G = Hq // Hkv
    scale = dh**-0.5 if scale is None else scale
    qg = q.reshape(B, Hkv, G, dh)
    s = torch.einsum("bhgd,bhkd->bhgk", qg.float(), k_cache.float()) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    s = torch.where(length_mask[:, None, None, :], s, NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bhkd->bhgd", p.to(v_cache.dtype), v_cache)
    return o.reshape(B, Hq, 1, -1)


# ---------------------------------------------------------------------------
# GQA attention layer
# ---------------------------------------------------------------------------


def init_attention(generator, cfg: ModelConfig, stack: tuple = (), *, device) -> dict:
    D, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    pt = pdt(cfg)
    p = {
        "wq": normal(generator, stack + (D, H, hd), pt, device),
        "wk": normal(generator, stack + (D, Hkv, hd), pt, device),
        "wv": normal(generator, stack + (D, Hkv, hd), pt, device),
        "wo": normal(generator, stack + (H, hd, D), pt, device, scale=0.02 / max(1, cfg.n_layers) ** 0.5),
    }
    if cfg.qk_norm:
        p["q_norm"] = ones(stack + (hd,), pt, device)
        p["k_norm"] = ones(stack + (hd,), pt, device)
    return p


def attention(
    params: dict,
    x: torch.Tensor,            # [B,S,D]
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,    # [S]
    window: int | None = None,
    cache: dict | None = None,  # decode: {"k","v" [B,Hkv,C,dh], "pos" int}
    causal: bool = True,
    return_kv: bool = False,    # prefill: emit (k, v) for the decode cache
):
    """→ ``(out [B,S,D], new_cache)``.

    With a cache (decode, S = 1) the new key and value are written **in
    place** at ring slot ``pos % C`` of the cache tensors, which come back
    in ``new_cache`` with ``pos + 1``.
    """
    adt = x.dtype
    q = proj(x, params["wq"].to(adt)).transpose(1, 2)
    k = proj(x, params["wk"].to(adt)).transpose(1, 2)
    v = proj(x, params["wv"].to(adt)).transpose(1, 2)  # a strided view: the kernel reads its strides
    if cfg.qk_norm:
        q = rmsnorm(q, params["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, params["k_norm"], cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    if cache is None:
        o = flash_attention(q, k, v, causal=causal, window=window, softcap=cfg.attn_softcap)
        new_cache = (k, v) if return_kv else None
    else:
        # rolling ring buffer: capacity C == window for windowed layers, the
        # full sequence length otherwise; slot = pos % C covers both.
        k_cache, v_cache, pos = cache["k"], cache["v"], cache["pos"]
        C = k_cache.shape[2]
        slot = pos % C
        k_cache[:, :, slot] = k[:, :, 0]
        v_cache[:, :, slot] = v[:, :, 0]
        valid = torch.arange(C, device=x.device) <= pos  # partial fill → prefix
        if pos >= C:
            valid = torch.ones_like(valid)  # full ring → all
        mask = valid[None].expand(x.shape[0], C)
        o = decode_attention(q, k_cache, v_cache, mask, softcap=cfg.attn_softcap)
        new_cache = {"k": k_cache, "v": v_cache, "pos": pos + 1}

    B, H, S, hd = o.shape
    o = o.to(adt).transpose(1, 2).reshape(B, S, H * hd)
    out = o @ params["wo"].to(adt).reshape(H * hd, -1)
    return out, new_cache


def init_mla(*args, **kwargs):
    raise NotImplementedError(f"MLA attention {_LATER}")


def mla_attention(*args, **kwargs):
    raise NotImplementedError(f"MLA attention {_LATER}")


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GELU)
# ---------------------------------------------------------------------------


def init_mlp(generator, cfg: ModelConfig, d_ff: int | None = None, stack: tuple = (), *, device) -> dict:
    D, Fd = cfg.d_model, d_ff or cfg.d_ff
    pt = pdt(cfg)
    if cfg.act == "gelu":
        return {"w1": normal(generator, stack + (D, Fd), pt, device),
                "w2": normal(generator, stack + (Fd, D), pt, device)}
    return {
        "w1": normal(generator, stack + (D, Fd), pt, device),
        "w3": normal(generator, stack + (D, Fd), pt, device),
        "w2": normal(generator, stack + (Fd, D), pt, device, scale=0.02 / max(1, cfg.n_layers) ** 0.5),
    }


def mlp(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    adt = x.dtype
    if "w3" in params:
        h = F.silu(proj(x, params["w1"].to(adt))) * proj(x, params["w3"].to(adt))
    else:
        h = F.gelu(proj(x, params["w1"].to(adt)), approximate="tanh")  # jax.nn.gelu's default
    return h @ params["w2"].to(adt)
