"""The transformer stack of the port: dense, uniform GQA stacks (qwen3,
granite, llama3 …), inference only.

The JAX package's ``models/transformer.py`` with the same public names and
the same parameter tree: ``{"embed", "layers": {...stacked [L,…]...},
"final_norm", ["lm_head"]}``, where each layer's weights are the ``l``-th
slice of the stacked tensors.  Where JAX scans over the stack, this module
loops over the layers.

``init_decode_state`` / ``prefill`` / ``decode_step`` share one cache
layout, ``{"pos": int, "layers": {"k", "v": [L,B,Hkv,C,hd]}}``, with ring
caches of capacity ``min(cache_len, window)`` for windowed models.
``decode_step`` writes the new key and value into the cache tensors in
place and returns the same tensors with ``pos + 1``.

The other families (MoE, SSM, hybrid, enc-dec, VLM), gemma2's local/global
pair stack and MLA raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L


def check_supported(cfg: ModelConfig) -> None:
    """Raise unless ``cfg`` is a dense, uniform GQA stack (what is ported)."""
    what = None
    if cfg.family != "dense":
        what = f"the {cfg.family!r} family"
    elif cfg.local_global:
        what = "the local/global pair stack"
    elif cfg.attn_type != "gqa":
        what = f"{cfg.attn_type!r} attention"
    if what:
        raise NotImplementedError(f"{cfg.name}: {what} {L._LATER}")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _norm_init(cfg, d, stack, device):
    init = L.init_rmsnorm if cfg.act != "gelu" else L.init_layernorm
    return init(d, cfg, stack, device=device)


def _norm_apply(cfg, x, p):
    return L.rmsnorm(x, p, cfg.norm_eps) if cfg.act != "gelu" else L.layernorm(x, p, cfg.norm_eps)


def init_params(cfg: ModelConfig, generator: torch.Generator, device=None) -> dict:
    """Random parameters, ``N(0, 0.02²)`` as the JAX package's ``init_params``
    (output projections scaled by 1/√L, norms 1), drawn in a fixed order from
    ``generator``, which must live on ``device`` (``None`` → the card)."""
    check_supported(cfg)
    dev = resolve_device(device)
    V, D, n = cfg.vocab_size, cfg.d_model, (cfg.n_layers,)
    params: dict[str, Any] = {"embed": L.normal(generator, (V, D), L.pdt(cfg), dev)}
    params["layers"] = {
        "attn": L.init_attention(generator, cfg, n, device=dev),
        "mlp": L.init_mlp(generator, cfg, stack=n, device=dev),
        "ln1": _norm_init(cfg, D, n, dev),
        "ln2": _norm_init(cfg, D, n, dev),
    }
    params["final_norm"] = _norm_init(cfg, D, (), dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = L.normal(generator, (D, V), L.pdt(cfg), dev)
    return params


def layer(stacked: Any, i: int) -> Any:
    """Layer ``i``'s parameters (views) from a stacked ``[L,…]`` tree."""
    if isinstance(stacked, dict):
        return {k: layer(v, i) for k, v in stacked.items()}
    return stacked[i]


def layer_slice(stacked: Any, lo: int, hi: int) -> Any:
    """Layers ``lo:hi`` (views) of a stacked ``[L,…]`` tree."""
    if isinstance(stacked, dict):
        return {k: layer_slice(v, lo, hi) for k, v in stacked.items()}
    return stacked[lo:hi]


def n_stacked(stacked: Any) -> int:
    while isinstance(stacked, dict):
        stacked = next(iter(stacked.values()))
    return stacked.shape[0]


# ---------------------------------------------------------------------------
# blocks, embedding
# ---------------------------------------------------------------------------


def _apply_attn_block(p, x, cfg, *, positions, window, cache=None, causal=True, return_kv=False):
    h = _norm_apply(cfg, x, p["ln1"])
    a, new_cache = L.attention(p["attn"], h, cfg, positions=positions, window=window, cache=cache,
                               causal=causal, return_kv=return_kv)
    x = x + a
    h = _norm_apply(cfg, x, p["ln2"])
    return x + L.mlp(p["mlp"], h, cfg), new_cache


def _embed(params, cfg, tokens):
    """Rows of the table, then cast: the same numbers as casting the table
    first (elementwise), without a table-sized temporary per call."""
    return params["embed"][tokens].to(L.dt(cfg))


def _unembed(params, cfg, x):
    x = _norm_apply(cfg, x, params["final_norm"])
    table = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return (x @ table.to(x.dtype)).float()


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


@torch.no_grad()
def forward(params, cfg: ModelConfig, batch: dict, *, remat: bool = True):
    """→ (logits [B,S,V] fp32, aux_loss 0).  Inference only: ``remat`` is
    accepted for the JAX signature and ignored."""
    del remat
    check_supported(cfg)
    x = _embed(params, cfg, batch["tokens"])
    positions = torch.arange(x.shape[1], device=x.device)
    for i in range(n_stacked(params["layers"])):
        x, _ = _apply_attn_block(layer(params["layers"], i), x, cfg, positions=positions, window=cfg.window)
    return _unembed(params, cfg, x), torch.zeros((), dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def cache_capacity(cfg: ModelConfig, cache_len: int) -> int:
    return min(cache_len, cfg.window) if cfg.window else cache_len


def _kv_cache(cfg, stack, B, C, dtype, device):
    shape = stack + (B, cfg.n_kv_heads, C, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_decode_state(cfg: ModelConfig, B: int, cache_len: int, dtype=torch.bfloat16, device=None) -> dict:
    """Empty caches for a decode run of ``cache_len`` total positions."""
    check_supported(cfg)
    dev = resolve_device(device)
    return {"pos": 0, "layers": _kv_cache(cfg, (cfg.n_layers,), B, cache_capacity(cfg, cache_len), dtype, dev)}


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor, state: dict):
    """One token per sequence: tokens [B,1] → (logits [B,1,V], new state)."""
    check_supported(cfg)
    pos = state["pos"]
    x = _embed(params, cfg, tokens)
    positions = torch.arange(pos, pos + 1, device=x.device)  # no host→device copy: no sync
    caches = state["layers"]
    for i in range(n_stacked(params["layers"])):
        c = {"k": caches["k"][i], "v": caches["v"][i], "pos": pos}
        x, _ = _apply_attn_block(layer(params["layers"], i), x, cfg, positions=positions,
                                 window=cfg.window, cache=c)
    return _unembed(params, cfg, x), {**state, "pos": pos + 1}


# ---------------------------------------------------------------------------
# prefill: forward over the prompt that emits the decode cache
# ---------------------------------------------------------------------------


def _pack_kv(k: torch.Tensor, C: int) -> torch.Tensor:
    """[..., S, d] prompt keys → ring cache [..., C, d] consistent with
    decode's ``slot = pos % C`` addressing at pos = S."""
    S = k.shape[-2]
    if S <= C:
        return F.pad(k, (0, 0, 0, C - S))
    return torch.roll(k[..., S - C:, :], S % C, dims=-2)


@torch.no_grad()
def prefill(params, cfg: ModelConfig, batch: dict, cache_len: int, *, out: dict | None = None):
    """Run the prompt, return (last-token logits [B,1,V], decode state).

    Attention goes through the flash kernel once per layer.  The state is
    layout-identical to :func:`init_decode_state` (ring-packed caches in the
    activation dtype, written layer by layer into preallocated tensors), so
    ``decode_step`` continues from it.  ``out`` (``{"k", "v"}``, each
    indexable by layer, e.g. the host KV blocks of offloaded serving) takes
    the caches in place of new device tensors, one layer at a time.
    """
    check_supported(cfg)
    x = _embed(params, cfg, batch["tokens"])
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device)
    n = n_stacked(params["layers"])
    C = cache_capacity(cfg, cache_len)
    caches = out if out is not None else _kv_cache(cfg, (n,), B, C, x.dtype, x.device)
    for i in range(n):
        x, (k, v) = _apply_attn_block(layer(params["layers"], i), x, cfg, positions=positions,
                                      window=cfg.window, return_kv=True)
        caches["k"][i].copy_(_pack_kv(k, C))
        caches["v"][i].copy_(_pack_kv(v, C))
    return _unembed(params, cfg, x[:, -1:, :]), {"pos": S, "layers": caches}
