"""The transformer stack of the port, inference only: dense GQA stacks
(qwen3, granite, llama3 …), gemma2's local/global pair stack, and the MoE
family (mixtral's GQA, deepseek-v2's MLA with a first dense stack).

The JAX package's ``models/transformer.py`` with the same public names and
the same parameter trees, where each stack's layers are slices of stacked
tensors:

  dense          ``layers [L,…]``
  gemma2         ``layers [L/2, 2, …]``: sub-layer 0 local (window
                 ``cfg.window or 4096``), sub-layer 1 global, each with the
                 post-norms ``post1``/``post2``; the embedding scaled by √d
                 and the logits soft-capped by ``final_softcap``
  moe            ``dense_layers [nd,…]`` (``first_dense_layers``), then
                 ``layers [L-nd,…]`` with ``moe`` in place of ``mlp``

Where JAX scans over a stack, this module loops over its layers.

``init_decode_state`` / ``prefill`` / ``decode_step`` share one cache
layout: ``{"pos": int, <stack>: {"k", "v": [n,B,Hkv,C,hd]}}`` with ring
caches of capacity ``min(cache_len, window)`` for windowed layers; gemma2
keys its stacks ``local`` and ``global``; MLA keeps the latents
``{"c_kv" [n,B,C,r_kv], "k_rope" [n,B,C,nr]}``.  ``decode_step`` writes
the new entries into the cache tensors in place and returns the same
tensors with ``pos + 1``.

The MoE routes dropless in prefill and in GQA decode, and at the capacity
factor in ``forward`` and in MLA decode: the reference's ``_scan_mla``
calls the MoE without ``full_capacity``, and the port does as it does.

The SSM, hybrid, encoder-decoder and VLM families raise
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as M

PORTED_FAMILIES = ("dense", "moe")
LOCAL_WINDOW = 4096  # gemma2's local window when the config gives none (the reference's default)


def check_supported(cfg: ModelConfig) -> None:
    """Raise unless ``cfg``'s family is ported (dense, gemma2's pair stack, MoE)."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(f"{cfg.name}: the {cfg.family!r} family {L._LATER}")


def stack_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """The leading (stack) dimensions of each layer stack of the parameter tree."""
    if cfg.family == "moe":
        nd = cfg.first_dense_layers
        return {**({"dense_layers": (nd,)} if nd else {}), "layers": (cfg.n_layers - nd,)}
    if cfg.local_global:
        return {"layers": (cfg.n_layers // 2, 2)}
    return {"layers": (cfg.n_layers,)}


def _moe_stack(cfg: ModelConfig, name: str) -> bool:
    """Whether stack ``name``'s layers carry the MoE in place of the MLP."""
    return cfg.family == "moe" and name == "layers"


class Slot(NamedTuple):
    """One attention layer of the model, in order: where its parameters and
    its cache are, and how it runs."""
    stack: str                  # its parameter stack
    at: int | tuple[int, int]   # its index there: the layer, or gemma2's (pair, sub-layer)
    cache: str                  # the decode state's key of its cache
    row: int                    # its index in that cache
    window: int | None
    moe: bool                   # the MoE in place of the MLP


def layout(cfg: ModelConfig) -> list[Slot]:
    """Every attention layer of ``cfg``'s stacks, in the order they run.
    gemma2's pair: sub-layer 0 local (window ``cfg.window or 4096``, cache
    ``local``), sub-layer 1 global (no window, cache ``global``)."""
    if cfg.local_global:
        subs = (("local", cfg.window or LOCAL_WINDOW), ("global", None))
        return [Slot("layers", (i, s), key, i, w, False)
                for i in range(cfg.n_layers // 2) for s, (key, w) in enumerate(subs)]
    return [Slot(name, i, name, i, cfg.window, _moe_stack(cfg, name))
            for name, (n,) in stack_shapes(cfg).items() for i in range(n)]


def check_offload_scope(cfg: ModelConfig) -> None:
    """Caches that live outside the decode state (offloaded KV, prefill's
    ``out=``) take one uniform ``[L,…]`` stack of GQA layers, dense or MoE
    (the reference's scope, which it asserts): raise ``ValueError``, naming
    the reason, for any other layout.  Nothing falls back to resident
    decode."""
    check_supported(cfg)
    why = None
    if cfg.local_global:
        why = "gemma2's local/global pair stack (two caches of different capacities)"
    elif cfg.attn_type == "mla":
        why = "MLA's latent cache"
    elif cfg.first_dense_layers:
        why = "a first_dense_layers stack beside the MoE stack"
    if why:
        raise ValueError(f"{cfg.name}: offloaded KV takes a uniform stack of GQA layers, not {why}")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _norm_init(cfg, d, stack, device):
    init = L.init_rmsnorm if cfg.act != "gelu" else L.init_layernorm
    return init(d, cfg, stack, device=device)


def _norm_apply(cfg, x, p):
    return L.rmsnorm(x, p, cfg.norm_eps) if cfg.act != "gelu" else L.layernorm(x, p, cfg.norm_eps)


def _init_block(generator, cfg, stack, device, *, moe: bool):
    init_attn = L.init_mla if cfg.attn_type == "mla" else L.init_attention
    p = {"attn": init_attn(generator, cfg, stack, device=device)}
    if moe:
        p["moe"] = M.init_moe(generator, cfg, stack, device=device)
    else:
        p["mlp"] = L.init_mlp(generator, cfg, stack=stack, device=device)
    p["ln1"] = _norm_init(cfg, cfg.d_model, stack, device)
    p["ln2"] = _norm_init(cfg, cfg.d_model, stack, device)
    if cfg.local_global:  # gemma2's post-norms
        p["post1"] = _norm_init(cfg, cfg.d_model, stack, device)
        p["post2"] = _norm_init(cfg, cfg.d_model, stack, device)
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator, device=None) -> dict:
    """Random parameters, ``N(0, 0.02²)`` as the JAX package's ``init_params``
    (output projections scaled by 1/√L, norms 1), drawn in a fixed order from
    ``generator``, which must live on ``device`` (``None`` → the card)."""
    check_supported(cfg)
    dev = resolve_device(device)
    V, D = cfg.vocab_size, cfg.d_model
    params: dict[str, Any] = {"embed": L.normal(generator, (V, D), L.pdt(cfg), dev)}
    for name, stack in stack_shapes(cfg).items():
        params[name] = _init_block(generator, cfg, stack, dev, moe=_moe_stack(cfg, name))
    params["final_norm"] = _norm_init(cfg, D, (), dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = L.normal(generator, (D, V), L.pdt(cfg), dev)
    return params


def layer(stacked: Any, i: int) -> Any:
    """Entry ``i`` (views) of a stacked tree: a layer of ``[L,…]``; of
    ``[L/2, 2, …]``, a pair, or with ``i = (pair, sub-layer)`` a sub-layer."""
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


def _attend(p, h, cfg, *, positions, window, cache=None, return_kv=False):
    if cfg.attn_type == "mla":
        return L.mla_attention(p, h, cfg, positions=positions, cache=cache, return_kv=return_kv)
    return L.attention(p, h, cfg, positions=positions, window=window, cache=cache, return_kv=return_kv)


def _block(p, x, cfg, slot: Slot, mode: str, positions, cache=None):
    """One layer in ``mode`` (``forward``, ``prefill`` or ``decode``): the
    attention, then the MLP or the MoE, each pre-normed (gemma2: post-normed
    too) before its residual add → (x, prefill's keys and values, the MoE's
    aux loss or ``None``).  The MoE routes dropless in prefill and in GQA
    decode (the reference's ``_apply_moe_block`` sets ``full_capacity`` with
    a cache), at the capacity factor in ``forward`` and in MLA decode (its
    ``_scan_mla`` does not)."""
    h = _norm_apply(cfg, x, p["ln1"])
    a, kv = _attend(p["attn"], h, cfg, positions=positions, window=slot.window, cache=cache,
                    return_kv=mode == "prefill")
    if "post1" in p:
        a = _norm_apply(cfg, a, p["post1"])
    x = x + a
    h = _norm_apply(cfg, x, p["ln2"])
    aux = None
    if slot.moe:
        full = mode == "prefill" or (mode == "decode" and cfg.attn_type != "mla")
        m, aux = M.moe(p["moe"], h, cfg, full_capacity=full)
    else:
        m = L.mlp(p["mlp"], h, cfg)
    if "post2" in p:
        m = _norm_apply(cfg, m, p["post2"])
    return x + m, kv, aux


def _layers(params, cfg):
    """(layer parameters (views), slot) of every attention layer, in order."""
    for s in layout(cfg):
        yield layer(params[s.stack], s.at), s


def _embed(params, cfg, tokens):
    """Rows of the table, then cast: the same numbers as casting the table
    first (elementwise), without a table-sized temporary per call.  gemma2
    scales by √d rounded to the activation dtype, as JAX multiplies."""
    x = params["embed"][tokens].to(L.dt(cfg))
    if cfg.local_global:
        x = x * float(torch.tensor(cfg.d_model**0.5, dtype=x.dtype))
    return x


def _unembed(params, cfg, x):
    x = _norm_apply(cfg, x, params["final_norm"])
    table = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = (x @ table.to(x.dtype)).float()
    if cfg.final_softcap:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


@torch.no_grad()
def forward(params, cfg: ModelConfig, batch: dict, *, remat: bool = True):
    """→ (logits [B,S,V] fp32, aux_loss fp32: the MoE layers' load-balancing
    losses summed, 0 without them).  Inference only: ``remat`` is accepted
    for the JAX signature and ignored."""
    del remat
    check_supported(cfg)
    x = _embed(params, cfg, batch["tokens"])
    positions = torch.arange(x.shape[1], device=x.device)
    auxes = []
    for lp, slot in _layers(params, cfg):
        x, _, a = _block(lp, x, cfg, slot, "forward", positions)
        if a is not None:
            auxes.append(a)
    aux = torch.stack(auxes).sum() if auxes else torch.zeros((), dtype=torch.float32, device=x.device)
    return _unembed(params, cfg, x), aux


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def _capacity(window: int | None, cache_len: int) -> int:
    return min(cache_len, window) if window else cache_len


def cache_capacity(cfg: ModelConfig, cache_len: int) -> int:
    """The cache capacity of a uniform stack's layers."""
    return _capacity(cfg.window, cache_len)


def _cache_names(cfg: ModelConfig) -> tuple[str, str]:
    """The two tensors of a layer's cache: GQA's keys and values, or MLA's latents."""
    return ("c_kv", "k_rope") if cfg.attn_type == "mla" else ("k", "v")


def _kv_cache(cfg, stack, B, C, dtype, device):
    if cfg.attn_type == "mla":
        return {"c_kv": torch.zeros(stack + (B, C, cfg.kv_lora_rank), dtype=dtype, device=device),
                "k_rope": torch.zeros(stack + (B, C, cfg.qk_rope_dim), dtype=dtype, device=device)}
    shape = stack + (B, cfg.n_kv_heads, C, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _caches(cfg, B, cache_len, dtype, device) -> dict:
    """Empty caches of every cache key of the layout, keyed as the decode
    state keys them."""
    rows, windows = {}, {}
    for slot in layout(cfg):
        rows[slot.cache], windows[slot.cache] = slot.row + 1, slot.window
    return {key: _kv_cache(cfg, (n,), B, _capacity(windows[key], cache_len), dtype, device)
            for key, n in rows.items()}


def init_decode_state(cfg: ModelConfig, B: int, cache_len: int, dtype=torch.bfloat16, device=None) -> dict:
    """Empty caches for a decode run of ``cache_len`` total positions."""
    check_supported(cfg)
    return {"pos": 0, **_caches(cfg, B, cache_len, dtype, resolve_device(device))}


def _layer_cache(caches: dict, i: int, pos: int) -> dict:
    """Layer ``i``'s cache tensors (views, written in place) at ``pos``."""
    return {**{name: t[i] for name, t in caches.items()}, "pos": pos}


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor, state: dict):
    """One token per sequence: tokens [B,1] → (logits [B,1,V], new state)."""
    check_supported(cfg)
    pos = state["pos"]
    x = _embed(params, cfg, tokens)
    positions = torch.arange(pos, pos + 1, device=x.device)  # no host→device copy: no sync
    for lp, slot in _layers(params, cfg):
        x, _, _ = _block(lp, x, cfg, slot, "decode", positions, cache=_layer_cache(state[slot.cache], slot.row, pos))
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


def _store(cfg, caches: dict, i: int, kv) -> None:
    """Layer ``i``'s prompt keys and values (MLA: latents), ring-packed into
    its cache tensors."""
    for name, t in zip(_cache_names(cfg), kv):
        caches[name][i].copy_(_pack_kv(t, caches[name][i].shape[-2]))


@torch.no_grad()
def prefill(params, cfg: ModelConfig, batch: dict, cache_len: int, *, out: dict | None = None):
    """Run the prompt, return (last-token logits [B,1,V], decode state).

    Attention goes through the flash kernel once per layer (gemma2: once per
    sub-layer; MLA at dh = nq + nr, dv), and the MoE routes dropless.  The
    state is layout-identical to :func:`init_decode_state` (ring-packed
    caches in the activation dtype, written layer by layer into
    preallocated tensors), so ``decode_step`` continues from it.  ``out``
    (for a uniform stack: ``{"k", "v"}``, each indexable by layer, e.g. the
    host KV blocks of offloaded serving) takes the caches in place of new
    device tensors, one layer at a time.
    """
    check_supported(cfg)
    if out is not None:
        check_offload_scope(cfg)
    x = _embed(params, cfg, batch["tokens"])
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device)
    caches = {"layers": out} if out is not None else _caches(cfg, B, cache_len, x.dtype, x.device)
    for lp, slot in _layers(params, cfg):
        x, kv, _ = _block(lp, x, cfg, slot, "prefill", positions)
        _store(cfg, caches[slot.cache], slot.row, kv)
    return _unembed(params, cfg, x[:, -1:, :]), {"pos": S, **caches}
