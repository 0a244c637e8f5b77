"""The model stacks of the port: every family of the JAX package's
``models/transformer.py``, with the same public names and the same
parameter trees, where each stack's layers are slices of stacked tensors:

  dense / vlm    ``layers [L,…]``; the VLM also ``patch_proj [D, D]``, its
                 projected patches going before the token embeddings
  gemma2         ``layers [L/2, 2, …]``: sub-layer 0 local (window
                 ``cfg.window or 4096``), sub-layer 1 global, each with the
                 post-norms ``post1``/``post2``; the embedding scaled by √d
                 and the logits soft-capped by ``final_softcap``
  moe            ``dense_layers [nd,…]`` (``first_dense_layers``), then
                 ``layers [L-nd,…]`` with ``moe`` in place of ``mlp``
  ssm            ``layers [L,…]`` of Mamba-2 blocks ``{"mamba", "ln"}``
  hybrid         zamba2: Mamba groups ``groups [G, every, …]``, ONE attention
                 block ``shared_attn`` (unstacked) applied after each group,
                 then ``remainder [rem, …]`` Mamba blocks
  encdec         whisper: ``encoder [Le,…]`` (non-causal, rope on the frame
                 positions) and ``enc_norm``, then decoder ``layers [L,…]``
                 with the cross attention ``xattn`` and its norm ``lnx``

Where JAX scans over a stack, this module loops over the layers that
:func:`layout` lists in the order they run, Mamba blocks included, each
stack split into its layers once per call (``torch.unbind``: in a backward,
one stacking of the layers' gradients per stack).  ``forward`` trains:
under grad mode with ``remat`` each block runs under
``torch.utils.checkpoint`` (what the reference's ``jax.checkpoint(...,
nothing_saveable)`` over each scan body does), so the backward recomputes
it, flash attention included; ``prefill`` and ``decode_step`` run under
``torch.no_grad``.

``init_decode_state`` / ``prefill`` / ``decode_step`` share one state
layout: ``{"pos": int, <cache key>: …}``.  Attention layers keep ring caches
``{"k", "v": [n,B,Hkv,C,hd]}`` of capacity ``min(cache_len, window)`` for
windowed layers; gemma2 keys its caches ``local`` and ``global``; MLA keeps
the latents ``{"c_kv" [n,B,C,r_kv], "k_rope" [n,B,C,nr]}``; Mamba blocks
keep ``{"ssm" [*stack,B,H,P,N], "conv" [*stack,B,K−1,convdim]}`` (zamba2's
groups ``[G, every, …]``, its shared attention one cache row per
application, ``shared_attn [G,…]``); whisper's decoder keeps the encoder's
keys and values beside its own cache, ``enc_kv [L,B,Hkv,enc_len,hd]``.
``decode_step`` writes the new entries into the state's tensors in place
and returns the same tensors with ``pos + 1``.

The MoE routes dropless in prefill and in GQA decode, and at the capacity
factor in ``forward`` and in MLA decode: the reference's ``_scan_mla``
calls the MoE without ``full_capacity``, and the port does as it does.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.parallel import sharding as sh

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")
LOCAL_WINDOW = 4096  # gemma2's local window when the config gives none (the reference's default)


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a family the package does not know (the
    reference's ``init_params`` does the same); every one of its six is ported."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}, not one of {FAMILIES}")


def zamba_layout(cfg: ModelConfig) -> tuple[int, int, int]:
    """(groups, Mamba blocks a group, remainder) of the hybrid pattern."""
    g = cfg.attn_every
    n_groups = cfg.n_layers // g
    return n_groups, g, cfg.n_layers - n_groups * g


def stack_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """The leading (stack) dimensions of each block stack of the parameter
    tree, in the reference's order (zamba2's ``shared_attn`` is one block: ())."""
    check_supported(cfg)
    if cfg.family == "moe":
        nd = cfg.first_dense_layers
        return {**({"dense_layers": (nd,)} if nd else {}), "layers": (cfg.n_layers - nd,)}
    if cfg.family == "hybrid":
        G, every, rem = zamba_layout(cfg)
        return {"groups": (G, every), "shared_attn": (), **({"remainder": (rem,)} if rem else {})}
    if cfg.family == "encdec":
        return {"encoder": (cfg.encoder_layers,), "layers": (cfg.n_layers,)}
    if cfg.local_global:
        return {"layers": (cfg.n_layers // 2, 2)}
    return {"layers": (cfg.n_layers,)}


def _stack_kind(cfg: ModelConfig, name: str) -> str:
    """The blocks of stack ``name``: ``attn`` (attention + MLP), ``moe``
    (attention + MoE), ``mamba`` (a Mamba-2 mixer), ``cross`` (whisper's
    decoder block: self attention, cross attention, MLP) or ``encoder`` (an
    attention block without the causal mask)."""
    if cfg.family == "moe" and name == "layers":
        return "moe"
    if cfg.family == "ssm" or name in ("groups", "remainder"):
        return "mamba"
    if cfg.family == "encdec":
        return "cross" if name == "layers" else "encoder"
    return "attn"


class Slot(NamedTuple):
    """One block of the model, in run order: where its parameters and its
    cache are, and how it runs."""
    stack: str                          # its parameter stack
    at: int | tuple[int, int] | None    # its index there (gemma2, zamba2's groups: a pair); None: unstacked
    cache: str | None                   # the decode state's key of its cache (None: the encoder's, none)
    row: int | tuple[int, int]          # its index in that cache
    window: int | None
    kind: str                           # as ``_stack_kind``


def layout(cfg: ModelConfig) -> list[Slot]:
    """Every block of the decoder stacks of ``cfg``, in the order they run.
    gemma2's pair: sub-layer 0 local (window ``cfg.window or 4096``, cache
    ``local``), sub-layer 1 global (no window, cache ``global``).  zamba2:
    each group's Mamba blocks, then the shared attention block with the
    group's row of its cache, then the remainder.  (whisper's encoder runs
    before these, over the frames: ``_encode``.)"""
    check_supported(cfg)
    if cfg.local_global:
        subs = (("local", cfg.window or LOCAL_WINDOW), ("global", None))
        return [Slot("layers", (i, s), key, i, w, "attn")
                for i in range(cfg.n_layers // 2) for s, (key, w) in enumerate(subs)]
    if cfg.family == "hybrid":
        G, every, rem = zamba_layout(cfg)
        slots = []
        for g in range(G):
            slots += [Slot("groups", (g, i), "groups", (g, i), None, "mamba") for i in range(every)]
            slots.append(Slot("shared_attn", None, "shared_attn", g, cfg.window, "attn"))
        return slots + [Slot("remainder", i, "remainder", i, None, "mamba") for i in range(rem)]
    return [Slot(name, i, name, i, cfg.window, _stack_kind(cfg, name))
            for name, (n,) in stack_shapes(cfg).items() if name != "encoder" for i in range(n)]


def check_offload_scope(cfg: ModelConfig) -> None:
    """Caches that live outside the decode state (offloaded KV, prefill's
    ``out=``) take one uniform ``[L,…]`` stack of GQA layers, dense, MoE or
    VLM (the reference's scope, which it asserts): raise ``ValueError``,
    naming the reason, for any other layout.  Nothing falls back to
    resident decode."""
    why = None
    if cfg.family in ("ssm", "hybrid"):
        why = "Mamba blocks, whose SSM and conv states are no KV cache"
    elif cfg.family == "encdec":
        why = "an encoder-decoder's self and cross caches"
    elif cfg.local_global:
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


def _init_block(generator, cfg, stack, device, kind: str):
    if kind == "mamba":
        return {"mamba": S.init_mamba2(generator, cfg, stack, device=device),
                "ln": _norm_init(cfg, cfg.d_model, stack, device)}
    init_attn = L.init_mla if cfg.attn_type == "mla" else L.init_attention
    p = {"attn": init_attn(generator, cfg, stack, device=device)}
    if kind == "moe":
        p["moe"] = M.init_moe(generator, cfg, stack, device=device)
    else:
        p["mlp"] = L.init_mlp(generator, cfg, stack=stack, device=device)
    p["ln1"] = _norm_init(cfg, cfg.d_model, stack, device)
    p["ln2"] = _norm_init(cfg, cfg.d_model, stack, device)
    if cfg.local_global:  # gemma2's post-norms
        p["post1"] = _norm_init(cfg, cfg.d_model, stack, device)
        p["post2"] = _norm_init(cfg, cfg.d_model, stack, device)
    if kind == "cross":
        p["xattn"] = L.init_attention(generator, cfg, stack, device=device)
        p["lnx"] = _norm_init(cfg, cfg.d_model, stack, device)
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator, device=None) -> dict:
    """Random parameters, ``N(0, 0.02²)`` as the JAX package's ``init_params``
    (output projections scaled by 1/√L, norms 1, the Mamba mixers' value
    inits), drawn in a fixed order from ``generator``, which must live on
    ``device`` (``None`` → the card)."""
    dev = resolve_device(device)
    V, D = cfg.vocab_size, cfg.d_model
    params: dict[str, Any] = {"embed": L.normal(generator, (V, D), L.pdt(cfg), dev)}
    for name, stack in stack_shapes(cfg).items():
        params[name] = _init_block(generator, cfg, stack, dev, _stack_kind(cfg, name))
    if cfg.family == "vlm":
        params["patch_proj"] = L.normal(generator, (D, D), L.pdt(cfg), dev)
    if cfg.family == "encdec":
        params["enc_norm"] = _norm_init(cfg, D, (), dev)
    params["final_norm"] = _norm_init(cfg, D, (), dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = L.normal(generator, (D, V), L.pdt(cfg), dev)
    return params


def _norm_specs(cfg, stack):
    return L.rmsnorm_specs(stack) if cfg.act != "gelu" else L.layernorm_specs(stack)


def _block_specs(cfg, stack, kind: str) -> dict:
    """Logical axes of :func:`_init_block`'s tree, leaf for leaf."""
    if kind == "mamba":
        return {"mamba": S.mamba2_specs(stack), "ln": _norm_specs(cfg, stack)}
    s = {"attn": (L.mla_specs if cfg.attn_type == "mla" else L.attention_specs)(cfg, stack)}
    if kind == "moe":
        s["moe"] = M.moe_specs(cfg, stack)
    else:
        s["mlp"] = L.mlp_specs(cfg, stack)
    s["ln1"] = s["ln2"] = _norm_specs(cfg, stack)
    if cfg.local_global:
        s["post1"] = s["post2"] = _norm_specs(cfg, stack)
    if kind == "cross":
        s["xattn"] = L.attention_specs(cfg, stack)
        s["lnx"] = _norm_specs(cfg, stack)
    return s


def param_specs(cfg: ModelConfig) -> dict:
    """The logical axes of every leaf of :func:`init_params`'s tree (a tuple
    a leaf, one entry a dimension): the spec tree the JAX package's
    ``init_params`` returns beside its parameters, which
    :mod:`repro_torch.parallel.sharding` maps to a mesh."""
    specs: dict[str, Any] = {"embed": ("vocab", "fsdp")}
    for name, stack in stack_shapes(cfg).items():
        specs[name] = _block_specs(cfg, stack, _stack_kind(cfg, name))
    if cfg.family == "vlm":
        specs["patch_proj"] = ("fsdp", None)
    if cfg.family == "encdec":
        specs["enc_norm"] = _norm_specs(cfg, ())
    specs["final_norm"] = _norm_specs(cfg, ())
    if not cfg.tie_embeddings:
        specs["lm_head"] = ("fsdp", "vocab")
    return specs


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


def _attend(p, h, cfg, *, positions, window, causal=True, cache=None, return_kv=False):
    if cfg.attn_type == "mla":
        return L.mla_attention(p, h, cfg, positions=positions, cache=cache, return_kv=return_kv)
    return L.attention(p, h, cfg, positions=positions, window=window, causal=causal, cache=cache,
                       return_kv=return_kv)


def _cross_attention(p, x, cfg, enc):
    """whisper's cross attention: queries from the decoder, keys and values
    from the encoder's output ``enc [B,Se,D]`` (prefill, ``forward``: through
    the flash kernel, non-causal, Sq ≠ Skv; over a mesh, on each process's
    rows and heads: :func:`~repro_torch.models.layers.attend`) or
    from their cache ``enc = {"k", "v"}`` (decode: the plain decode
    attention).  No positions, no mask → (out, (k, v))."""
    adt = x.dtype
    x = sh.constrain(x, "batch", None, None)
    q = L.proj(x, p["wq"].to(adt)).transpose(1, 2)
    if isinstance(enc, dict):
        k, v = enc["k"], enc["v"]
        every = torch.ones((x.shape[0], k.shape[2]), dtype=torch.bool, device=x.device)
        o = L.decode_attention(q, k, v, every, softcap=cfg.attn_softcap)
    else:
        k = L.proj(enc, p["wk"].to(adt)).transpose(1, 2)
        v = L.proj(enc, p["wv"].to(adt)).transpose(1, 2)
        o = L.attend(sh.constrain(q, "batch", "heads", None, None), k, v, causal=False, window=None,
                     softcap=cfg.attn_softcap)
    B, H, Sq, hd = o.shape
    out = o.to(adt).transpose(1, 2).reshape(B, Sq, H * hd) @ p["wo"].to(adt).reshape(H * hd, -1)
    return sh.constrain(out, "batch", None, None), (k, v)


def _block(p, x, cfg, slot: Slot, mode: str, positions, cache=None, enc=None):
    """One block in ``mode`` (``forward``, ``prefill`` or ``decode``) → (x,
    what prefill stores, the MoE's aux loss or ``None``).

    A Mamba block is its mixer, pre-normed, before its residual add; with a
    cache it steps the states in place, and in prefill it returns them.  An
    attention block is the attention (non-causal in the encoder), whisper's
    cross attention over ``enc`` (decoder blocks), then the MLP or the MoE,
    each pre-normed (gemma2: post-normed too) before its residual add; in
    prefill it returns its keys and values (whisper: with the cross
    attention's).  The MoE routes dropless in prefill and in GQA decode (the
    reference's ``_apply_moe_block`` sets ``full_capacity`` with a cache), at
    the capacity factor in ``forward`` and in MLA decode (its ``_scan_mla``
    does not)."""
    if slot.kind == "mamba":
        y, state = S.mamba2_block(p["mamba"], _norm_apply(cfg, x, p["ln"]), cfg, cache=cache,
                                  return_state=mode == "prefill")
        return x + y, state, None
    h = _norm_apply(cfg, x, p["ln1"])
    a, kv = _attend(p["attn"], h, cfg, positions=positions, window=slot.window, causal=slot.kind != "encoder",
                    cache=cache, return_kv=mode == "prefill")
    if "post1" in p:
        a = _norm_apply(cfg, a, p["post1"])
    x = x + a
    if slot.kind == "cross":
        a, enc_kv = _cross_attention(p["xattn"], _norm_apply(cfg, x, p["lnx"]), cfg, enc)
        x = x + a
        kv = (kv, enc_kv)
    h = _norm_apply(cfg, x, p["ln2"])
    aux = None
    if slot.kind == "moe":
        full = mode == "prefill" or (mode == "decode" and cfg.attn_type != "mla")
        m, aux = M.moe(p["moe"], h, cfg, full_capacity=full)
    else:
        m = L.mlp(p["mlp"], h, cfg)
    if "post2" in p:
        m = _norm_apply(cfg, m, p["post2"])
    return x + m, kv, aux


def _unbound(stacked: Any, depth: int) -> Any:
    """A stacked tree with each leaf split along its ``depth`` stack
    dimensions into nested tuples of views."""
    if isinstance(stacked, dict):
        return {k: _unbound(v, depth) for k, v in stacked.items()}
    parts = torch.unbind(stacked, 0)
    return parts if depth == 1 else tuple(_unbound(x, depth - 1) for x in parts)


def _pick(unbound: Any, at: int | tuple[int, int]) -> Any:
    """Entry ``at`` of an :func:`_unbound` tree."""
    if isinstance(unbound, dict):
        return {k: _pick(v, at) for k, v in unbound.items()}
    return unbound[at] if isinstance(at, int) else unbound[at[0]][at[1]]


def _layers(params, cfg, slots=None):
    """(block parameters (views), slot) of every block of ``slots`` (the
    decoder's :func:`layout` by default), in order."""
    split = {}
    for s in layout(cfg) if slots is None else slots:
        if s.at is None:
            yield params[s.stack], s
            continue
        if s.stack not in split:
            split[s.stack] = _unbound(params[s.stack], 1 if isinstance(s.at, int) else 2)
        yield _pick(split[s.stack], s.at), s


def _forward_block(lp, x, cfg, slot, positions, enc, remat):
    """One block of ``forward`` → (x, the MoE's aux or ``None``); under grad
    mode with ``remat``, checkpointed: its activations are recomputed in
    the backward instead of kept."""
    def run(lp, x, enc):
        y, _, aux = _block(lp, x, cfg, slot, "forward", positions, enc=enc)
        return sh.constrain(y, "batch", "act_seq", None), aux

    if remat and torch.is_grad_enabled():
        return checkpoint(run, lp, x, enc, use_reentrant=False, preserve_rng_state=False)
    return run(lp, x, enc)


def _embed(params, cfg, tokens):
    """Rows of the table, then cast: the same numbers as casting the table
    first (elementwise), without a table-sized temporary per call.  gemma2
    scales by √d rounded to the activation dtype, as JAX multiplies.  Over
    a mesh, :func:`_mesh_embed` of the cast table."""
    if sh.is_distributed(tokens):  # the table cast first: the same numbers, half the bytes to gather
        x = _mesh_embed(params["embed"].to(L.dt(cfg)), tokens)
    else:
        x = params["embed"][tokens].to(L.dt(cfg))
    if cfg.local_global:
        x = x * float(torch.tensor(cfg.d_model**0.5, dtype=x.dtype))
    return sh.constrain(x, "batch", None, None)


def _mesh_embed(table, tokens):
    """The rows of a ``DTensor`` table ``[V, D]`` for ``DTensor`` tokens:
    the table gathered over its ``fsdp`` axes, then each process looks up
    the tokens of its batch rows in its own block of the vocabulary (rows
    outside it are zeros), and the blocks' rows are summed over the
    ``vocab`` axes by the caller's layout (each token's row comes from one
    block, so the sum is exact).  The table's gradient is each process's
    rows' part, summed over the batch axes."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    t_pl = sh.placements(sh.spec_for("vocab", None), mesh)
    tok_pl = sh.placements(sh.spec_for("batch", None), mesh)
    vocab_axes = {sh.axis_names(mesh).index(a) for a in sh.entry_axes(sh.spec_for("vocab")[0])}
    out_pl = tuple(Partial() if m in vocab_axes else p for m, p in enumerate(tok_pl))
    # each process's gradient of the table holds its own rows' tokens alone: partial over the batch axes
    t_grad = tuple(Partial() if tp.is_shard() and not p.is_shard() else p for tp, p in zip(tok_pl, t_pl))

    def lookup(t, ids):
        # this process's vocabulary block [lo, lo + n)
        n = t.shape[0]
        lo = sh.block_start(mesh, vocab_axes, n)
        inside = (ids >= lo) & (ids < lo + n)
        rows = t[torch.where(inside, ids - lo, 0)]
        return torch.where(inside[..., None], rows, 0).to(t.dtype)

    return local_map(lookup, out_placements=list(out_pl), in_placements=(t_pl, tok_pl),
                     in_grad_placements=(t_grad, tok_pl), device_mesh=mesh, redistribute_inputs=True)(table, tokens)


def _inputs(params, cfg, batch):
    """The decoder's input sequence: the token embeddings, after the
    projected ``patches [B,P,D]`` where a VLM batch has them."""
    x = _embed(params, cfg, batch["tokens"])
    if cfg.family == "vlm" and "patches" in batch:
        adt = L.dt(cfg)
        x = torch.cat([batch["patches"].to(adt) @ params["patch_proj"].to(adt), x], dim=1)
    return x


def _encode(params, cfg, batch, remat: bool = False):
    """whisper's encoder over ``batch["frames"] [B,Se,D]`` (the stub
    frontend's output): non-causal blocks with rope on the frame positions,
    then ``enc_norm``; ``remat`` as in :func:`forward`."""
    if "frames" not in batch:
        raise ValueError(f"{cfg.name}: the encoder-decoder family needs batch['frames'] [B, frames, d_model] "
                         f"beside the tokens")
    e = batch["frames"].to(L.dt(cfg))
    positions = torch.arange(e.shape[1], device=e.device)
    slots = [Slot("encoder", i, None, i, None, "encoder") for i in range(cfg.encoder_layers)]  # no cache
    for lp, slot in _layers(params, cfg, slots):
        e, _ = _forward_block(lp, e, cfg, slot, positions, None, remat)
    # over a mesh, whole frame sequences once for every decoder layer's cross attention
    return sh.constrain(_norm_apply(cfg, e, params["enc_norm"]), "batch", None, None)


def _unembed(params, cfg, x):
    x = sh.constrain(_norm_apply(cfg, x, params["final_norm"]), "batch", None, None)
    table = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    # over a mesh: the table gathered over its fsdp axes, so the logits come out split by
    # batch and vocabulary, never as partial sums over the batch axes
    logits = (x @ sh.constrain(table.to(x.dtype), None, "vocab")).float()
    if cfg.final_softcap:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return sh.constrain(logits, "batch", None, "vocab")


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def forward(params, cfg: ModelConfig, batch: dict, *, remat: bool = True):
    """batch: ``tokens`` (+ ``frames`` for whisper, ``patches`` for a VLM) →
    (logits [B,S,V] fp32, aux_loss fp32: the MoE layers' load-balancing
    losses summed, 0 without them).  Differentiable: with grad mode on and
    ``remat``, every block (the encoder's too) is checkpointed; attention
    runs the flash kernel's forward once per layer, and again where the
    backward recomputes the block."""
    x = _inputs(params, cfg, batch)
    enc = _encode(params, cfg, batch, remat) if cfg.family == "encdec" else None
    positions = torch.arange(x.shape[1], device=x.device)
    auxes = []
    for lp, slot in _layers(params, cfg):
        x, a = _forward_block(lp, x, cfg, slot, positions, enc, remat)
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


def cache_stacks(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """The leading (stack) dimensions of each cache of the decode state, by its key."""
    stacks = {}
    for slot in layout(cfg):
        row = slot.row if isinstance(slot.row, tuple) else (slot.row,)
        lead = stacks.get(slot.cache, (0,) * len(row))
        stacks[slot.cache] = tuple(max(n, r + 1) for n, r in zip(lead, row))
    if cfg.family == "encdec":
        stacks["enc_kv"] = (cfg.n_layers,)
    return stacks


def _caches(cfg, B, cache_len, dtype, device, enc_len: int = 0) -> dict:
    """Empty caches of every cache key of the layout, keyed as the decode
    state keys them."""
    kinds, windows = {}, {}
    for slot in layout(cfg):
        kinds[slot.cache], windows[slot.cache] = slot.kind, slot.window
    caches = {}
    for key, stack in cache_stacks(cfg).items():
        if key == "enc_kv":
            caches[key] = _kv_cache(cfg, stack, B, enc_len, dtype, device)
        elif kinds[key] == "mamba":
            caches[key] = S.init_ssm_cache(cfg, B, dtype, device, stack)
        else:
            caches[key] = _kv_cache(cfg, stack, B, _capacity(windows[key], cache_len), dtype, device)
    return caches


def init_decode_state(cfg: ModelConfig, B: int, cache_len: int, dtype=torch.bfloat16, device=None,
                      enc_len: int = 0) -> dict:
    """Empty caches for a decode run of ``cache_len`` total positions
    (whisper: and ``enc_len`` encoder frames)."""
    return {"pos": 0, **_caches(cfg, B, cache_len, dtype, resolve_device(device), enc_len)}


def cache_specs(cfg: ModelConfig) -> dict:
    """The logical axes of the decode state's tensors, key for key as
    :func:`init_decode_state` makes them (``pos``, a python int, has ``()``)."""
    kinds = {slot.cache: slot.kind for slot in layout(cfg)}
    specs: dict[str, Any] = {"pos": ()}
    for key, stack in cache_stacks(cfg).items():
        lead = ("layers",) * len(stack)
        if key == "enc_kv":
            specs[key] = {n: lead + ("kv_batch", "kv_heads", "enc_seq", None) for n in ("k", "v")}
        elif kinds[key] == "mamba":
            specs[key] = {"ssm": lead + ("kv_batch", "ssm_heads", None, None),
                          "conv": lead + ("kv_batch", None, "mlp")}
        elif cfg.attn_type == "mla":
            specs[key] = {n: lead + ("kv_batch", "kv_seq", None) for n in ("c_kv", "k_rope")}
        else:
            specs[key] = {n: lead + ("kv_batch", "kv_heads", "kv_seq", None) for n in ("k", "v")}
    return specs


def batch_specs(cfg: ModelConfig, with_labels: bool = True) -> dict:
    """The logical axes of a batch: ``tokens`` (and ``labels``), whisper's
    ``frames``, a VLM's ``patches``."""
    s: dict[str, Any] = {"tokens": ("batch", None)}
    if with_labels:
        s["labels"] = ("batch", None)
    if cfg.family == "encdec":
        s["frames"] = ("batch", None, None)
    if cfg.family == "vlm":
        s["patches"] = ("batch", None, None)
    return s


def _slot_cache(state: dict, slot: Slot, pos: int) -> dict:
    """A block's cache tensors (views, written in place); an attention
    layer's at ``pos``."""
    views = {name: t[slot.row] for name, t in state[slot.cache].items()}
    return views if slot.kind == "mamba" else {**views, "pos": pos}


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor, state: dict):
    """One token per sequence: tokens [B,1] → (logits [B,1,V], new state).
    whisper's cross attention reads the encoder's keys and values that its
    prefill left in ``state["enc_kv"]``."""
    pos = state["pos"]
    if "enc_kv" in state and state["enc_kv"]["k"].shape[-2] == 0:
        raise ValueError(f"{cfg.name}: the decode state holds no encoder frames: prefill with batch['frames'] "
                         f"first")
    x = _embed(params, cfg, tokens)
    positions = torch.arange(pos, pos + 1, device=x.device)  # no host→device copy: no sync
    for lp, slot in _layers(params, cfg):
        enc = {n: t[slot.row] for n, t in state["enc_kv"].items()} if slot.kind == "cross" else None
        x, _, _ = _block(lp, x, cfg, slot, "decode", positions, cache=_slot_cache(state, slot, pos), enc=enc)
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


def _put(cfg, cache: dict, row, kv) -> None:
    """One layer's prompt keys and values (MLA: latents), ring-packed into
    row ``row`` of its cache tensors."""
    for name, t in zip(_cache_names(cfg), kv):
        cache[name][row].copy_(_pack_kv(t, cache[name][row].shape[-2]))


def _store(cfg, caches: dict, slot: Slot, new) -> None:
    """What a block's prefill returned, into its rows of the caches: a Mamba
    block's states (cast to the caches' dtype), an attention layer's keys
    and values, a whisper decoder block's also into ``enc_kv``."""
    if slot.kind == "mamba":
        for name, t in new.items():
            caches[slot.cache][name][slot.row].copy_(t)
        return
    if slot.kind == "cross":
        new, enc_kv = new
        _put(cfg, caches["enc_kv"], slot.row, enc_kv)
    _put(cfg, caches[slot.cache], slot.row, new)


@torch.no_grad()
def prefill(params, cfg: ModelConfig, batch: dict, cache_len: int, *, out: dict | None = None):
    """Run the prompt (batch as for :func:`forward`), return (last-position
    logits [B,1,V], decode state with ``pos`` the input's length: a VLM's
    patches and tokens).

    Attention goes through the flash kernel once per layer (gemma2: once per
    sub-layer; MLA at dh = nq + nr, dv; zamba2 once per application of its
    shared block; whisper once per encoder layer, and twice per decoder
    layer: causal self attention, non-causal cross attention), and the MoE
    routes dropless.  The state is layout-identical to
    :func:`init_decode_state` (ring-packed caches and the Mamba states in the
    activation dtype, written block by block into preallocated tensors), so
    ``decode_step`` continues from it.  ``out`` (for a uniform stack:
    ``{"k", "v"}``, each indexable by layer, e.g. the host KV blocks of
    offloaded serving) takes the caches in place of new device tensors, one
    layer at a time.  A prompt shorter than a Mamba block's conv state
    (``d_conv − 1`` tokens) raises ``ValueError``.
    """
    if out is not None:
        check_offload_scope(cfg)
    x = _inputs(params, cfg, batch)
    B, Sx = x.shape[:2]
    slots = layout(cfg)
    if Sx < cfg.d_conv - 1 and any(s.kind == "mamba" for s in slots):
        raise ValueError(f"{cfg.name}: a prompt of {Sx} tokens is shorter than the Mamba blocks' conv state "
                         f"(d_conv − 1 = {cfg.d_conv - 1} inputs): prefill cannot fill it")
    enc = _encode(params, cfg, batch) if cfg.family == "encdec" else None
    positions = torch.arange(Sx, device=x.device)
    caches = ({"layers": out} if out is not None
              else _caches(cfg, B, cache_len, x.dtype, x.device, 0 if enc is None else enc.shape[1]))
    for lp, slot in _layers(params, cfg, slots):
        x, new, _ = _block(lp, x, cfg, slot, "prefill", positions, enc=enc)
        _store(cfg, caches, slot, new)
    return _unembed(params, cfg, x[:, -1:, :]), {"pos": Sx, **caches}
