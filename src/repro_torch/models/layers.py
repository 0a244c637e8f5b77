"""Core layers in PyTorch: norms, rotary, attention (GQA and MLA), MLP.

The JAX package's ``models/layers.py`` with the same public names, layouts
and rounding points:

* parameters are plain tensors in ``cfg.param_dtype``, cast to the
  activation dtype ``cfg.dtype`` where they are used;
* activations run in ``cfg.dtype`` (bf16 on the card), softmax statistics
  and norm reductions in fp32;
* attention never forms S×S: the prefill and the training forward go
  through :class:`FlashAttentionFn` — :func:`flash_attention` (the
  hand-written CUDA kernel on the card, its plain version on the CPU), with
  a backward that recomputes the plain blocked softmax one query block at
  a time — the decode through :func:`decode_attention` over the cache.

The reference's layout hints are here at the same points and logical
axes (:func:`repro_torch.parallel.sharding.constrain`): the identity on one
device; over a ``DeviceMesh`` the ``DTensor`` activations are
redistributed to them, and the flash kernel runs on each process's local
heads (:func:`mesh_attention`).  MLA (DeepSeek-V2) prefills through the
same flash kernel (dh = nq + nr, dv) and decodes in the absorbed form over
its latent cache.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import BLOCK_Q, NEG, attend_rows
from repro_torch.parallel import sharding as sh


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


def stacked(stack: tuple, spec_tree):
    """Prepend one replicated ``"layers"`` axis a stack dimension to every
    logical-axis tuple of ``spec_tree``: the specs of the ``init_*`` of the
    same ``stack``."""
    pre = ("layers",) * len(stack)
    if isinstance(spec_tree, dict):
        return {k: stacked(stack, v) for k, v in spec_tree.items()}
    return pre + spec_tree


def init_rmsnorm(d, cfg, stack: tuple = (), *, device) -> torch.Tensor:
    return ones(stack + (d,), pdt(cfg), device)


def rmsnorm_specs(stack: tuple = ()):
    return stacked(stack, ("embed",))


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Variance in fp32, then ``x · inv · scale`` in ``x``'s dtype."""
    var = x.float().square().mean(-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * scale.to(x.dtype)


def init_layernorm(d, cfg, stack: tuple = (), *, device) -> dict:
    return {"scale": ones(stack + (d,), pdt(cfg), device), "bias": zeros(stack + (d,), pdt(cfg), device)}


def layernorm_specs(stack: tuple = ()) -> dict:
    return stacked(stack, {"scale": ("embed",), "bias": ("embed",)})


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
    cos, sin = sh.replicated_like(torch.cos(ang), x), sh.replicated_like(torch.sin(ang), x)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.stack([y1, y2], dim=-1).reshape(x.shape).to(x.dtype)


def proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum('bsd,d...->bs...')`` as one matmul."""
    return (x @ w.reshape(w.shape[0], -1)).reshape(*x.shape[:-1], *w.shape[1:])


# ---------------------------------------------------------------------------
# trainable attention: the kernel forward, a blocked recompute backward
# ---------------------------------------------------------------------------


def _flash_backward(q, k, v, do, *, causal, window, softcap, scale):
    """dq, dk, dv of the plain blocked attention (``flash_attention_jnp``'s
    function, as ``jax.grad`` differentiates it): per query block of 512,
    its rows recomputed under autograd from fp32 copies of q, k and v (``p``
    still rounded to v's dtype) and ``do``'s rows backpropagated; dk and dv
    summed over the blocks in fp32.  One query block's graph lives until
    its ``autograd.grad``: a few fp32 ``[B,Hq,512,1024]`` score tensors for
    each key block it sees, so several times ``[B,Hq,512,Skv]`` in all.
    Key blocks that the mask hides from a whole query block are skipped
    (bitwise the same function)."""
    B, Hq, Sq, dh = q.shape
    Hkv, Skv, dv = k.shape[1], k.shape[2], v.shape[3]
    G = Hq // Hkv
    scale = dh**-0.5 if scale is None else scale
    qg = q.detach().reshape(B, Hkv, G, Sq, dh)
    dog = do.reshape(B, Hkv, G, Sq, dv)
    dq = torch.empty((B, Hkv, G, Sq, dh), dtype=torch.float32, device=q.device)
    with torch.enable_grad():
        kf = k.detach().float().requires_grad_()
        vf = v.detach().float().requires_grad_()
        dk, dvv = torch.zeros_like(kf), torch.zeros_like(vf)
        for q0 in range(0, Sq, BLOCK_Q):
            qb = qg[:, :, :, q0:q0 + BLOCK_Q].float().detach().requires_grad_()
            n = qb.shape[3]
            o = attend_rows(qb, kf, vf, q0, causal=causal, window=window, softcap=softcap, scale=scale,
                            offset=Skv - Sq, p_dtype=v.dtype, skip_masked=True)
            gq, gk, gv = torch.autograd.grad(o, (qb, kf, vf), dog[:, :, :, q0:q0 + n].float())
            dq[:, :, :, q0:q0 + n] = gq
            dk += gk
            dvv += gv
    return dq.reshape(B, Hq, Sq, dh).to(q.dtype), dk.to(k.dtype), dvv.to(v.dtype)


class FlashAttentionFn(torch.autograd.Function):
    """Attention that trains: the forward is :func:`flash_attention` as it
    is (the kernel on the card, with its launches and values; the plain
    version on the CPU) and saves q, k and v; the backward is
    :func:`_flash_backward`.  With grad mode off, or no input requiring a
    gradient, ``apply`` is that forward alone, launches included, and
    builds no graph.  The JAX package trains through ``flash_attention_jnp``
    and has no backward kernel either."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale):
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap, scale=scale)
        return flash_attention(q, k, v, **ctx.opts)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        return (*_flash_backward(q, k, v, do, **ctx.opts), None, None, None, None)


def _kv_heads_of(h0: int, h1: int, G: int) -> slice:
    """The key/value heads that query heads ``[h0, h1)`` of a kv-major GQA
    layout read (query head h reads kv head h // G): the range must lie
    inside one group or cover whole groups."""
    first, last = h0 // G, (h1 - 1) // G
    if first != last and (h0 % G or h1 % G):
        raise ValueError(f"query heads [{h0}, {h1}) hold parts of the groups {first}..{last} of {G}: the heads "
                         f"split over the model axis must align with the GQA groups")
    return slice(first, last + 1)


def mesh_attention(q, k, v, *, causal: bool, window: int | None, softcap: float | None, scale=None,
                   kv_heads: str = "kv_heads"):
    """:class:`FlashAttentionFn` over a ``DeviceMesh``: ``q [B,Hq,S,dh]``,
    ``k``, ``v [B,Hkv,S,·]`` are ``DTensor``s, and each process runs the
    kernel (forward and blocked backward) on its local rows of the batch
    and its local query heads, inside ``local_map``.

    The layout: the batch over ``batch``'s axes, the query heads over
    ``heads``' (``model``), the key and value heads over ``kv_heads``'
    where they divide it.  Where they do not (the rules then pick the
    reference's ``q_per_kv`` or split-Q ``attn_q`` layout inside its
    blocked attention), they are replicated over ``model`` and each process
    takes the kv heads its own query heads read; their gradients are then
    partial over ``model`` and summed there.  Every input is redistributed
    to this layout first, and the output goes back to the ``heads``
    layout.  ``kv_heads`` names the logical axis of k's and v's heads: MLA,
    whose keys and values are expanded to one a query head (G = 1), passes
    ``"heads"``, so each process takes its own query heads' keys.  Each
    process runs the same operations on its own block, so the collectives
    of the backward line up across processes."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    names = sh.axis_names(mesh)
    heads, kv_heads = sh.spec_for("heads")[0], sh.spec_for(kv_heads)[0]
    if heads is None:
        kv_heads = None
    G = q.shape[1] // k.shape[1]
    q_pl = sh.placements(sh.spec_for("batch", "heads", None, None), mesh)
    kv_pl = sh.placements((sh.spec_for("batch")[0], kv_heads, None, None), mesh)
    # replicated kv heads that each process reads in part: a partial gradient
    split = {names.index(a) for a in sh.entry_axes(heads)} - {names.index(a) for a in sh.entry_axes(kv_heads)}
    kv_grad = tuple(Partial() if m in split else p for m, p in enumerate(kv_pl))
    at = sh.block_start(mesh, split, 1)

    def local(ql, kl, vl):
        if split:
            pick = _kv_heads_of(at * ql.shape[1], (at + 1) * ql.shape[1], G)
            kl, vl = kl[:, pick], vl[:, pick]
        return FlashAttentionFn.apply(ql, kl, vl, causal, window, softcap, scale)

    run = local_map(local, out_placements=list(q_pl), in_placements=(q_pl, kv_pl, kv_pl),
                    in_grad_placements=(q_pl, kv_grad, kv_grad), device_mesh=mesh, redistribute_inputs=True)
    q, k, v = (sh.contiguous_grad(t) for t in (q, k, v))
    return run(q, k, v)


def attend(q, k, v, *, causal: bool, window: int | None, softcap: float | None, scale=None,
           kv_heads: str = "kv_heads"):
    """The attention of a layer's forward (prefill, training):
    :class:`FlashAttentionFn` on plain tensors, :func:`mesh_attention` on
    ``DTensor``s."""
    if sh.is_distributed(q):
        return mesh_attention(q, k, v, causal=causal, window=window, softcap=softcap, scale=scale, kv_heads=kv_heads)
    return FlashAttentionFn.apply(q, k, v, causal, window, softcap, scale)


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


def attention_specs(cfg: ModelConfig, stack: tuple = ()) -> dict:
    """Logical axes of :func:`init_attention`'s tree, leaf for leaf."""
    s = {"wq": ("fsdp", "heads", None), "wk": ("fsdp", "kv_heads", None), "wv": ("fsdp", "kv_heads", None),
         "wo": ("heads", None, "fsdp")}
    if cfg.qk_norm:
        s["q_norm"] = (None,)
        s["k_norm"] = (None,)
    return stacked(stack, s)


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
    x = sh.constrain(x, "batch", None, None)  # whole sequences into the projections (sequence parallelism's gather)
    q = proj(x, params["wq"].to(adt)).transpose(1, 2)
    k = proj(x, params["wk"].to(adt)).transpose(1, 2)
    v = proj(x, params["wv"].to(adt)).transpose(1, 2)  # a strided view: the kernel reads its strides
    if cfg.qk_norm:
        q = rmsnorm(q, params["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, params["k_norm"], cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    q = sh.constrain(q, "batch", "heads", None, None)

    if cache is None:
        o = attend(q, k, v, causal=causal, window=window, softcap=cfg.attn_softcap)
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
    return sh.constrain(out, "batch", None, None), new_cache


# ---------------------------------------------------------------------------
# MLA attention (DeepSeek-V2): latent-compressed KV
# ---------------------------------------------------------------------------


def init_mla(generator, cfg: ModelConfig, stack: tuple = (), *, device) -> dict:
    D, H = cfg.d_model, cfg.n_heads
    nq, nr, dv, r_kv, r_q = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim, cfg.kv_lora_rank, cfg.q_lora_rank
    pt = pdt(cfg)
    return {
        "wq_a": normal(generator, stack + (D, r_q), pt, device),
        "q_norm": ones(stack + (r_q,), pt, device),
        "wq_b": normal(generator, stack + (r_q, H, nq + nr), pt, device),
        "wkv_a": normal(generator, stack + (D, r_kv + nr), pt, device),
        "kv_norm": ones(stack + (r_kv,), pt, device),
        "wk_b": normal(generator, stack + (r_kv, H, nq), pt, device),
        "wv_b": normal(generator, stack + (r_kv, H, dv), pt, device),
        "wo": normal(generator, stack + (H, dv, D), pt, device, scale=0.02 / max(1, cfg.n_layers) ** 0.5),
    }


def mla_specs(cfg: ModelConfig, stack: tuple = ()) -> dict:
    """Logical axes of :func:`init_mla`'s tree, leaf for leaf."""
    return stacked(stack, {"wq_a": ("fsdp", None), "q_norm": (None,), "wq_b": (None, "heads", None),
                           "wkv_a": ("fsdp", None), "kv_norm": (None,), "wk_b": (None, "heads", None),
                           "wv_b": (None, "heads", None), "wo": ("heads", None, "fsdp")})


def mla_attention(
    params: dict,
    x: torch.Tensor,            # [B,S,D]
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,    # [S]
    cache: dict | None = None,  # decode: {"c_kv" [B,C,r_kv], "k_rope" [B,C,nr], "pos" int}
    return_kv: bool = False,    # prefill: emit (c_kv [B,S,r_kv], k_rope [B,S,nr])
):
    """→ ``(out [B,S,D], new_cache)``.

    Prefill expands the latents into per-head keys and values and sends
    ``[q_nope, q_rope]`` (dh = nq + nr) and ``v`` (dv) through the flash
    kernel, with ``k_rope`` shared by the heads.  Decode is the absorbed
    form: scores against the latent cache (``q_nope·wk_b`` against ``c_kv``
    plus ``q_rope`` against ``k_rope``), softmax and the latent output in
    plain PyTorch, then ``wv_b``.  The decode cache is no ring: the new
    latent goes to slot ``pos`` in place, which must lie inside the cache.
    """
    adt = x.dtype
    H, nq, nr, r = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.kv_lora_rank
    scale = (nq + nr) ** -0.5
    x = sh.constrain(x, "batch", None, None)  # whole sequences into the projections

    qa = rmsnorm(x @ params["wq_a"].to(adt), params["q_norm"], cfg.norm_eps)
    q = proj(qa, params["wq_b"].to(adt)).transpose(1, 2)  # [B,H,S,nq+nr]
    q_nope = q[..., :nq]
    q_rope = rope(q[..., nq:], positions, cfg.rope_theta)

    kv = x @ params["wkv_a"].to(adt)  # [B,S,r+nr]
    c_kv = rmsnorm(kv[..., :r], params["kv_norm"], cfg.norm_eps)
    k_rope = rope(kv[..., None, r:].transpose(1, 2), positions, cfg.rope_theta)  # [B,1,S,nr]

    if cache is None:
        B, _, S, _ = q.shape
        k_nope = proj(c_kv, params["wk_b"].to(adt)).transpose(1, 2)  # [B,H,S,nq]
        v = proj(c_kv, params["wv_b"].to(adt)).transpose(1, 2)  # a strided view: the kernel reads its strides
        # over a mesh, each process's heads of both halves (of the shared k_rope, a local slice)
        k_nope, k_rope_h = (sh.constrain(t, "batch", "heads", None, None)
                            for t in (k_nope, k_rope.expand(B, H, S, nr)))
        k = torch.cat([k_nope, k_rope_h], dim=-1)  # contiguous, k_rope copied per head
        o = attend(torch.cat([q_nope, q_rope], dim=-1), k, v, causal=True, window=None, softcap=None, scale=scale,
                   kv_heads="heads")
        new_cache = (c_kv, k_rope[:, 0]) if return_kv else None
    else:
        ck, kr, pos = cache["c_kv"], cache["k_rope"], cache["pos"]
        if not 0 <= pos < ck.shape[1]:
            raise ValueError(f"MLA decode at position {pos} outside its cache of {ck.shape[1]}: the latent "
                             f"cache is no ring, so cache_len must cover every position")
        ck[:, pos] = c_kv[:, 0]
        kr[:, pos] = k_rope[:, 0, 0]
        q_c = torch.einsum("bhsk,rhk->bhsr", q_nope, params["wk_b"].to(adt))  # [B,H,1,r]
        s_c = torch.einsum("bhsr,btr->bhst", q_c, ck)
        s_r = torch.einsum("bhsk,btk->bhst", q_rope, kr)
        s = (s_c + s_r).float() * scale
        valid = torch.arange(ck.shape[1], device=x.device) <= pos
        s = torch.where(valid, s, NEG)
        p = torch.softmax(s, dim=-1).to(adt)
        o_lat = torch.einsum("bhst,btr->bhsr", p, ck)
        o = torch.einsum("bhsr,rhk->bhsk", o_lat, params["wv_b"].to(adt))
        new_cache = {"c_kv": ck, "k_rope": kr, "pos": pos + 1}

    B, H, S, dv = o.shape
    out = o.to(adt).transpose(1, 2).reshape(B, S, H * dv) @ params["wo"].to(adt).reshape(H * dv, -1)
    return sh.constrain(out, "batch", None, None), new_cache


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


def mlp_specs(cfg: ModelConfig, stack: tuple = ()) -> dict:
    """Logical axes of :func:`init_mlp`'s tree, leaf for leaf."""
    s = {"w1": ("fsdp", "mlp"), "w2": ("mlp", "fsdp")}
    if cfg.act != "gelu":
        s["w3"] = ("fsdp", "mlp")
    return stacked(stack, s)


def mlp(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    adt = x.dtype
    x = sh.constrain(x, "batch", None, None)  # whole sequences into the projections
    if "w3" in params:
        h = F.silu(proj(x, params["w1"].to(adt))) * proj(x, params["w3"].to(adt))
    else:
        h = F.gelu(proj(x, params["w1"].to(adt)), approximate="tanh")  # jax.nn.gelu's default
    h = sh.constrain(h, "batch", None, "mlp")
    return sh.constrain(h @ params["w2"].to(adt), "batch", None, None)
