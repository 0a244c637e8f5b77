"""Mixture-of-Experts layer of the port: sort-based dispatch with a static
per-expert capacity (dropless when the capacity covers the imbalance).

The JAX package's ``models/moe.py`` with the same parameter tree, routing
and rounding points:

  router logits (activation dtype, then fp32) → top-k → flatten the
  (token, expert, gate) triples → stable sort by expert → position within
  the expert (left ``searchsorted``) → dispatch into ``[E, C, D]`` with an
  overflow row ``E·C`` → batched expert products → gated combine.

Shared experts (DeepSeek) are a dense branch added to the routed output.
The auxiliary load-balancing loss is the Switch form ``E · Σ_e f_e · P_e``
on each token's first choice.

On one device all tokens form one routing group (the reference's
``_n_token_groups`` is 1 without a mesh); over a ``DeviceMesh`` each shard
of the batch is a group, routed on its own process (:func:`_mesh_moe`).
The expert products,
the router and the gathers are plain PyTorch, as the JAX package leaves
them to XLA.  The combine sums each token's contributions in the sorted
order with plain additions, never ``index_add_``: CUDA's atomic scatter
would change the last bits from run to run.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import mlp, normal, pdt, stacked
from repro_torch.parallel import sharding as sh


def init_moe(generator: torch.Generator, cfg: ModelConfig, stack: tuple = (), *, device) -> dict:
    D, Fd, E = cfg.d_model, cfg.moe_d_ff or cfg.d_ff, cfg.n_experts
    pt = pdt(cfg)
    p = {
        "router": normal(generator, stack + (D, E), pt, device),
        "w1": normal(generator, stack + (E, D, Fd), pt, device),
        "w3": normal(generator, stack + (E, D, Fd), pt, device),
        "w2": normal(generator, stack + (E, Fd, D), pt, device, scale=0.02 / max(1, cfg.n_layers) ** 0.5),
    }
    if cfg.n_shared_experts:
        Fs = Fd * cfg.n_shared_experts
        p["shared"] = {"w1": normal(generator, stack + (D, Fs), pt, device),
                       "w3": normal(generator, stack + (D, Fs), pt, device),
                       "w2": normal(generator, stack + (Fs, D), pt, device)}
    return p


def moe_specs(cfg: ModelConfig, stack: tuple = ()) -> dict:
    """Logical axes of :func:`init_moe`'s tree, leaf for leaf."""
    s = {"router": (None, None), "w1": ("experts", "fsdp", "moe_mlp"), "w3": ("experts", "fsdp", "moe_mlp"),
         "w2": ("experts", "moe_mlp", "fsdp")}
    if cfg.n_shared_experts:
        s["shared"] = {"w1": ("fsdp", "mlp"), "w3": ("fsdp", "mlp"), "w2": ("mlp", "fsdp")}
    return stacked(stack, s)


def _top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, ties to the lower
    index (a stable descending sort; ``torch.topk`` promises no tie order on
    the card)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe(params: dict, x: torch.Tensor, cfg: ModelConfig, *, full_capacity: bool = False):
    """x [B,S,D] → (y [B,S,D], aux_loss fp32 scalar).

    ``full_capacity=True`` sets each expert's capacity to the token count:
    strictly dropless.  A ``DTensor`` ``x`` routes over its mesh
    (:func:`_mesh_moe`).
    """
    if sh.is_distributed(x):
        return _mesh_moe(params, x, cfg, full_capacity)
    adt = x.dtype
    B, S, D = x.shape
    T = B * S
    xf = x.reshape(T, D)
    logits = (xf @ params["router"].to(adt)).float()  # [T,E]
    probs = torch.softmax(logits, dim=-1)
    yf, ce = _routed(xf, _scores(logits, probs, cfg), params["w1"], params["w3"], params["w2"], cfg,
                     full_capacity, 0)
    aux = cfg.n_experts * (probs.mean(0) * (ce / T)).sum()
    if "shared" in params:
        yf = yf + mlp(params["shared"], xf, cfg)
    return yf.reshape(B, S, D), aux


def _scores(logits, probs, cfg: ModelConfig):
    """What the top-k selects from: the logits (mixtral, a softmax over the
    selected ones follows) or the softmax (deepseek, renormalised)."""
    return logits if cfg.router_norm == "topk_softmax" else probs


def _routed(xf, scores, w1, w3, w2, cfg: ModelConfig, full_capacity: bool, e0: int):
    """One routing group: its tokens ``xf [T,D]`` with their router
    :func:`_scores` ``[T,E]`` (fp32), through the experts ``e0 …
    e0 + El`` whose weights ``w1``, ``w3 [El,D,F]``, ``w2 [El,F,D]`` are
    given (all ``E`` on one device) → (their gated outputs summed per token
    ``[T,D]``, each expert's count of first choices ``[E]`` fp32).

    Top-k, the stable sort by expert, each entry's position within its
    expert (left ``searchsorted``) and the capacity ``C`` (of the group's
    tokens) are the group's whatever experts are given; the entries of the
    given experts that fit are dispatched into ``[El, C, D]`` (an overflow
    row takes the rest), and each token's entries are summed in the sorted
    order with plain additions, the other experts' entries as zeros."""
    adt = xf.dtype
    T, D = xf.shape
    E, K = cfg.n_experts, cfg.top_k
    El = w1.shape[0]
    top, top_idx = _top_k(scores, K)
    if cfg.router_norm == "topk_softmax":  # mixtral: softmax over the selected logits
        gates = torch.softmax(top, dim=-1)
    else:  # deepseek: renormalise the selected probabilities
        gates = top / (top.sum(-1, keepdim=True) + 1e-9)
    ce = F.one_hot(top_idx[:, 0], E).float().sum(0)

    C = T if full_capacity else max(1, int(T * K / E * cfg.capacity_factor))
    flat_e = top_idx.reshape(T * K)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    st = order // K  # token of each sorted entry (entries are token-major)
    sg = gates.reshape(T * K)[order]
    start = torch.searchsorted(se, torch.arange(E, device=xf.device))  # left side
    pos = torch.arange(T * K, device=xf.device) - start[se]
    keep = (pos < C) & (se >= e0) & (se < e0 + El)
    slot = torch.where(keep, (se - e0) * C + pos, El * C)  # the overflow row takes the dropped entries

    disp = torch.zeros((El * C + 1, D), dtype=adt, device=xf.device)
    disp[slot] = xf[st] * keep[:, None].to(adt)  # unique slots; the overflow row only receives zeros
    xe = disp[:El * C].reshape(El, C, D)
    h = F.silu(torch.bmm(xe, w1.to(adt))) * torch.bmm(xe, w3.to(adt))
    ye = torch.bmm(h, w2.to(adt)).reshape(El * C, D)
    contrib = ye[slot.clamp(0, El * C - 1)] * (sg * keep).to(adt)[:, None]

    # each token's K entries in the sorted order, summed left to right from
    # zero: the reference's sequential scatter-add, without atomics
    rank = torch.empty_like(order)
    rank[order] = torch.arange(T * K, device=xf.device)
    per_token = contrib[rank.reshape(T, K).sort(dim=-1).values]  # [T,K,D]
    yf = torch.zeros((T, D), dtype=adt, device=xf.device)
    for j in range(K):
        yf = yf + per_token[:, j]
    return yf, ce


def _mesh_moe(params: dict, x, cfg: ModelConfig, full_capacity: bool):
    """The MoE over a ``DeviceMesh``, as the reference's grouped dispatch:
    one routing group a shard of the batch (its ``_n_token_groups``), the
    capacity ``C = int(Tg·K/E·cf)`` of a group's ``Tg`` tokens, so a mesh
    that splits the batch may drop other tokens than one device.

    The router and its softmax run on ``DTensor``s (the load-balancing
    mean over every token reduced over the batch axes); the dispatch runs
    inside ``local_map`` on each process's group (its rows of the batch)
    and the experts it holds (``experts``' axes; with ``moe_mlp`` split, its
    columns of every expert), :func:`_routed`.  The routed output is partial
    over those axes and summed there; the router's and the experts'
    gradients come back partial over the axes that split the work and are
    reduced to their layouts.  The shared experts are a dense branch on
    ``DTensor``s."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    adt = x.dtype
    B, S, D = x.shape
    E = cfg.n_experts
    mesh = x.device_mesh
    names = sh.axis_names(mesh)
    rows = sh.placements(sh.spec_for("batch", None, None), mesh)
    groups = math.prod(mesh.size(m) for m, p in enumerate(rows) if p.is_shard())
    if B % groups:
        raise ValueError(f"{cfg.name}: a batch of {B} rows does not split into {groups} routing groups")
    expert_dims = {names.index(a) for a in sh.entry_axes(sh.spec_for("experts")[0])}
    split = expert_dims | {names.index(a) for a in sh.entry_axes(sh.spec_for("moe_mlp")[0])}
    e0 = sh.block_start(mesh, expert_dims, E // math.prod(mesh.size(m) for m in expert_dims))
    ws = ("w1", "w3", "w2")  # each gathered over fsdp: [E, D, F] and [E, F, D] split over experts and moe_mlp
    w_pl = {k: sh.placements(sh.spec_for("experts", *((None, "moe_mlp") if k != "w2" else ("moe_mlp", None))), mesh)
            for k in ws}
    w_grad = {k: tuple(Partial() if p.is_shard() else q for p, q in zip(rows, w_pl[k])) for k in ws}
    part = tuple(Partial() if m in split else p for m, p in enumerate(rows))  # summed over the experts' axes
    counts = tuple(Partial() if p.is_shard() else Replicate() for p in rows)  # summed over the groups

    def local(xl, scores, w1, w3, w2):
        b = xl.shape[0]
        yf, ce = _routed(xl.reshape(b * S, D), scores.reshape(b * S, E), w1, w3, w2, cfg, full_capacity, e0)
        return yf.reshape(b, S, D), ce

    x = sh.constrain(x, "batch", None, None)
    logits = (x @ params["router"].to(adt)).float()  # [B,S,E]
    probs = torch.softmax(logits, dim=-1)
    run = local_map(local, out_placements=(part, counts), in_placements=(rows, rows, *(w_pl[k] for k in ws)),
                    in_grad_placements=(part, part, *(w_grad[k] for k in ws)), device_mesh=mesh,
                    redistribute_inputs=True)
    y, ce = run(sh.contiguous_grad(x), sh.contiguous_grad(_scores(logits, probs, cfg)),
                *(sh.contiguous_grad(params[k]) for k in ws))
    whole = [Replicate()] * mesh.ndim
    aux = E * (probs.mean((0, 1)).redistribute(mesh, whole) * (ce / (B * S)).redistribute(mesh, whole)).sum()
    y = sh.constrain(y, "batch", None, None)
    if "shared" in params:
        y = y + mlp(params["shared"], x, cfg)
    return sh.constrain(y, "batch", None, None), aux


def tokens_dropped_fraction(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Diagnostic: the fraction of routed assignments beyond the capacity, for
    router logits ``[T, E]`` (fp32 scalar)."""
    T, E, K = logits.shape[0], cfg.n_experts, cfg.top_k
    _, top_idx = _top_k(logits, K)
    counts = torch.bincount(top_idx.reshape(-1), minlength=E)
    C = max(1, int(T * K / E * cfg.capacity_factor))
    return (counts - C).clamp_min(0).sum().float() / (T * K)
