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

One process holds one device, so all tokens form one routing group (the
reference's ``_n_token_groups`` is 1 without a mesh).  The expert products,
the router and the gathers are plain PyTorch, as the JAX package leaves
them to XLA.  The combine sums each token's contributions in the sorted
order with plain additions, never ``index_add_``: CUDA's atomic scatter
would change the last bits from run to run.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import normal, pdt


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


def _top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, ties to the lower
    index (a stable descending sort; ``torch.topk`` promises no tie order on
    the card)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe(params: dict, x: torch.Tensor, cfg: ModelConfig, *, full_capacity: bool = False):
    """x [B,S,D] → (y [B,S,D], aux_loss fp32 scalar).

    ``full_capacity=True`` sets each expert's capacity to the token count:
    strictly dropless.
    """
    adt = x.dtype
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    xf = x.reshape(T, D)

    logits = (xf @ params["router"].to(adt)).float()  # [T,E]
    probs = torch.softmax(logits, dim=-1)
    if cfg.router_norm == "topk_softmax":  # mixtral: softmax over the selected logits
        top_logits, top_idx = _top_k(logits, K)
        gates = torch.softmax(top_logits, dim=-1)
    else:  # deepseek: select from the softmax, renormalise
        top_probs, top_idx = _top_k(probs, K)
        gates = top_probs / (top_probs.sum(-1, keepdim=True) + 1e-9)

    me = probs.mean(0)
    ce = F.one_hot(top_idx[:, 0], E).float().mean(0)
    aux = E * (me * ce).sum()

    C = T if full_capacity else max(1, int(T * K / E * cfg.capacity_factor))
    flat_e = top_idx.reshape(T * K)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    st = order // K  # token of each sorted entry (entries are token-major)
    sg = gates.reshape(T * K)[order]
    start = torch.searchsorted(se, torch.arange(E, device=x.device))  # left side
    pos = torch.arange(T * K, device=x.device) - start[se]
    keep = pos < C
    slot = torch.where(keep, se * C + pos, E * C)  # the overflow row takes the dropped entries

    disp = torch.zeros((E * C + 1, D), dtype=adt, device=x.device)
    disp[slot] = xf[st] * keep[:, None].to(adt)  # unique slots; the overflow row only receives zeros
    xe = disp[:E * C].reshape(E, C, D)
    h = F.silu(torch.bmm(xe, params["w1"].to(adt))) * torch.bmm(xe, params["w3"].to(adt))
    ye = torch.bmm(h, params["w2"].to(adt)).reshape(E * C, D)
    contrib = ye[slot.clamp(0, E * C - 1)] * (sg * keep).to(adt)[:, None]

    # each token's K entries in the sorted order, summed left to right from
    # zero: the reference's sequential scatter-add, without atomics
    rank = torch.empty_like(order)
    rank[order] = torch.arange(T * K, device=x.device)
    per_token = contrib[rank.reshape(T, K).sort(dim=-1).values]  # [T,K,D]
    yf = torch.zeros((T, D), dtype=adt, device=x.device)
    for j in range(K):
        yf = yf + per_token[:, j]

    if "shared" in params:
        sh = params["shared"]
        hs = F.silu(xf @ sh["w1"].to(adt)) * (xf @ sh["w3"].to(adt))
        yf = yf + hs @ sh["w2"].to(adt)
    return yf.reshape(B, S, D), aux


def tokens_dropped_fraction(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Diagnostic: the fraction of routed assignments beyond the capacity, for
    router logits ``[T, E]`` (fp32 scalar)."""
    T, E, K = logits.shape[0], cfg.n_experts, cfg.top_k
    _, top_idx = _top_k(logits, K)
    counts = torch.bincount(top_idx.reshape(-1), minlength=E)
    C = max(1, int(T * K / E * cfg.capacity_factor))
    return (counts - C).clamp_min(0).sum().float() / (T * K)
