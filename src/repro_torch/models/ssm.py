"""Mamba-2 (SSD, state-space duality, arXiv:2405.21060) in PyTorch.

The JAX package's ``models/ssm.py`` with the same public names, parameter
tree and rounding points: the chunked SSD algorithm for prefill and
``forward`` (quadratic within chunks of ``Q`` steps, a recurrence over the
chunks' states across them), and the O(1)-state step for decode.  Layout
as the reference: ``in_proj → [z | xBC | dt]``, a short causal conv over
xBC, the SSD core, a gated RMSNorm, ``out_proj``.

The dtype steps are part of the result in bf16 and follow the reference
exactly: ``a = dt·A`` is formed in the compute dtype and then cast to fp32;
the segment sums ``L`` are fp32 and ``CB·L`` is cast to x's dtype before its
product; the decays to a chunk's end and from its start are cast to x's
dtype; the chunk states are carried in x's dtype.  The causal conv is a sum
of K shifted products in index order, and groups map to heads as
``jnp.repeat`` maps them (head h reads group h // (H/G)).  No TPU kernel
exists here: this is plain tensor code on the card and on the CPU alike.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import normal, ones, pdt, rmsnorm, stacked, zeros


def dims(cfg: ModelConfig):
    """(d_inner, heads, state size N, groups G)."""
    d_inner = cfg.ssm_expand * cfg.d_model
    nheads = d_inner // cfg.ssm_headdim
    return d_inner, nheads, cfg.ssm_state, cfg.ssm_groups


def init_mamba2(generator, cfg: ModelConfig, stack: tuple = (), *, device) -> dict:
    """One Mamba-2 mixer per entry of ``stack``: the random projections drawn
    from ``generator`` (conv ``0.5·N(0, 1)``, ``out_proj`` scaled by 1/√L),
    ``A_log = log(linspace(1, 16, H))``, ``dt_bias = log(expm1(0.01))``."""
    D = cfg.d_model
    d_inner, H, N, G = dims(cfg)
    conv_dim = d_inner + 2 * G * N
    pt = pdt(cfg)

    def const(row):  # a value init broadcast over the stack
        return row.expand(stack + (H,)).to(pt).to(device).clone()

    return {
        "in_proj": normal(generator, stack + (D, 2 * d_inner + 2 * G * N + H), pt, device),
        "conv_w": normal(generator, stack + (cfg.d_conv, conv_dim), pt, device, scale=0.5),
        "conv_b": zeros(stack + (conv_dim,), pt, device),
        "A_log": const(torch.log(torch.linspace(1.0, 16.0, H))),
        "D": ones(stack + (H,), pt, device),
        "dt_bias": const(torch.log(torch.expm1(torch.full((H,), 1e-2)))),
        "norm": ones(stack + (d_inner,), pt, device),
        "out_proj": normal(generator, stack + (d_inner, D), pt, device,
                           scale=0.02 / math.sqrt(max(1, cfg.n_layers))),
    }


def mamba2_specs(stack: tuple = ()) -> dict:
    """Logical axes of :func:`init_mamba2`'s tree, leaf for leaf."""
    return stacked(stack, {"in_proj": ("fsdp", "mlp"), "conv_w": (None, "mlp"), "conv_b": ("mlp",),
                           "A_log": (None,), "D": (None,), "dt_bias": (None,), "norm": ("mlp",),
                           "out_proj": ("mlp", "fsdp")})


def _to_heads(x: torch.Tensor, rep: int, dim: int) -> torch.Tensor:
    """Groups → heads along ``dim``: each group repeated ``rep`` times in a
    row (``repeat_interleave``'s values, by an expand: no host sync)."""
    return x.unsqueeze(dim + 1).expand(*x.shape[:dim + 1], rep, *x.shape[dim + 1:]).flatten(dim, dim + 1)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """``L[i, j] = Σ_{j<k≤i} a[k]`` (−inf above the diagonal), the log of the
    decay products, as a difference of cumulative sums."""
    Q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=a.device))
    return torch.where(mask, diff, -math.inf)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                chunk: int, init_state: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,H,P], dt [B,S,H] (softplus'd, > 0), A [H] (< 0), Bm and Cm
    [B,S,G,N], init_state [B,H,P,N] → (y [B,S,H,P], final state [B,H,P,N])."""
    B, S, H, Pd = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        x, Bm, Cm = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, Bm, Cm))
        dt = F.pad(dt, (0, 0, 0, pad))
    Sp = S + pad
    nC = Sp // Q
    rep = H // G

    xc = x.reshape(B, nC, Q, H, Pd)
    dtc = dt.reshape(B, nC, Q, H)
    Bc = Bm.reshape(B, nC, Q, G, N)
    Cc = Cm.reshape(B, nC, Q, G, N)
    a = (dtc * A).float()  # log-decay per step [B,nC,Q,H], formed in the compute dtype

    # within a chunk (quadratic in Q)
    Lm = torch.exp(_segsum(a.permute(0, 1, 3, 2)))                      # [B,nC,H,Q,Q]
    CB = _to_heads(torch.einsum("bcqgn,bckgn->bcgqk", Cc, Bc), rep, 2)  # [B,nC,H,Q,Q]
    dtx = xc * dtc[..., None]                                            # Δ folded into x
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", (CB * Lm).to(x.dtype), dtx)

    # each chunk's contribution to its end state
    decay_to_end = torch.exp(a.sum(dim=2, keepdim=True) - torch.cumsum(a, dim=2))  # [B,nC,Q,H]
    Bh = _to_heads(Bc, rep, 3)                                           # groups → heads
    states = torch.einsum("bcqhn,bcqh,bcqhp->bchpn", Bh, decay_to_end.to(x.dtype), dtx)

    # the recurrence over chunks: the state entering each chunk
    chunk_decay = torch.exp(a.sum(dim=2)).to(x.dtype)  # [B,nC,H]
    s = torch.zeros((B, H, Pd, N), dtype=x.dtype, device=x.device) if init_state is None else init_state
    prev = []
    for c in range(nC):
        prev.append(s)
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)  # [B,nC,H,P,N]

    # across chunks: y += C · (decay from the chunk's start ⊙ the state entering it)
    decay_from_start = torch.exp(torch.cumsum(a, dim=2))  # [B,nC,Q,H]
    Ch = _to_heads(Cc, rep, 3)
    y_off = torch.einsum("bcqhn,bchpn,bcqh->bcqhp", Ch, prev_states, decay_from_start.to(x.dtype))

    y = (y_diag + y_off).reshape(B, Sp, H, Pd)[:, :S]
    return y, s


def ssd_decode_step(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                    state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One step: x [B,1,H,P], dt [B,1,H], A [H], Bm and Cm [B,1,G,N], state
    [B,H,P,N] → (y [B,1,H,P], new state)."""
    H = x.shape[2]
    rep = H // Bm.shape[2]
    dec = torch.exp(dt[:, 0, :] * A[None]).to(x.dtype)          # [B,H]
    Bh = _to_heads(Bm[:, 0], rep, 1)                             # [B,H,N]
    Ch = _to_heads(Cm[:, 0], rep, 1)
    dx = (x[:, 0] * dt[:, 0, :, None]).to(x.dtype)              # [B,H,P]
    new_state = state * dec[..., None, None] + torch.einsum("bhp,bhn->bhpn", dx, Bh)
    y = torch.einsum("bhpn,bhn->bhp", new_state, Ch)
    return y[:, None], new_state


def mamba2_block(params: dict, x: torch.Tensor, cfg: ModelConfig, *, cache: dict | None = None,
                 return_state: bool = False) -> tuple[torch.Tensor, dict | None]:
    """x [B,S,D] → (y [B,S,D], state).

    With ``cache = {"ssm" [B,H,P,N], "conv" [B,K−1,convdim]}`` (decode, S = 1)
    the new states are written **in place** into the cache tensors, which
    come back as the state.  Without one, ``return_state`` (prefill) gives
    the final SSM state and the last K−1 inputs of the conv, or ``None`` for
    the conv when the sequence is shorter than K−1, as the reference does.
    """
    adt = x.dtype
    B, S, _ = x.shape
    d_inner, H, N, G = dims(cfg)
    conv_dim = d_inner + 2 * G * N

    zxbcdt = x @ params["in_proj"].to(adt)  # [B,S, 2·d_inner + 2GN + H]
    z = zxbcdt[..., :d_inner]
    xBC = zxbcdt[..., d_inner:d_inner + conv_dim]
    dt_raw = zxbcdt[..., -H:]

    # the short causal depthwise conv over xBC: K shifted products, summed in order
    w = params["conv_w"].to(adt)  # [K, convdim]
    K = w.shape[0]
    if cache is None:
        xpad = F.pad(xBC, (0, 0, K - 1, 0))
        conv = sum(xpad[:, i:i + S] * w[i] for i in range(K))
        new_conv = None if S < K - 1 else xBC[:, S - (K - 1):]
    else:
        hist = torch.cat([cache["conv"], xBC], dim=1)  # [B,K,convdim]
        conv = sum(hist[:, i:i + 1] * w[i] for i in range(K))
        new_conv = hist[:, 1:]
    xBC = F.silu(conv + params["conv_b"].to(adt))

    xs = xBC[..., :d_inner].reshape(B, -1, H, cfg.ssm_headdim)
    Bm = xBC[..., d_inner:d_inner + G * N].reshape(B, -1, G, N)
    Cm = xBC[..., d_inner + G * N:].reshape(B, -1, G, N)
    dt_a = F.softplus(dt_raw.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"].float())

    if cache is None:
        y, final = ssd_chunked(xs, dt_a.to(adt), A.to(adt), Bm, Cm, cfg.ssm_chunk)
        new_cache = {"ssm": final, "conv": new_conv} if return_state else None
    else:
        y, final = ssd_decode_step(xs, dt_a.to(adt), A.to(adt), Bm, Cm, cache["ssm"])
        cache["ssm"].copy_(final)
        cache["conv"].copy_(new_conv)
        new_cache = {"ssm": cache["ssm"], "conv": cache["conv"]}

    y = y + xs * params["D"].to(adt)[:, None]  # the skip
    y = y.reshape(B, -1, d_inner)
    y = rmsnorm(y * F.silu(z), params["norm"], cfg.norm_eps)  # the gated norm
    return y @ params["out_proj"].to(adt), new_cache


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype, device, stack: tuple = ()) -> dict:
    """Zero states ``{"ssm" [*stack,B,H,P,N], "conv" [*stack,B,K−1,convdim]}``."""
    d_inner, H, N, G = dims(cfg)
    conv_dim = d_inner + 2 * G * N
    return {"ssm": torch.zeros(stack + (batch, H, cfg.ssm_headdim, N), dtype=dtype, device=device),
            "conv": torch.zeros(stack + (batch, cfg.d_conv - 1, conv_dim), dtype=dtype, device=device)}
