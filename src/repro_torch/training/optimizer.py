"""AdamW in plain PyTorch, leaf-wise form: the JAX package's ``training/optimizer.py``.

The leaf-wise update is free of any tree structure: the heterogeneous-memory
manager applies it per streamed block (``core/offload.py``) and the resident
optimizer maps it over the whole tree.  Both call the *same* arithmetic in
the same order, so offloaded ≡ resident bit for bit on one device.

The parameters come back as new tensors, as the reference's functional
update returns them; the moments are written back in place (the resident
state's tensors here, the pinned host blocks in ``core/offload.py``), so the
optimizer holds one copy of its 8 bytes a parameter.  The step count is a
python int; the
scalars derived from it (warm-up learning rate, bias corrections) are
formed in fp32 as the reference forms them, and gradient clipping keeps its
scale on the device (no host sync).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.utils.tree import tree_flatten, tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    learning_rate: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    warmup_steps: int = 100
    # optimizer-state dtype: fp32 master moments (paper-grade fidelity)
    state_dtype: torch.dtype = torch.float32


def lr_at(cfg: AdamWConfig, step: int) -> float:
    """Linear warm-up then constant, in fp32: ``lr · min(1, (step+1)/warmup)``."""
    warm = min(np.float32(1.0), np.float32(step + 1) / np.float32(max(1, cfg.warmup_steps)))
    return float(np.float32(cfg.learning_rate) * warm)


def _bias_correction(b: float, t: int) -> float:
    """``1 − b**t`` in fp32."""
    return float(np.float32(1.0) - np.float32(b) ** np.float32(t))


def init_moments_leaf(p: torch.Tensor, cfg: AdamWConfig) -> dict[str, torch.Tensor]:
    return {"m": torch.zeros(p.shape, dtype=cfg.state_dtype, device=p.device),
            "v": torch.zeros(p.shape, dtype=cfg.state_dtype, device=p.device)}


def adamw_update_leaf(g: torch.Tensor, p: torch.Tensor, mv: dict[str, torch.Tensor], step: int,
                      cfg: AdamWConfig, lr: float | None = None) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """One AdamW step for a single leaf → (new_param, new_moments)."""
    lr = lr_at(cfg, step) if lr is None else lr
    sdt = cfg.state_dtype
    g32 = g.to(sdt)
    m = cfg.b1 * mv["m"] + (1.0 - cfg.b1) * g32
    v = cfg.b2 * mv["v"] + (1.0 - cfg.b2) * (g32 * g32)
    mhat = m / _bias_correction(cfg.b1, step + 1)
    vhat = v / _bias_correction(cfg.b2, step + 1)
    p32 = p.to(sdt)
    upd = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p32
    new_p = (p32 - lr * upd).to(p.dtype)
    return new_p, {"m": m, "v": v}


def global_norm(tree: Any) -> torch.Tensor:
    """√(Σ x²) over every leaf in fp32, the leaves' sums added in leaf order."""
    total = None
    for x in tree_leaves(tree):
        s = x.float().square().sum()
        total = s if total is None else total + s
    return torch.sqrt(total)


def clip_scale(tree: Any, max_norm: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(scale ``min(1, max_norm / (‖tree‖ + 1e-12))``, the global norm), on the device."""
    gn = global_norm(tree)
    return torch.clamp(max_norm / (gn + 1e-12), max=1.0), gn


def scaled(x: torch.Tensor, scale: torch.Tensor | None) -> torch.Tensor:
    """``x`` clipped by a :func:`clip_scale` scale (``None``: unclipped), in ``x``'s dtype."""
    return x if scale is None else (x * scale).to(x.dtype)


def clip_by_global_norm(tree: Any, max_norm: float) -> tuple[Any, torch.Tensor]:
    scale, gn = clip_scale(tree, max_norm)
    return tree_map(lambda x: scaled(x, scale), tree), gn


# ---------------------------------------------------------------------------
# Resident (non-offloaded) optimizer — the conventional baseline.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AdamWState:
    step: int
    moments: Any  # a tree mirroring params with {"m","v"} leaves


def adamw_init(params: Any, cfg: AdamWConfig) -> AdamWState:
    return AdamWState(step=0, moments=tree_map(lambda p: init_moments_leaf(p, cfg), params))


def adamw_apply(grads: Any, params: Any, state: AdamWState, cfg: AdamWConfig) -> tuple[Any, AdamWState]:
    """Clip by the global norm, then :func:`adamw_update_leaf` leaf by leaf →
    (new params, the state one step on).  Each leaf's gradient is clipped
    just before its update (the values the reference's clipped tree holds),
    so no clipped copy of the whole tree is held; each leaf's new moments
    are copied into ``state``'s, which the returned state shares."""
    scale = clip_scale(grads, cfg.grad_clip_norm)[0] if cfg.grad_clip_norm else None
    g_flat, treedef = tree_flatten(grads)
    p_flat = treedef.flatten_up_to(params)
    mv_flat = treedef.flatten_up_to(state.moments)  # each leaf is {"m","v"}
    new_p = []
    for g, p, mv in zip(g_flat, p_flat, mv_flat):
        p2, mv2 = adamw_update_leaf(scaled(g, scale), p, mv, state.step, cfg)
        mv["m"].copy_(mv2["m"])
        mv["v"].copy_(mv2["v"])
        new_p.append(p2)
    return treedef.unflatten(new_p), AdamWState(step=state.step + 1, moments=state.moments)
