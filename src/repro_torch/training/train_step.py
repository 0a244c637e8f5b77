"""Training step: mixed-precision forward and backward, then the (offloadable) AdamW.

The JAX package's ``training/train_step.py`` in PyTorch.  The optimizer
update is where the paper's heterogeneous memory management plugs into
training: with ``OffloadConfig.optimizer_state`` the Adam moments live in
pinned host memory and stream through the card in blocks (Algorithm 3).

Parameters are fp32 trees as ``transformer.init_params`` makes them; the
forward computes in ``cfg.dtype`` (bf16 on the card) and checkpoints every
block (``remat=True``), so the backward recomputes each block, its flash
attention forward included, before backpropagating through it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.offload import OffloadConfig, OffloadedAdamWState, offloaded_adamw_apply, offloaded_adamw_init
from repro_torch.models import transformer as T
from repro_torch.training.optimizer import AdamWConfig, adamw_apply, adamw_init
from repro_torch.utils.tree import tree_flatten


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    adamw: AdamWConfig = AdamWConfig()
    offload: OffloadConfig = OffloadConfig()
    z_loss: float = 1e-4
    aux_loss_weight: float = 1e-2
    label_ignore: int = -100


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, ignore: int = -100):
    """Mean token NLL over valid labels, and the mean of ``logsumexp²``
    (the z-loss term), for fp32 ``logits [B,S,V]``.  The label logit is a
    gather: the same number the reference's masked sum over the vocabulary
    picks (one term, the rest exact zeros)."""
    valid = (labels != ignore).float()
    safe = torch.where(labels == ignore, 0, labels).long()
    lse = torch.logsumexp(logits, dim=-1)
    tok = logits.gather(-1, safe[..., None])[..., 0]
    nll = (lse - tok) * valid
    denom = torch.clamp(valid.sum(), min=1.0)
    return nll.sum() / denom, (lse**2 * valid).sum() / denom


def make_loss_fn(cfg: ModelConfig, tcfg: TrainConfig) -> Callable:
    def loss_fn(params, batch):
        logits, aux = T.forward(params, cfg, batch, remat=True)
        nll, zsq = cross_entropy(logits, batch["labels"], tcfg.label_ignore)
        loss = nll + tcfg.z_loss * zsq + tcfg.aux_loss_weight * aux
        return loss, {"loss": loss.detach(), "nll": nll.detach(), "aux": aux.detach()}

    return loss_fn


def init_train_state(cfg: ModelConfig, tcfg: TrainConfig, params):
    if tcfg.offload.optimizer_state:
        return offloaded_adamw_init(params, tcfg.adamw, tcfg.offload)
    return adamw_init(params, tcfg.adamw)


def value_and_grad(loss_fn: Callable, params: Any, batch: dict) -> tuple[dict, Any]:
    """(metrics, gradients shaped like ``params``) of ``loss_fn(params,
    batch) → (loss, metrics)``.  The gradients are taken with respect to
    detached aliases of the parameter tensors, so ``params`` is neither
    copied nor marked."""
    leaves, treedef = tree_flatten(params)
    req = [p.detach().requires_grad_() for p in leaves]
    loss, metrics = loss_fn(treedef.unflatten(req), batch)
    grads = torch.autograd.grad(loss, req)
    return metrics, treedef.unflatten(list(grads))


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig) -> Callable:
    """(params, opt_state, batch) → (params, opt_state, metrics); the
    optimizer by the state's type: resident :class:`AdamWState` or
    :class:`OffloadedAdamWState` (streamed with ``tcfg.offload``'s
    schedule).  Metrics are 0-d device tensors (reading one syncs)."""
    loss_fn = make_loss_fn(cfg, tcfg)

    def train_step(params, opt_state, batch):
        metrics, grads = value_and_grad(loss_fn, params, batch)
        if isinstance(opt_state, OffloadedAdamWState):
            new_params, new_state = offloaded_adamw_apply(
                grads, params, opt_state, tcfg.adamw,
                schedule=tcfg.offload.optimizer_schedule)
        else:
            new_params, new_state = adamw_apply(grads, params, opt_state, tcfg.adamw)
        return new_params, new_state, metrics

    return train_step


def make_eval_step(cfg: ModelConfig, tcfg: TrainConfig) -> Callable:
    loss_fn = make_loss_fn(cfg, tcfg)

    @torch.no_grad()
    def eval_step(params, batch):
        return loss_fn(params, batch)[1]

    return eval_step
