"""Training step: mixed-precision forward and backward, then the (offloadable) AdamW.

The JAX package's ``training/train_step.py`` in PyTorch.  The optimizer
update is where the paper's heterogeneous memory management plugs into
training: with ``OffloadConfig.optimizer_state`` the Adam moments live in
pinned host memory and stream through the card in blocks (Algorithm 3).

Parameters are fp32 trees as ``transformer.init_params`` makes them; the
forward computes in ``cfg.dtype`` (bf16 on the card) and checkpoints every
block (``remat=True``), so the backward recomputes each block, its flash
attention forward included, before backpropagating through it.

Over a ``DeviceMesh`` (under :func:`repro_torch.parallel.sharding.use_mesh`)
the parameters and the batch are ``DTensor``s laid out by the rules
(:func:`repro_torch.convert.distribute_params`,
:func:`repro_torch.training.data.batch_to_mesh`): the forward follows the
reference's layout hints, the loss reads the vocabulary-split logits
where they lie (:func:`cross_entropy`), each gradient is reduced to its
parameter's layout, and the optimizer updates each process's local shards.
Every family trains there: attention (GQA, gemma2's local/global pairs,
whisper's encoder and cross attention, MLA) runs the flash kernel on each
process's heads (``layers.mesh_attention``), a Mamba-2 block the SSD on its
SSM heads (``ssm._mesh_mamba2``), and the MoE routes one group a shard of
the batch through the experts each process holds (``moe._mesh_moe``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.offload import OffloadConfig, OffloadedAdamWState, offloaded_adamw_apply, offloaded_adamw_init
from repro_torch.models import transformer as T
from repro_torch.parallel import sharding as sh
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
    picks (one term, the rest exact zeros).  ``DTensor`` logits are read
    where they lie (:func:`_mesh_lse_and_label`)."""
    valid = (labels != ignore).float()
    safe = torch.where(labels == ignore, 0, labels).long()
    if sh.is_distributed(logits):
        lse, tok = _mesh_lse_and_label(logits, safe)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        tok = logits.gather(-1, safe[..., None])[..., 0]
    nll = (lse - tok) * valid
    denom = torch.clamp(valid.sum(), min=1.0)
    return nll.sum() / denom, (lse**2 * valid).sum() / denom


def _mesh_lse_and_label(logits, labels):
    """``logsumexp`` over the vocabulary and the label's logit of
    ``DTensor`` logits split over the vocabulary, without gathering them:
    the row maximum (no gradient: it cancels) and the sum of ``exp(x − max)``
    are reduced over the ``vocab`` axes as ``B×S`` numbers, and each process
    reads the labels that fall in its vocabulary block (the rest are exact
    zeros in the sum), as the single-device ``logsumexp`` and gather."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    mesh = logits.device_mesh
    row = sh.placements(sh.spec_for("batch", None), mesh)
    m = sh.constrain(logits.detach().amax(-1), "batch", None)
    lse = m + sh.constrain((logits - m[..., None]).exp().sum(-1), "batch", None).log()
    vocab_axes = {sh.axis_names(mesh).index(a) for a in sh.entry_axes(sh.spec_for("vocab")[0])}
    out_pl = tuple(Partial() if i in vocab_axes else p for i, p in enumerate(row))

    def label_logit(lg, ids):
        n = lg.shape[-1]
        lo = sh.block_start(mesh, vocab_axes, n)
        inside = (ids >= lo) & (ids < lo + n)
        picked = lg.gather(-1, torch.where(inside, ids - lo, 0)[..., None])[..., 0]
        return torch.where(inside, picked, 0.0)

    tok = local_map(label_logit, out_placements=list(out_pl),
                    in_placements=(sh.placements(sh.spec_for("batch", None, "vocab"), mesh), row),
                    device_mesh=mesh, redistribute_inputs=True)(logits, labels)
    return lse, sh.constrain(tok, "batch", None)


def make_loss_fn(cfg: ModelConfig, tcfg: TrainConfig) -> Callable:
    def loss_fn(params, batch):
        if not sh.is_distributed(batch["tokens"]):
            return _loss(params, batch)
        from torch.distributed.tensor.experimental import implicit_replication

        with implicit_replication():  # positions, masks and the aux zero are the same on every process
            loss, metrics = _loss(params, batch)
        return loss, {k: v.full_tensor() if sh.is_distributed(v) else v for k, v in metrics.items()}

    def _loss(params, batch):
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
    copied nor marked.  A ``DTensor`` parameter's gradient comes back in
    the parameter's layout: one that is partial over the axes that
    replicate the parameter (each process's part of the sum) is reduced
    there."""
    leaves, treedef = tree_flatten(params)
    req = [p.detach().requires_grad_() for p in leaves]
    loss, metrics = loss_fn(treedef.unflatten(req), batch)
    grads = torch.autograd.grad(loss, req)
    grads = [g.redistribute(p.device_mesh, p.placements) if sh.is_distributed(p) and g.placements != p.placements
             else g for g, p in zip(grads, leaves)]
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
