"""Offload policies: the paper's HMM applied to neural-network training.

The JAX package's ``core/offload.py`` in PyTorch.  Three state classes in an
LM trainer outgrow device memory long before the weights do, and each maps
onto Algorithm 3 of the paper with a different "multispring":

* **optimizer state** (Adam ``m, v`` in fp32, 8 bytes a parameter): blocks
  of moment leaves live in pinned host memory; the update streams each
  block through the card — copy-in ‖ compute overlap is the paper's
  pipeline, with the Adam update in the role of the constitutive law.
* **activations** (long-sequence training): saved tensors go to pinned host
  memory in the forward and come back in the backward
  (:func:`activation_offload_policy`), or are recomputed.
* **KV cache** (long-context decode): ``serving/decode.py`` streams host KV
  blocks per layer group.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import torch

from repro_torch.core import hetmem
from repro_torch.core.stream import StreamEngine, StreamPlan
from repro_torch.training.optimizer import AdamWConfig, adamw_update_leaf, clip_scale, init_moments_leaf, scaled
from repro_torch.utils.tree import BlockSpec, group_leaves_into_blocks, group_like, tree_flatten, tree_leaves


@dataclasses.dataclass(frozen=True)
class OffloadConfig:
    """Which HMM features are on. Mirrors the paper's method ladder:

    everything False      → Baseline 2 (accelerator-resident state)
    optimizer_state=True  → Proposed 1 applied to training
    + activations         → a further beyond-paper application

    KV-cache offload is the serving path's own (``ServeConfig.kv_offload``).
    """

    optimizer_state: bool = False
    optimizer_npart: int = 8
    optimizer_schedule: str = "serial"   # StreamEngine schedule for the update
    activations: bool = False            # every saved tensor to pinned host memory


# ---------------------------------------------------------------------------
# Offloaded AdamW (Algorithm 3 with Adam as the per-block kernel)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class OffloadedAdamWState:
    """``moments`` holds ``npart`` blocks; block ``j`` is ``[m, v, m, v, …]``
    of the parameter leaves that ``spec`` assigns to it, in leaf order."""

    step: int
    moments: hetmem.PartitionedState
    spec: BlockSpec


class _Opaque:
    """A parameter leaf's ``{"m", "v"}`` as one leaf for the block partitioner:
    its size is both moments' (the reference's ``_Opaque``)."""

    def __init__(self, mv: dict[str, torch.Tensor]):
        self.tree = mv
        self.shape = (mv["m"].numel() + mv["v"].numel(),)
        self.dtype = mv["m"].dtype


def offloaded_adamw_init(params: Any, cfg: AdamWConfig, off: OffloadConfig) -> OffloadedAdamWState:
    """Moment blocks matching ``params``' leaf layout, each parameter leaf's
    ``m`` and ``v`` kept together in one block, in pinned host memory when
    the parameters live on the card."""
    leaves, treedef = tree_flatten(params)
    dev = leaves[0].device
    # partition by *param* leaves so grads and params group identically later
    sized = [_Opaque(init_moments_leaf(p.to("meta"), cfg)) for p in leaves]
    _, spec = group_leaves_into_blocks(treedef.unflatten(sized), off.optimizer_npart)
    blocks = []
    for p_blk in group_like(params, spec):  # one block at a time on the card
        blk = []
        for p in p_blk:
            mv = init_moments_leaf(p, cfg)
            blk += [mv["m"], mv["v"]]
        blocks.append(hetmem.put_host(blk, dev))
    return OffloadedAdamWState(step=0, moments=hetmem.PartitionedState(blocks=blocks), spec=spec)


def moments_tree(state: OffloadedAdamWState) -> Any:
    """The moments of ``state`` as the resident optimizer holds them: a tree
    mirroring the parameters with ``{"m", "v"}`` leaves (the block tensors
    themselves, where they live)."""
    pairs = [[{"m": blk[2 * i], "v": blk[2 * i + 1]} for i in range(len(blk) // 2)] for blk in state.moments.blocks]
    return state.spec.treedef.unflatten(state.spec.blocks_to_flat(pairs))


def offloaded_adamw_apply(grads: Any, params: Any, state: OffloadedAdamWState, cfg: AdamWConfig, *,
                          schedule: str = "serial") -> tuple[Any, OffloadedAdamWState]:
    """Streamed AdamW step (Algorithm 3 through the StreamEngine).

    Per block j: moments_j host→device ‖ the update of block j−1 (the
    ``prefetch`` schedule overlaps them on copy streams, one block ahead;
    ``serial`` runs copy, update and copy back in order on one stream).  New parameters
    stay on the card (the "D" of Algorithm 3); new moments go back into
    their pinned host blocks in place, so the returned state shares them
    with ``state``.  Bit-identical to ``adamw_apply``: the same leaf
    update, each leaf's gradient clipped just before it.
    """
    spec = state.spec
    scale = clip_scale(grads, cfg.grad_clip_norm)[0] if cfg.grad_clip_norm else None
    gblocks = group_like(grads, spec)
    pblocks = group_like(params, spec)

    def update_block(mv_blk, g_blk, p_blk):
        new_mv, new_p = [], []
        for i, (g, p) in enumerate(zip(g_blk, p_blk)):
            p2, mv2 = adamw_update_leaf(scaled(g, scale), p, {"m": mv_blk[2 * i], "v": mv_blk[2 * i + 1]},
                                        state.step, cfg)
            new_mv += [mv2["m"], mv2["v"]]
            new_p.append(p2)
        return new_mv, new_p

    plan = StreamPlan(npart=state.moments.npart, schedule=schedule, collect=True,
                      device=tree_leaves(params)[0].device)
    res = StreamEngine(plan).run(update_block, state.moments, per_block=(gblocks, pblocks))
    new_params = spec.treedef.unflatten(spec.blocks_to_flat(res.extras))
    return new_params, OffloadedAdamWState(step=state.step + 1, moments=res.state, spec=spec)


# ---------------------------------------------------------------------------
# Activation offload (saved-tensor policy)
# ---------------------------------------------------------------------------


def _pack_to_host(x: torch.Tensor):
    if x.device.type != "cuda":
        return x
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    h.copy_(x, non_blocking=True)
    return x.device, h


def _unpack_from_host(packed):
    if isinstance(packed, torch.Tensor):
        return packed
    dev, h = packed
    return h.to(dev, non_blocking=True)


def activation_offload_policy():
    """A context in which every tensor autograd saves for the backward goes
    to pinned host memory during the forward and streams back during the
    backward (the backward pass is the "second sweep" of the streamed
    loop).  The reference offloads only the residuals it tags by name; the
    port's forward tags none, so it takes no names.  Defined and, as in the
    reference, not wired into the trainer."""
    return torch.autograd.graph.saved_tensors_hooks(_pack_to_host, _unpack_from_host)


def remat_policy(off: OffloadConfig):
    """The saved-tensor context of ``off``: host offload with
    ``off.activations``, else none (what the forward's checkpointed blocks
    save, their inputs, stays on the card)."""
    if off.activations:
        return activation_offload_policy()
    return contextlib.nullcontext()
