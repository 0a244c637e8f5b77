"""The dry run's accounting over a logical mesh: bytes a device holds, and
the collective traffic the sharding rules imply.

The JAX package reads both out of XLA's partitioned program (its HLO
text, loop trip counts recovered from the ``while`` conditions).  The port
has no partitioner and no HLO, so it counts them from the model's own
structure: the parameter and cache trees with their logical axes
(``transformer.param_specs`` / ``cache_specs``), the rules
(``parallel/sharding.rules_for``) and the blocks ``transformer.layout``
lists.  Every term is multiplied by the slots of its kind in the layout:
the port's explicit form of the reference's loop-trip scaling.
FLOPs need no such scaling (the reference's ``flops_scaled``): the dry
run's ``FlopCounterMode`` counts every layer the port runs.

:func:`collective_bytes` gives per-device payload bytes by kind in the
reference's format, each collective counted by the bytes of its output on
one device (as the reference sums output shapes).  It counts:

* **FSDP all-gathers** (train, prefill): each parameter leaf with an
  ``fsdp`` dimension on mesh axes of size > 1, gathered over those axes,
  once per use in each pass: the forward, and in training once more in the
  backward, where remat's recompute and the gradient products share one
  gather.  Decode gathers nothing: ``rules_for`` replicates its activations
  and the weights stay sharded (weight-stationary).
* **Gradient reductions** (train, once a step, in the parameters' dtype):
  a reduce-scatter over ``fsdp``'s axes for FSDP leaves, an all-reduce over
  the in-pod batch axes for the others; on a mesh with a ``pod`` axis,
  every gradient shard crosses it through the int8 compressed all-reduce
  (``parallel/compression``), whose payload is int32 (4 bytes an element)
  and one fp32 scale a leaf, counted under ``all-reduce``.
* **Matmul partial sums** (tensor parallelism, and decode's
  weight-stationary contractions): every matmul of every block whose
  contracting dimensions are sharded, in the pass's weight layout (FSDP
  gathered in train and prefill, not in decode), all-reduces its output
  over those axes, once per use: the forward, in training again in the
  recompute, and in the backward an all-reduce of the input gradient over
  the axes that shard the output dimensions (once for the matmuls that
  share an input: q/k/v, w1/w3).  A block's last projection whose output
  stays sharded over axes the tokens are not (decode) all-gathers it back
  into the residual stream.  The embedding lookup from a vocab-sharded
  table all-reduces its rows; the MoE's combine over experts sharded on the
  mesh all-reduces ``[tokens, D]`` (and its dispatch's transpose in the
  backward).

Not counted: sequence parallelism's reduce-scatter/all-gather form of the
residual all-reduces (``act_seq``), the attention-internal splits
(``q_per_kv``, ``attn_q``, decode's ``kv_seq``: their softmax statistics
and the KV all-gathers of split-Q), the loss's and the greedy argmax's
reductions over a vocab-sharded dimension, the gradient norm's scalar
all-reduce, and anything a partitioner would fuse or reorder.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import layers as L, transformer as T
from repro_torch.parallel import sharding as sh

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")


def tree_bytes(tree: Any, specs: Any, mesh, rules: dict) -> int:
    """Bytes one device of ``mesh`` holds of ``tree`` (tensors, ``meta``
    tensors included) laid out by the logical-axis tree ``specs`` under
    ``rules``; non-tensor leaves (a decode state's ``pos``) hold none."""
    shards = sh.tree_shardings(specs, mesh, rules)

    def walk(t, s):
        if isinstance(t, torch.Tensor):
            return s.nbytes(t.shape, t.element_size())
        if isinstance(t, dict):
            if set(t) != set(s):
                raise ValueError(f"tree keys {sorted(t)} ≠ spec keys {sorted(s)}")
            return sum(walk(t[k], s[k]) for k in t)
        return 0

    return walk(tree, shards)


@dataclasses.dataclass(frozen=True)
class _Matmul:
    path: tuple[str, ...]       # the weight inside its block (or at the top level)
    contract: tuple[int, ...]   # the weight's contracting dims (after its stack dims)
    tokens: str = "x"           # "x" the block's tokens, "enc" the encoder's, "cap" an expert's capacity
    group: str = ""             # matmuls of one group share their input: one input-gradient reduction
    residual: bool = False      # its output goes into the residual stream


def _block_matmuls(cfg: ModelConfig, kind: str, mode: str) -> list[_Matmul]:
    if kind == "mamba":
        return [_Matmul(("mamba", "in_proj"), (0,), group="in"),
                _Matmul(("mamba", "out_proj"), (0,), residual=True)]
    if cfg.attn_type == "mla" and kind != "cross":
        out = [_Matmul(("attn", w), (0,), group="x") for w in ("wq_a", "wkv_a")]
        out += [_Matmul(("attn", "wq_b"), (0,), group="qa")]
        out += [_Matmul(("attn", w), (0,), group="ckv") for w in ("wk_b", "wv_b")]
    else:
        out = [_Matmul(("attn", w), (0,), group="x") for w in ("wq", "wk", "wv")]
    out.append(_Matmul(("attn", "wo"), (0, 1), residual=True))
    if kind == "cross":
        out.append(_Matmul(("xattn", "wq"), (0,), group="xq"))
        if mode != "decode":  # decode reads the encoder's keys and values from the cache
            out += [_Matmul(("xattn", w), (0,), tokens="enc", group="enc") for w in ("wk", "wv")]
        out.append(_Matmul(("xattn", "wo"), (0, 1), residual=True))
    if kind == "moe":
        out.append(_Matmul(("moe", "router"), (0,), group="r"))
        out += [_Matmul(("moe", w), (1,), tokens="cap", group="e") for w in ("w1", "w3")]
        out.append(_Matmul(("moe", "w2"), (1,), tokens="cap"))
        if cfg.n_shared_experts:
            out += [_Matmul(("moe", "shared", w), (0,), group="s") for w in ("w1", "w3")]
            out.append(_Matmul(("moe", "shared", "w2"), (0,), residual=True))
    else:
        ws = ("w1",) if cfg.act == "gelu" else ("w1", "w3")
        out += [_Matmul(("mlp", w), (0,), group="m") for w in ws]
        out.append(_Matmul(("mlp", "w2"), (0,), residual=True))
    return out


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _axes(spec) -> set[str]:
    return {a for e in spec for a in sh.entry_axes(e)}


def _drop(spec, axes: set[str]):
    """``spec`` with ``axes`` taken out of every entry (those dims gathered over them)."""
    out = []
    for e in spec:
        kept = tuple(a for a in sh.entry_axes(e) if a not in axes)
        out.append(None if not kept else kept[0] if len(kept) == 1 else kept)
    return tuple(out)


def _prod(sizes, axes) -> int:
    return math.prod(sizes[a] for a in axes)


def collective_bytes(cfg: ModelConfig, shape: ShapeConfig, mesh, rules: dict) -> dict[str, float]:
    """Per-device collective payload bytes by kind for one step of the cell
    ``(cfg, shape)`` over ``mesh`` under ``rules`` (the module docstring
    lists the terms).  Parameters in ``cfg.param_dtype``, activations in
    ``cfg.dtype``."""
    sizes = mesh.sizes
    big = {a for a, n in sizes.items() if n > 1}
    rules = dict(sh.DEFAULT_RULES, **rules)
    out = {k: 0.0 for k in COLLECTIVES}
    mode, train = shape.kind, shape.kind == "train"
    params = T.init_params(cfg, torch.Generator(), torch.device("meta"))
    shards = sh.tree_shardings(T.param_specs(cfg), mesh, rules)

    def rule_axes(name):
        return set(sh.entry_axes(sh.entry_for(name, rules, set(sizes)))) & big

    fsdp, batch_axes = rule_axes("fsdp"), rule_axes("batch")
    act = torch.empty((), dtype=L.dt(cfg)).element_size()

    # tokens per device: the decoder's, the encoder's, an expert's capacity
    B, S = shape.global_batch, shape.seq_len
    split = _prod(sizes, batch_axes)
    tokens = {"x": B * (1 if mode == "decode" else S) / split, "enc": B * cfg.n_frontend_tokens / split,
              "p": B * cfg.n_frontend_tokens / split}
    if cfg.n_experts:
        full = mode == "prefill" or (mode == "decode" and cfg.attn_type != "mla")
        t = tokens["x"]
        tokens["cap"] = t if full else max(1, int(t * cfg.top_k / cfg.n_experts * cfg.capacity_factor))

    # the blocks each stack runs in one pass: its slots in the layout
    stacks = T.stack_shapes(cfg)
    slots = {name: 0 for name in stacks}
    for s in T.layout(cfg):
        slots[s.stack] += 1
    if cfg.family == "encdec" and mode != "decode":  # decode reads the encoder's output from the cache
        slots["encoder"] = cfg.encoder_layers

    def weight_spec(spec):  # train and prefill gather the FSDP dims before each use
        return spec if mode == "decode" else _drop(spec, fsdp)

    fwd_uses = 2 if train else 1  # training recomputes each block (remat)

    def matmul(w, spec, mm: _Matmul, n_stack: int, uses: int, fwd: int, reduced: set):
        """The partial-sum all-reduces (forward, recompute, the backward's
        input gradient) and the residual all-gather of a matmul by ``w``
        (mesh spec ``spec``; its first ``n_stack`` dims a stack), run
        ``uses`` times a pass; ``reduced`` holds the groups whose input
        gradient is already counted."""
        spec, w_shape = weight_spec(spec)[n_stack:], w.shape[n_stack:]
        tok = tokens[mm.tokens]
        outs = [d for d in range(len(w_shape)) if d not in mm.contract]

        def axes_of(dims):
            return {a for d in dims for a in sh.entry_axes(spec[d])} & big - batch_axes

        def nbytes(dims):
            return tok * act * math.prod(-(-w_shape[d] // _prod(sizes, axes_of([d]))) for d in dims)

        if axes_of(mm.contract):
            out["all-reduce"] += fwd * uses * nbytes(outs)
        if axes_of(outs):
            if mm.residual and mode == "decode":
                out["all-gather"] += uses * tok * act * cfg.d_model
            if train and (mm.group or mm.path) not in reduced:
                reduced.add(mm.group or mm.path)
                out["all-reduce"] += uses * nbytes(mm.contract)

    for name, uses in slots.items():
        kind = T._stack_kind(cfg, name)
        reduced: set = set()
        for mm in _block_matmuls(cfg, kind, mode):
            spec = _get(shards[name], mm.path).spec
            if kind == "encoder":
                mm = dataclasses.replace(mm, tokens="enc")
            matmul(_get(params[name], mm.path), spec, mm, len(stacks[name]), uses, fwd_uses, reduced)
        if kind == "moe" and rule_axes("experts"):
            # the combine sums over experts the mesh holds apart (and, in the backward, the dispatch's transpose)
            out["all-reduce"] += (fwd_uses + train) * uses * tokens["x"] * act * cfg.d_model

    # the top level, outside the remat blocks: the embedding lookup, the VLM's
    # patch projection, the unembedding (prefill: the last position alone)
    if set(sh.entry_axes(weight_spec(shards["embed"].spec)[0])) & big:
        out["all-reduce"] += tokens["x"] * act * cfg.d_model  # masked rows of a vocab-sharded table, summed
    if cfg.family == "vlm" and mode != "decode":
        matmul(params["patch_proj"], shards["patch_proj"].spec, _Matmul(("patch_proj",), (0,), tokens="p"), 0, 1, 1,
               set())
    if mode == "prefill":
        tokens["x"] = B / split
    if cfg.tie_embeddings:
        matmul(params["embed"].T, tuple(reversed(shards["embed"].spec)), _Matmul(("embed",), (0,)), 0, 1, 1, set())
    else:
        matmul(params["lm_head"], shards["lm_head"].spec, _Matmul(("lm_head",), (0,)), 0, 1, 1, set())

    # parameter traffic: FSDP gathers per use, gradient reductions once a step
    p_item = torch.empty((), dtype=L.pdt(cfg)).element_size()
    pod = {"pod"} & batch_axes
    in_pod = batch_axes - pod
    top_uses = {"embed": 2 if cfg.tie_embeddings else 1, "patch_proj": int(mode != "decode")}
    for path, w, s in _leaves(params, shards):
        # a stacked leaf holds every entry of its stack: runs of each entry a pass
        uses = slots.get(path[0], 0) / math.prod(stacks[path[0]]) if path[0] in stacks \
            else top_uses.get(path[0], 1)
        gathered = _axes(s.spec) & fsdp
        if gathered and mode != "decode":
            full = sh.ShardSpec(mesh, _drop(s.spec, gathered)).nbytes(w.shape, p_item)
            out["all-gather"] += (2 if train else 1) * uses * full
        if not train:
            continue
        shard = s.nbytes(w.shape, p_item)
        if gathered and gathered <= in_pod:
            out["reduce-scatter"] += shard
        if in_pod - gathered:
            out["all-reduce"] += shard
        if pod:  # the compressed pod all-reduce: int32 payload, one fp32 scale
            out["all-reduce"] += 4 * s.nbytes(w.shape, 1) + 4
    return {k: v for k, v in out.items() if v}


def _leaves(tree, shards, prefix=()):
    """(path, tensor, ShardSpec) of every leaf, in the tree's order."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], shards[k], prefix + (k,))
    else:
        yield prefix, tree, shards
