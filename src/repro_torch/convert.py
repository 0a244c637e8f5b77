"""Carry state across from the JAX package, as numpy arrays.

:func:`mesh_from_arrays` rebuilds the port's ``Mesh`` from any object or
dict with the reference ``Mesh``'s numpy fields; :func:`carry_from_numpy`
turns a mid-run carry of any of the four methods (as numpy) into the
port's carry on an operator set's device, so both packages can continue
from the same nonlinear state.  :func:`params_from_numpy` and
:func:`decode_state_from_numpy` do the same for a language model's
parameters (and any parameter-shaped tree, such as its gradients) and
for a decode state (the KV caches after a prefill),
:func:`adamw_state_from_numpy` for the resident AdamW state, and
:func:`surrogate_params_from_numpy` for a surrogate's params (the CNN+LSTM
or the SSM trajectory model).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.utils.tree import tree_leaves
from repro_torch.fem import meshgen, multispring as ms, newmark
from repro_torch.fem.methods import METHODS, partition_springs, springs_to_host
from repro_torch.models import transformer
from repro_torch.training.optimizer import AdamWState

_MATERIAL_FIELDS = tuple(f.name for f in dataclasses.fields(meshgen.Material))


def _get(obj, key):
    return obj[key] if isinstance(obj, dict) else getattr(obj, key)


def mesh_from_arrays(obj: Any) -> meshgen.Mesh:
    """The port's :class:`~repro_torch.fem.meshgen.Mesh` from an object or dict
    holding the reference ``Mesh``'s fields (arrays are copied)."""
    kwargs = {}
    for f in dataclasses.fields(meshgen.Mesh):
        v = _get(obj, f.name)
        if f.name == "materials":
            v = [meshgen.Material(**{k: float(_get(m, k)) for k in _MATERIAL_FIELDS}) for m in v]
        elif f.name == "npad":
            v = int(v)
        else:
            v = np.array(v)
        kwargs[f.name] = v
    return meshgen.Mesh(**kwargs)


def carry_from_numpy(carry: dict[str, Any], ops, *, method: str):
    """The port's carry for ``ops`` from a carry given as numpy arrays.

    ``carry`` holds the ``NewmarkState`` fields ``u, v, a, q``, ``springs``
    (the six ``[P,S]`` spring-state arrays by name), ``D [E,P,6,6]``,
    ``alpha``, ``beta_e`` and, as ``ops.cfg`` requires, ``du_prev``
    (``warm_start``) and, for ``proposed2`` with ``precond_every > 1``,
    ``Minv``/``step``.  The springs go where ``method`` keeps them: into
    ``cfg.npart`` blocks in pinned host memory for Proposed 1 and 2 (plain
    blocks when ``ops`` runs on the CPU), on ``ops.host`` for Baseline 2,
    on the device for Baseline 1.
    """
    if method not in METHODS:
        raise KeyError(method)
    cfg, dev = ops.cfg, ops.device
    streamed, host = method in ("proposed1", "proposed2"), method == "baseline2"

    def T(a, dtype=cfg.rdtype):
        return torch.tensor(np.asarray(a), dtype=dtype, device=dev)

    nm = newmark.NewmarkState(*(T(carry[k]) for k in ("u", "v", "a", "q")))
    springs = {}
    for k in ms.STATE_KEYS:
        dtype = torch.int32 if k in ms.FLAG_KEYS else cfg.rdtype
        springs[k] = torch.tensor(np.asarray(carry["springs"][k]), dtype=dtype,
                                  device=ops.host if streamed or host else dev)
    if streamed:
        springs = partition_springs(ops, springs, cfg.npart)
        if dev.type != "cpu":
            springs = springs_to_host(springs, dev)
    tail = ()
    if cfg.warm_start:
        tail += (T(carry["du_prev"]),)
    if method == "proposed2" and cfg.precond_every > 1:
        tail += (T(carry["Minv"]), int(carry["step"]))
    return (nm, springs, T(carry["D"]), T(carry["alpha"]), T(carry["beta_e"]), *tail)


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # numpy has no bf16 of its own: go through fp32, exactly
        return torch.tensor(a.astype(np.float32), device=device).to(torch.bfloat16)
    return torch.tensor(a, device=device)


def _tree(tree: Any, device) -> Any:
    if isinstance(tree, dict):
        return {k: _tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree(v, device) for v in tree]
    return _tensor(tree, device)


def params_from_numpy(tree: dict[str, Any], cfg, device) -> dict[str, Any]:
    """The port's parameters for ``cfg`` from the JAX ``init_params`` tree
    (leaves as numpy arrays; the same keys and stacked block tensors:
    ``[L,…]``, gemma2's pairs ``[L/2, 2, …]``, the MoE family's
    ``dense_layers`` and ``layers``, zamba2's ``groups [G, every, …]``,
    unstacked ``shared_attn`` and ``remainder``, whisper's ``encoder`` and
    ``enc_norm``, a VLM's ``patch_proj``)."""
    stacks = transformer.stack_shapes(cfg)
    expected = ({"embed", "final_norm", *stacks} | ({"lm_head"} if not cfg.tie_embeddings else set())
                | ({"enc_norm"} if cfg.family == "encdec" else set())
                | ({"patch_proj"} if cfg.family == "vlm" else set()))
    if set(tree) != expected:
        raise ValueError(f"parameter tree has keys {sorted(tree)}, expected {sorted(expected)}")
    params = _tree(tree, device)
    for name, lead in stacks.items():
        _check_stack(params[name], lead, name, cfg)
    return params


def adamw_state_from_numpy(state: Any, cfg, device) -> AdamWState:
    """The port's resident :class:`~repro_torch.training.optimizer.AdamWState`
    from the reference's (an object or dict with ``step`` and ``moments``:
    a parameter-shaped tree of ``{"m", "v"}`` leaves, numpy arrays), each
    moment tree checked as :func:`params_from_numpy` checks parameters."""
    moments = _get(state, "moments")

    def pick(tree, key):
        if isinstance(tree, dict) and set(tree) == {"m", "v"} and not isinstance(tree["m"], dict):
            return tree[key]
        if isinstance(tree, dict):
            return {k: pick(v, key) for k, v in tree.items()}
        raise ValueError(f"moments: a leaf {type(tree).__name__} where a {{'m', 'v'}} pair belongs")

    m, v = (params_from_numpy(pick(moments, key), cfg, device) for key in ("m", "v"))

    def join(a, b):
        return {k: join(a[k], b[k]) for k in a} if isinstance(a, dict) else {"m": a, "v": b}

    return AdamWState(step=int(np.asarray(_get(state, "step"))), moments=join(m, v))


def _check_stack(tree: Any, lead: tuple[int, ...], name: str, cfg) -> None:
    got = {tuple(t.shape[:len(lead)]) for t in tree_leaves(tree)}
    if got != {lead}:
        raise ValueError(f"{name}: layer stacks of {sorted(got)}, cfg {cfg.name} has {lead}")


def _keys(tree: Any) -> Any:
    return {k: _keys(v) for k, v in tree.items()} if isinstance(tree, dict) else None


def decode_state_from_numpy(state: dict[str, Any], cfg, device) -> dict[str, Any]:
    """The port's decode state from the JAX one (``pos`` and each cache,
    numpy leaves: ``layers``; gemma2's ``local`` and ``global``; the MoE
    family's ``dense_layers`` beside ``layers``; MLA's ``c_kv`` and
    ``k_rope``; the Mamba blocks' ``ssm`` and ``conv``, zamba2's nested
    ``groups [G, every, …]``, ``shared_attn`` and ``remainder``; whisper's
    ``enc_kv``), e.g. the state a JAX ``prefill`` returned.  Each cache's
    stack dimensions are checked against ``cfg``."""
    want = _keys(transformer.init_decode_state(cfg, 1, 1, device="meta"))
    if _keys(state) != want:
        raise ValueError(f"decode state has keys {_keys(state)}, {cfg.name} expects {want}")
    out = {"pos": int(np.asarray(state["pos"])), **{k: _tree(v, device) for k, v in state.items() if k != "pos"}}
    for key, lead in transformer.cache_stacks(cfg).items():
        _check_stack(out[key], lead, key, cfg)
    return out


_SURROGATE_KEYS = ({"enc", "lstm", "dec", "heads"}, {"enc", "layers", "out"})  # CNN+LSTM, trajectory


def surrogate_params_from_numpy(tree: dict[str, Any], device) -> dict[str, Any]:
    """The port's surrogate params on ``device`` from a JAX ``init_params``
    (or trained) tree of either family — the CNN+LSTM (``enc``/``lstm``/
    ``dec``/``heads``) or the SSM trajectory model (``enc``/``layers``/
    ``out``) — with numpy leaves: the same nested dicts and lists, the
    same leaf names, fp32 tensors."""
    if set(tree) not in _SURROGATE_KEYS:
        raise ValueError(f"surrogate tree has keys {sorted(tree)}, expected one of "
                         f"{[sorted(k) for k in _SURROGATE_KEYS]}")
    params = _tree(tree, device)
    bad = [t.dtype for t in tree_leaves(params) if t.dtype != torch.float32]
    if bad:
        raise ValueError(f"surrogate params are fp32; got {sorted(set(map(str, bad)))}")
    return params

