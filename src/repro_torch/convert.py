"""Carry state across from the JAX package, as numpy arrays.

:func:`mesh_from_arrays` rebuilds the port's ``Mesh`` from any object or
dict with the reference ``Mesh``'s numpy fields; :func:`carry_from_numpy`
turns a mid-run carry of any of the four methods (as numpy) into the
port's carry on an operator set's device, so both packages can continue
from the same nonlinear state.  :func:`params_from_numpy` and
:func:`decode_state_from_numpy` do the same for a language model's
parameters and for a decode state (the KV caches after a prefill), and
:func:`surrogate_params_from_numpy` for a surrogate's params (the CNN+LSTM
or the SSM trajectory model).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core.stream import tree_leaves
from repro_torch.fem import meshgen, multispring as ms, newmark
from repro_torch.fem.methods import METHODS, partition_springs, springs_to_host
from repro_torch.models import transformer

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
    (leaves as numpy arrays; same keys, stacked ``[L,…]`` layer tensors)."""
    transformer.check_supported(cfg)
    expected = {"embed", "layers", "final_norm"} | ({"lm_head"} if not cfg.tie_embeddings else set())
    if set(tree) != expected:
        raise ValueError(f"parameter tree has keys {sorted(tree)}, expected {sorted(expected)}")
    params = _tree(tree, device)
    if transformer.n_stacked(params["layers"]) != cfg.n_layers:
        raise ValueError(f"layer stack of {transformer.n_stacked(params['layers'])}, cfg has {cfg.n_layers}")
    return params


def decode_state_from_numpy(state: dict[str, Any], cfg, device) -> dict[str, Any]:
    """The port's decode state from the JAX one (``{"pos", "layers": {"k",
    "v"}}``, numpy leaves), e.g. the state a JAX ``prefill`` returned."""
    transformer.check_supported(cfg)
    return {"pos": int(np.asarray(state["pos"])), "layers": _tree(state["layers"], device)}


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

