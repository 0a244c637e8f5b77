"""Carry state across from the JAX package, as numpy arrays.

:func:`mesh_from_arrays` rebuilds the port's ``Mesh`` from any object or
dict with the reference ``Mesh``'s numpy fields; :func:`carry_from_numpy`
turns a mid-run Proposed 2 carry (as numpy) into the port's carry on an
operator set's device, so both packages can continue from the same
nonlinear state.  There are no learned weights on this path.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.fem import meshgen, multispring as ms, newmark
from repro_torch.fem.methods import partition_springs, springs_to_host

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


def carry_from_numpy(carry: dict[str, Any], ops, *, streamed: bool):
    """The port's carry for ``ops`` from a carry given as numpy arrays.

    ``carry`` holds the ``NewmarkState`` fields ``u, v, a, q``, ``springs``
    (the six ``[P,S]`` spring-state arrays by name), ``D [E,P,6,6]``,
    ``alpha``, ``beta_e`` and, as ``ops.cfg`` requires, ``du_prev``
    (``warm_start``) and ``Minv``/``step`` (``precond_every > 1``).  With
    ``streamed=True`` the springs are partitioned into ``cfg.npart`` blocks
    in pinned host memory (plain blocks when ``ops`` runs on the CPU).
    """
    cfg, dev = ops.cfg, ops.device

    def T(a, dtype=cfg.rdtype):
        return torch.tensor(np.asarray(a), dtype=dtype, device=dev)

    nm = newmark.NewmarkState(*(T(carry[k]) for k in ("u", "v", "a", "q")))
    springs = {}
    for k in ms.STATE_KEYS:
        dtype = torch.int32 if k in ms.FLAG_KEYS else cfg.rdtype
        springs[k] = torch.tensor(np.asarray(carry["springs"][k]), dtype=dtype,
                                  device="cpu" if streamed else dev)
    if streamed:
        springs = partition_springs(ops, springs, cfg.npart)
        if dev.type != "cpu":
            springs = springs_to_host(springs, dev)
    tail = ()
    if cfg.warm_start:
        tail += (T(carry["du_prev"]),)
    if cfg.precond_every > 1:
        tail += (T(carry["Minv"]), int(carry["step"]))
    return (nm, springs, T(carry["D"]), T(carry["alpha"]), T(carry["beta_e"]), *tail)
