"""Logical-axis sharding rules (T5X/MaxText style), as an accounting over a
logical mesh.

The JAX package annotates tensors with *logical* axis names and maps them
through one rules table to mesh axes, which GSPMD then places.  The port
keeps the same names, the same table and the same divisibility fallbacks
(:func:`rules_for`), so a rules dict means the same layout in both
packages.  It places nothing: the port runs one device a process, so a
mesh is a :class:`~repro_torch.launch.mesh.LogicalMesh` (axis names and
sizes) and a sharding is a :class:`ShardSpec`, which says what one device
would hold of a tensor (:meth:`ShardSpec.shard_shape`,
:meth:`ShardSpec.nbytes`).  The dry run (:mod:`repro_torch.launch.dryrun`)
and the accounting (:mod:`repro_torch.launch.hlo_analysis`) read them.

Default layout on the (pod, data, model) mesh:
  batch      → (pod, data)   data parallel across pods and the data axis
  fsdp       → data          weight shards gathered per layer (ZeRO-3 style)
  heads/mlp/experts/vocab → model   tensor/expert parallel

:func:`constrain` and :func:`shard_map` are the identity and a plain call
on one device (no mesh, or a mesh of size 1), and raise over several.

A mesh here is a ``LogicalMesh`` (``axis_names``, ``shape``, ``sizes``,
``size``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Optional

from repro_torch.launch.mesh import MULTI_DEVICE

_state = threading.local()

# a PartitionSpec: one entry a tensor dimension, each None (replicated), a
# mesh axis name, or a tuple of mesh axis names
PartitionSpec = tuple

DEFAULT_RULES: dict[str, Any] = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,
    "kv": None,
    "heads": "model",
    "kv_heads": "model",
    "qk": None,
    "mlp": "model",
    "moe_mlp": None,          # expert FF dim; takes "model" when experts can't
    "experts": "model",
    "expert_cap": ("pod", "data"),  # MoE capacity dim follows tokens
    "vocab": "model",
    "fsdp": "data",
    "layers": None,
    "conv": None,
    "state": None,
    "kv_seq": None,           # decode caches: sequence-sharded (flash-decoding)
    "act_seq": None,          # sequence parallelism: residual stream between
    "ssm_heads": "model",     # blocks sharded over model (Megatron-SP)
    "enc_seq": None,
    "q_per_kv": None,         # GQA group dim: carries head parallelism when
    "attn_q": None,           # kv heads can't; attn_q = split-Q fallback
    "kv_batch": ("pod", "data"),  # decode-cache batch dim (≠ activation batch)
}


def rules_for(
    cfg, mesh, *, kind: str = "train", global_batch: int = 0, seq_len: int = 0
) -> dict[str, Any]:
    """Derive per-arch/per-shape rules from divisibility on this mesh.

    Every mesh axis used to shard a tensor dim must divide it; where the
    canonical choice doesn't divide (e.g. 8 kv heads on a 16-way model
    axis) the rule falls back: heads→replicated, expert FF→model,
    decode-cache sequence→model (flash-decoding style split-S).
    """
    sizes = mesh.sizes
    model = sizes.get("model", 1)
    rules = dict(DEFAULT_RULES)

    # --- batch: largest (pod, data) prefix that divides the global batch
    dp = [a for a in ("pod", "data") if a in sizes]
    batch_axes: tuple = ()
    for k in range(len(dp), 0, -1):
        prod = 1
        for a in dp[:k]:
            prod *= sizes[a]
        if global_batch and global_batch % prod == 0:
            batch_axes = tuple(dp[:k])
            break
    rules["batch"] = batch_axes or None
    rules["expert_cap"] = batch_axes or None

    div = lambda n: n and n % model == 0  # noqa: E731
    rules["heads"] = "model" if div(cfg.n_heads) else None
    rules["kv_heads"] = "model" if div(cfg.n_kv_heads) else None
    rules["vocab"] = "model" if div(cfg.vocab_size) else None

    # all dims tagged "mlp" for this family must divide the model axis
    mlp_dims = [cfg.d_ff] if cfg.d_ff else []
    if cfg.ssm_state:
        d_inner = cfg.ssm_expand * cfg.d_model
        G, N, H = cfg.ssm_groups, cfg.ssm_state, d_inner // cfg.ssm_headdim
        conv_dim = d_inner + 2 * G * N
        mlp_dims += [d_inner, conv_dim, 2 * d_inner + 2 * G * N + H]
    if cfg.n_shared_experts:
        mlp_dims += [(cfg.moe_d_ff or cfg.d_ff) * cfg.n_shared_experts]
    rules["mlp"] = "model" if mlp_dims and all(d % model == 0 for d in mlp_dims) else None

    if cfg.n_experts:
        if cfg.n_experts % model == 0:
            rules["experts"], rules["moe_mlp"] = "model", None
        else:
            F = cfg.moe_d_ff or cfg.d_ff
            rules["experts"] = None
            rules["moe_mlp"] = "model" if F % model == 0 else None
    if cfg.ssm_state:
        d_inner = cfg.ssm_expand * cfg.d_model
        rules["ssm_heads"] = "model" if (d_inner // cfg.ssm_headdim) % model == 0 else None

    # attention-internal parallelism when kv heads can't cover the model
    # axis: prefer sharding the q-per-kv (GQA group) dim; else split-Q
    # (query-block dim) — both keep the blocked flash fully model-parallel
    if cfg.n_kv_heads:
        G = cfg.n_heads // max(1, cfg.n_kv_heads)
        if rules["kv_heads"] is None and G % model == 0 and G > 0:
            rules["q_per_kv"] = "model"
        elif rules["kv_heads"] is None and kind != "decode":
            rules["attn_q"] = "model"
    rules["kv_batch"] = batch_axes or None
    if kind == "decode":
        # split-S decode attention: shard caches along sequence when kv
        # heads can't cover the model axis (keeps per-chip KV ≤ HBM)
        rules["kv_seq"] = None if rules["kv_heads"] else "model"
        # activations replicate over the data axes: decode matmuls then
        # contract the data-sharded weight dim with activation-sized partial
        # sums instead of all-gathering the weights every token
        rules["batch"] = None
        rules["expert_cap"] = None
    if kind in ("train", "prefill") and seq_len and seq_len % model == 0:
        # sequence parallelism: the per-layer saved residuals (the dominant
        # training-memory term) shard over the model axis between blocks
        rules["act_seq"] = "model"
    return rules


def current_mesh():
    return getattr(_state, "mesh", None)


def current_rules() -> dict[str, Any]:
    return getattr(_state, "rules", DEFAULT_RULES)


@contextlib.contextmanager
def use_mesh(mesh, rules: Optional[dict] = None):
    """Activate a mesh + rules for :func:`spec_for` and :func:`constrain`."""
    prev = (current_mesh(), current_rules())
    _state.mesh = mesh
    _state.rules = dict(DEFAULT_RULES, **(rules or {}))
    try:
        yield
    finally:
        _state.mesh, _state.rules = prev


def entry_for(ax: Optional[str], rules: dict, names: Optional[set]):
    """One PartitionSpec entry: the mesh axes ``ax`` maps to, those absent
    from the mesh dropped (``names`` None: no mesh, none dropped)."""
    m = rules.get(ax) if ax else None
    if m is None:
        return None
    axes = (m,) if isinstance(m, str) else tuple(m)
    if names is not None:
        axes = tuple(a for a in axes if a in names)
    return axes[0] if len(axes) == 1 else (axes if axes else None)


def spec_for(*logical: Optional[str], rules: Optional[dict] = None) -> PartitionSpec:
    """PartitionSpec from logical axis names, dropping mesh axes not present."""
    rules = rules or current_rules()
    mesh = current_mesh()
    names = set(mesh.axis_names) if mesh is not None else None
    return tuple(entry_for(ax, rules, names) for ax in logical)


def entry_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one PartitionSpec entry."""
    return () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """What one device of ``mesh`` holds of a tensor laid out by ``spec``
    (the port's ``NamedSharding``): each dimension split over the product of
    its entry's axis sizes, rounded up (XLA pads an uneven split)."""

    mesh: Any
    spec: PartitionSpec

    def split(self, i: int) -> int:
        """Devices that dimension ``i`` is split over (1 past the spec)."""
        if i >= len(self.spec):
            return 1
        return math.prod(self.mesh.sizes[a] for a in entry_axes(self.spec[i]))

    def shard_shape(self, global_shape) -> tuple[int, ...]:
        if len(self.spec) > len(global_shape):
            raise ValueError(f"spec {self.spec} has more entries than shape {tuple(global_shape)} has dims")
        return tuple(-(-int(n) // self.split(i)) for i, n in enumerate(global_shape))

    def nbytes(self, global_shape, itemsize: int) -> int:
        """Bytes one device holds of a tensor of ``global_shape``."""
        return math.prod(self.shard_shape(global_shape)) * itemsize


def named_sharding(*logical: Optional[str], mesh=None) -> ShardSpec:
    mesh = mesh or current_mesh()
    if mesh is None:
        raise ValueError("named_sharding: no active mesh")
    return ShardSpec(mesh, spec_for(*logical))


def _is_spec(x) -> bool:
    return isinstance(x, tuple)


def tree_shardings(spec_tree: Any, mesh, rules: Optional[dict] = None) -> Any:
    """Tree of logical-axis tuples → tree of :class:`ShardSpec` (dicts and
    lists walked, tuples the leaves)."""
    rules = dict(DEFAULT_RULES, **(rules or {}))
    names = set(mesh.axis_names)

    def walk(t):
        if _is_spec(t):
            return ShardSpec(mesh, tuple(entry_for(ax, rules, names) for ax in t))
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        raise TypeError(f"tree_shardings: a spec leaf must be a tuple of logical axes, got {t!r}")

    return walk(spec_tree)


def _one_device(mesh) -> bool:
    return mesh is None or mesh.size == 1


def constrain(x, *logical: Optional[str]):
    """The layout hint of the JAX package's ``with_sharding_constraint``: the
    identity on one device (no mesh, or a mesh of size 1); over several it
    raises, since the port places nothing across devices."""
    mesh = current_mesh()
    if _one_device(mesh):
        return x
    raise NotImplementedError(f"constrain{logical} over a {tuple(mesh.shape)} mesh: {MULTI_DEVICE}")


def shard_map(fn, mesh, in_specs, out_specs, check: bool = False):
    """``fn`` itself on a one-device mesh (each device holds all of every
    operand); over several devices it raises."""
    if _one_device(mesh):
        return fn
    raise NotImplementedError(f"shard_map over a {tuple(mesh.shape)} mesh: {MULTI_DEVICE}")
