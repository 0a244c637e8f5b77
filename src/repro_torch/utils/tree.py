"""Tree utilities: leaf order, byte accounting, block grouping for streamed state.

The port's copy of the JAX package's ``utils/tree.py``.  A tree is nested
dicts, NamedTuples, lists, tuples and :class:`PartitionedState` (its
``.blocks``); ``None`` has no leaf and anything else is a leaf.  Leaves come in ``jax.tree_util``'s order — dict keys sorted,
NamedTuple fields and sequence items in order — and paths are named as
``jax.tree_util.keystr`` names them, so a leaf index means the same leaf in
both packages.

The heterogeneous-memory manager works on *blocks*: lists of leaves grouped
to roughly equal byte sizes.  Leaves stay separate (no concatenation), so
every block keeps its shapes and dtypes and moves as a list of tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.core.hetmem import PartitionedState

_LEAF = object()  # where a leaf sits in a TreeDef's skeleton


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> list[tuple[str, Any]] | None:
    """``(path step, child)`` of a node in leaf order, or None for a leaf."""
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f".{f}", v) for f, v in zip(tree._fields, tree)]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(tree)]
    if isinstance(tree, PartitionedState):  # its blocks; ``spare`` is scratch
        return [(".blocks", tree.blocks)]
    return None


def _rebuild(node, values: list) -> Any:
    """``node``'s container type around ``values`` (in ``_children`` order)."""
    if isinstance(node, dict):
        by_key = dict(zip(sorted(node), values))
        return {k: by_key[k] for k in node}
    if _is_namedtuple(node):
        return type(node)(*values)
    if isinstance(node, PartitionedState):
        return dataclasses.replace(node, blocks=values[0])
    return type(node)(values)


@dataclasses.dataclass(frozen=True)
class TreeDef:
    """A tree's structure: its containers with every leaf replaced by a marker."""

    skeleton: Any
    n_leaves: int

    def unflatten(self, leaves: Sequence[Any]) -> Any:
        it = iter(leaves)
        out = _map_skeleton(self.skeleton, lambda _: next(it))
        if next(it, _LEAF) is not _LEAF:
            raise ValueError(f"more than {self.n_leaves} leaves to unflatten")
        return out

    def flatten_up_to(self, tree: Any) -> list[Any]:
        """The subtrees of ``tree`` at this structure's leaves, in leaf order
        (``tree`` must have this structure down to them)."""
        out: list[Any] = []
        _walk_up_to(self.skeleton, tree, out)
        return out


# The walkers are module functions that take the output list: a recursive
# closure over it would form a reference cycle that keeps every leaf (a
# tensor of the card's memory) alive until the cyclic collector runs.
def _walk_up_to(skel, node, out: list) -> None:
    if skel is _LEAF:
        out.append(node)
        return
    if skel is None:
        return
    kids, have = _children(skel), _children(node)
    if have is None or [p for p, _ in kids] != [p for p, _ in have]:
        raise ValueError(f"tree does not match the structure at {[p for p, _ in kids]}")
    for (_, s), (_, n) in zip(kids, have):
        _walk_up_to(s, n, out)


def _walk(node, prefix: str, out: list) -> None:
    if node is None:
        return
    kids = _children(node)
    if kids is None:
        out.append((prefix, node))
        return
    for step, child in kids:
        _walk(child, prefix + step, out)


def _skeleton(node):
    if node is None:
        return None
    kids = _children(node)
    if kids is None:
        return _LEAF
    return _rebuild(node, [_skeleton(c) for _, c in kids])


def _map_skeleton(skel, fn):
    if skel is _LEAF:
        return fn(skel)
    if skel is None:
        return None
    kids = _children(skel)
    return _rebuild(skel, [_map_skeleton(c, fn) for _, c in kids])


def leaves_with_paths(tree: Any) -> list[tuple[str, Any]]:
    """Flatten ``tree`` to ``[(path_string, leaf), ...]`` in leaf order."""
    out: list[tuple[str, Any]] = []
    _walk(tree, "", out)
    return out


def tree_flatten(tree: Any) -> tuple[list[Any], TreeDef]:
    leaves = [leaf for _, leaf in leaves_with_paths(tree)]
    return leaves, TreeDef(skeleton=_skeleton(tree), n_leaves=len(leaves))


def tree_leaves(tree: Any) -> list[Any]:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the subtrees of ``rest`` at them."""
    leaves, treedef = tree_flatten(tree)
    others = [treedef.flatten_up_to(r) for r in rest]
    return treedef.unflatten([fn(x, *xs) for x, *xs in zip(leaves, *others)])


def _itemsize(dtype) -> int:
    return dtype.itemsize if isinstance(dtype, torch.dtype) else np.dtype(dtype).itemsize


def leaf_bytes(leaf: Any) -> int:
    """Bytes of an array leaf (anything with ``shape`` and ``dtype``)."""
    return int(np.prod(leaf.shape)) * _itemsize(leaf.dtype)


def byte_size(tree: Any) -> int:
    """Total bytes of all array leaves in ``tree``."""
    return sum(leaf_bytes(x) for x in tree_leaves(tree))


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """Assignment of tree leaves to ``npart`` blocks.

    ``block_of[i]`` is the block index of flat leaf ``i``; within a block the
    leaves keep their flat order.
    """

    treedef: TreeDef
    block_of: tuple[int, ...]
    npart: int

    def blocks_to_flat(self, blocks: Sequence[Sequence[Any]]) -> list[Any]:
        slots: list[Any] = [None] * len(self.block_of)
        cursor = [0] * self.npart
        for i, b in enumerate(self.block_of):
            slots[i] = blocks[b][cursor[b]]
            cursor[b] += 1
        return slots


def group_leaves_into_blocks(tree: Any, npart: int) -> tuple[list[list[Any]], BlockSpec]:
    """Greedily group leaves of ``tree`` into ``npart`` byte-balanced blocks.

    Returns ``(blocks, spec)`` where ``blocks[j]`` is a list of leaves and
    ``spec`` reassembles the original tree via :func:`reassemble_blocks`.
    Leaves are scanned largest-first (ties in leaf order) and each goes to
    the lightest block (the first of equals): LPT scheduling, which keeps
    the streamed pass's per-block transfer times balanced.
    """
    flat, treedef = tree_flatten(tree)
    npart = max(1, min(npart, len(flat)))
    sizes = [leaf_bytes(x) for x in flat]
    order = sorted(range(len(flat)), key=lambda i: -sizes[i])
    load = [0] * npart
    block_of = [0] * len(flat)
    for i in order:
        j = int(np.argmin(load))
        block_of[i] = j
        load[j] += sizes[i]
    blocks: list[list[Any]] = [[] for _ in range(npart)]
    for i, leaf in enumerate(flat):
        blocks[block_of[i]].append(leaf)
    return blocks, BlockSpec(treedef=treedef, block_of=tuple(block_of), npart=npart)


def reassemble_blocks(blocks: Sequence[Sequence[Any]], spec: BlockSpec) -> Any:
    """Inverse of :func:`group_leaves_into_blocks`."""
    return spec.treedef.unflatten(spec.blocks_to_flat(blocks))


def group_like(tree: Any, spec: BlockSpec) -> list[list[Any]]:
    """Group ``tree``'s leaves into blocks by an *existing* assignment, so
    gradients and parameters share the block layout of the offloaded
    optimizer state."""
    flat = tree_leaves(tree)
    if len(flat) != len(spec.block_of):
        raise ValueError(f"leaf count {len(flat)} != spec {len(spec.block_of)}")
    blocks: list[list[Any]] = [[] for _ in range(spec.npart)]
    for leaf, b in zip(flat, spec.block_of):
        blocks[b].append(leaf)
    return blocks


def map_blocks(fn: Callable, blocks: Sequence[Sequence[Any]]) -> list[list[Any]]:
    """Apply ``fn`` leaf-wise inside every block."""
    return [[fn(leaf) for leaf in blk] for blk in blocks]


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def tree_allclose(a: Any, b: Any, *, rtol: float = 1e-6, atol: float = 1e-6) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    if len(la) != len(lb):
        return False
    return all(np.allclose(_numpy(x), _numpy(y), rtol=rtol, atol=atol) for x, y in zip(la, lb))
