"""Int8 error-feedback gradient compression for the slow (cross-pod) axis.

The JAX package's ``parallel/compression.py`` over a ``torch.distributed``
process group instead of a ``shard_map`` axis: each process of the group is
one member of the compressed axis and holds its own gradients and its own
residual.  Per leaf, in fp32, the same arithmetic in the same order:

  g32       = g + r
  scale     = all_reduce_max(max|g32|) / 127 + 1e-30   (one scalar)
  q         = clamp(round(g32 / scale), −127, 127)     int8
  sum_q     = all_reduce_sum(q as int32)
  mean      = sum_q · scale / n                         in g's dtype
  residual' = g32 − q·scale                             (stays local, added next step)

The summed payload on the wire is int32, as the reference sums
``q.astype(int32)``: four bytes an element, the size of an fp32 gradient.
The quantisation bounds the error of the mean; it does not cut the bytes
of this all-reduce.  Error feedback keeps the accumulated bias bounded
over steps (1-bit Adam / EF-SGD lineage).

The default group is the launch's (``launch/bootstrap.distributed_init``,
gloo), whose ``all_reduce`` takes CPU and CUDA tensors alike; with no group
the "axis" has one member and the mean is that member's dequantised
gradient.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as torch_dist

from repro_torch.utils.tree import tree_flatten, tree_map


def _group_size(group) -> int:
    if not (torch_dist.is_available() and torch_dist.is_initialized()):
        return 1
    return torch_dist.get_world_size(group)


def _all_reduce(x: torch.Tensor, op, group) -> torch.Tensor:
    if _group_size(group) > 1:
        torch_dist.all_reduce(x, op=op, group=group)
    return x


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` correctly rounded on every device: CUDA turns a division by a
    python number into a multiplication by its rounded reciprocal, an ulp
    off the CPU's (and the reference's) quotient now and then."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def _compress_leaf(g: torch.Tensor, r: torch.Tensor, group):
    n = _group_size(group)
    g32 = g.float() + r
    scale = _div(_all_reduce(g32.abs().max(), torch_dist.ReduceOp.MAX, group), 127.0) + 1e-30
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    new_r = g32 - q.float() * scale
    summed = _all_reduce(q.to(torch.int32), torch_dist.ReduceOp.SUM, group).float()
    return _div(summed * scale, float(n)).to(g.dtype), new_r


def compressed_mean_grads(grads: Any, residual: Any, group=None) -> tuple[Any, Any]:
    """All-reduce-mean ``grads`` over the processes of ``group`` (None: the
    default group) with an int8 quantisation and its error-feedback
    ``residual`` (fp32 leaves shaped like ``grads``) → (mean grads, new
    residual).  Every process must call it with trees of the same
    structure and leaf shapes; leaves go one by one, in the tree's order."""
    g_flat, treedef = tree_flatten(grads)
    r_flat = treedef.flatten_up_to(residual)
    out, res = zip(*(_compress_leaf(g, r, group) for g, r in zip(g_flat, r_flat))) if g_flat else ((), ())
    return treedef.unflatten(list(out)), treedef.unflatten(list(res))


def init_residual(grads_like: Any) -> Any:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads_like)
