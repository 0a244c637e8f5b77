"""StreamEngine: the executor of Algorithm-3 block streaming, on CUDA streams.

Copy block ``j`` host→device, run a per-block kernel, copy the evolved block
back, and overlap block ``j±k``'s transfers with block ``j``'s compute.

Schedules
---------
``serial``
    transfer-in → compute → transfer-out per block, all on the current
    stream, in order.  With ``offload=False`` it is bit-identical to the
    resident computation.
``prefetch`` (depth ``k`` ≥ 1)
    Block ``j+k``'s host→device copy is issued on a copy stream before
    block ``j``'s compute, and each evolved block goes back on a second copy
    stream, both ordered by CUDA events: ``k+1`` device-resident input
    blocks (``k=1`` is the paper's double buffer).  The kernels and their
    order are those of ``serial``, so the result is bit-identical to it.

``donate``
    The paper's GPU realization: exactly two device buffers per block leaf,
    allocated once per pass and reused block after block, with block
    ``j+1``'s copy in flight during block ``j``'s compute (depth 1).  A
    buffer is refilled only after the compute that read it and the copy
    back of what that compute returned have completed.  The kernel's
    outputs are its own allocations (PyTorch's caching allocator recycles
    them), so the result is bit-identical to ``serial``.

k-set ensembles (generalized 2SET)
----------------------------------
``kset=k`` declares a leading ensemble axis of size ``k`` on every block
leaf; the engine refuses a block that lacks it.  The per-block kernel sees
the whole k-set block and advances the ``k`` members independently, so one
launch serves every member: the k-set form of the paper's Proposed 2
"2SET" (two problem sets batched through the memory EBE frees).  This is
where the port differs from the JAX package, whose engine ``vmap``s a
one-member kernel: ``torch.func.vmap`` can map neither a ctypes kernel
launch nor a CG loop that stops where the data says.  ``per_block`` and
``broadcast`` inputs are passed as they are (shared by the members unless
they carry the axis themselves).  :meth:`StreamEngine.kmap` maps a
one-member function over the leading axis, and :func:`stack_kset` …
:func:`unstack_kset_state` build and split k-set trees.

Host blocks are updated **in place**: each evolved block is copied back
into the pinned host tensors it came from, so θ is held once in host
memory.  A state with a second set (``PartitionedState.spare``) is read
from one set and written into the other instead, and the returned state
points at the set just written, with the set read as its spare: the old
state then outlives the pass (what ``health.guard_step`` needs to freeze a
lane), at the cost of a second host copy of θ and no extra transfer.  The
lanes in ``PartitionedState.frozen`` are not written back.  The copies are
asynchronous; the host tensors are valid to read from the CPU once the
current stream has been synchronised.  When the computation runs on the
CPU, or with ``offload=False``, there are no transfers and the evolved
blocks are new tensors (copied into the second set where there is one).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core.hetmem import PartitionedState, transfers_real

SCHEDULES = ("serial", "prefetch", "donate")


@dataclasses.dataclass(frozen=True)
class StreamPlan:
    """Declarative description of one streamed pass (Algorithm 3).

    ``npart``     number of host-resident blocks (must match the state).
    ``schedule``  "serial" | "prefetch" | "donate" (see module docstring).
    ``prefetch``  copy-ahead depth for the "prefetch" schedule.
    ``offload``   False elides every transfer — semantics invariant.
    ``collect``   the per-block kernel returns ``(block', extra)``; the
                  device-resident extras are gathered into a list.
    ``kset``      ensemble members per block leaf (1 = no ensemble axis).
    ``device``    where the per-block kernel runs.
    """

    npart: int
    schedule: str = "serial"
    prefetch: int = 1
    offload: bool = True
    collect: bool = False
    kset: int = 1
    device: Any = "cpu"

    def __post_init__(self):
        if self.npart < 1:
            raise ValueError(f"npart must be ≥ 1, got {self.npart}")
        if self.schedule not in SCHEDULES:
            raise ValueError(f"schedule {self.schedule!r} not in {SCHEDULES}")
        if self.prefetch < 1:
            raise ValueError(f"prefetch depth must be ≥ 1, got {self.prefetch}")
        if self.kset < 1:
            raise ValueError(f"kset must be ≥ 1, got {self.kset}")

    @property
    def device_buffers(self) -> int:
        """Device-resident block count implied by the schedule."""
        if not self.offload:
            return self.npart  # resident regime: everything on the device
        if self.schedule == "prefetch":
            return self.prefetch + 1
        return 2  # serial / donate: the paper's double buffer


class StreamResult(NamedTuple):
    state: PartitionedState
    carry: Any
    extras: list


class StreamEngine:
    """Executes a :class:`StreamPlan` over a :class:`PartitionedState`.

    The per-block kernel ``fn`` sees device-resident operands and returns the
    evolved block (a list of tensors):

    ==============================  =========================================
    plan                            ``fn`` signature → return
    ==============================  =========================================
    plain                           ``fn(blk, *pb_j, *bc) → blk'``
    ``collect=True``                ``… → (blk', extra)``
    ``carry=…`` passed to ``run``   ``fn(blk, carry, *pb_j, *bc) → (blk', carry')``
    carry + collect                 ``… → (blk', carry', extra)``
    ==============================  =========================================

    A carry threads through the blocks in order (the serving decode's hidden
    state flowing through layer groups).  It does not hold back prefetch:
    the copies depend only on the host blocks, not on the carry.
    """

    def __init__(self, plan: StreamPlan):
        self.plan = plan

    def kmap(self, fn: Callable[..., Any], *mapped: Any, broadcast: Sequence[Any] = ()):
        """Map the one-member ``fn`` over the leading k-set axis of every
        tensor in ``mapped`` (``broadcast`` args are shared) and stack the
        results.  A loop over the members: the device-resident limit of the
        plan, for functions that have no k-set form of their own."""
        k = self.plan.kset
        for x in leaves_in_insertion_order(mapped):
            if not isinstance(x, torch.Tensor) or x.dim() < 1 or x.shape[0] != k:
                raise ValueError(f"k-set leading axis {tuple(getattr(x, 'shape', ()))} != kset={k}")
        outs = [fn(*(_member(t, i) for t in mapped), *broadcast) for i in range(k)]
        return stack_kset(outs)

    def run(self, fn: Callable[..., Any], state: PartitionedState, *,
            per_block: Sequence[Sequence[Any]] = (), broadcast: Sequence[Any] = (),
            carry: Any = None) -> StreamResult:
        plan = self.plan
        blocks = state.blocks
        npart = len(blocks)
        if plan.npart != npart:
            raise ValueError(f"plan.npart={plan.npart} but state has {npart} blocks")
        for i, pb in enumerate(per_block):
            if len(pb) != npart:
                raise ValueError(f"per_block[{i}] has {len(pb)} entries, expected {npart}")
        if plan.kset > 1:
            for j, blk in enumerate(blocks):
                for x in blk:
                    if x.dim() < 1 or x.shape[0] != plan.kset:
                        raise ValueError(
                            f"kset={plan.kset} but block {j} leaf has shape {tuple(x.shape)} — "
                            f"stack members with stack_kset_states")
        if state.spare is not None and [[(x.shape, x.dtype) for x in b] for b in state.spare] != [
                [(x.shape, x.dtype) for x in b] for b in blocks]:
            raise ValueError("the second set of blocks (spare) differs in shape or dtype from the blocks")
        dst = blocks if state.spare is None else state.spare  # where the evolved blocks go
        frozen = state.frozen
        bc = tuple(broadcast)
        has_carry = carry is not None
        box = [carry]  # the carry after the blocks called so far

        def call(j, dev_blk):
            args = (*(pb[j] for pb in per_block), *bc)
            if not has_carry:
                out = fn(dev_blk, *args)
                return out if plan.collect else (out, None)
            out = fn(dev_blk, box[0], *args)
            new_blk, box[0], extra = out if plan.collect else (*out, None)
            return new_blk, extra

        extras: list = []
        if not (plan.offload and transfers_real(plan.device)):
            out_blocks = []
            for j in range(npart):
                new_blk, extra = call(j, blocks[j])
                if state.spare is not None:
                    _write_back(dst[j], new_blk, frozen)
                    new_blk = dst[j]
                out_blocks.append(list(new_blk))
                extras.append(extra)
        elif plan.schedule == "serial":
            out_blocks = self._serial(call, blocks, dst, frozen, extras)
        elif plan.schedule == "prefetch":
            out_blocks = self._prefetch(call, blocks, dst, frozen, extras)
        else:
            out_blocks = self._donate(call, blocks, dst, frozen, extras)
        spare = None if state.spare is None else blocks
        return StreamResult(state=PartitionedState(blocks=out_blocks, spare=spare, frozen=frozen), carry=box[0],
                            extras=extras if plan.collect else [])

    def _serial(self, call, blocks, dst, frozen, extras):
        dev = torch.device(self.plan.device)
        for j, host in enumerate(blocks):
            dev_blk = [x.to(dev, non_blocking=True) for x in host]
            new_blk, extra = call(j, dev_blk)
            _write_back(dst[j], new_blk, frozen)  # same stream: ordered
            extras.append(extra)
        return dst

    def _prefetch(self, call, blocks, dst, frozen, extras):
        dev = torch.device(self.plan.device)
        npart, depth = len(blocks), self.plan.prefetch
        compute = torch.cuda.current_stream(dev)
        h2d, d2h = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
        # Work already queued on the compute stream (an earlier pass's
        # copies back into these host blocks) completes before any copy here.
        h2d.wait_stream(compute)
        d2h.wait_stream(compute)
        ready: dict[int, tuple[list[torch.Tensor], torch.cuda.Event]] = {}

        def issue(j):
            with torch.cuda.stream(h2d):
                dev_blk = [x.to(dev, non_blocking=True) for x in blocks[j]]
                ready[j] = (dev_blk, h2d.record_event())

        for j in range(min(depth, npart)):
            issue(j)
        for j in range(npart):
            if j + depth < npart:
                issue(j + depth)
            dev_blk, arrived = ready.pop(j)
            compute.wait_event(arrived)
            for x in dev_blk:
                # allocated on the copy stream, read on the compute stream:
                # its memory is not reused before the compute has read it
                x.record_stream(compute)
            new_blk, extra = call(j, dev_blk)
            extras.append(extra)
            d2h.wait_event(compute.record_event())
            with torch.cuda.stream(d2h):
                for d in new_blk:
                    d.record_stream(d2h)  # not reused while the copy reads it
                _write_back(dst[j], new_blk, frozen)
        # Block j's copy back completes before anything later on the compute
        # stream, including the next pass's copy of block j to the device.
        compute.wait_stream(d2h)
        return dst

    def _donate(self, call, blocks, dst, frozen, extras):
        dev = torch.device(self.plan.device)
        shapes = [(tuple(x.shape), x.dtype) for x in blocks[0]]
        for j, blk in enumerate(blocks):
            if [(tuple(x.shape), x.dtype) for x in blk] != shapes:
                raise ValueError(f"schedule 'donate' reuses two buffers per leaf: block {j}'s leaves "
                                 f"differ from block 0's")
        compute = torch.cuda.current_stream(dev)
        h2d, d2h = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
        h2d.wait_stream(compute)
        d2h.wait_stream(compute)
        # the two buffers of every leaf, allocated once for the pass
        bufs = [[torch.empty(s, dtype=d, device=dev) for s, d in shapes] for _ in range(2)]
        arrived: list = [None, None]
        released: list = [None, None]  # after the last compute and copy back that read buffer s

        def issue(j):
            s = j % 2
            with torch.cuda.stream(h2d):
                if released[s] is not None:
                    h2d.wait_event(released[s])
                for b, h in zip(bufs[s], blocks[j]):
                    b.copy_(h, non_blocking=True)
                arrived[s] = h2d.record_event()

        issue(0)
        for j in range(len(blocks)):
            s = j % 2
            if j + 1 < len(blocks):
                issue(j + 1)
            compute.wait_event(arrived[s])
            new_blk, extra = call(j, bufs[s])
            extras.append(extra)
            d2h.wait_event(compute.record_event())
            with torch.cuda.stream(d2h):
                for d in new_blk:
                    d.record_stream(d2h)  # not reused while the copy reads it
                _write_back(dst[j], new_blk, frozen)
                released[s] = d2h.record_event()  # the compute came before it on d2h
        compute.wait_stream(d2h)
        compute.wait_stream(h2d)
        return dst


def _write_back(dst: list[torch.Tensor], new_blk: Sequence[torch.Tensor], frozen: tuple[int, ...]) -> None:
    """Copy an evolved block into the host tensors ``dst`` in place, on the
    current stream, leaving the k-set lanes in ``frozen`` as they are."""
    for h, d in zip(dst, new_blk):
        if not frozen:
            h.copy_(d, non_blocking=True)
            continue
        for i in range(h.shape[0]):
            if i not in frozen:
                h[i].copy_(d[i], non_blocking=True)


# ---------------------------------------------------------------------------
# k-set trees: tensors in (nested) dicts, lists, tuples and NamedTuples
# ---------------------------------------------------------------------------


def tree_map(fn, *trees):
    """``fn`` over the leaves of identically-structured trees, keeping the
    structure (dicts, lists, tuples, NamedTuples; anything else is a leaf)."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, tuple) and hasattr(t, "_fields"):  # NamedTuple
        return type(t)(*(tree_map(fn, *xs) for xs in zip(*trees)))
    if isinstance(t, (list, tuple)):
        return type(t)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def leaves_in_insertion_order(tree):
    """The leaves of ``tree`` in :func:`tree_map`'s visiting order: dict keys
    as inserted.  ``utils.tree.tree_leaves`` sorts dict keys instead, as
    ``jax.tree_util`` does; the two orders must not be mixed."""
    out = []
    tree_map(out.append, tree)
    return out


def _member(tree, i):
    return tree_map(lambda x: x[i], tree)


def stack_kset(trees: Sequence[Any]) -> Any:
    """Stack ``k`` identically-structured trees along a new leading axis."""
    return tree_map(lambda *xs: torch.stack(xs, dim=0), *trees)


def broadcast_kset(tree: Any, k: int) -> Any:
    """Replicate one tree ``k``-fold along a new leading ensemble axis.

    The result is materialised (``expand`` then ``clone``): a stride-0 view
    would let one lane's in-place update write into every lane."""
    return tree_map(lambda x: x.unsqueeze(0).expand(k, *x.shape).clone(), tree)


def pad_kset(arr, multiple: int, axis: int = 0):
    """Pad ``arr``'s ensemble axis up to a ``multiple`` → ``(padded, valid)``.

    The tail is padded with repeats of the last case (keeping the padded
    lanes numerically well-behaved) and ``valid`` (numpy bool) masks them
    out.  ``arr`` is a numpy array or a tensor, and the result the same."""
    n = arr.shape[axis]
    if n == 0:
        raise ValueError("cannot pad an empty ensemble axis")
    pad = (-n) % multiple
    valid = np.arange(n + pad) < n
    if pad == 0:
        return arr, valid
    idx = [slice(None)] * arr.ndim
    idx[axis] = slice(n - 1, n)
    last = arr[tuple(idx)]
    if isinstance(arr, torch.Tensor):
        return torch.cat([arr, last.repeat_interleave(pad, dim=axis)], dim=axis), valid
    return np.concatenate([arr, np.repeat(last, pad, axis=axis)], axis=axis), valid


def unstack_kset(tree: Any, k: int) -> list[Any]:
    """Inverse of :func:`stack_kset`."""
    return [_member(tree, i) for i in range(k)]


def stack_kset_states(states: Sequence[PartitionedState]) -> PartitionedState:
    """Stack ``k`` identically-partitioned states into one k-set state:
    every block leaf gains a leading ``k`` axis; stream the result with a
    ``kset=k`` plan to advance all members in one pass."""
    npart = len(states[0].blocks)
    for s in states[1:]:
        if len(s.blocks) != npart:
            raise ValueError("k-set members must share the block partition")
    return PartitionedState(blocks=[stack_kset([s.blocks[j] for s in states]) for j in range(npart)])


def unstack_kset_state(state: PartitionedState, k: int) -> list[PartitionedState]:
    """Inverse of :func:`stack_kset_states`."""
    return [PartitionedState(blocks=[_member(blk, i) for blk in state.blocks]) for i in range(k)]
