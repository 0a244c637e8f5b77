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

``donate`` and k-set ensembles (``kset > 1``, :meth:`StreamEngine.kmap`)
are not ported yet (ROADMAP, "Ensembles and health").

Host blocks are updated **in place**: each evolved block is copied back
into the pinned host tensors it came from, so θ is held once in host
memory.  The copies are asynchronous; the host tensors are valid to read
from the CPU once the current stream has been synchronised.  When the
computation runs on the CPU, or with ``offload=False``, there are no
transfers and the evolved blocks are new tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Sequence

import torch

from repro_torch.core.hetmem import PartitionedState, transfers_real

SCHEDULES = ("serial", "prefetch")
_LATER = "not ported yet (ROADMAP: 'Ensembles and health')"


@dataclasses.dataclass(frozen=True)
class StreamPlan:
    """Declarative description of one streamed pass (Algorithm 3).

    ``npart``     number of host-resident blocks (must match the state).
    ``schedule``  "serial" | "prefetch" (see module docstring).
    ``prefetch``  copy-ahead depth for the "prefetch" schedule.
    ``offload``   False elides every transfer — semantics invariant.
    ``collect``   the per-block kernel returns ``(block', extra)``; the
                  device-resident extras are gathered into a list.
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
        if self.schedule == "donate":
            raise NotImplementedError(f"schedule 'donate' is {_LATER}")
        if self.kset != 1:
            raise NotImplementedError(f"k-set streaming (kset={self.kset}) is {_LATER}")
        if self.npart < 1:
            raise ValueError(f"npart must be ≥ 1, got {self.npart}")
        if self.schedule not in SCHEDULES:
            raise ValueError(f"schedule {self.schedule!r} not in {SCHEDULES}")
        if self.prefetch < 1:
            raise ValueError(f"prefetch depth must be ≥ 1, got {self.prefetch}")


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

    def kmap(self, *args, **kwargs):
        raise NotImplementedError(f"StreamEngine.kmap (k-set ensembles) is {_LATER}")

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
                out_blocks.append(list(new_blk))
                extras.append(extra)
        elif plan.schedule == "serial":
            out_blocks = self._serial(call, blocks, extras)
        else:
            out_blocks = self._prefetch(call, blocks, extras)
        return StreamResult(state=PartitionedState(blocks=out_blocks), carry=box[0],
                            extras=extras if plan.collect else [])

    def _serial(self, call, blocks, extras):
        dev = torch.device(self.plan.device)
        for j, host in enumerate(blocks):
            dev_blk = [x.to(dev, non_blocking=True) for x in host]
            new_blk, extra = call(j, dev_blk)
            for h, d in zip(host, new_blk):
                h.copy_(d, non_blocking=True)  # in place, same stream: ordered
            extras.append(extra)
        return blocks

    def _prefetch(self, call, blocks, extras):
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
                for h, d in zip(blocks[j], new_blk):
                    d.record_stream(d2h)  # not reused while the copy reads it
                    h.copy_(d, non_blocking=True)  # in place
        # Block j's copy back completes before anything later on the compute
        # stream, including the next pass's copy of block j to the device.
        compute.wait_stream(d2h)
        return blocks
