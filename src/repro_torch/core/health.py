"""Per-case numerical health of a k-set: detect, freeze, and quarantine
diverged cases.

A k-set advances many independent cases at once.  When one case's
constitutive update or CG solve goes non-finite, nothing in plain
arithmetic stops the NaN from marching forward in *time*: every later step
of that case computes on garbage.  (The lanes of a k-set are arithmetically
independent, so siblings are untouched, but an unflagged diverged lane
looks like a healthy one downstream.)

* a per-case **health word** — an int32 bitmask of everything that has
  gone wrong for that case so far (sticky: bits set, never cleared), one
  per lane, ``[k]`` on the host;
* :func:`guard_step` — wraps a k-set FEM step so that after each step the
  words update from (carry finiteness, spring-state finiteness, CG
  convergence) and, once a *fatal* bit trips, the case's lane of the carry
  is **frozen**: its old value is written back into the new carry, so
  non-finite values never enter the carry and the case's observables stay
  finite while its siblings go on;
* helpers to report and exclude (:func:`diverged`, :func:`describe`).

The port's counterpart of the JAX package's ``core/health.py``, over a
native k-set instead of a ``vmap``: every tensor leaf of a carry has the
member axis first.  Freezing writes only the tripped lanes, in place (a
whole-carry select would copy θ, 14.2 GB at the full-size mesh with k = 2,
every step), so the old carry must still exist when the step returns.  θ
resident on the device (or Baseline 2's on the host) is a new tensor each
step; θ streamed through pinned host blocks (Proposed 1 with
``offload=True``) is given a second host set that the passes alternate
between (:func:`guard_step`).
"""
from __future__ import annotations

import torch

from repro_torch.core.hetmem import PartitionedState
from repro_torch.core.stream import leaves_in_insertion_order

# -- health word bits --------------------------------------------------------
BIT_CARRY_NONFINITE = 1    # non-finite value somewhere in the step carry
BIT_SPRINGS_NONFINITE = 2  # non-finite constitutive (multispring) state
BIT_SOLVER_NONFINITE = 4   # CG produced a non-finite residual/solution
BIT_NONCONVERGED = 8       # CG hit maxiter with relres > tol (informational)

#: bits that freeze a case
FATAL = BIT_CARRY_NONFINITE | BIT_SPRINGS_NONFINITE | BIT_SOLVER_NONFINITE

_BIT_NAMES = {
    BIT_CARRY_NONFINITE: "carry_nonfinite",
    BIT_SPRINGS_NONFINITE: "springs_nonfinite",
    BIT_SOLVER_NONFINITE: "solver_nonfinite",
    BIT_NONCONVERGED: "nonconverged",
}


def init_word(k: int) -> torch.Tensor:
    """Healthy (all-clear) health words for ``k`` cases."""
    return torch.zeros((k,), dtype=torch.int32)


def is_live(word: torch.Tensor) -> torch.Tensor:
    """True while no fatal bit has tripped (the case still advances)."""
    return (word & FATAL) == 0


def diverged(word) -> torch.Tensor:
    """Elementwise: has this case tripped a fatal bit?"""
    return (torch.as_tensor(word) & FATAL) != 0


def describe(word: int) -> str:
    """Human-readable bit list for manifests/logs (``"healthy"`` if 0)."""
    bits = [name for bit, name in _BIT_NAMES.items() if int(word) & bit]
    return "+".join(bits) if bits else "healthy"


def _tensors(tree) -> list[torch.Tensor]:
    """The tensor leaves of ``tree``, a :class:`PartitionedState`'s blocks
    included (Proposed 1's θ with ``offload=False``: ``[k, chunk, S]`` blocks)."""
    out = []
    for x in leaves_in_insertion_order(tree):
        if isinstance(x, PartitionedState):
            out.extend(t for blk in x.blocks for t in blk)
        elif isinstance(x, torch.Tensor):
            out.append(x)
    return out


def _finite_lanes(leaves) -> torch.Tensor | None:
    """Per lane (host bool ``[k]``): every floating leaf of ``leaves`` is
    finite on that lane (``None`` when no leaf is floating).  The lanes are
    combined on each device, so the host waits once a device."""
    on_device: dict[torch.device, torch.Tensor] = {}
    for leaf in leaves:
        if leaf.is_floating_point():
            lane = torch.isfinite(leaf.reshape(leaf.shape[0], -1)).all(dim=1)
            prev = on_device.get(lane.device)
            on_device[lane.device] = lane if prev is None else prev & lane
    ok = None
    for lane in on_device.values():
        ok = lane.cpu() if ok is None else ok & lane.cpu()
    return ok


def finite_all(tree) -> torch.Tensor:
    """Per lane (host bool ``[k]``): every floating leaf of the k-set ``tree``
    is finite on that lane.  Integer leaves (spring direction flags, counters)
    are finite by construction and skipped; ``tree`` holds at least one
    floating leaf (a carry, or θ)."""
    return _finite_lanes(_tensors(tree))


def freeze(live: torch.Tensor, new_tree, old_tree):
    """``new_tree`` with each lane where ``live`` is False set back to
    ``old_tree``'s, in place, leaf by leaf; returns ``new_tree``.

    A :class:`PartitionedState` written into the second set of
    ``old_tree``'s (``new.spare is old.blocks``) has its dead lanes' rows
    copied once, when they trip; they join ``frozen``, so later passes skip
    their write-back and both sets keep them."""
    dead = (~live).nonzero().flatten()
    if not dead.numel():
        return new_tree
    for n, o in zip(leaves_in_insertion_order(new_tree), leaves_in_insertion_order(old_tree)):
        lanes = dead
        if isinstance(n, PartitionedState):
            if n.spare is not None and n.spare is o.blocks:
                lanes = torch.tensor([i for i in dead.tolist() if i not in n.frozen], dtype=torch.long)
                n.frozen = tuple(dead.tolist())
            pairs = list(zip((t for blk in n.blocks for t in blk), (t for blk in o.blocks for t in blk)))
        elif isinstance(n, torch.Tensor):
            pairs = [(n, o)]
        else:
            continue
        for nt, ot in pairs:
            if nt is not ot and lanes.numel():
                idx = lanes.to(nt.device)
                nt[idx] = ot[idx]
    return new_tree


def update_word(word, new_carry, springs, aux) -> torch.Tensor:
    """Fold one step's outcome into the health words (sticky bits).
    ``springs`` is the carry's constitutive state: it is read once, for both
    its own bit and the carry's."""
    spring_leaves = _tensors(springs)
    theirs = {id(t) for t in spring_leaves}
    springs_ok = _finite_lanes(spring_leaves)
    rest_ok = _finite_lanes([t for t in _tensors(new_carry) if id(t) not in theirs])
    carry_ok = springs_ok if rest_ok is None else springs_ok & rest_ok
    trip = torch.where(carry_ok, 0, BIT_CARRY_NONFINITE)
    trip |= torch.where(springs_ok, 0, BIT_SPRINGS_NONFINITE)
    trip |= torch.where(torch.isfinite(aux.relres), 0, BIT_SOLVER_NONFINITE)
    trip |= torch.where(aux.converged, 0, BIT_NONCONVERGED)
    return word | trip.to(torch.int32)


def initial_guard_carry(carry):
    """Wrap a bare k-set step carry for :func:`guard_step`:
    ``(carry, word [k], nonconverged_steps [k])``."""
    k = carry[0][0].shape[0]  # the Newmark state's u: [k,N,3]
    return (carry, init_word(k), torch.zeros((k,), dtype=torch.int32))


def _with_second_set(carry, springs_index: int = 1):
    """``carry`` with its streamed θ (a :class:`PartitionedState`) given a
    second set of blocks, allocated like the first (pinned host memory
    where the first is pinned); the identity when it has one already."""
    ps = carry[springs_index]
    if not isinstance(ps, PartitionedState):
        raise ValueError(f"a step with θ updated in place needs θ as a PartitionedState at carry[{springs_index}], "
                         f"got {type(ps).__name__}")
    if ps.spare is not None:
        return carry
    spare = [[torch.empty(x.shape, dtype=x.dtype, device=x.device, pin_memory=x.is_pinned()) for x in blk]
             for blk in ps.blocks]
    two = PartitionedState(blocks=ps.blocks, spare=spare, frozen=ps.frozen)
    return (*carry[:springs_index], two, *carry[springs_index + 1:])


def _synchronize(tree) -> None:
    """Wait for the current stream of the CUDA device ``tree`` computes on
    (the streamed pass's copies back into host blocks are queued there)."""
    for x in leaves_in_insertion_order(tree):
        if isinstance(x, torch.Tensor) and x.device.type == "cuda":
            torch.cuda.current_stream(x.device).synchronize()
            return


def guard_step(step, *, springs_index: int = 1):
    """Wrap a k-set ``step(carry, f_t) -> (carry', aux)`` with health tracking.

    The wrapped step operates on ``(carry, word, ncg)`` — see
    :func:`initial_guard_carry`.  ``springs_index`` locates the constitutive
    state inside the carry tuple (the FEM step factories keep it at 1).
    ``aux`` exposes ``relres`` and ``converged`` per lane
    (:class:`repro_torch.fem.methods.StepAux`).

    A step that streams θ through host blocks it updates in place
    (``step.theta_in_place``: Proposed 1 with ``offload=True``) gets a
    second host set of θ on its first call (:func:`_with_second_set`): each
    pass reads one set and writes the other, and the carry points at the set
    just written, as the reference's functional update keeps old and new θ
    across the step.  A lane that trips has its rows of the old set copied
    into the new one once, on the host; its write-back is skipped from then
    on, so both sets keep its frozen θ.  While every lane is healthy this
    adds no transfer and no host copy; it costs a second pinned θ (k × 7.08
    GB at the full-size mesh, 150 springs) and a wait for the pass's copies
    before the host reads θ's finiteness each step.  The blocks of the carry
    handed to the first call are written by the second.
    """
    two_sets = getattr(step, "theta_in_place", False)

    def wrapped(hcarry, f_t):
        inner, word, ncg = hcarry
        if two_sets:
            inner = _with_second_set(inner, springs_index)
        new_inner, aux = step(inner, f_t)
        if two_sets:
            _synchronize(new_inner)  # the host blocks are read below
        live_before = is_live(word)
        word_new = torch.where(live_before, update_word(word, new_inner, new_inner[springs_index], aux), word)
        frozen = freeze(is_live(word_new), new_inner, inner)
        # count genuine maxiter exhaustion only while the case is live
        # (a non-finite residual trips BIT_SOLVER_NONFINITE instead)
        ncg_new = ncg + (live_before & ~aux.converged & torch.isfinite(aux.relres)).to(ncg.dtype)
        return (frozen, word_new, ncg_new), aux

    return wrapped
