"""Process topology and barriers of a campaign: the one-process part.

A campaign's cases are embarrassingly parallel, so across processes the
only traffic would be coordination ("every shard of this checkpoint is on
disk, process 0 may commit the manifest").  The port runs one process on
one card: :func:`process_index` is 0, :func:`process_count` 1, and
:func:`barrier` returns at once.  What needs more than one process
(a barrier across processes) raises :class:`NotImplementedError`; the
multi-process campaign is not ported yet.  Unit tests still emulate a
sharded checkpoint from one process by giving
:class:`~repro_torch.training.checkpoint.CheckpointManager` a no-op barrier.
"""
from __future__ import annotations

import socket

MULTI_PROCESS = ("the port runs campaigns in one process; the multi-process campaign "
                 "(a barrier across processes) is not ported yet")


def process_index() -> int:
    """This process's rank: always 0."""
    return 0


def process_count() -> int:
    """World size: always 1."""
    return 1


def is_distributed() -> bool:
    return process_count() > 1


def barrier(tag: str) -> None:
    """Block until every process reaches this barrier: with one process,
    return at once.  ``tag`` names the synchronization point."""


def free_port() -> int:
    """An OS-assigned free TCP port on localhost (bind, then close: another
    process may take it before the caller binds it again)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def make_barrier(tag: str):
    """A zero-argument barrier bound to ``tag``: the injection point
    :class:`~repro_torch.training.checkpoint.CheckpointManager` takes, so
    tests can pass a no-op instead."""
    return lambda: barrier(tag)
