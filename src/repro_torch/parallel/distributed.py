"""Process topology and barriers of a multi-process campaign.

A campaign's cases are embarrassingly parallel, so each process runs the
same program on the case slice it owns, and the only traffic between
processes is coordination: "every shard of this checkpoint is on disk,
process 0 may commit the manifest".  That coordination rides a
``torch.distributed`` process group on the **gloo** backend
(:func:`repro_torch.launch.bootstrap.distributed_init` brings it up), and
never a device collective:

* a barrier between file writes synchronizes hosts, not devices, so it
  must not need a device computation;
* the processes of one launch may share one card, which NCCL refuses
  (two ranks on one device).

Without a process group :func:`process_index` is 0, :func:`process_count`
1 and :func:`barrier` returns at once, so callers never branch on world
size.
"""
from __future__ import annotations

import datetime
import itertools
import random
import socket

import torch.distributed as torch_dist

_BARRIER_TIMEOUT_MS = 600_000
# processes reach the same call sites in the same order (a campaign's control
# flow is deterministic), so one counter a process keeps the tags aligned
_counter = itertools.count()


def group_up() -> bool:
    return torch_dist.is_available() and torch_dist.is_initialized()


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return torch_dist.get_rank() if group_up() else 0


def process_count() -> int:
    """World size (1 without a process group)."""
    return torch_dist.get_world_size() if group_up() else 1


def is_distributed() -> bool:
    return process_count() > 1


def barrier(tag: str, *, timeout_ms: int = _BARRIER_TIMEOUT_MS) -> None:
    """Block until every process reaches this barrier; return at once with
    one process.

    ``tag`` and a per-process counter name the synchronization point
    (``ckpt_3``): a barrier that times out, or loses a peer, raises
    :class:`RuntimeError` naming it and the ranks gloo saw missing."""
    if not is_distributed():
        return
    name = f"{tag}_{next(_counter)}"
    try:
        torch_dist.monitored_barrier(timeout=datetime.timedelta(milliseconds=timeout_ms), wait_all_ranks=True)
    except RuntimeError as e:
        raise RuntimeError(f"barrier {name} across {process_count()} processes failed on process "
                           f"{process_index()}: {e}") from e


def _ephemeral_low() -> int:
    """The first port of the OS's ephemeral range (Linux's default where it cannot be read)."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            return int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 32768


def free_port() -> int:
    """A free TCP port on localhost, drawn at random from the 12,288 ports
    below the OS's ephemeral range: between this call and the caller's bind
    (a process group's store, seconds later in a child), no socket bound to
    port 0 or connecting out (a gloo pair, a store's client) can take it, as
    it could an OS-assigned port; another caller of this function still may,
    one time in thousands.  An OS-assigned port where none of 64 draws is
    free."""
    low = _ephemeral_low()
    for port in random.Random().sample(range(max(1024, low - 12288), low), 64):
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
            return port
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def make_barrier(tag: str):
    """A zero-argument barrier bound to ``tag``: the injection point
    :class:`~repro_torch.training.checkpoint.CheckpointManager` takes, so
    tests can pass a no-op instead."""
    return lambda: barrier(tag)
