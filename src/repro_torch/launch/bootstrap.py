"""Launcher bootstrap: the multi-process flags, for one process.

The JAX package's launchers parse ``--coordinator`` / ``--num-processes`` /
``--process-id`` before importing JAX and bring up ``jax.distributed``.
The port parses the same flags so the launchers accept them, runs one
process, and raises for more (:class:`NotImplementedError`).  Importing this module imports no torch.
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.parallel.distributed import MULTI_PROCESS


def force_host_devices(flag: str = "--host-devices", default: int = 0) -> int:
    """Parse ``flag`` from ``sys.argv``: the count of virtual host devices the
    JAX package can force.  The port has one device, so any count above 1
    raises.  Returns the requested count (0 = not requested)."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument(flag, type=int, default=default, dest="n")
    args, _ = ap.parse_known_args()
    if args.n > 1:
        raise NotImplementedError(f"{flag} {args.n}: the port runs on one device; several host devices are "
                                  f"not ported")
    return args.n


@dataclasses.dataclass(frozen=True)
class DistributedArgs:
    """Parsed multi-host topology (``num_processes == 1`` → single-host)."""

    coordinator: str | None = None  # "host:port" of process 0's service
    num_processes: int = 1
    process_id: int = 0

    def __post_init__(self):
        if self.num_processes < 1:
            raise ValueError(f"num_processes must be ≥ 1, got {self.num_processes}")
        if not 0 <= self.process_id < self.num_processes:
            raise ValueError(f"process_id {self.process_id} outside [0, {self.num_processes})")
        if self.num_processes > 1 and not self.coordinator:
            raise ValueError("num_processes > 1 requires a coordinator host:port")

    @property
    def distributed(self) -> bool:
        return self.num_processes > 1


def parse_distributed(argv=None) -> DistributedArgs:
    """Parse the multi-host flags (unknown flags are left for the launcher's
    own parser)."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--coordinator", default=None, help="process 0's coordination address, host:port")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    args, _ = ap.parse_known_args(argv)
    return DistributedArgs(coordinator=args.coordinator, num_processes=args.num_processes,
                           process_id=args.process_id)


def distributed_init(dist: DistributedArgs | None = None, **overrides) -> DistributedArgs:
    """Bring up the process group of a multi-process launch: nothing to do
    for one process, and :class:`NotImplementedError` for more.  ``dist``
    defaults to :func:`parse_distributed` over ``sys.argv``; keyword
    overrides build the config programmatically."""
    if dist is None:
        dist = DistributedArgs() if overrides else parse_distributed()
    if overrides:
        dist = dataclasses.replace(dist, **overrides)
    if dist.distributed:
        raise NotImplementedError(f"--num-processes {dist.num_processes}: {MULTI_PROCESS}")
    return dist
