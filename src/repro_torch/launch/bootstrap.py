"""Launcher bootstrap: the multi-process flags and the process group.

Multi-process launchers bootstrap in two steps, as the JAX package's do:

1. :func:`parse_distributed` reads ``--coordinator`` / ``--num-processes``
   / ``--process-id`` / ``--cpu-backend``;
2. :func:`distributed_init` brings up the ``torch.distributed`` process
   group (gloo, ``tcp://<coordinator>``) that
   :mod:`repro_torch.parallel.distributed` synchronizes through.

``--cpu-backend`` runs the processes on the CPU (the launcher reads it as
``--device cpu``): the rehearsal of a multi-process launch without a card.
Importing this module imports no torch.
"""
from __future__ import annotations

import argparse
import atexit
import dataclasses

_INIT_TIMEOUT_S = 600


def force_host_devices(flag: str = "--host-devices", default: int = 0) -> int:
    """Parse ``flag`` from ``sys.argv``: the count of virtual host devices the
    JAX package can force.  The port has one device a process, so any count
    above 1 raises.  Returns the requested count (0 = not requested)."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument(flag, type=int, default=default, dest="n")
    args, _ = ap.parse_known_args()
    if args.n > 1:
        raise NotImplementedError(f"{flag} {args.n}: the port runs on one device; several host devices are "
                                  f"not ported")
    return args.n


@dataclasses.dataclass(frozen=True)
class DistributedArgs:
    """Parsed multi-process topology (``num_processes == 1`` → one process)."""

    coordinator: str | None = None  # "host:port" of process 0's store
    num_processes: int = 1
    process_id: int = 0
    cpu_backend: bool = False       # run on the CPU (multi-process rehearsal)

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
    """Parse the multi-process flags (unknown flags are left for the
    launcher's own parser)."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--coordinator", default=None, help="process 0's coordination address, host:port")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--cpu-backend", action="store_true", help="run on the CPU (multi-process rehearsal)")
    args, _ = ap.parse_known_args(argv)
    return DistributedArgs(coordinator=args.coordinator, num_processes=args.num_processes,
                           process_id=args.process_id, cpu_backend=args.cpu_backend)


def _teardown() -> None:
    import torch.distributed as torch_dist

    if torch_dist.is_initialized():
        torch_dist.destroy_process_group()


def distributed_init(dist: DistributedArgs | None = None, **overrides) -> DistributedArgs:
    """Bring up the process group of a multi-process launch and return the
    args.  One process needs none: a no-op, so launchers call this
    unconditionally.  ``dist`` defaults to :func:`parse_distributed` over
    ``sys.argv``; keyword overrides (``coordinator=…, num_processes=…,
    process_id=…``) build the config programmatically.

    The group is gloo over ``tcp://<coordinator>`` (process 0 hosts the
    store there) and carries barriers only; it is destroyed at interpreter
    exit.  Every process blocks here until all ``num_processes`` have
    joined (at most ten minutes)."""
    if dist is None:
        dist = DistributedArgs() if overrides else parse_distributed()
    if overrides:
        dist = dataclasses.replace(dist, **overrides)
    if dist.distributed:
        import datetime

        import torch.distributed as torch_dist

        if torch_dist.is_initialized():
            raise RuntimeError("a torch.distributed process group is already up in this process")
        torch_dist.init_process_group("gloo", init_method=f"tcp://{dist.coordinator}", rank=dist.process_id,
                                      world_size=dist.num_processes,
                                      timeout=datetime.timedelta(seconds=_INIT_TIMEOUT_S))
        atexit.register(_teardown)
    return dist
