"""Heterogeneous memory management (the paper's core contribution), in PyTorch.

The spring state θ stays in *host* memory and streams through the card in
``npart`` blocks (Algorithm 3, executed by :mod:`repro_torch.core.stream`).
On CUDA, host placement means **pinned** CPU tensors, which the copy engines
can read and write asynchronously.  When the computation runs on the CPU
(the caller asked for ``device="cpu"``), host and device are the same memory
and every placement is the identity, as the JAX package's placements are on
its single-memory CPU runtime.
"""
from __future__ import annotations

import dataclasses

import torch


def check_divisible(n: int, npart: int, what: str = "axis size") -> int:
    """Validate ``npart | n`` and return the chunk size.

    Silent truncation would leave trailing quadrature points unevolved, so
    every Algorithm-3 block split raises the same error instead.
    """
    if npart < 1:
        raise ValueError(f"npart must be ≥ 1, got {npart}")
    if n % npart != 0:
        raise ValueError(f"{what} {n} not divisible by npart={npart}")
    return n // npart


def partition_arrays(tree: dict[str, torch.Tensor], npart: int) -> list[dict[str, torch.Tensor]]:
    """Split every tensor of ``tree`` into ``npart`` equal leading-axis chunks
    (views; the leading dim must be divisible by ``npart``)."""
    n = next(iter(tree.values())).shape[0]
    chunk = check_divisible(n, npart)
    return [{k: v[j * chunk:(j + 1) * chunk] for k, v in tree.items()} for j in range(npart)]


@dataclasses.dataclass
class PartitionedState:
    """State of Algorithm 3: ``npart`` blocks, each a list of tensors.

    ``spare``, when given, is a second set of blocks of the same shapes: a
    streamed pass then reads ``blocks``, writes the evolved blocks into
    ``spare`` and returns a state whose ``blocks`` are the set it wrote and
    whose ``spare`` is the set it read, so the old state outlives the pass.
    ``frozen`` names k-set lanes whose evolved rows are not written back
    (with ``spare``: both sets keep the rows they hold)."""

    blocks: list[list[torch.Tensor]]
    spare: list[list[torch.Tensor]] | None = None
    frozen: tuple[int, ...] = ()

    @property
    def npart(self) -> int:
        return len(self.blocks)


def transfers_real(device) -> bool:
    """True when host and ``device`` are different memories (CUDA)."""
    return torch.device(device).type == "cuda"


def put_host(tensors: list[torch.Tensor], device) -> list[torch.Tensor]:
    """Copy ``tensors`` into pinned host memory (identity when ``device`` is the CPU)."""
    if not transfers_real(device):
        return list(tensors)
    out = []
    for x in tensors:
        h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        h.copy_(x)
        out.append(h)
    return out


def is_pinned_host(x: torch.Tensor) -> bool:
    return x.device.type == "cpu" and x.is_pinned()

