"""Straggler detection and elastic re-layout (framework-free).

The port's copy of the JAX package's ``training/elastic.py``.
:class:`StepWatchdog` flags hosts whose step time exceeds ``median ×
slack`` (median + MAD, so one outlier cannot poison the baseline); the
elastic scheduler's :class:`~repro_torch.scenario.scheduler.QueueWatch`
feeds it worker heartbeat ages.  :func:`elastic_plan` reassigns the rows
of the global batch when the data-parallel world size changes.
"""
from __future__ import annotations

import dataclasses
import statistics
from collections import defaultdict, deque
from typing import Optional


@dataclasses.dataclass(frozen=True)
class StragglerReport:
    step: int
    slow_hosts: tuple[int, ...]
    median_s: float
    worst_s: float


class StepWatchdog:
    """Per-host step-duration telemetry → straggler flags.

    MAD-based so a single fast/slow outlier can't poison the baseline.
    ``patience`` consecutive slow steps are required before flagging, so a
    transient GC pause doesn't evict a host.
    """

    def __init__(self, n_hosts: int, slack: float = 1.75, patience: int = 3, window: int = 32):
        self.n_hosts = n_hosts
        self.slack = slack
        self.patience = patience
        self.history: dict[int, deque] = {h: deque(maxlen=window) for h in range(n_hosts)}
        self._slow_streak: dict[int, int] = defaultdict(int)

    def report(self, host: int, step: int, duration_s: float) -> None:
        self.history[host].append((step, duration_s))

    def snapshot(self, step: int) -> Optional[StragglerReport]:
        latest = {}
        for h, dq in self.history.items():
            if dq and dq[-1][0] == step:
                latest[h] = dq[-1][1]
        if len(latest) < self.n_hosts:
            return None
        med = statistics.median(latest.values())
        mad = statistics.median(abs(v - med) for v in latest.values()) or 1e-9
        slow = []
        for h, v in latest.items():
            is_slow = v > med * self.slack and (v - med) / mad > 3.0
            self._slow_streak[h] = self._slow_streak[h] + 1 if is_slow else 0
            if self._slow_streak[h] >= self.patience:
                slow.append(h)
        return StragglerReport(
            step=step, slow_hosts=tuple(sorted(slow)), median_s=med, worst_s=max(latest.values())
        )


def elastic_plan(global_batch: int, old_dp: int, new_dp: int) -> dict[int, tuple[int, int]]:
    """Per-new-replica ``(start, size)`` rows of the global batch.

    Deterministic and gap-free: the union of all assignments covers
    ``[0, global_batch)`` exactly once, for any old and new world size, and
    the layout depends on ``new_dp`` alone (a rejoining host computes the
    survivors' plan).  A batch that ``new_dp`` does not divide takes
    ⌈global_batch / new_dp⌉ rows a replica, the last one fewer."""
    del old_dp
    per = -(-global_batch // new_dp)
    plan = {}
    start = 0
    for r in range(new_dp):
        size = min(per, global_batch - start)
        plan[r] = (start, size)
        start += size
    return plan
