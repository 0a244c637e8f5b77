"""Straggler detection from step-time telemetry (framework-free).

The port's copy of the watchdog half of the JAX package's
``training/elastic.py``.  :class:`StepWatchdog` flags hosts whose step time
exceeds ``median × slack`` (median + MAD, so one outlier cannot poison the
baseline); the elastic scheduler's :class:`~repro_torch.scenario.scheduler.
QueueWatch` feeds it worker heartbeat ages.
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
