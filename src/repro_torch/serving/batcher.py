"""Request microbatcher: bounded queue → padded engine batches (numpy and
threads only: the port's own copy of the JAX package's
``serving/batcher.py``).

The serving front door.  Callers :meth:`MicroBatcher.submit` individual
requests (each carrying one or more input rows) and get a
:class:`concurrent.futures.Future` back; a background thread coalesces
queued requests into engine batches under a ``max_batch`` / ``max_wait_ms``
flush policy:

* **flush-on-full** — the moment pending rows reach ``max_batch``;
* **flush-on-timeout** — when the *oldest* pending request has waited
  ``max_wait_ms``, whatever has accumulated goes (latency floor for quiet
  traffic).

The engine pads each batch to its bucket shapes (the ``pad_kset``-style
pad+mask of :mod:`repro_torch.serving.engine`), so every batch runs at one
of a few fixed shapes however requests coalesce — and because rows are
independent and the same shape runs the same kernels, a request's result
is bit-identical whether it rode a full batch or its own (test-asserted).

A :class:`repro_torch.serving.cache.ResultCache` short-circuits ``submit``:
a hit resolves the future on the caller thread without touching the queue
or the device.  A :class:`repro_torch.serving.feedback.FeedbackLog` observes
every computed request's uncertainty score and routes high-scoring
scenarios back to the campaign planner.

Reliability (the numerical-health layer's serving half):

* **per-request deadlines** — a request older than its deadline at flush
  time fails with :class:`DeadlineExceededError` instead of occupying a
  batch slot its caller has already given up on;
* **split-retry isolation** — when a batch's engine call raises, the
  batch bisects and retries each half, recursively, until the poison
  request fails *alone* with the original error while every coalesced
  neighbor still gets its result;
* **non-finite output detection** — a request whose output rows contain
  NaN/Inf fails with :class:`NonFiniteOutputError` (and is never cached
  or fed back) instead of serving garbage;
* **circuit breaker** — ``breaker_threshold`` consecutive engine failures
  open the breaker: flushes fail fast with :class:`CircuitOpenError`
  without touching the engine for ``breaker_cooldown_s``, then one
  half-open probe either closes it or re-opens it.

Per-request latency is accounted in three phases — queue wait, batch
compute, total — surfaced by :meth:`MicroBatcher.stats` next to the cache
hit/miss/eviction counters and the health counters above.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Optional

import numpy as np


class DeadlineExceededError(TimeoutError):
    """The request's deadline passed before its batch flushed."""


class NonFiniteOutputError(RuntimeError):
    """The engine returned NaN/Inf rows for this request."""


class CircuitOpenError(RuntimeError):
    """The circuit breaker is open: the engine has failed
    ``breaker_threshold`` consecutive times and is cooling down."""


@dataclasses.dataclass
class Request:
    """One serving request: a cache ``key`` + input rows ``x [n, ...]``.

    ``meta`` travels untouched to the feedback log (the surrogate serving
    path puts the :class:`~repro_torch.scenario.catalog.Scenario` here so
    high-uncertainty requests can be routed back to the planner).
    ``deadline`` is an absolute ``time.monotonic()`` instant (None → no
    deadline).
    """

    key: str
    x: np.ndarray
    meta: Any = None
    t_submit: float = 0.0
    t_flush: float = 0.0
    future: Optional[Future] = None
    deadline: Optional[float] = None

    @property
    def n(self) -> int:
        return int(self.x.shape[0])


@dataclasses.dataclass(frozen=True)
class ServedResult:
    """What a request's future resolves to."""

    y: np.ndarray          # [n, ...] output rows
    score: float           # max uncertainty score over the request's rows
    cached: bool           # served from the result cache
    wait_ms: float         # queue wait (0 for cache hits)
    infer_ms: float        # batch compute share (0 for cache hits)


class MicroBatcher:
    """Batches requests through one :class:`~repro_torch.serving.engine.Engine`.

    ``queue_depth`` bounds the submit queue — a saturated server applies
    backpressure at ``submit`` (blocks) rather than growing without bound.

    ``deadline_ms`` is the default per-request deadline (None → none);
    ``breaker_threshold`` consecutive engine failures trip the circuit
    breaker (0 disables it); ``nonfinite_check`` fails requests whose
    output rows are non-finite.
    """

    def __init__(
        self,
        engine,
        *,
        max_batch: int = 8,
        max_wait_ms: float = 5.0,
        queue_depth: int = 256,
        cache=None,
        feedback=None,
        deadline_ms: Optional[float] = None,
        breaker_threshold: int = 0,
        breaker_cooldown_s: float = 1.0,
        nonfinite_check: bool = True,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be ≥ 1, got {max_batch}")
        if max_wait_ms < 0:
            raise ValueError(f"max_wait_ms must be ≥ 0, got {max_wait_ms}")
        if deadline_ms is not None and deadline_ms <= 0:
            raise ValueError(f"deadline_ms must be > 0, got {deadline_ms}")
        if breaker_threshold < 0:
            raise ValueError(f"breaker_threshold must be ≥ 0, got {breaker_threshold}")
        self.engine = engine
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.cache = cache
        self.feedback = feedback
        self.deadline_s = None if deadline_ms is None else float(deadline_ms) / 1e3
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_cooldown_s = float(breaker_cooldown_s)
        self.nonfinite_check = bool(nonfinite_check)
        self._q: "queue.Queue[Optional[Request]]" = queue.Queue(maxsize=queue_depth)
        self._lock = threading.Lock()
        self._stats = {
            "requests": 0, "rows": 0, "batches": 0,
            "flush_full": 0, "flush_timeout": 0, "flush_drain": 0,
            "cache_hits": 0,
            "wait_ms_sum": 0.0, "infer_ms_sum": 0.0, "wait_ms_max": 0.0,
            # -- health counters --------------------------------------------
            "engine_failures": 0,     # engine.infer exceptions observed
            "split_retries": 0,       # failed batches bisected for isolation
            "poison_requests": 0,     # requests failed alone after isolation
            "nonfinite_outputs": 0,   # requests refused on NaN/Inf outputs
            "deadline_expired": 0,    # requests failed on their deadline
            "breaker_trips": 0,       # closed/half-open → open transitions
            "breaker_rejected": 0,    # requests failed fast while open
        }
        # circuit breaker: consecutive engine failures; open until t
        self._consec_failures = 0
        self._open_until: Optional[float] = None
        self._closed = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # -- front door ---------------------------------------------------------
    def _cache_key(self, key: str) -> tuple:
        return (self.engine.signature(), key)

    def submit(
        self, key: str, x, meta: Any = None,
        deadline_ms: Optional[float] = None,
    ) -> Future:
        """Enqueue one request; returns a future of :class:`ServedResult`.

        The result cache is consulted *here*, on the caller thread: a hit
        never enqueues, never batches, never touches the device.
        ``deadline_ms`` overrides the batcher default for this request.
        """
        if self._closed:
            raise RuntimeError("batcher is closed")
        fut: Future = Future()
        if self.cache is not None:
            hit = self.cache.get(self._cache_key(key))
            if hit is not None:
                with self._lock:
                    self._stats["requests"] += 1
                    self._stats["cache_hits"] += 1
                fut.set_result(dataclasses.replace(hit, cached=True))
                return fut
        dl_s = (float(deadline_ms) / 1e3 if deadline_ms is not None
                else self.deadline_s)
        now = time.monotonic()
        req = Request(key=key, x=np.asarray(x), meta=meta, t_submit=now,
                      future=fut, deadline=None if dl_s is None else now + dl_s)
        if req.x.ndim < 1 or req.n < 1:
            raise ValueError(f"request x must be [n≥1, ...], got {req.x.shape}")
        self._q.put(req)
        return fut

    # -- batch loop ---------------------------------------------------------
    def _loop(self) -> None:
        pending: list[Request] = []
        rows = 0
        while True:
            if pending:
                deadline = pending[0].t_submit + self.max_wait_s
                timeout = max(0.0, deadline - time.monotonic())
            else:
                timeout = None  # idle: block until traffic (or close)
            try:
                req = self._q.get(timeout=timeout)
            except queue.Empty:
                self._flush(pending, "timeout")
                pending, rows = [], 0
                continue
            if req is None:  # close sentinel: drain everything and exit
                # requests enqueued concurrently with close() can land
                # *behind* the sentinel — drain past it so no future is
                # ever abandoned unresolved (callers would hang forever)
                while True:
                    try:
                        extra = self._q.get_nowait()
                    except queue.Empty:
                        break
                    if extra is not None:
                        pending.append(extra)
                group: list[Request] = []
                grows = 0
                for r in pending:
                    if group and grows + r.n > self.max_batch:
                        self._flush(group, "drain")
                        group, grows = [], 0
                    group.append(r)
                    grows += r.n
                self._flush(group, "drain")
                return
            pending.append(req)
            rows += req.n
            if rows >= self.max_batch:
                self._flush(pending, "full")
                pending, rows = [], 0

    # -- circuit breaker (call with self._lock held) -------------------------
    def _breaker_state_locked(self, now: float) -> str:
        if self.breaker_threshold <= 0 or self._open_until is None:
            return "closed"
        return "open" if now < self._open_until else "half_open"

    def _record_engine_failure_locked(self, now: float) -> None:
        self._stats["engine_failures"] += 1
        self._consec_failures += 1
        tripped = (
            self.breaker_threshold > 0
            and self._consec_failures >= self.breaker_threshold
        )
        reopened = self._breaker_state_locked(now) == "half_open"
        if tripped or reopened:
            self._open_until = now + self.breaker_cooldown_s
            self._stats["breaker_trips"] += 1

    def _record_engine_success_locked(self) -> None:
        self._consec_failures = 0
        self._open_until = None  # half-open probe succeeded → closed

    def _flush(self, pending: list[Request], reason: str) -> None:
        if not pending:
            return
        t0 = time.monotonic()
        # expired requests fail here instead of occupying batch slots
        live = []
        for r in pending:
            if r.deadline is not None and t0 > r.deadline:
                with self._lock:
                    self._stats["deadline_expired"] += 1
                r.future.set_exception(DeadlineExceededError(
                    f"request {r.key!r} expired "
                    f"{(t0 - r.deadline) * 1e3:.1f} ms past its deadline "
                    f"before its batch flushed"
                ))
            else:
                live.append(r)
        pending = live
        if not pending:
            return
        with self._lock:
            state = self._breaker_state_locked(t0)
            if state == "open":
                self._stats["breaker_rejected"] += len(pending)
        if state == "open":
            err = CircuitOpenError(
                f"circuit breaker open after {self._consec_failures} "
                f"consecutive engine failure(s); cooling down"
            )
            for r in pending:
                r.future.set_exception(err)
            return
        try:
            xb = np.concatenate([r.x for r in pending], axis=0)
            res = self.engine.infer(xb)
        except Exception as e:  # noqa: BLE001 — fail requests, not the loop
            with self._lock:
                self._record_engine_failure_locked(time.monotonic())
            if len(pending) == 1:
                # isolation floor: the poison request fails alone, with
                # the engine's original error
                with self._lock:
                    self._stats["poison_requests"] += 1
                pending[0].future.set_exception(e)
                return
            # split-retry: bisect so a poison request cannot take its
            # coalesced neighbors down with it
            with self._lock:
                self._stats["split_retries"] += 1
            mid = len(pending) // 2
            self._flush(pending[:mid], reason)
            self._flush(pending[mid:], reason)
            return
        infer_ms = (time.monotonic() - t0) * 1e3
        with self._lock:
            self._record_engine_success_locked()
            st = self._stats
            st["batches"] += 1
            st[f"flush_{reason}"] += 1
            st["requests"] += len(pending)
            st["rows"] += sum(r.n for r in pending)
            st["infer_ms_sum"] += infer_ms
        lo = 0
        for r in pending:
            hi = lo + r.n
            y = np.asarray(res.y[lo:hi])
            score = float(np.max(res.score[lo:hi]))
            lo = hi
            wait_ms = (t0 - r.t_submit) * 1e3
            with self._lock:
                self._stats["wait_ms_sum"] += wait_ms
                self._stats["wait_ms_max"] = max(self._stats["wait_ms_max"], wait_ms)
            if self.nonfinite_check and not np.isfinite(y).all():
                with self._lock:
                    self._stats["nonfinite_outputs"] += 1
                r.future.set_exception(NonFiniteOutputError(
                    f"engine returned non-finite output rows for request "
                    f"{r.key!r} — refusing to serve (or cache) garbage"
                ))
                continue
            out = ServedResult(y=y, score=score, cached=False,
                               wait_ms=wait_ms, infer_ms=infer_ms)
            if self.cache is not None:
                self.cache.put(self._cache_key(r.key), out)
            if self.feedback is not None:
                self.feedback.observe(r.meta, score, key=r.key)
            r.future.set_result(out)

    # -- lifecycle / telemetry ---------------------------------------------
    def stats(self) -> dict:
        """Counter snapshot (+ cache counters when a cache is attached)."""
        with self._lock:
            st = dict(self._stats)
            st["breaker_state"] = self._breaker_state_locked(time.monotonic())
        served = max(1, st["requests"] - st["cache_hits"])
        st["wait_ms_mean"] = st["wait_ms_sum"] / served
        st["infer_ms_mean"] = st["infer_ms_sum"] / max(1, st["batches"])
        if self.cache is not None:
            st["cache"] = self.cache.stats()
        return st

    def close(self) -> None:
        """Drain pending requests and stop the batch thread (idempotent)."""
        if not self._closed:
            self._closed = True
            self._q.put(None)
        self._thread.join()

    def __enter__(self) -> "MicroBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
