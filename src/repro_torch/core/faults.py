"""Deterministic fault injection: the chaos half of the health subsystem
(numpy only; a copy of the JAX package's ``core/faults.py``, so the port
imports nothing of it).

Every injection point is deterministic: the same spec string always
produces the same fault at the same place.

* :func:`nan_at_step` — poison one case's input wave at one time step; the
  FEM step computes a non-finite right-hand side there and the health layer
  (:mod:`repro_torch.core.health`) must quarantine exactly that case;
* :func:`corrupt_shard_byte` — flip one byte of a file on disk; checksum
  verification must refuse it;
* :func:`fail_infer_every_n` — wrap a serving engine so calls fail on a
  deterministic schedule.

A spec is ``kind=value[,key=value...]``, e.g. ``nan_at_step=5,case=1`` or
``fail_infer_every_n=1,limit=4`` (:func:`parse`).
"""
from __future__ import annotations

import dataclasses

import numpy as np

KINDS = ("nan_at_step", "corrupt_shard_byte", "fail_infer_every_n")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One parsed ``--inject`` directive."""

    kind: str
    value: int
    params: tuple  # sorted (key, value) pairs — hashable, repr-stable

    def get(self, key: str, default: int = 0) -> int:
        return dict(self.params).get(key, default)

    def describe(self) -> str:
        extra = "".join(f",{k}={v}" for k, v in self.params)
        return f"{self.kind}={self.value}{extra}"


def parse(spec: str | None) -> FaultSpec | None:
    """``"nan_at_step=5,case=1"`` → :class:`FaultSpec`; None/"" → None."""
    if not spec:
        return None
    parts = [p.strip() for p in spec.split(",") if p.strip()]
    head = parts[0]
    if "=" not in head:
        raise ValueError(
            f"bad --inject spec {spec!r}: expected kind=value[,key=value...]"
        )
    kind, _, val = head.partition("=")
    if kind not in KINDS:
        raise ValueError(f"unknown fault kind {kind!r}; known: {KINDS}")
    params = []
    for p in parts[1:]:
        if "=" not in p:
            raise ValueError(f"bad --inject parameter {p!r} in {spec!r}")
        k, _, v = p.partition("=")
        params.append((k.strip(), int(v)))
    return FaultSpec(kind=kind, value=int(val), params=tuple(sorted(params)))


# -- injectors ---------------------------------------------------------------


def nan_at_step(waves: np.ndarray, step: int, case: int = 0) -> np.ndarray:
    """Copy of ``waves [M, nt, 3]`` with ``waves[case, step, :] = NaN``.

    The poisoned sample flows through the external-force assembly into the
    CG right-hand side, so the target case diverges at exactly ``step``;
    every sibling's wave is untouched and — lanes being arithmetically
    independent under vmap — its trajectory is bit-identical to the
    uninjected run.  The campaign signature covers the wave bytes, so the
    injected run can never splice into a clean checkpoint.
    """
    waves = np.array(waves, copy=True)
    M, nt = waves.shape[0], waves.shape[1]
    if not 0 <= case < M:
        raise ValueError(f"nan_at_step: case {case} outside [0, {M})")
    if not 0 <= step < nt:
        raise ValueError(f"nan_at_step: step {step} outside [0, {nt})")
    waves[case, step, :] = np.nan
    return waves


def corrupt_shard_byte(path: str, offset: int = 0, xor: int = 0xFF) -> int:
    """XOR one byte of ``path`` in place; returns the absolute offset hit.

    ``offset`` counts from the *end* of the file when negative.  The
    header region of ``.npy``/``.npz`` files is deliberately easy to miss:
    pass an offset into the payload (e.g. ``-8``) so the corruption is a
    silent data flip that only a checksum can catch.
    """
    if xor == 0:
        raise ValueError("xor=0 would be a no-op, not a corruption")
    with open(path, "r+b") as f:
        f.seek(0, 2)
        size = f.tell()
        pos = offset if offset >= 0 else size + offset
        if not 0 <= pos < size:
            raise ValueError(f"offset {offset} outside file of {size} bytes")
        f.seek(pos)
        old = f.read(1)[0]
        f.seek(pos)
        f.write(bytes([old ^ xor]))
    return pos


class FaultyEngine:
    """Engine wrapper failing ``infer`` on a deterministic schedule.

    Call ``c`` (1-based) raises iff ``c % n == 0``, stopping after
    ``limit`` injected failures (``limit=0`` → unbounded).  ``n=1`` with a
    finite ``limit`` is the circuit-breaker rehearsal: the first ``limit``
    calls fail consecutively (tripping the breaker), then the engine heals.
    The signature is suffixed with the spec so cache identity reflects the
    injection.
    """

    def __init__(self, engine, n: int, limit: int = 0):
        if n < 1:
            raise ValueError(f"fail_infer_every_n: n must be ≥ 1, got {n}")
        self.engine = engine
        self.n = int(n)
        self.limit = int(limit)
        self.calls = 0
        self.failures = 0

    def warmup(self) -> None:
        self.engine.warmup()

    def signature(self) -> str:
        return (
            f"{self.engine.signature()}"
            f"+fault:fail_infer_every_n={self.n},limit={self.limit}"
        )

    def infer(self, x):
        self.calls += 1
        if self.calls % self.n == 0 and (
            self.limit == 0 or self.failures < self.limit
        ):
            self.failures += 1
            raise RuntimeError(
                f"injected engine failure #{self.failures} "
                f"(call {self.calls}, every {self.n})"
            )
        return self.engine.infer(x)

    def __getattr__(self, name):  # buckets, nt, … delegate to the inner engine
        return getattr(self.engine, name)


def fail_infer_every_n(engine, n: int, limit: int = 0) -> FaultyEngine:
    return FaultyEngine(engine, n, limit=limit)


# -- spec application --------------------------------------------------------


def apply_wave_fault(spec: FaultSpec | None, waves: np.ndarray) -> np.ndarray:
    """Apply a campaign-side spec to a wave array (pass-through if None)."""
    if spec is None:
        return waves
    if spec.kind != "nan_at_step":
        raise ValueError(
            f"--inject {spec.kind} is not a campaign wave fault; the campaign "
            f"launcher supports nan_at_step (use the serving launcher for "
            f"fail_infer_every_n, corrupt_shard_byte via repro.core.faults)"
        )
    return nan_at_step(waves, spec.value, case=spec.get("case", 0))


def wrap_engine(spec: FaultSpec | None, engine):
    """Apply a serving-side spec to an engine (pass-through if None)."""
    if spec is None:
        return engine
    if spec.kind != "fail_infer_every_n":
        raise ValueError(
            f"--inject {spec.kind} is not a serving fault; the serving "
            f"launcher supports fail_infer_every_n"
        )
    return fail_infer_every_n(engine, spec.value, limit=spec.get("limit", 0))
