"""The serving tier's `Engine` protocol and its implementations (the JAX
package's ``serving/engine.py``).

Everything behind one small protocol — ``warmup() / infer(batch) /
signature()`` — so the batcher (:mod:`repro_torch.serving.batcher`), result
cache (:mod:`repro_torch.serving.cache`) and active-learning feedback loop
(:mod:`repro_torch.serving.feedback`) are generic over workloads:

``SurrogateEngine``
    the FEM-surrogate forward pass (:func:`repro_torch.surrogate.model.
    predict`, the pad-to-bucket preprocessing shared with the trainer's
    validation path), params restored through
    :func:`repro_torch.surrogate.train.load_surrogate`.  Holds one param set
    or an *ensemble* of them; with an ensemble, ``infer`` returns the member
    mean plus a per-request disagreement score — the active-learning signal.
``TrajectoryEngine``
    the same contract over the parallel-in-time trajectory surrogate
    (:func:`repro_torch.surrogate.seqmodel.predict`).
``DecodeEngine``
    batched LM generation (:func:`repro_torch.serving.decode.generate`:
    prefill through the flash kernel, then resident or host-offloaded KV
    decode).
``ShardedEngine``
    wraps any engine and shards its batch axis over the case mesh
    (:func:`repro_torch.launch.mesh.make_case_mesh`): one replica of the
    inner engine a device, each entry's contiguous slice of the padded batch
    run in a host thread and on a CUDA stream of its own.

Each engine runs on ``device`` (``None``: the card), fixed when it is
built: ``infer`` is called from the batcher's thread, whose current device
is not the caller's.  An ``infer`` moves its batch to the device once and
hands back host numpy arrays, so results (and the cache that holds them)
never pin device memory.

``signature()`` is the cache-identity contract: two engines with equal
signatures must produce bit-identical results for equal inputs.  The digest
is the reference's, byte for byte, so a port engine and a JAX engine over
the same parameters and config have equal signatures.

Batched ≡ per-request, bitwise: every ``infer`` pads its batch to a bucket
shape before any computation — the member mean and the disagreement score
included — so a row meets the same kernels, at the same shapes, whatever
else rides in its batch.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, NamedTuple, Optional, Protocol, Sequence, runtime_checkable

import numpy as np
import torch

from repro_torch.core.stream import pad_kset, tree_map
from repro_torch.device import resolve_device
from repro_torch.surrogate.model import pick_bucket
from repro_torch.utils.tree import leaves_with_paths


class InferResult(NamedTuple):
    """One batched inference: per-row outputs + per-row uncertainty score
    (0 where the engine has no uncertainty notion — e.g. greedy decode)."""

    y: np.ndarray      # [B, ...]
    score: np.ndarray  # [B] float


@runtime_checkable
class Engine(Protocol):
    """What the serving stack requires of a model."""

    def warmup(self) -> None:
        """Run every steady-state batch shape once ahead of traffic."""
        ...

    def infer(self, x) -> InferResult:
        """Run one batch ``x [B, ...]`` → :class:`InferResult`.  Rows must
        be independent: the batcher asserts batched ≡ per-request."""
        ...

    def signature(self) -> str:
        """Stable digest of everything that shapes the outputs (model
        params, config, preprocessing) — the cache-identity key."""
        ...


def _leaf_bytes(leaf) -> tuple[str, str, bytes]:
    """``(dtype, shape, bytes)`` of a leaf as the reference hashes it
    (``str(np.asarray(leaf).dtype)``, ``str(shape)``, C-order bytes).  A
    bf16 tensor has no numpy dtype: it is named ``bfloat16``, as
    ``ml_dtypes`` names it, and hashed as its 16-bit patterns."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return "bfloat16", str(tuple(t.shape)), t.contiguous().view(torch.int16).numpy().tobytes()
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return str(arr.dtype), str(arr.shape), arr.tobytes()


def _params_digest(members: Sequence[Any]) -> str:
    """Content hash over every leaf of every member param tree, leaves named
    and ordered as ``jax.tree_util`` names and flattens them."""
    h = hashlib.sha256()
    for p in members:
        for name, leaf in leaves_with_paths(p):
            h.update(name.encode())
            dtype, shape, data = _leaf_bytes(leaf)
            h.update(dtype.encode() + shape.encode())
            h.update(data)
    return h.hexdigest()


def _engine_device(device) -> torch.device:
    """``device`` resolved (``None``: the card), with its index fixed."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _signature(blob: dict) -> str:
    return hashlib.sha256(json.dumps(blob, sort_keys=True).encode()).hexdigest()[:16]


# ---------------------------------------------------------------------------
# surrogate forward passes
# ---------------------------------------------------------------------------


class _EnsembleEngine:
    """Ensemble mean × ``scale`` and disagreement score over ``predict``.

    ``infer`` pads the batch to a :func:`~repro_torch.surrogate.model.
    pick_bucket` size, runs every member's ``predict`` on it, and reduces
    over the members at the padded shape, each row's score on its own; the
    rows past the batch are sliced off last.  The score is the RMS
    deviation of the members from their mean, normalized by the mean's RMS;
    a single member scores 0.
    """

    kind = ""

    def __init__(self, cfg, params, *, scale: float = 1.0, buckets: Sequence[int] = (8,), nt: int = 64,
                 step: int = 0, device=None):
        self.cfg = cfg
        self.device = _engine_device(device)
        members = list(params) if isinstance(params, (list, tuple)) else [params]
        if not members:
            raise ValueError(f"{type(self).__name__} needs at least one param set")
        self.members = [tree_map(lambda t: t.to(self.device), m) for m in members]
        self.scale = float(scale)
        self.buckets = tuple(sorted(int(b) for b in buckets))
        self.nt = int(nt)
        self.step = int(step)
        self._sig: Optional[str] = None

    @classmethod
    def _load(cls, ckpt_dir: str, device):
        raise NotImplementedError

    @classmethod
    def from_checkpoint(cls, ckpt_dir: str, *, device=None, **kw):
        """Restore the newest checkpoint written by the family's save
        function (either package's), its members on ``device``."""
        dev = _engine_device(device)
        cfg, members, scale, step = cls._load(ckpt_dir, dev)
        return cls(cfg, members, scale=scale, step=step, device=dev, **kw)

    def _predict(self, m, x):
        raise NotImplementedError

    def replica(self, device, buckets: Optional[Sequence[int]] = None) -> "_EnsembleEngine":
        """This engine on ``device``, padding to ``buckets`` (``None``: its
        own): the same members (copied there), config and signature."""
        dev, buckets = _engine_device(device), tuple(sorted(buckets or self.buckets))
        if dev == self.device and buckets == self.buckets:
            return self
        twin = type(self)(self.cfg, self.members, scale=self.scale, buckets=buckets, nt=self.nt,
                          step=self.step, device=dev)
        twin._sig = self._sig
        return twin

    # -- protocol -----------------------------------------------------------
    def signature(self) -> str:
        if self._sig is None:
            self._sig = _signature({
                "engine": self.kind,
                "cfg": dataclasses.asdict(self.cfg),
                "scale": self.scale,
                "members": len(self.members),
                "params": _params_digest(self.members),
            })
        return self._sig

    def warmup(self) -> None:
        for b in self.buckets:
            self.infer(np.zeros((b, self.nt, 3), np.float32))

    @torch.no_grad()
    def infer(self, x) -> InferResult:
        x = torch.as_tensor(x, dtype=torch.float32).to(self.device)
        B = x.shape[0]
        x, _valid = pad_kset(x, pick_bucket(B, self.buckets))
        preds = torch.stack([self._predict(m, x) for m in self.members])  # [M, Bp, T, 3]
        mean = preds.mean(dim=0)
        if len(self.members) > 1:
            # a reduction a row, each over one contiguous block of the same shape: on the card a
            # reduction's order follows its count of outputs, which would tie a row's score to Bp
            rows = preds.transpose(0, 1).contiguous()  # [Bp, M, T, 3]
            dev = torch.stack([((rows[i] - mean[i]) ** 2).mean() for i in range(len(rows))]).sqrt()
            ref = torch.stack([(mean[i] ** 2).mean() for i in range(len(rows))]).sqrt()
            score = dev / (ref + 1e-12)
        else:
            score = torch.zeros((x.shape[0],), dtype=mean.dtype, device=mean.device)
        return InferResult(y=mean[:B].cpu().numpy() * self.scale,
                           score=score[:B].cpu().numpy().astype(np.float64))


class SurrogateEngine(_EnsembleEngine):
    """Serves the §3 FEM surrogate: bedrock wave [nt,3] → surface response.

    ``params`` is one param tree or a list of them (an ensemble of
    independently-trained members — e.g. different seeds over the same
    shards).  ``infer`` returns the ensemble-mean prediction *denormalized
    by* ``scale`` (the trainer's MAE normalization constant, restored from
    the checkpoint), and a per-row disagreement score.

    The time-axis pad to ``2**n_c`` lives in :func:`repro_torch.surrogate.
    model.predict`, shared with the trainer's validation path.  ``buckets``
    defaults to one batch shape (``(max_batch,)`` via the batcher); pass
    several to trade latency for compute on small batches.  The
    convolutions run under ``model.exact_convs()`` (inside ``apply``):
    full fp32 and deterministic algorithms.
    """

    kind = "surrogate"

    @classmethod
    def _load(cls, ckpt_dir, device):
        from repro_torch.surrogate.train import load_surrogate

        return load_surrogate(ckpt_dir, device=device)

    def _predict(self, m, x):
        from repro_torch.surrogate.model import predict

        return predict(m, self.cfg, x, buckets=self.buckets, device=self.device)


class TrajectoryEngine(_EnsembleEngine):
    """Serves the parallel-in-time trajectory surrogate: bedrock wave
    ``[nt, 3]`` → the full ``obs_every``-strided response history in one
    O(log T)-depth forward pass (:func:`repro_torch.surrogate.seqmodel.
    predict`).

    Protocol-identical to :class:`SurrogateEngine` on purpose: same
    ensemble-mean + disagreement-score ``infer`` contract and the same
    pad-to-bucket preprocessing.  The signature blob differs (``"engine":
    "trajectory"`` + the :class:`~repro_torch.surrogate.seqmodel.
    TrajectoryConfig`), so the two families never share cache entries.
    """

    kind = "trajectory"

    @classmethod
    def _load(cls, ckpt_dir, device):
        from repro_torch.surrogate.trajectory import load_trajectory

        return load_trajectory(ckpt_dir, device=device)

    def _predict(self, m, x):
        from repro_torch.surrogate.seqmodel import predict

        return predict(m, self.cfg, x, buckets=self.buckets, device=self.device)


# ---------------------------------------------------------------------------
# LM decode
# ---------------------------------------------------------------------------


class DecodeEngine:
    """Batched token generation behind the Engine protocol.

    A request row is one fixed-length prompt ``[prompt_len]`` (integer
    tokens); the output row is its ``n_new`` generated tokens (int32).
    ``serve`` carries the decode knobs — resident vs host-offloaded KV
    (``kv_offload`` / ``kv_npart``), greedy vs temperature sampling — all
    realized by :func:`repro_torch.serving.decode.generate`, this engine's
    internal.  ``params`` go to ``device`` (``None``: the card).

    Each ``infer`` pads its batch to a bucket with repeats of the last
    prompt, so prefill and decode run at one of a few shapes.  The
    uncertainty score is 0: greedy/temperature decode has no ensemble to
    disagree.
    """

    def __init__(self, cfg, params, *, n_new: int = 8, prompt_len: int = 8, serve=None,
                 buckets: Sequence[int] = (4,), kv_schedule: str = "serial", kv_prefetch: int = 1, device=None):
        from repro_torch.models.transformer import check_offload_scope
        from repro_torch.serving.decode import ServeConfig, check_generate_scope

        check_generate_scope(cfg)
        self.serve = serve if serve is not None else ServeConfig()
        if self.serve.kv_offload:
            check_offload_scope(cfg)
        self.cfg = cfg
        self.device = _engine_device(device)
        self.params = tree_map(lambda t: t.to(self.device), params)
        self.n_new = int(n_new)
        self.prompt_len = int(prompt_len)
        self.buckets = tuple(sorted(int(b) for b in buckets))
        self.kv_schedule = kv_schedule
        self.kv_prefetch = int(kv_prefetch)
        self._sig: Optional[str] = None

    def replica(self, device, buckets: Optional[Sequence[int]] = None) -> "DecodeEngine":
        """This engine on ``device``, padding to ``buckets`` (``None``: its
        own): the same parameters (copied there), knobs and signature."""
        dev, buckets = _engine_device(device), tuple(sorted(buckets or self.buckets))
        if dev == self.device and buckets == self.buckets:
            return self
        twin = DecodeEngine(self.cfg, self.params, n_new=self.n_new, prompt_len=self.prompt_len, serve=self.serve,
                            buckets=buckets, kv_schedule=self.kv_schedule, kv_prefetch=self.kv_prefetch,
                            device=dev)
        twin._sig = self._sig
        return twin

    def signature(self) -> str:
        if self._sig is None:
            self._sig = _signature({
                "engine": "decode",
                "arch": self.cfg.name,
                "serve": dataclasses.asdict(self.serve),
                "n_new": self.n_new,
                "prompt_len": self.prompt_len,
                "params": _params_digest([self.params]),
            })
        return self._sig

    def warmup(self) -> None:
        for b in self.buckets:
            self.infer(np.zeros((b, self.prompt_len), np.int32))

    @torch.no_grad()
    def infer(self, x) -> InferResult:
        from repro_torch.serving.decode import generate

        x = torch.as_tensor(x)
        if x.ndim != 2 or x.shape[1] != self.prompt_len:
            raise ValueError(f"DecodeEngine expects prompts [B, {self.prompt_len}], got {tuple(x.shape)}")
        B = x.shape[0]
        x, _valid = pad_kset(x.to(self.device, torch.long), pick_bucket(B, self.buckets))
        toks = generate(self.params, self.cfg, x, self.n_new, self.serve,
                        kv_schedule=self.kv_schedule, kv_prefetch=self.kv_prefetch)
        return InferResult(y=toks[:B, self.prompt_len:].cpu().numpy().astype(np.int32),
                           score=np.zeros((B,), np.float64))


# ---------------------------------------------------------------------------
# batch-axis sharding wrapper
# ---------------------------------------------------------------------------


class ShardedEngine:
    """Shard any engine's batch axis over the case mesh.

    Pads the batch to a multiple of the mesh's entries (``pad_kset``
    repeats of the last row), gives entry ``d`` the ``d``-th contiguous
    slice and runs it through the inner engine's replica on the entry's
    device (entries on one device share a replica), each entry in a host
    thread and on a CUDA stream of its own; the slices' outputs and scores
    are concatenated and cut back to the true batch.  A replica pads its
    slice to a bucket of ``ceil(b / N)`` for each inner bucket ``b`` over
    ``N`` entries, so the entries together compute what the inner engine
    would (the reference's ``NamedSharding`` gives each device ``b / N``
    rows), not ``N`` whole buckets.  Every engine pads a batch to a bucket
    before any computation and computes each row on its own, so a row's
    result does not depend on the slice it rides in: sharded ≡ unsharded,
    bitwise on the CPU and on the card (``chip_smoke.py``'s ``case_mesh``).

    ``device_mesh`` defaults to every card of the inner engine's device
    type (:func:`~repro_torch.launch.mesh.make_case_mesh`; the CPU: one
    entry), and must be this process's.  An entry that names no device
    runs on the inner engine's.  The signature is the *inner* engine's:
    sharding is an execution detail that must not change results, so
    sharded and unsharded servers share cache entries.
    """

    def __init__(self, inner, device_mesh=None):
        from repro_torch.launch.mesh import EntryPool, entry_device, make_case_mesh

        self.inner = inner
        self.mesh = device_mesh if device_mesh is not None else make_case_mesh(device=inner.device.type)
        entries = [None] if self.mesh is None else list(self.mesh.devices.flat)
        if self.mesh is not None and self.mesh.devices.ndim != 1:
            raise ValueError(f"ShardedEngine shards one batch axis; got a {self.mesh.devices.ndim}-D mesh "
                             f"{self.mesh.devices.shape}")
        if len({getattr(e, "process_index", 0) for e in entries}) > 1:
            raise ValueError("ShardedEngine runs the entries of one process; this case mesh spans several")
        devices = [entry_device(e, inner.device) for e in entries]
        shard_buckets = tuple(sorted({-(-b // len(devices)) for b in inner.buckets}))
        replicas = {}
        for dev in devices:
            if dev not in replicas:
                replicas[dev] = inner.replica(dev, shard_buckets)
        self.replicas = [replicas[dev] for dev in devices]
        self._pool = EntryPool(devices)

    @property
    def n_devices(self) -> int:
        return len(self.replicas)

    @property
    def buckets(self):
        return self.inner.buckets

    def signature(self) -> str:
        return self.inner.signature()

    def warmup(self) -> None:
        for eng in {id(r): r for r in self.replicas}.values():
            eng.warmup()

    def infer(self, x) -> InferResult:
        B = x.shape[0]
        x, _valid = pad_kset(x, self.n_devices)
        n = x.shape[0] // self.n_devices
        parts = self._pool.map(lambda eng, lo: eng.infer(x[lo:lo + n]), self.replicas,
                               range(0, x.shape[0], n))
        y = np.concatenate([p.y for p in parts])
        score = np.concatenate([p.score for p in parts])
        return InferResult(y=y[:B], score=score[:B])
