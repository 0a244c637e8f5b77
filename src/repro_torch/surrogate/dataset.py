"""§3 ensemble dataset generation: random band-limited bedrock waves →
3-D nonlinear FEM responses at an observation point.

The paper's production run uses 100 waves × 16,000 steps on the 32.5M-DOF
Tokyo-site model — generated under the heterogeneous-memory method at scale.
The ensemble advances through :mod:`repro_torch.campaign` — ``kset``
members per round as one k-set (2SET), rounds checkpointed for exact
resume — and lands in ``.npz`` dataset shards the surrogate trainer
streams back in.

The JAX package's ``surrogate/dataset.py`` with its on-disk format (npz
shards and a committed ``index.json`` with CRCs and ``meta``), so each
package reads the other's shards, and its :class:`ShardStream`, which the
trainer (:mod:`repro_torch.surrogate.train`) consumes.  ``generate_sweep``
waits for the scenario planner.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os
import re
import time
import zlib
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from repro_torch.campaign import CampaignConfig, run_campaign
from repro_torch.fem import meshgen, methods
from repro_torch.scenario.catalog import WaveSpec


class ShardIntegrityError(RuntimeError):
    """A shard file's bytes no longer match the checksum its index
    committed — the dataset is corrupt and must be regenerated, not
    silently trained on."""


class NonFinitePayloadError(ValueError):
    """Refusal to commit NaN/Inf rows into dataset shards.  Diverged cases
    must be excluded (see :mod:`repro_torch.core.health` and the campaign's
    quarantine records) before :func:`save_shards`."""


@dataclasses.dataclass(frozen=True)
class EnsembleConfig:
    n_waves: int = 8
    nt: int = 64
    dt: float = 0.01
    fmax: float = 2.5          # band limit [Hz]
    amp_xy: float = 0.6
    amp_z: float = 0.3
    mesh_n: tuple = (3, 3, 3)
    nspring: int = 12
    seed: int = 0
    kset: int = 2              # ensemble members advanced together (2SET)


def random_band_limited_waves(cfg: EnsembleConfig) -> np.ndarray:
    """Uniform-amplitude waves with content above fmax removed → [N, nt, 3].

    Delegates to the scenario catalog's ``band_noise`` family, which —
    unlike the original implementation here — zeroes the rfft **DC bin**
    and applies a cosine taper.  Keeping the DC bin gave every input
    velocity a nonzero mean, i.e. a linear baseline drift in the
    displacement it integrates to; the regression test pins both the exact
    zero mean and the bounded endpoint drift.
    """
    spec = WaveSpec(family="band_noise", fmax=cfg.fmax,
                    amp_xy=cfg.amp_xy, amp_z=cfg.amp_z)
    return spec.synthesize(cfg.n_waves, cfg.nt, cfg.dt, cfg.seed)


def simulation_config(cfg: EnsembleConfig, **overrides) -> methods.SeismicConfig:
    """``overrides`` pass straight to :class:`~repro_torch.fem.methods.
    SeismicConfig` — the CLI threads its kernel-backend and solver-
    amortization flags through here.  fp64, as the reference under x64."""
    base = methods.SeismicConfig(
        dt=cfg.dt, tol=1e-6, maxiter=400, npart=2, nspring=cfg.nspring, dtype=torch.float64,
    )
    return dataclasses.replace(base, **overrides) if overrides else base


def generate(
    cfg: EnsembleConfig,
    method: str = "proposed2",
    *,
    device=None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 0,
    trajectories: bool = False,
    obs_every: int = 1,
):
    """→ (waves [N,nt,3], responses at the max-response point).

    Cases advance as a :mod:`repro_torch.campaign` on ``device`` (``None`` →
    the card): ``cfg.kset`` members per round (the paper's 2SET, sized by
    how many state sets fit), checkpointed into ``checkpoint_dir`` so an
    interrupted generation resumes bit-identically.
    ``n_waves`` need not divide the round size — the tail is padded+masked.

    Two harvesting modes over the same campaign run:

    * default — responses ``[N, nt, 3]``, the CNN surrogate's
      full-rate target;
    * ``trajectories=True`` — the observation time series downsampled by
      the ``obs_every`` stride, ``[N, ⌈nt/obs_every⌉, 3]``, the
      parallel-in-time trajectory surrogate's target
      (the JAX package's ``surrogate/seqmodel.py`` with
      ``TrajectoryConfig(obs_every=obs_every)``).  Pass the pair to
      :func:`save_shards` with ``meta={"trajectories": True, "obs_every":
      obs_every}`` so the shard directory self-describes its stride.
    """
    if obs_every < 1:
        raise ValueError(f"obs_every must be ≥ 1, got {obs_every}")
    mesh = meshgen.generate(*cfg.mesh_n, pad_elems_to=8)
    sim = simulation_config(cfg)
    waves = random_band_limited_waves(cfg)
    # observation point: surface node nearest the basin slope (max response)
    obs = mesh.surface[len(mesh.surface) // 2 : len(mesh.surface) // 2 + 1]
    res = run_campaign(
        mesh, sim, waves, observe=obs,
        campaign=CampaignConfig(
            kset=max(1, cfg.kset), method=method, seed=cfg.seed,
            checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
        ),
        device=device,
    )
    responses = res.velocity_history[:, :, 0, :]
    if trajectories:
        responses = responses[:, ::obs_every]
    return waves.astype(np.float32), np.asarray(responses).astype(np.float32)


# ---------------------------------------------------------------------------
# dataset shards: campaign output → files the surrogate trainer streams
# ---------------------------------------------------------------------------


def save_shards(
    directory: str,
    x: np.ndarray,
    y: np.ndarray,
    shard_size: int = 16,
    *,
    meta: Optional[dict] = None,
) -> list[str]:
    """Write ``(x, y)`` as ``shard_NNNNN.npz`` files + an index manifest.

    Pre-existing ``shard_*.npz`` files are removed first: a rerun with a
    smaller ensemble must not leave stale shards from the previous run to be
    silently concatenated back in by :func:`load_shards`.

    The index manifest lands *last*, via an atomic rename — it is the
    **commit marker** of the streaming shard cache: a directory without
    ``index.json`` is in-flight (or torn) and invisible to
    :func:`committed` readers, so a
    campaign worker can build a scenario's shards in place and publish them
    with one rename.

    ``meta`` merges extra self-describing keys into the manifest (read
    back by :func:`shard_meta`) — trajectory harvests record
    ``{"trajectories": True, "obs_every": k}`` so a trainer can refuse a
    stride mismatch instead of silently learning the wrong alignment.
    Reserved keys (``n``/``nt``/``shards``/``checksums``) cannot be
    overridden.

    Integrity: non-finite payload rows are refused
    (:class:`NonFinitePayloadError` — a NaN that reaches here escaped the
    health layer's quarantine and must not be trained on), and the index
    records a per-shard checksum that every reader verifies
    (:class:`ShardIntegrityError` on mismatch)."""
    if len(x) != len(y):
        raise ValueError(f"waves/responses length mismatch: {len(x)} vs {len(y)}")
    for name, arr in (("x", x), ("y", y)):
        arr = np.asarray(arr)
        flat = arr.reshape(len(arr), -1) if len(arr) else arr
        if len(arr) and not np.isfinite(flat).all():
            bad = np.unique(np.argwhere(~np.isfinite(flat))[:, 0])
            raise NonFinitePayloadError(
                f"refusing to commit non-finite {name} rows "
                f"{bad[:8].tolist()} to {directory} — exclude diverged "
                f"cases (repro_torch.core.health) before save_shards"
            )
    os.makedirs(directory, exist_ok=True)
    index = os.path.join(directory, "index.json")
    if os.path.exists(index):
        os.remove(index)  # de-commit before mutating the shard set
    for stale in glob.glob(os.path.join(directory, "shard_*.npz")):
        os.remove(stale)
    paths = []
    for s, lo in enumerate(range(0, len(x), shard_size)):
        p = os.path.join(directory, f"shard_{s:05d}.npz")
        np.savez(p, x=x[lo : lo + shard_size], y=y[lo : lo + shard_size])
        paths.append(p)
    record = dict(meta or {})
    overlap = {"n", "nt", "shards", "checksums"} & set(record)
    if overlap:
        raise ValueError(f"meta may not override reserved index keys {sorted(overlap)}")
    record.update({
        "n": int(len(x)), "nt": int(x.shape[1]), "shards": len(paths),
        "checksums": {
            os.path.basename(p): _file_crc(p) for p in paths
        },
    })
    tmp = index + ".tmp"
    with open(tmp, "w") as f:
        json.dump(record, f)
    os.replace(tmp, index)
    return paths


def shard_meta(directory: str) -> dict:
    """The index manifest of a committed shard directory, verbatim —
    including any extra keys :func:`save_shards` merged via ``meta``
    (e.g. the trajectory harvest's ``obs_every`` stride)."""
    index = os.path.join(directory, "index.json")
    if not os.path.exists(index):
        raise FileNotFoundError(
            f"{directory} has no index.json — not a committed shard directory"
        )
    with open(index) as f:
        return json.load(f)


def committed(directory: str) -> bool:
    """True iff ``directory`` is a committed shard directory (its
    ``index.json`` commit marker exists)."""
    return os.path.exists(os.path.join(directory, "index.json"))


def plan_scenario_order(manifest_path: str) -> Optional[list[str]]:
    """Scenario names in **plan order** from a sweep manifest
    (``plan.json``, written by the reference's scenario planner and
    elastic scheduler), or None when the manifest is absent or
    unreadable.  This is the order a live
    :meth:`ShardStream.from_cache` consumer saw, so a post-hoc reader
    that follows it reproduces the live batch sequence even when
    scenario names do not sort lexically in plan order."""
    try:
        with open(manifest_path) as f:
            m = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    names = [s.get("name") for g in m.get("groups", [])
             for s in g.get("scenarios", [])]
    return [n for n in names if n] or None


_PROC_DIR = re.compile(r"^p\d{2,}$")


def shard_paths(directory: str) -> list[str]:
    """Every shard file under ``directory`` in deterministic order.

    Three layouts, never mixed (ambiguous ordering is refused):

    * **flat** — ``shard_*.npz`` files, sorted, validated against the
      directory's index manifest when one is present;
    * **process tree** — ``p00/, p01/, …`` subdirectories (a multi-host
      campaign's ``--out``), walked in numeric **(process, shard)** order
      (``p100`` after ``p99``, not after ``p10``);
    * **scenario cache** — any other subdirectories holding a *committed*
      shard set (``index.json`` present — e.g. a sweep's
      ``out/<scenario>/`` dirs), walked in sorted-name order, recursively.
      Uncommitted subdirectories are an error here: a post-hoc load must
      not silently skip a scenario that a crashed worker half-wrote.
    """
    flat = sorted(glob.glob(os.path.join(directory, "shard_*.npz")))
    subdirs = sorted(
        d for d in (os.listdir(directory) if os.path.isdir(directory) else [])
        if os.path.isdir(os.path.join(directory, d))
    )
    pdirs = sorted((d for d in subdirs if _PROC_DIR.match(d)),
                   key=lambda d: int(d[1:]))
    sdirs = [d for d in subdirs if not _PROC_DIR.match(d)
             and not d.endswith(".tmp")]
    if flat and (pdirs or sdirs):
        raise ValueError(
            f"{directory} mixes flat shard_*.npz files with subdirectories "
            f"{pdirs + sdirs} — ambiguous ordering; keep one layout"
        )
    if pdirs and sdirs:
        raise ValueError(
            f"{directory} mixes process dirs {pdirs} with scenario dirs "
            f"{sdirs} — ambiguous ordering; keep one layout"
        )
    if flat:
        index = os.path.join(directory, "index.json")
        if os.path.exists(index):
            with open(index) as f:
                meta = json.load(f)
            if meta.get("shards") != len(flat):
                raise ValueError(
                    f"shard directory {directory} inconsistent with its index "
                    f"({len(flat)} shards vs manifest {meta}) — regenerate "
                    f"with save_shards"
                )
        return flat
    if pdirs:
        return [p for d in pdirs for p in shard_paths(os.path.join(directory, d))]
    if sdirs:
        out = []
        for d in sdirs:
            sub = os.path.join(directory, d)
            if not committed(sub) and not any(
                os.path.isdir(os.path.join(sub, dd)) for dd in os.listdir(sub)
            ):
                raise ValueError(
                    f"scenario shard directory {sub} was never committed "
                    f"(no index.json) — a worker died mid-write; rerun the "
                    f"sweep (or remove the torn directory)"
                )
            out.extend(shard_paths(sub))
        return out
    raise FileNotFoundError(f"no dataset shards under {directory}")


def _file_crc(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        while chunk := f.read(1 << 26):
            crc = zlib.crc32(chunk, crc)
    return crc & 0xFFFFFFFF


def _expected_crc(path: str) -> Optional[int]:
    """The committed checksum for a shard file, from its directory's index
    (None for pre-checksum indexes — nothing to verify against)."""
    index = os.path.join(os.path.dirname(path), "index.json")
    try:
        with open(index) as f:
            return (json.load(f).get("checksums") or {}).get(
                os.path.basename(path)
            )
    except (OSError, json.JSONDecodeError):
        return None


def _load_shard(path: str) -> tuple[np.ndarray, np.ndarray]:
    want = _expected_crc(path)
    if want is not None and _file_crc(path) != want:
        raise ShardIntegrityError(
            f"shard {path} does not match the checksum its index committed "
            f"— the file was modified or corrupted after save_shards; "
            f"regenerate the dataset"
        )
    with np.load(path) as z:
        return z["x"], z["y"]


def iter_shards(directory: str) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Yield ``(x, y)`` per shard in :func:`shard_paths` order — the
    O(one-shard) form of :func:`load_shards`; nothing is concatenated."""
    for p in shard_paths(directory):
        yield _load_shard(p)


def load_shards(directory: str) -> tuple[np.ndarray, np.ndarray]:
    """Concatenate every shard under ``directory`` back to (x, y).

    Accepts every layout :func:`shard_paths` knows (flat, multi-host
    ``pNN/`` trees, committed scenario caches) in its deterministic order,
    validated against each index manifest.  This materializes the whole
    dataset in host memory — training-sized runs should prefer
    :func:`iter_shards` / :class:`ShardStream` (what
    :func:`repro_torch.surrogate.train.fit_shards` streams through)."""
    paths = shard_paths(directory)
    xs, ys = zip(*(_load_shard(p) for p in paths))
    x, y = np.concatenate(xs), np.concatenate(ys)
    index = os.path.join(directory, "index.json")
    if os.path.exists(index):
        with open(index) as f:
            meta = json.load(f)
        if meta.get("n") != len(x):
            raise ValueError(
                f"shard directory {directory} inconsistent with its index "
                f"({len(paths)} shards / {len(x)} rows vs manifest {meta}) — "
                f"regenerate with save_shards"
            )
    return x, y


# ---------------------------------------------------------------------------
# streaming shard cache: train while the campaign is still producing
# ---------------------------------------------------------------------------


class ShardStream:
    """Deterministic, lazily-materialized stream of dataset shards.

    Iterating yields ``(x, y)`` per shard, loading one shard at a time.
    The *order* is fixed up front — by directory layout
    (:meth:`from_dir`) or by the caller's scenario order
    (:meth:`from_cache`) — so the sequence a trainer sees is identical for
    any (worker count, shard arrival) interleaving; a cache stream merely
    *blocks* until the next scenario in order has committed.  After a shard
    has been yielded its path is recorded, so ``stream[i]`` re-loads it
    from disk later (the trainer's full-dataset phase) without the stream
    ever holding more than one shard in memory itself.

    ``wait_s`` accumulates the time spent blocked on uncommitted scenarios
    — the overlap telemetry of train-while-generating.
    """

    def __init__(self, groups, *, poll_s: float = 0.2, timeout_s: float = 600.0):
        # groups: [(label, dir_or_paths)] — a dir is resolved (and possibly
        # waited on) at iteration time; a path list is used as-is
        self._groups = list(groups)
        self.poll_s = poll_s
        self.timeout_s = timeout_s
        self.paths: list[str] = []   # filled (in order) as iteration advances
        self.wait_s = 0.0
        self._exhausted = False

    @classmethod
    def from_dir(cls, directory: str) -> "ShardStream":
        """Stream over an already-complete shard directory (any
        :func:`shard_paths` layout); never blocks."""
        return cls([(directory, shard_paths(directory))])

    @classmethod
    def from_cache(
        cls,
        directory: str,
        order: Sequence[str],
        *,
        poll_s: float = 0.2,
        timeout_s: float = 600.0,
    ) -> "ShardStream":
        """Stream over a cache that campaign workers are still filling.

        ``order`` names the scenario subdirectories (``directory/<name>/``)
        in the order the trainer must consume them — the plan's scenario
        order, so every consumer sees the same sequence regardless of which
        worker commits which scenario when.  Iteration blocks (polling
        every ``poll_s``) until the next scenario in order is committed;
        ``timeout_s`` without progress raises rather than hanging on a dead
        sweep."""
        return cls([(n, os.path.join(directory, n)) for n in order],
                   poll_s=poll_s, timeout_s=timeout_s)

    def _resolve(self, label, target) -> list[str]:
        if isinstance(target, list):
            return target
        deadline = time.monotonic() + self.timeout_s
        t0 = time.monotonic()
        while not committed(target):
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"scenario {label!r} not committed under {target} after "
                    f"{self.timeout_s:.0f}s — generation died or the order "
                    f"names a scenario this sweep never produces"
                )
            time.sleep(self.poll_s)
        self.wait_s += time.monotonic() - t0
        return shard_paths(target)

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        if self._exhausted:  # re-iteration replays the recorded order
            for p in self.paths:
                yield _load_shard(p)
            return
        for label, target in self._groups:
            for p in self._resolve(label, target):
                self.paths.append(p)
                yield _load_shard(p)
        self._exhausted = True

    def __getitem__(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        # valid for already-yielded shards only: the stream records paths
        # as it advances, so the trainer's full-dataset phase can re-load
        # any consumed shard from disk without the stream holding it
        return _load_shard(self.paths[i])
