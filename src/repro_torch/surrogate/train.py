"""Surrogate training (§3): Adam + MAE + random hyperparameter search.

The paper tunes (n_c, n_lstm, kernel, latent, lr) with Optuna; :func:`search`
runs the same search space with pure random sampling (the JAX package's
documented deviation).  Batch training lives in :func:`fit` (in-memory
pairs), :func:`fit_stream` (shards as a campaign commits them), and
:func:`fit_shards` (a committed shard directory, streamed in plan order);
all three take a pluggable ``model`` module, so the CNN surrogate and the
parallel-in-time trajectory surrogate (:mod:`repro_torch.surrogate.
seqmodel`) share one optimizer path.

The JAX package's ``surrogate/train.py`` on ``device`` (``None``: the
card): the same Adam arithmetic, and the same numpy ``default_rng(seed)``
draws in the same order, so from the same initial params both packages
train on the same batch sequence.  Data stays in host memory and moves to
the device one batch at a time.  Saved surrogates use the reference's
checkpoint layout and ``meta`` keys: each package loads the other's.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.stream import leaves_in_insertion_order, tree_map
from repro_torch.device import resolve_device
from repro_torch.surrogate import model as _cnn
from repro_torch.surrogate.model import SurrogateConfig, exact_convs, init_params, mae_loss

SEARCH_SPACE = {
    "n_c": [2, 3, 4],
    "n_lstm": [1, 2, 3],
    "kernel": [3, 5, 9, 17, 33, 65],
    "latent": [128, 256, 512, 1024],
    "lr": (5e-5, 5e-4),
}
B1, B2, EPS = 0.9, 0.999, 1e-8


def _make_adam(cfg, params, loss_fn=None):
    """(step_fn, m0, v0): the Adam+MAE update shared by :func:`fit` and
    :func:`fit_stream` — identical math, so a streamed run that sees the
    same batch sequence reproduces the offline run exactly.

    The reference's explicit update: the gradient by autograd, then under
    ``no_grad`` ``m = b1·m + (1−b1)·g``, ``v = b2·v + (1−b2)·g²``, bias
    corrections ``1 − b**(t+1)`` taken in fp32, ``p −= lr·m̂ / (√v̂ + eps)``
    (``torch.optim.Adam`` places eps and rounds the corrections
    otherwise).  ``loss_fn(params, cfg, xb, yb)`` defaults to the CNN
    surrogate's MAE."""
    loss_fn = mae_loss if loss_fn is None else loss_fn
    m = tree_map(torch.zeros_like, params)
    v = tree_map(torch.zeros_like, params)

    def step_fn(params, m, v, t: int, xb, yb):
        ps = tree_map(lambda p: p.detach().requires_grad_(True), params)
        with exact_convs():
            loss = loss_fn(ps, cfg, xb, yb)
            grads = torch.autograd.grad(loss, leaves_in_insertion_order(ps))
        g = iter(grads)
        g = tree_map(lambda _: next(g), params)
        # fp32 on the device (torch.full fills there: no host → device copy)
        t1, b1, b2 = (torch.full((), c, dtype=torch.float32, device=loss.device) for c in (t + 1, B1, B2))
        bc1, bc2 = 1 - b1 ** t1, 1 - b2 ** t1
        with torch.no_grad():
            m = tree_map(lambda a, b: B1 * a + (1 - B1) * b, m, g)
            v = tree_map(lambda a, b: B2 * a + (1 - B2) * b * b, v, g)
            params = tree_map(lambda p, mm, vv: p - cfg.lr * (mm / bc1) / (torch.sqrt(vv / bc2) + EPS),
                              params, m, v)
        return params, m, v, loss.detach()

    return step_fn, m, v


def _on(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)


def fit(
    cfg,
    x: np.ndarray,  # [N,T,3] input waves
    y: np.ndarray,  # [N,T,3] responses ([N,T/obs_every,3] for trajectories)
    *,
    steps: int = 200,
    batch: int = 4,
    val_frac: float = 0.25,
    seed: int = 0,
    verbose: bool = False,
    model=None,
    device=None,
) -> tuple[Any, dict]:
    """Adam + MAE on in-memory pairs on ``device`` (``None``: the card).
    ``model`` is the module providing ``init_params/mae_loss/predict`` —
    the CNN surrogate (:mod:`repro_torch.surrogate.model`, default) or the
    parallel-in-time trajectory surrogate (:mod:`repro_torch.surrogate.
    seqmodel`); its ``init_params(cfg, generator, device=)`` gets a CPU
    generator seeded with ``seed``."""
    model = _cnn if model is None else model
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n_val = max(1, int(len(x) * val_frac))
    # normalize by train std for robust MAE scale
    scale = float(np.abs(np.asarray(y)[n_val:]).std() + 1e-12)
    s32 = np.float32(scale)
    x, y = np.asarray(x, np.float32), np.asarray(y, np.float32)
    xv, yv = x[:n_val], _on(y[:n_val] / s32, dev)
    xt, yt = x[n_val:], y[n_val:]

    params = model.init_params(cfg, torch.Generator().manual_seed(seed), device=dev)
    step_fn, m, v = _make_adam(cfg, params, model.mae_loss)

    # validation through the canonical serving entry point (model.predict):
    # the val batch rides the same pad-to-bucket path the serving engine
    # serves through, so training and serving cannot drift on preprocessing
    def val_loss(params):
        return (model.predict(params, cfg, xv, device=dev) - yv).abs().mean()

    t0 = time.time()
    hist = []
    for t in range(steps):
        idx = rng.integers(0, len(xt), size=min(batch, len(xt)))
        params, m, v, loss = step_fn(params, m, v, t, _on(xt[idx], dev), _on(yt[idx] / s32, dev))
        if t % 25 == 0 or t == steps - 1:
            vl = float(val_loss(params))
            hist.append((t, float(loss), vl))
            if verbose:
                print(f"  step {t}: train {float(loss):.4f} val {vl:.4f}")
    info = {
        "val_mae": float(val_loss(params)),
        "history": hist,
        "train_s": time.time() - t0,
        "scale": scale,
    }
    return params, info


def fit_stream(
    cfg,
    shards,  # ShardStream (or any re-iterable of (x, y) shard pairs)
    *,
    steps: int = 200,
    batch: int = 4,
    val_shards: int = 1,
    steps_per_shard: int = 4,
    window: int = 8,
    seed: int = 0,
    verbose: bool = False,
    model=None,
    device=None,
) -> tuple[Any, dict]:
    """Train on a shard stream *while it is still being produced*, on
    ``device`` (``None``: the card).

    A scheduled sweep commits scenario shards as groups finish, and the
    trainer consumes them through a :class:`~repro_torch.surrogate.dataset.
    ShardStream` instead of waiting for campaign → shards →
    :func:`fit_shards`.  Two phases, both a pure function of (stream
    order, ``seed``, ``steps``) and therefore **deterministic for any
    (worker count, shard arrival) interleaving** — arrival timing only
    decides how long the stream blocks, never which batch is drawn when:

    1. **streaming** — the first ``val_shards`` shards become the held-out
       validation block (and the MAE normalization scale, from the
       validation block: the train split's std is unavailable before the
       stream ends).  Each subsequent shard triggers up to
       ``steps_per_shard`` optimizer steps on batches drawn from a sliding
       window of the last ``window`` shards;
    2. **full-dataset** — once the stream is exhausted, the remaining step
       budget samples (shard, rows) pairs over the whole dataset, loading
       one shard from disk per step: peak host memory stays O(shard).

    Returns ``(params, info)`` with :func:`fit`-compatible ``info`` keys
    plus ``n_shards`` and ``stream_wait_s`` (time blocked on uncommitted
    shards).  ``model`` selects the surrogate family exactly as in
    :func:`fit`.
    """
    model = _cnn if model is None else model
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    params = model.init_params(cfg, torch.Generator().manual_seed(seed), device=dev)
    step_fn, m, v = _make_adam(cfg, params, model.mae_loss)

    t0 = time.time()
    hist = []
    t = 0
    val_xy: list[tuple[np.ndarray, np.ndarray]] = []
    win: list[tuple[np.ndarray, np.ndarray]] = []
    s32 = np.float32(1.0)
    scale = 1.0
    val_loss = None

    def one_step(xb, yb):
        nonlocal params, m, v, t
        params, m, v, loss = step_fn(params, m, v, t, _on(xb, dev),
                                     _on(np.asarray(yb, np.float32) / s32, dev))
        if t % 25 == 0 or t == steps - 1:
            vl = float(val_loss(params))
            hist.append((t, float(loss), vl))
            if verbose:
                print(f"  step {t}: train {float(loss):.4f} val {vl:.4f}")
        t += 1

    def draw(pool):  # (shard-of-pool, rows) under the single seeded rng
        xs, ys = pool[int(rng.integers(0, len(pool)))]
        idx = rng.integers(0, len(xs), size=min(batch, len(xs)))
        return xs[idx], ys[idx]

    # ---- phase 1: consume the stream as it commits -------------------------
    n_shards = 0
    for xk, yk in shards:
        n_shards += 1
        if len(val_xy) < val_shards:
            val_xy.append((xk, yk))
            if len(val_xy) == val_shards:
                xv = np.concatenate([a for a, _ in val_xy])
                yv_raw = np.concatenate([b for _, b in val_xy])
                scale = float(np.abs(yv_raw).std() + 1e-12)
                s32 = np.float32(scale)
                yv = _on(np.asarray(yv_raw, np.float32) / s32, dev)
                # same canonical predict path as fit()'s val_loss
                val_loss = lambda p: (model.predict(p, cfg, xv, device=dev) - yv).abs().mean()  # noqa: E731
            continue
        win.append((xk, yk))
        del win[:-window]
        for _ in range(steps_per_shard):
            if t >= steps:
                break  # keep consuming: phase 2 needs the full shard list
            one_step(*draw(win))
    if val_loss is None:
        raise ValueError(
            f"stream ended after {n_shards} shard(s) — fewer than "
            f"val_shards={val_shards}; nothing left to train on"
        )
    if n_shards == val_shards:
        raise ValueError(
            f"stream holds only the {val_shards} validation shard(s) — "
            f"lower val_shards or generate more data"
        )
    win.clear()
    stream_wait_s = float(getattr(shards, "wait_s", 0.0))

    # ---- phase 2: remaining budget over the full dataset, O(shard) memory --
    n_train = n_shards - val_shards
    while t < steps:
        k = val_shards + int(rng.integers(0, n_train))
        if not hasattr(shards, "__getitem__"):
            raise TypeError(
                "fit_stream needs an indexable shard source (ShardStream) "
                "to run its full-dataset phase"
            )
        one_step(*draw([shards[k]]))

    info = {
        "val_mae": float(val_loss(params)),
        "history": hist,
        "train_s": time.time() - t0,
        "scale": scale,
        "n_shards": n_shards,
        "stream_wait_s": stream_wait_s,
    }
    return params, info


def fit_shards(
    cfg,
    shard_dir: str,
    *,
    order: Optional[Sequence[str]] = None,
    **kw,
) -> tuple[Any, dict]:
    """:func:`fit_stream` on a campaign-written dataset shard directory.

    The campaign → shards → trainer handoff: generation and training need
    not share a process.  ``shard_dir`` may be a flat shard directory, a
    multi-host ``OUT/pNN/`` tree, or a sweep's committed scenario cache.
    Training streams shard-by-shard through :func:`fit_stream`, so peak
    host memory is O(shard), not O(dataset).

    Shard **order** decides the batch sequence, so it also decides whether
    a post-hoc fit reproduces what :func:`fit_stream` computed live
    against an in-flight sweep (live consumers walk scenarios in *plan*
    order).  It is resolved in precedence order:

    1. ``order`` — scenario subdirectory names, explicitly;
    2. a ``plan.json`` manifest inside ``shard_dir`` whose scenario
       directories are all present and committed — plan order, via
       :func:`~repro_torch.surrogate.dataset.plan_scenario_order`;
    3. the :func:`~repro_torch.surrogate.dataset.shard_paths` layout order
       (sorted scenario names)."""
    from repro_torch.surrogate.dataset import ShardStream, committed, plan_scenario_order

    if order is None:
        names = plan_scenario_order(os.path.join(shard_dir, "plan.json"))
        if names and all(committed(os.path.join(shard_dir, n)) for n in names):
            order = names
    if order is not None:
        stream = ShardStream.from_cache(shard_dir, order, timeout_s=0.0)
    else:
        stream = ShardStream.from_dir(shard_dir)
    return fit_stream(cfg, stream, **kw)


def _save_members(directory: str, key: str, cfg, params, *, scale: float, step: int, keep: int) -> str:
    """One param tree or a list of members as ``member{i}`` trees of one
    :class:`~repro_torch.training.checkpoint.CheckpointManager` step, with
    ``{key: cfg, "scale", "members"}`` in the manifest ``meta``."""
    from repro_torch.training.checkpoint import CheckpointManager

    members = list(params) if isinstance(params, (list, tuple)) else [params]
    if not members:
        raise ValueError(f"saving a {key} needs at least one param set")
    state = {f"member{i}": p for i, p in enumerate(members)}
    meta = {key: dataclasses.asdict(cfg), "scale": float(scale), "members": len(members)}
    CheckpointManager(directory, keep=keep).save(step, state, blocking=True, meta=meta)
    return directory


def _load_members(directory: str, key: str, config_cls, init, device, written_by: str):
    """→ ``(cfg, members, scale, step)`` from the newest step under
    ``directory`` whose ``meta`` carries ``key``; ``init(cfg, generator,
    device=)`` gives the tree each member is restored into."""
    from repro_torch.training.checkpoint import CheckpointManager

    dev = resolve_device(device)
    mgr = CheckpointManager(directory)
    step = mgr.latest_step()
    if step is None:
        raise FileNotFoundError(f"no {key} checkpoint under {directory}")
    with open(os.path.join(directory, f"step_{step:09d}", "manifest.json")) as f:
        meta = (json.load(f) or {}).get("meta") or {}
    if key not in meta:
        raise ValueError(
            f"checkpoint step {step} under {directory} carries no {key} "
            f"meta — written by {written_by}"
        )
    cfg = config_cls(**meta[key])
    n = int(meta.get("members", 1))
    like = {f"member{i}": init(cfg, torch.Generator().manual_seed(0), device=dev) for i in range(n)}
    state = mgr.restore(step, like)
    return cfg, [state[f"member{i}"] for i in range(n)], float(meta.get("scale", 1.0)), step


def save_surrogate(
    directory: str,
    cfg: SurrogateConfig,
    params,
    *,
    scale: float = 1.0,
    step: int = 0,
    keep: int = 2,
) -> str:
    """Persist a trained surrogate (or an *ensemble* of them) for serving.

    ``params`` is one param tree or a list of independently-trained members
    (the serving tier's disagreement signal needs ≥ 2).  Written through
    :class:`repro_torch.training.checkpoint.CheckpointManager` — atomic,
    GC'd, the reference's layout — with the :class:`~repro_torch.surrogate.
    model.SurrogateConfig` and MAE-normalization ``scale`` in the manifest
    ``meta``, so :func:`load_surrogate` (and the JAX package's) can rebuild
    the model without side-channel config."""
    return _save_members(directory, "surrogate", cfg, params, scale=scale, step=step, keep=keep)


def load_surrogate(directory: str, *, device=None):
    """→ ``(cfg, members, scale, step)`` from the newest checkpoint written
    by :func:`save_surrogate` (either package's), the members on ``device``
    (``None``: the card); raises if the directory holds none."""
    return _load_members(directory, "surrogate", SurrogateConfig, init_params, device,
                        "save_surrogate? (campaign, training and trajectory checkpoints are not CNN surrogates)")


def search(x, y, *, trials: int = 4, steps: int = 120, seed: int = 0, latent_cap: int = 128, device=None):
    """Random search over the paper's (n_c, n_lstm, kernel, latent, lr)
    space on ``device`` (``None``: the card); returns the best ``(cfg,
    params, info)`` by validation MAE.

    Each trial is a full :func:`fit` on the **in-memory** ``(x, y)`` pair.
    For training-sized datasets, pick a config here at subset scale and
    hand it to :func:`fit_shards` / :func:`fit_stream`, which keep peak
    host memory at O(shard) and consume shards in plan order."""
    rng = np.random.default_rng(seed)
    best = None
    for t in range(trials):
        cfg = SurrogateConfig(
            n_c=int(rng.choice(SEARCH_SPACE["n_c"])),
            n_lstm=int(rng.choice(SEARCH_SPACE["n_lstm"])),
            kernel=int(rng.choice([k for k in SEARCH_SPACE["kernel"] if k <= 17])),
            latent=int(min(latent_cap, rng.choice(SEARCH_SPACE["latent"]))),
            lr=float(np.exp(rng.uniform(np.log(5e-5), np.log(5e-4)))),
        )
        params, info = fit(cfg, x, y, steps=steps, seed=seed + t, device=device)
        if best is None or info["val_mae"] < best[2]["val_mae"]:
            best = (cfg, params, info)
    return best
