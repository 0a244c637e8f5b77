"""Training/persistence entry points for the parallel-in-time trajectory
surrogate (:mod:`repro_torch.surrogate.seqmodel`).

Deliberately thin: every function here is the corresponding CNN-surrogate
entry point from :mod:`repro_torch.surrogate.train` with the trajectory
model plugged in, so the two surrogate families share one Adam update
(``train._make_adam``), one streaming loop (``train.fit_stream``), one
shard-order contract (``train.fit_shards``), and one checkpoint layout
(:class:`repro_torch.training.checkpoint.CheckpointManager`).  The only
trajectory-specific choice is the manifest key (``"trajectory"`` instead
of ``"surrogate"``), which keeps :func:`load_trajectory` and
``train.load_surrogate`` from restoring each other's params into the wrong
architecture.  The JAX package's ``surrogate/trajectory.py``: each package
loads the other's saved trajectory surrogates.

Data flow: ``dataset.generate(trajectories=True, obs_every=k)`` harvests
``(wave [N, nt, 3], history [N, ⌈nt/k⌉, 3])`` pairs;
:func:`fit_trajectory_shards` streams them; :func:`save_trajectory`
commits the result.
"""
from __future__ import annotations

from typing import Any

from repro_torch.surrogate import seqmodel
from repro_torch.surrogate import train as _train
from repro_torch.surrogate.seqmodel import TrajectoryConfig


def fit_trajectory(cfg: TrajectoryConfig, x, y, **kw) -> tuple[Any, dict]:
    """Adam + MAE on in-memory ``(wave, strided-history)`` pairs — the
    trajectory instantiation of :func:`repro_torch.surrogate.train.fit`
    (``device=None``: the card).

    ``x [N, nt, 3]`` full-rate bedrock waves, ``y [N, ⌈nt/obs_every⌉, 3]``
    observation series harvested at ``cfg.obs_every`` stride.  The forward
    pass trains through the O(log T)-depth scan."""
    return _train.fit(cfg, x, y, model=seqmodel, **kw)


def fit_trajectory_stream(cfg: TrajectoryConfig, shards, **kw):
    """Train on trajectory shards *while a campaign is still producing
    them* — :func:`repro_torch.surrogate.train.fit_stream` with the
    trajectory model; same determinism contract (batch sequence is a pure
    function of stream order and seed, never arrival timing)."""
    return _train.fit_stream(cfg, shards, model=seqmodel, **kw)


def fit_trajectory_shards(cfg: TrajectoryConfig, shard_dir: str, **kw):
    """:func:`fit_trajectory_stream` over a committed shard directory,
    resolved in plan order exactly as
    :func:`repro_torch.surrogate.train.fit_shards` documents."""
    return _train.fit_shards(cfg, shard_dir, model=seqmodel, **kw)


def save_trajectory(
    directory: str,
    cfg: TrajectoryConfig,
    params,
    *,
    scale: float = 1.0,
    step: int = 0,
    keep: int = 2,
) -> str:
    """Persist a trained trajectory surrogate (or ensemble) for serving:
    :func:`repro_torch.surrogate.train.save_surrogate`'s layout, with the
    manifest meta stamped ``"trajectory"`` so the loaders can tell the
    families apart."""
    return _train._save_members(directory, "trajectory", cfg, params, scale=scale, step=step, keep=keep)


def load_trajectory(directory: str, *, device=None):
    """→ ``(cfg, members, scale, step)`` from the newest checkpoint written
    by :func:`save_trajectory` (either package's), the members on
    ``device`` (``None``: the card); refuses checkpoints of other
    provenance (CNN-surrogate or campaign state) rather than mis-restoring
    them."""
    return _train._load_members(
        directory, "trajectory", TrajectoryConfig, seqmodel.init_params, device,
        "save_trajectory? (CNN-surrogate and campaign checkpoints are not trajectory models)")
