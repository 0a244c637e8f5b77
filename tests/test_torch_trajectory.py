"""The port's SSM trajectory surrogate against the JAX package's, both on the
same numpy inputs on the CPU (the reference in fp32).

Tolerances: the doubling scan against the reference's ``lax.scan`` at T ∈
{1, 2, 7, 64, 129} within atol 1e-5 (the reference's own), and against the
port's loop likewise; ``apply`` (both scans) and ``predict`` within
1e-5·max|y|; ``step`` replayed sample by sample against ``apply(scan=
"seq")`` within atol 1e-5 (the reference's test); the MAE gradient per
leaf within 1e-4·max|g|; 30 steps of ``fit_trajectory`` from the
reference's init within 1e-4 relative; ``rmsnorm`` (the port's
``models/layers``) within 1e-6·max for fp32; checkpoints cross-load bitwise
in both directions, and each family's loader refuses the other's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as ref_layers
from repro.surrogate import model as ref_model
from repro.surrogate import seqmodel as ref_seq
from repro.surrogate import train as ref_train
from repro.surrogate import trajectory as ref_traj
from repro_torch import convert
from repro_torch.core.stream import leaves_in_insertion_order, tree_map
from repro_torch.models import layers
from repro_torch.surrogate import dataset, model, seqmodel, train, trajectory

CFG = dict(latent=8, state=4, n_layers=2)
ref_apply = jax.jit(ref_seq.apply, static_argnums=1, static_argnames="scan")
ref_value_and_grad = jax.jit(jax.value_and_grad(ref_seq.mae_loss), static_argnums=1)


def _cfgs(**kw):
    kw = {**CFG, **kw}
    return ref_seq.TrajectoryConfig(**kw), seqmodel.TrajectoryConfig(**kw)


def _ref_params(cfg, seed=0):
    return jax.tree_util.tree_map(np.asarray, ref_seq.init_params(cfg, jax.random.key(seed)))


def _np(tree):
    return tree_map(lambda t: t.detach().numpy(), tree)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(a).max())


def waves(n, nt, seed=0):
    return np.random.default_rng(seed).standard_normal((n, nt, 3)).astype(np.float32)


@pytest.mark.parametrize("T", [1, 2, 7, 64, 129])
def test_doubling_scan_matches_the_reference_scan(T):
    rng = np.random.default_rng(T)
    a = rng.uniform(0.1, 0.999, size=(2, T, 4, 3)).astype(np.float32)
    b = rng.normal(size=(2, T, 4, 3)).astype(np.float32)
    want = np.asarray(ref_seq.ssm_scan_ref(jnp.asarray(a), jnp.asarray(b)))
    got = seqmodel.ssm_scan(torch.tensor(a), torch.tensor(b)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(seqmodel.ssm_scan_ref(torch.tensor(a), torch.tensor(b)).numpy(), want, atol=1e-5)
    h0 = rng.normal(size=(2, 4, 3)).astype(np.float32)
    want = np.asarray(ref_seq.ssm_scan(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0)))
    for fn in (seqmodel.ssm_scan, seqmodel.ssm_scan_ref):
        np.testing.assert_allclose(fn(torch.tensor(a), torch.tensor(b), torch.tensor(h0)).numpy(), want, atol=1e-5)


def test_rmsnorm_matches_the_reference_in_fp32():
    """``seqmodel`` normalizes with the port's ``models/layers.rmsnorm``:
    eps 1e-6, the variance in fp32, fp32 in and out."""
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(3, 7, 16)) * 40).astype(np.float32)
    s = rng.normal(size=(16,)).astype(np.float32)
    want = np.asarray(ref_layers.rmsnorm(jnp.asarray(x), jnp.asarray(s)))
    got = layers.rmsnorm(torch.tensor(x), torch.tensor(s))
    assert got.dtype == torch.float32 and _rel(want, got.numpy()) <= 1e-6
    tiny = np.full((1, 16), 1e-4, np.float32)  # where eps decides the scale
    assert _rel(np.asarray(ref_layers.rmsnorm(jnp.asarray(tiny), jnp.asarray(s))),
                layers.rmsnorm(torch.tensor(tiny), torch.tensor(s)).numpy()) <= 1e-6


@pytest.mark.parametrize("scan", seqmodel.SCANS)
def test_apply_and_predict_match(scan):
    rcfg, cfg = _cfgs()
    pn = _ref_params(rcfg)
    p = convert.surrogate_params_from_numpy(pn, "cpu")
    x = waves(2, 33)
    want = np.asarray(ref_apply(pn, rcfg, jnp.asarray(x), scan=scan))
    got = seqmodel.apply(p, cfg, torch.tensor(x), scan=scan).numpy()
    assert got.shape == want.shape == (2, 33, 3) and _rel(want, got) <= 1e-5
    rcfg4, cfg4 = _cfgs(obs_every=4)
    x = waves(3, 30, seed=1)
    want = np.asarray(ref_seq.predict(pn, rcfg4, x, buckets=(4,), scan=scan))
    got = seqmodel.predict(p, cfg4, x, buckets=(4,), scan=scan, device="cpu").numpy()
    assert got.shape == want.shape == (3, 8, 3) and _rel(want, got) <= 1e-5
    for i in range(3):  # row independence within one bucket (the serving contract)
        np.testing.assert_array_equal(
            got[i], seqmodel.predict(p, cfg4, x[i:i + 1], buckets=(4,), scan=scan, device="cpu").numpy()[0])
    with pytest.raises(ValueError, match="scan must be one of"):
        seqmodel.apply(p, cfg, torch.tensor(x), scan="magic")


def test_step_replays_the_sequential_path():
    """O(1)-state streaming ≡ the full-sequence loop, within the port."""
    _, cfg = _cfgs()
    p = seqmodel.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    x = torch.tensor(waves(2, 17))
    full = seqmodel.apply(p, cfg, x, scan="seq")
    state = seqmodel.init_state(cfg, 2, device="cpu")
    outs = []
    for t in range(x.shape[1]):
        y_t, state = seqmodel.step(p, cfg, x[:, t], state)
        outs.append(y_t)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(), atol=1e-5)
    assert [tuple(h.shape) for h in state] == [(2, 8, 4)] * 2
    with pytest.raises(ValueError, match="obs_every"):
        seqmodel.TrajectoryConfig(obs_every=0)


def test_init_params_tree_and_constants():
    rcfg, cfg = _cfgs()
    pn = _ref_params(rcfg)
    p = _np(seqmodel.init_params(cfg, torch.Generator().manual_seed(1), device="cpu"))
    assert jax.tree_util.tree_structure(pn) == jax.tree_util.tree_structure(p)
    for a, b in zip(jax.tree_util.tree_leaves(pn), jax.tree_util.tree_leaves(p)):
        assert a.shape == b.shape and b.dtype == np.float32
    for name in ("A_log", "dt_bias", "D", "norm"):  # the deterministic leaves
        np.testing.assert_allclose(p["layers"][1][name], pn["layers"][1][name], rtol=1e-6)


def test_mae_loss_and_gradient_match():
    rcfg, cfg = _cfgs(obs_every=2)
    pn = _ref_params(rcfg)
    x, y = waves(3, 18), waves(3, 9, seed=1)  # odd B·T: no exact-zero sign sum
    want_l, want_g = ref_value_and_grad(pn, rcfg, jnp.asarray(x), jnp.asarray(y))
    ps = tree_map(lambda t: t.requires_grad_(True), convert.surrogate_params_from_numpy(pn, "cpu"))
    loss = seqmodel.mae_loss(ps, cfg, torch.tensor(x), torch.tensor(y))
    g = iter(torch.autograd.grad(loss, leaves_in_insertion_order(ps)))
    got_g = tree_map(lambda _: next(g).numpy(), ps)
    assert float(loss.detach()) == pytest.approx(float(want_l), rel=1e-5)
    want_g = jax.tree_util.tree_map(np.asarray, want_g)
    assert jax.tree_util.tree_structure(want_g) == jax.tree_util.tree_structure(got_g)
    for a, b in zip(jax.tree_util.tree_leaves(want_g), jax.tree_util.tree_leaves(got_g)):
        assert np.abs(a).max() > 0 and _rel(a, b) <= 1e-4


def _shim(params_np):
    class Shim:
        init_params = staticmethod(lambda cfg, gen, device: convert.surrogate_params_from_numpy(params_np, device))
        mae_loss = staticmethod(seqmodel.mae_loss)
        predict = staticmethod(seqmodel.predict)
    return Shim


def test_fit_trajectory_30_steps_from_the_reference_init():
    """Batches of 3 × 9 strided samples: an odd count, so no MAE sign sum
    (the output bias's gradient) cancels to an exact zero that the two
    packages would round differently (see test_torch_surrogate)."""
    rcfg, cfg = _cfgs(n_layers=1, obs_every=2, lr=1e-2)
    pn = _ref_params(rcfg)
    x = waves(8, 18)
    y = x[:, ::2] * 0.5  # a linear strided map the SSM can represent
    _, want = ref_traj.fit_trajectory(rcfg, x, y, steps=30, batch=3, seed=0)
    params, got = train.fit(cfg, x, y, steps=30, batch=3, seed=0, model=_shim(pn), device="cpu")
    assert got["scale"] == want["scale"] and got["val_mae"] == pytest.approx(want["val_mae"], rel=1e-4)
    assert [h[0] for h in got["history"]] == [h[0] for h in want["history"]]
    for (_, lw, vw), (_, lg, vg) in zip(want["history"], got["history"]):
        assert lg == pytest.approx(lw, rel=1e-4) and vg == pytest.approx(vw, rel=1e-4)
    assert got["history"][-1][2] < got["history"][0][2]  # val MAE fell
    # the port's own entry point, from its own init, learns as well
    params, info = trajectory.fit_trajectory(cfg, x, y, steps=30, batch=3, seed=0, device="cpu")
    assert info["history"][-1][2] < info["history"][0][2]


def test_trajectory_checkpoints_cross_load_bitwise(tmp_path):
    rcfg, cfg = _cfgs(n_layers=1, obs_every=2)
    members_np = [_ref_params(rcfg, seed) for seed in (0, 1)]
    ref_traj.save_trajectory(str(tmp_path / "ref"), rcfg, members_np, scale=0.5, step=3)
    got_cfg, got, scale, step = trajectory.load_trajectory(str(tmp_path / "ref"), device="cpu")
    assert (got_cfg, scale, step, len(got)) == (cfg, 0.5, 3, 2)
    for want, m in zip(members_np, got):
        for a, b in zip(jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(_np(m))):
            np.testing.assert_array_equal(a, b, strict=True)

    port = seqmodel.init_params(cfg, torch.Generator().manual_seed(4), device="cpu")
    trajectory.save_trajectory(str(tmp_path / "port"), cfg, port, scale=1.5, step=2)
    want_cfg, want, scale, step = ref_traj.load_trajectory(str(tmp_path / "port"))
    assert (dataclasses.asdict(want_cfg), scale, step, len(want)) == (dataclasses.asdict(cfg), 1.5, 2, 1)
    for a, b in zip(jax.tree_util.tree_leaves(_np(port)), jax.tree_util.tree_leaves(want[0])):
        np.testing.assert_array_equal(a, np.asarray(b), strict=True)
    # each family's loader refuses the other's, in both packages
    for d in ("ref", "port"):
        with pytest.raises(ValueError, match="no surrogate meta"):
            train.load_surrogate(str(tmp_path / d), device="cpu")
        with pytest.raises(ValueError, match="no surrogate meta"):
            ref_train.load_surrogate(str(tmp_path / d))
    scfg = model.SurrogateConfig(n_c=2, n_lstm=1, latent=8)
    train.save_surrogate(str(tmp_path / "cnn"), scfg, model.init_params(scfg, torch.Generator(), device="cpu"))
    with pytest.raises(ValueError, match="no trajectory meta"):
        trajectory.load_trajectory(str(tmp_path / "cnn"), device="cpu")
    ref_train.save_surrogate(str(tmp_path / "ref_cnn"), ref_model.SurrogateConfig(n_c=2, n_lstm=1, latent=8),
                             ref_model.init_params(ref_model.SurrogateConfig(n_c=2, n_lstm=1, latent=8),
                                                   jax.random.key(0)))
    with pytest.raises(ValueError, match="no trajectory meta"):
        trajectory.load_trajectory(str(tmp_path / "ref_cnn"), device="cpu")


def test_fit_trajectory_shards_streams(tmp_path):
    cfg = seqmodel.TrajectoryConfig(latent=8, state=4, n_layers=1, obs_every=2)
    x = waves(8, 16)
    d = str(tmp_path / "shards")
    dataset.save_shards(d, x, x[:, ::2] * 0.5, shard_size=2, meta={"trajectories": True, "obs_every": 2})
    params, info = trajectory.fit_trajectory_shards(cfg, d, steps=8, batch=2, seed=0, device="cpu")
    assert info["n_shards"] == 4 and np.isfinite(info["val_mae"])
    stream = dataset.ShardStream.from_dir(d)
    _, live = trajectory.fit_trajectory_stream(cfg, stream, steps=8, batch=2, seed=0, device="cpu")
    assert live["val_mae"] == info["val_mae"] and live["history"] == info["history"]
