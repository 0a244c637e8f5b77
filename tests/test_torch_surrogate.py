"""The port's CNN+LSTM surrogate and its trainer against the JAX package's,
both on the same numpy inputs on the CPU (the reference in fp32).

The reference's ``init_params`` crosses over with
``convert.surrogate_params_from_numpy``; ``fit`` gets them through a
``model=`` shim whose ``init_params`` returns them.  Tolerances: the
strided ``SAME`` convolution and the transposed one, ``apply`` and
``predict`` within 1e-5·max|y|; ``pick_bucket`` exactly equal; the MAE
gradient per leaf within 1e-4·max|g|; three Adam updates of one fixed
gradient within 1e-6·max (params, m, v); 30 steps of ``fit`` within 1e-4 relative
(val MAE and every history entry); ``search`` draws the reference's
configurations; checkpoints cross-load bitwise in both directions.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.surrogate import model as ref_model
from repro.surrogate import train as ref_train
from repro.surrogate.trajectory import load_trajectory as ref_load_trajectory
from repro_torch import convert
from repro_torch.core.stream import leaves_in_insertion_order, tree_map
from repro_torch.surrogate import model, train
from repro_torch.surrogate.trajectory import load_trajectory

CFG = dict(n_c=2, n_lstm=2, kernel=9, latent=16)
# the reference's functions compiled once (eager JAX compiles op by op)
ref_apply = jax.jit(ref_model.apply, static_argnums=1)
ref_value_and_grad = jax.jit(jax.value_and_grad(ref_model.mae_loss), static_argnums=1)


def _cfgs(**kw):
    kw = {**CFG, **kw}
    return ref_model.SurrogateConfig(**kw), model.SurrogateConfig(**kw)


def _ref_params(cfg, seed=0):
    return jax.tree_util.tree_map(np.asarray, ref_model.init_params(cfg, jax.random.key(seed)))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(a).max())


def _shim(params_np, module=model):
    """A ``model=`` module for ``train.fit`` whose ``init_params`` returns
    the reference's params."""
    class Shim:
        init_params = staticmethod(lambda cfg, gen, device: convert.surrogate_params_from_numpy(params_np, device))
        mae_loss = staticmethod(module.mae_loss)
        predict = staticmethod(module.predict)
    return Shim


def _smooth_pairs(n=8, nt=32, seed=0):
    """Band-limited waves and a saturating response (test_extras' data)."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 4 * np.pi, nt)
    x = (rng.uniform(0.5, 1.5, (n, 1, 3)) * np.sin(t[None, :, None] + rng.uniform(0, 2 * np.pi, (n, 1, 3))))
    return x.astype(np.float32), np.tanh(1.5 * x).astype(np.float32)


@pytest.mark.parametrize("K", [3, 9, 65])
@pytest.mark.parametrize("T", [8, 16, 40])
def test_strided_and_transposed_convs_match_xla(K, T):
    """XLA's SAME padding of a stride-2 convolution and lax.conv_transpose
    (no kernel flip) against the port's hand-padded ``F.conv1d``."""
    rng = np.random.default_rng(K * 100 + T)
    x = rng.normal(size=(2, T, 5)).astype(np.float32)
    w = rng.normal(size=(K, 5, 4)).astype(np.float32)
    b = rng.normal(size=(4,)).astype(np.float32)
    for ref_fn, fn in ((ref_model._conv1d, model._conv1d), (ref_model._conv1d_transpose, model._conv1d_transpose)):
        want = np.asarray(ref_fn(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=2))
        got = fn(torch.tensor(x), torch.tensor(w), torch.tensor(b), stride=2).numpy()
        assert got.shape == want.shape
        assert _rel(want, got) <= 1e-5


@pytest.mark.parametrize("kw", [{}, dict(n_c=3, n_lstm=1, kernel=5)])
def test_apply_and_predict_match(kw):
    rcfg, cfg = _cfgs(**kw)
    pn = _ref_params(rcfg)
    p = convert.surrogate_params_from_numpy(pn, "cpu")
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 64, 3)).astype(np.float32)
    want = np.asarray(ref_apply(pn, rcfg, jnp.asarray(x)))
    got = model.apply(p, cfg, torch.tensor(x)).numpy()
    assert got.shape == want.shape == (2, 64, 3) and _rel(want, got) <= 1e-5
    # odd B and T: T padded to a multiple of 2**n_c, B to a bucket, both trimmed
    xo = rng.normal(size=(3, 37, 3)).astype(np.float32)
    for buckets in (model.PREDICT_BUCKETS, (2,)):
        want = np.asarray(ref_model.predict(pn, rcfg, xo, buckets=buckets))
        got = model.predict(p, cfg, xo, buckets=buckets, device="cpu").numpy()
        assert got.shape == want.shape == (3, 37, 3) and _rel(want, got) <= 1e-5
    # row independence within one bucket (the serving contract)
    one = model.predict(p, cfg, xo[1:2], buckets=(4,), device="cpu").numpy()
    np.testing.assert_array_equal(one[0], model.predict(p, cfg, xo, buckets=(4,), device="cpu").numpy()[1])


def test_pick_bucket_equal():
    for buckets in (model.PREDICT_BUCKETS, (4,), (3, 1, 10)):
        for n in range(1, 200):
            assert model.pick_bucket(n, buckets) == ref_model.pick_bucket(n, buckets)
    assert model.PREDICT_BUCKETS == ref_model.PREDICT_BUCKETS
    with pytest.raises(ValueError, match="batch must be"):
        model.pick_bucket(0)


def test_predict_refuses_params_elsewhere():
    _, cfg = _cfgs()
    p = model.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="predict expects"):
        model.predict(p, cfg, np.zeros((4, 3)), device="cpu")
    with pytest.raises(ValueError, match="params live on"):
        model.check_params_on(p, torch.device("meta"))


def test_init_params_shapes_and_draw():
    """The reference's tree, leaf for leaf (names, shapes, fp32, zero
    biases, He scales); the draw depends on the generator alone."""
    rcfg, cfg = _cfgs(n_c=3, latent=32)
    pn = _ref_params(rcfg)
    p = model.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    assert jax.tree_util.tree_structure(pn) == jax.tree_util.tree_structure(tree_map(lambda t: t.numpy(), p))
    for a, b in zip(jax.tree_util.tree_leaves(pn), jax.tree_util.tree_leaves(tree_map(lambda t: t.numpy(), p))):
        assert a.shape == b.shape and b.dtype == np.float32
    w = p["enc"][1]["w"]
    assert abs(float(w.std()) - (2.0 / (9 * 16)) ** 0.5) < 0.1 * (2.0 / (9 * 16)) ** 0.5
    assert all(float(layer["b"].abs().max()) == 0 for layer in p["enc"] + p["dec"])
    q = model.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(leaves_in_insertion_order(p), leaves_in_insertion_order(q)))


def _grads_np(params_t, cfg, x, y, module=model):
    ps = tree_map(lambda t: t.clone().requires_grad_(True), params_t)
    loss = module.mae_loss(ps, cfg, torch.tensor(x), torch.tensor(y))
    g = iter(torch.autograd.grad(loss, leaves_in_insertion_order(ps)))
    return float(loss.detach()), tree_map(lambda _: next(g).numpy(), params_t)


def test_mae_loss_and_gradient_match():
    rcfg, cfg = _cfgs()
    pn = _ref_params(rcfg)
    rng = np.random.default_rng(2)
    x, y = (rng.normal(size=(3, 33, 3)).astype(np.float32) for _ in range(2))  # odd B·T: no exact-zero sign sum
    want_l, want_g = ref_value_and_grad(pn, rcfg, jnp.asarray(x), jnp.asarray(y))
    got_l, got_g = _grads_np(convert.surrogate_params_from_numpy(pn, "cpu"), cfg, x, y)
    assert got_l == pytest.approx(float(want_l), rel=1e-5)
    want_g = jax.tree_util.tree_map(np.asarray, want_g)
    assert jax.tree_util.tree_structure(want_g) == jax.tree_util.tree_structure(got_g)
    for a, b in zip(jax.tree_util.tree_leaves(want_g), jax.tree_util.tree_leaves(got_g)):
        assert np.abs(a).max() > 0 and _rel(a, b) <= 1e-4


def test_adam_steps_match():
    """The update alone: a loss linear in the params has the same gradient
    in both packages, exactly, so three steps compare the arithmetic of m,
    v, the fp32 bias corrections and the eps placement within 1e-6·max."""
    rcfg, cfg = _cfgs(lr=1e-2)
    pn = _ref_params(rcfg)
    rng = np.random.default_rng(3)
    c = jax.tree_util.tree_map(lambda a: rng.normal(size=a.shape).astype(np.float32), pn)
    c_t = convert.surrogate_params_from_numpy(c, "cpu")

    def ref_loss(p, cfg, xb, yb):
        return sum(jnp.sum(a * b) for a, b in zip(jax.tree_util.tree_leaves(p), jax.tree_util.tree_leaves(c)))

    def loss(p, cfg, xb, yb):
        return sum((a * b).sum() for a, b in zip(leaves_in_insertion_order(p), leaves_in_insertion_order(c_t)))

    step_r, m_r, v_r = ref_train._make_adam(rcfg, pn, ref_loss)
    p = convert.surrogate_params_from_numpy(pn, "cpu")
    step_t, m_t, v_t = train._make_adam(cfg, p, loss)
    x = np.zeros((1, 4, 3), np.float32)
    for t in range(3):
        pn, m_r, v_r, _ = step_r(pn, m_r, v_r, jnp.asarray(t, jnp.float32), x, x)
        p, m_t, v_t, _ = step_t(p, m_t, v_t, t, torch.tensor(x), torch.tensor(x))
    for tree_r, tree_t in ((pn, p), (m_r, m_t), (v_r, v_t)):
        ref_leaves = jax.tree_util.tree_leaves(tree_r)
        got_leaves = jax.tree_util.tree_leaves(tree_map(lambda t: t.numpy(), tree_t))
        assert len(ref_leaves) == len(got_leaves) == 20
        for a, b in zip(ref_leaves, got_leaves):
            assert _rel(a, b) <= 1e-6
    assert not any(t.requires_grad for t in leaves_in_insertion_order(p))


def _assert_fit_info_close(want, got, rel=1e-4):
    assert got["val_mae"] == pytest.approx(want["val_mae"], rel=rel)
    assert got["scale"] == want["scale"]
    assert [h[0] for h in got["history"]] == [h[0] for h in want["history"]]
    for (_, lw, vw), (_, lg, vg) in zip(want["history"], got["history"]):
        assert lg == pytest.approx(lw, rel=rel) and vg == pytest.approx(vw, rel=rel)


def test_fit_30_steps_from_the_reference_init():
    """Same init, same numpy batch draws, same Adam: the val MAE and every
    history entry within 1e-4 relative after 30 steps.  Batches of 3 × 33
    samples: a head bias's MAE gradient sums ±1/(B·T) terms, and with an
    odd count it cannot cancel to an exact zero (the reference's fp32
    reduction leaves such a zero as a ~1e-9 residue, which Adam's first
    step scales to 0.16·lr while the port's exact zero moves nothing)."""
    rcfg, cfg = _cfgs(lr=3e-3)
    pn = _ref_params(rcfg)
    x, y = _smooth_pairs(nt=33)
    _, want = ref_train.fit(rcfg, x, y, steps=30, batch=3, seed=0)
    params, got = train.fit(cfg, x, y, steps=30, batch=3, seed=0, model=_shim(pn), device="cpu")
    _assert_fit_info_close(want, got)
    assert got["history"][-1][1] < got["history"][0][1]  # it learns
    assert params["enc"][0]["w"].device.type == "cpu"


def test_search_draws_the_reference_configurations(monkeypatch):
    """The trial configurations come from the reference's rng calls in the
    reference's order (``fit`` stubbed in both packages); the port's real
    search runs end to end."""
    seen = {}

    def recorder(key):
        def fake_fit(cfg, x, y, *, steps, seed, **kw):
            seen.setdefault(key, []).append((dataclasses.asdict(cfg), steps, seed))
            return None, {"val_mae": -len(seen[key])}
        return fake_fit

    monkeypatch.setattr(ref_train, "fit", recorder("ref"))
    monkeypatch.setattr(train, "fit", recorder("port"))
    for seed in (0, 7):
        seen.clear()
        ref_best = ref_train.search(None, None, trials=5, steps=3, seed=seed, latent_cap=256)
        best = train.search(None, None, trials=5, steps=3, seed=seed, latent_cap=256)
        assert seen["port"] == seen["ref"] and len(seen["port"]) == 5
        assert dataclasses.asdict(best[0]) == dataclasses.asdict(ref_best[0])
    monkeypatch.undo()
    x, y = _smooth_pairs(n=4, nt=16)
    cfg, params, info = train.search(x, y, trials=2, steps=2, seed=1, latent_cap=8, device="cpu")
    assert cfg.latent == 8 and np.isfinite(info["val_mae"]) and train.SEARCH_SPACE == ref_train.SEARCH_SPACE


def test_surrogate_checkpoints_cross_load_bitwise(tmp_path):
    """A surrogate (two members) saved by either package loads in the other
    bitwise with its config and scale; the trajectory loader refuses it."""
    rcfg, cfg = _cfgs(n_lstm=1)
    members_np = [_ref_params(rcfg, seed) for seed in (0, 1)]
    ref_train.save_surrogate(str(tmp_path / "ref"), rcfg, members_np, scale=0.25, step=4)
    got_cfg, got, scale, step = train.load_surrogate(str(tmp_path / "ref"), device="cpu")
    assert (got_cfg, scale, step, len(got)) == (cfg, 0.25, 4, 2)
    for want, m in zip(members_np, got):
        for a, b in zip(jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(tree_map(lambda t: t.numpy(), m))):
            np.testing.assert_array_equal(a, b, strict=True)

    port = [model.init_params(cfg, torch.Generator().manual_seed(s), device="cpu") for s in (5, 6)]
    train.save_surrogate(str(tmp_path / "port"), cfg, port, scale=2.0, step=1)
    want_cfg, want, scale, step = ref_train.load_surrogate(str(tmp_path / "port"))
    assert (dataclasses.asdict(want_cfg), scale, step, len(want)) == (dataclasses.asdict(cfg), 2.0, 1, 2)
    for m, r in zip(port, want):
        for a, b in zip(jax.tree_util.tree_leaves(tree_map(lambda t: t.numpy(), m)), jax.tree_util.tree_leaves(r)):
            np.testing.assert_array_equal(a, np.asarray(b), strict=True)
    # each family's loader refuses the other's checkpoints, in both packages
    for d in ("ref", "port"):
        with pytest.raises(ValueError, match="no trajectory meta"):
            load_trajectory(str(tmp_path / d), device="cpu")
        with pytest.raises(ValueError, match="no trajectory meta"):
            ref_load_trajectory(str(tmp_path / d))
    with pytest.raises(FileNotFoundError):
        train.load_surrogate(str(tmp_path / "empty"), device="cpu")


def test_surrogate_params_from_numpy_keeps_the_tree_and_refuses_others():
    rcfg, _ = _cfgs()
    pn = _ref_params(rcfg)
    p = convert.surrogate_params_from_numpy(pn, "cpu")
    assert jax.tree_util.tree_structure(pn) == jax.tree_util.tree_structure(tree_map(lambda t: t.numpy(), p))
    assert all(t.dtype == torch.float32 for t in leaves_in_insertion_order(p))
    with pytest.raises(ValueError, match="surrogate tree has keys"):
        convert.surrogate_params_from_numpy({"embed": np.zeros(3, np.float32)}, "cpu")
    with pytest.raises(ValueError, match="fp32"):
        convert.surrogate_params_from_numpy(jax.tree_util.tree_map(lambda a: a.astype(np.float64), pn), "cpu")
