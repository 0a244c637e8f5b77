"""The port's Mamba-2 (``models/ssm.py``) against the JAX package's on the
same numpy inputs, fp32: the chunked SSD at chunks of 1, 3, 8 and the whole
sequence (13 steps: a multiple of neither 3 nor 8), with and without an
entering state; one decode step; the whole block, and the block stepped
with its cache (conv and SSM states), with the reference's weights carried
across.  Tolerances are the reference's (tests/test_models.py:201-248):
2e-5 on outputs and states, 1e-6 on the conv state.  Also bf16, where the
reference's dtype steps are part of the result: the chunked SSD within a
few bf16 roundings of the JAX one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.models import ssm as RS
from repro_torch.configs import ARCHS
from repro_torch.models import ssm as PS

B, S, H, P, G, N = 2, 13, 4, 8, 2, 4


def _ssd_inputs(seed=0):
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(size=(B, S, H, P)), "dt": rng.uniform(0.01, 0.2, size=(B, S, H)),
            "A": -rng.uniform(0.5, 2.0, size=(H,)), "Bm": rng.normal(size=(B, S, G, N)),
            "Cm": rng.normal(size=(B, S, G, N)), "s0": rng.normal(size=(B, H, P, N))}


def _both(a, jdtype=jnp.float32, tdtype=torch.float32):
    a = np.asarray(a, np.float32)
    return jnp.asarray(a, jdtype), torch.tensor(a).to(tdtype)


@pytest.mark.parametrize("chunk", [1, 3, 8, S])
def test_ssd_chunked_matches_reference(chunk):
    """From zero states and from an entering state."""
    d = _ssd_inputs()
    (jx, tx), (jdt, tdt), (jA, tA), (jB, tB), (jC, tC), (js, ts) = (
        _both(d[k]) for k in ("x", "dt", "A", "Bm", "Cm", "s0"))
    ref = jax.jit(lambda s0: RS.ssd_chunked(jx, jdt, jA, jB, jC, chunk, s0))
    for with_state in (False, True):
        ry, rs = ref(js if with_state else jnp.zeros_like(js))
        y, s = PS.ssd_chunked(tx, tdt, tA, tB, tC, chunk, ts if with_state else None)
        assert tuple(y.shape) == (B, S, H, P) and tuple(s.shape) == (B, H, P, N)
        np.testing.assert_allclose(y.numpy(), np.asarray(ry), atol=2e-5)
        np.testing.assert_allclose(s.numpy(), np.asarray(rs), atol=2e-5)


def test_ssd_chunked_bf16_follows_the_reference_dtype_steps():
    """In bf16 the casts of ``dt·A``, ``CB·L`` and the decays are part of
    the result: the port lands within a few bf16 roundings of the JAX one
    (an fp32 recurrence would sit much further off both)."""
    d = _ssd_inputs(1)
    (jx, tx), (jdt, tdt), (jA, tA), (jB, tB), (jC, tC) = (
        _both(d[k], jnp.bfloat16, torch.bfloat16) for k in ("x", "dt", "A", "Bm", "Cm"))
    ry, rs = RS.ssd_chunked(jx, jdt, jA, jB, jC, 4)
    y, s = PS.ssd_chunked(tx, tdt, tA, tB, tC, 4)
    assert y.dtype == s.dtype == torch.bfloat16
    ry, rs = np.asarray(ry.astype(jnp.float32)), np.asarray(rs.astype(jnp.float32))
    np.testing.assert_allclose(y.float().numpy(), ry, atol=4 * 2**-8 * np.abs(ry).max())
    np.testing.assert_allclose(s.float().numpy(), rs, atol=4 * 2**-8 * np.abs(rs).max())


def test_ssd_decode_step_matches_reference():
    d = _ssd_inputs(2)
    (jx, tx), (jdt, tdt), (jA, tA), (jB, tB), (jC, tC), (js, ts) = (
        _both(d[k]) for k in ("x", "dt", "A", "Bm", "Cm", "s0"))
    ry, rs = RS.ssd_decode_step(jx[:, :1], jdt[:, :1], jA, jB[:, :1], jC[:, :1], js)
    y, s = PS.ssd_decode_step(tx[:, :1], tdt[:, :1], tA, tB[:, :1], tC[:, :1], ts)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), atol=2e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), atol=2e-5)


def _block_setup():
    cfg, ref_cfg = ARCHS["mamba2-780m"].reduced(), REF_ARCHS["mamba2-780m"].reduced()
    ref_params, _ = RS.init_mamba2(jax.random.key(0), ref_cfg)
    params = {k: torch.tensor(np.asarray(v)) for k, v in ref_params.items()}
    x = (np.random.default_rng(0).normal(size=(2, 16, cfg.d_model)) * 0.1).astype(np.float32)
    return cfg, ref_cfg, params, ref_params, x


def test_mamba2_block_matches_reference_whole_and_stepped():
    """The whole block (and its final states), then the block stepped one
    input at a time from zero states with its cache written in place, each
    step's output and the states against the JAX block stepped alike."""
    cfg, ref_cfg, params, ref_params, x = _block_setup()
    ry, rc = RS.mamba2_block(ref_params, jnp.asarray(x), ref_cfg, return_state=True)
    y, c = PS.mamba2_block(params, torch.tensor(x), cfg, return_state=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), atol=2e-5)
    np.testing.assert_allclose(c["ssm"].numpy(), np.asarray(rc["ssm"]), atol=2e-5)
    np.testing.assert_allclose(c["conv"].numpy(), np.asarray(rc["conv"]), atol=1e-6)

    ref_step = jax.jit(lambda xt, c: RS.mamba2_block(ref_params, xt, ref_cfg, cache=c))
    rcache = RS.init_ssm_cache(ref_cfg, 2, jnp.float32)
    cache = PS.init_ssm_cache(cfg, 2, torch.float32, "cpu")
    held = {k: v for k, v in cache.items()}
    for t in range(x.shape[1]):
        ryt, rcache = ref_step(jnp.asarray(x[:, t:t + 1]), rcache)
        yt, out = PS.mamba2_block(params, torch.tensor(x[:, t:t + 1]), cfg, cache=cache)
        assert all(out[k] is held[k] for k in held)  # the states are stepped in place
        np.testing.assert_allclose(yt.numpy(), np.asarray(ryt), atol=2e-5)
        np.testing.assert_allclose(yt[:, 0].numpy(), y[:, t].numpy(), atol=2e-5)
    np.testing.assert_allclose(cache["ssm"].numpy(), np.asarray(rcache["ssm"]), atol=2e-5)
    np.testing.assert_allclose(cache["conv"].numpy(), np.asarray(rcache["conv"]), atol=1e-6)
    np.testing.assert_allclose(cache["ssm"].numpy(), c["ssm"].numpy(), atol=2e-5)


def test_init_mamba2_tree_and_values():
    """The reference's leaves, shapes and value inits (A_log, dt_bias, D,
    norm), stacked."""
    cfg, ref_cfg = ARCHS["zamba2-7b"].reduced(), REF_ARCHS["zamba2-7b"].reduced()
    ref, _ = RS.init_mamba2(jax.random.key(0), ref_cfg, (2, 3))
    mine = PS.init_mamba2(torch.Generator().manual_seed(0), cfg, (2, 3), device="cpu")
    assert {k: tuple(v.shape) for k, v in mine.items()} == {k: tuple(v.shape) for k, v in ref.items()}
    for k in ("A_log", "dt_bias", "D", "norm", "conv_b"):
        np.testing.assert_allclose(mine[k].numpy(), np.asarray(ref[k]), rtol=1e-6, atol=1e-7)
    assert 0.45 < float(mine["conv_w"].std()) < 0.55 and 0.018 < float(mine["in_proj"].std()) < 0.022
