"""gemma2's local/global pair stack in the port against the JAX package
(reduced config, fp32, unless a case says otherwise): the ring caches of the
local sub-layers past the window, the global caches beside them, the √d
embedding scale and the final logit softcap.

Tolerances: the window's ring within 1e-4·max|logits| (tests/test_models.py:160);
the embedding bitwise (the same rounding in bf16); the softcap within 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.models import transformer as RT
from repro_torch import convert
from repro_torch.configs import ARCHS
from repro_torch.models import transformer as T

NAME = "gemma2-2b"


def _setup(**replace):
    ref_cfg = dataclasses.replace(REF_ARCHS[NAME].reduced(), **replace)
    cfg = dataclasses.replace(ARCHS[NAME].reduced(), **replace)
    ref_params, _ = RT.init_params(ref_cfg, jax.random.key(0))
    return ref_cfg, ref_params, cfg, convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, ref_params),
                                                               cfg, "cpu")


@pytest.mark.parametrize("S0", [3, 9])
def test_local_ring_past_the_window(S0):
    """Window 4: the local caches hold 4 slots, the global ones 12; a prompt
    past the window (S0 9) is ring-packed into the local caches; decode from
    the port's prefill and from the JAX prefill's state follows forward."""
    ref_cfg, ref_params, cfg, params = _setup(window=4)
    B, S = 2, 12
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    fwd = np.asarray(RT.forward(ref_params, ref_cfg, {"tokens": jnp.asarray(toks)}, remat=False)[0])
    tol = 1e-4 * np.abs(fwd).max()
    _, rstate = RT.prefill(ref_params, ref_cfg, {"tokens": jnp.asarray(toks[:, :S0])}, cache_len=S)
    lg, state = T.prefill(params, cfg, {"tokens": torch.tensor(toks[:, :S0], dtype=torch.long)}, S)
    half = cfg.n_layers // 2
    assert tuple(state["local"]["k"].shape) == (half, B, cfg.n_kv_heads, 4, cfg.hd)
    assert tuple(state["global"]["k"].shape) == (half, B, cfg.n_kv_heads, S, cfg.hd)
    for key in ("local", "global"):
        for leaf in ("k", "v"):
            np.testing.assert_allclose(state[key][leaf].numpy(), np.asarray(rstate[key][leaf]), atol=1e-5)
    from_ref = convert.decode_state_from_numpy(jax.tree_util.tree_map(np.asarray, rstate), cfg, "cpu")
    np.testing.assert_allclose(lg[:, 0].numpy(), fwd[:, S0 - 1], atol=tol)
    for t in range(S0, S):
        tok = torch.tensor(toks[:, t:t + 1], dtype=torch.long)
        lg, state = T.decode_step(params, cfg, tok, state)
        lg2, from_ref = T.decode_step(params, cfg, tok, from_ref)
        np.testing.assert_allclose(lg[:, 0].numpy(), fwd[:, t], atol=tol)
        np.testing.assert_allclose(lg2[:, 0].numpy(), fwd[:, t], atol=tol)


def test_window_acts_in_forward():
    """The local sub-layers' window is on: at window 4 the logits differ from
    the same model at a window that covers the prompt (and the reference's
    do alike), and the port matches the reference at both."""
    outs = {}
    toks = np.random.default_rng(3).integers(0, 256, size=(1, 12)).astype(np.int32)
    for w in (4, 16):
        ref_cfg, ref_params, cfg, params = _setup(window=w)
        ref = np.asarray(RT.forward(ref_params, ref_cfg, {"tokens": jnp.asarray(toks)}, remat=False)[0])
        mine = T.forward(params, cfg, {"tokens": torch.tensor(toks, dtype=torch.long)})[0].numpy()
        np.testing.assert_allclose(mine, ref, atol=5e-5 * np.abs(ref).max())
        outs[w] = mine
    assert np.abs(outs[4][:, 4:] - outs[16][:, 4:]).max() > 1e-3 * np.abs(outs[16]).max()
    np.testing.assert_allclose(outs[4][:, :4], outs[16][:, :4], atol=5e-5 * np.abs(outs[16]).max())


def test_embedding_scale_in_bf16_at_published_width():
    """gemma2-2b's d 2,304 in bf16: the rows cast, then × √d rounded to bf16
    (48, exact), bitwise the reference's ``_embed``."""
    ref_cfg = dataclasses.replace(REF_ARCHS[NAME], vocab_size=64)
    cfg = dataclasses.replace(ARCHS[NAME], vocab_size=64)
    table = np.random.default_rng(4).normal(scale=0.7, size=(64, cfg.d_model)).astype(np.float32)
    toks = np.array([[0, 5, 63, 5]], dtype=np.int32)
    ref = RT._embed({"embed": jnp.asarray(table)}, ref_cfg, jnp.asarray(toks))
    mine = T._embed({"embed": torch.tensor(table)}, cfg, torch.tensor(toks, dtype=torch.long))
    assert mine.dtype == torch.bfloat16 and str(ref.dtype) == "bfloat16"
    np.testing.assert_array_equal(mine.float().numpy(), np.asarray(ref.astype(jnp.float32)))
    odd = dataclasses.replace(cfg, d_model=2000)  # √2000 is not a bf16 number: it is rounded first
    ref_odd = RT._embed({"embed": jnp.asarray(table[:, :2000])}, dataclasses.replace(ref_cfg, d_model=2000),
                        jnp.asarray(toks))
    mine_odd = T._embed({"embed": torch.tensor(table[:, :2000])}, odd, torch.tensor(toks, dtype=torch.long))
    np.testing.assert_array_equal(mine_odd.float().numpy(), np.asarray(ref_odd.astype(jnp.float32)))


def test_final_softcap_matches_reference():
    ref_cfg, ref_params, cfg, params = _setup()
    x = np.random.default_rng(5).normal(scale=40.0, size=(2, 3, cfg.d_model)).astype(np.float32)
    ref = np.asarray(RT._unembed(ref_params, ref_cfg, jnp.asarray(x)))
    mine = T._unembed(params, cfg, torch.tensor(x)).numpy()
    assert np.abs(mine).max() <= cfg.final_softcap
    np.testing.assert_allclose(mine, ref, atol=1e-6 * cfg.final_softcap)
