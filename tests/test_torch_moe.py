"""The MoE layer (``models/moe.py``) and mixtral's serving paths in the port
against the JAX package, on the same numpy inputs (reduced configs, fp32).

Tolerances: ``moe`` within 1e-5 (tests/test_models.py:204, the reference's
dropless check); its aux loss within 1e-6 relative and
``tokens_dropped_fraction`` equal; the window's ring buffer within
1e-4·max|logits| (tests/test_models.py:160); offloaded decode bitwise equal
to resident decode.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.models import moe as RM
from repro.models import transformer as RT
from repro_torch import convert
from repro_torch.configs import ARCHS
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.serving import decode as D

MOE_NAMES = ["mixtral-8x22b", "deepseek-v2-236b"]  # topk_softmax, softmax_topk with a shared expert


def _moe_setup(name, **replace):
    ref_cfg = dataclasses.replace(REF_ARCHS[name].reduced(), **replace)
    cfg = dataclasses.replace(ARCHS[name].reduced(), **replace)
    ref_p, _ = RM.init_moe(jax.random.key(4), ref_cfg)
    return ref_cfg, ref_p, cfg, convert._tree(jax.tree_util.tree_map(np.asarray, ref_p), "cpu")


@pytest.mark.parametrize("name", MOE_NAMES)
@pytest.mark.parametrize("capacity", ["default", 8.0, 0.1, "full"])
def test_moe_matches_reference(name, capacity):
    replace = {} if capacity in ("default", "full") else {"capacity_factor": capacity}
    ref_cfg, ref_p, cfg, p = _moe_setup(name, **replace)
    x = np.random.default_rng(5).normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    full = capacity == "full"
    ref_y, ref_aux = RM.moe(ref_p, jnp.asarray(x), ref_cfg, full_capacity=full)
    y, aux = M.moe(p, torch.tensor(x), cfg, full_capacity=full)
    assert y.dtype == torch.float32 and aux.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), atol=1e-5)
    np.testing.assert_allclose(float(aux), float(ref_aux), rtol=1e-6)
    assert float(aux) > 0


def test_moe_capacity_drops_what_the_reference_drops():
    """At capacity factor 0.1 the layer differs from its dropless self (the
    reference's test_moe_capacity_drops_tokens), by the same amount."""
    ref_cfg, ref_p, cfg, p = _moe_setup("mixtral-8x22b", capacity_factor=0.1)
    x = np.random.default_rng(5).normal(size=(2, 32, cfg.d_model)).astype(np.float32)
    small, _ = M.moe(p, torch.tensor(x), cfg)
    full, _ = M.moe(p, torch.tensor(x), cfg, full_capacity=True)
    ref_gap = float(jnp.abs(RM.moe(ref_p, jnp.asarray(x), ref_cfg)[0]
                            - RM.moe(ref_p, jnp.asarray(x), ref_cfg, full_capacity=True)[0]).max())
    gap = float((small - full).abs().max())
    assert gap > 1e-4 and abs(gap - ref_gap) <= 1e-5


@pytest.mark.parametrize("name", MOE_NAMES)
@pytest.mark.parametrize("capacity_factor", [1.25, 0.1])
def test_tokens_dropped_fraction_matches_reference(name, capacity_factor):
    cfg = dataclasses.replace(ARCHS[name].reduced(), capacity_factor=capacity_factor)
    ref_cfg = dataclasses.replace(REF_ARCHS[name].reduced(), capacity_factor=capacity_factor)
    logits = np.random.default_rng(9).normal(size=(64, cfg.n_experts)).astype(np.float32)
    logits[3, 1] = logits[3, 2] = logits[3].max() + 1.0  # a tie: the lower index first, as lax.top_k
    got = M.tokens_dropped_fraction(torch.tensor(logits), cfg)
    want = RM.tokens_dropped_fraction(jnp.asarray(logits), ref_cfg)
    assert got.dtype == torch.float32 and float(got) == float(want)
    assert (float(got) > 0) == (capacity_factor < 1)


def test_top_k_breaks_ties_toward_the_lower_index():
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0]])
    vals, idx = M._top_k(x, 3)
    ref_vals, ref_idx = jax.lax.top_k(jnp.asarray(x.numpy()), 3)
    assert idx.tolist() == np.asarray(ref_idx).tolist() == [[1, 2, 4]]
    assert vals.tolist() == np.asarray(ref_vals).tolist()


def test_init_moe_tree_matches_reference():
    ref_cfg, ref_p, cfg, _ = _moe_setup("deepseek-v2-236b")
    mine = M.init_moe(torch.Generator().manual_seed(0), cfg, (3,), device="cpu")
    ref3, _ = RM.init_moe(jax.random.key(4), ref_cfg, (3,))
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape), mine) == \
        jax.tree_util.tree_map(lambda a: tuple(a.shape), ref3)
    assert set(mine["shared"]) == {"w1", "w3", "w2"}


def _mixtral(**replace):
    ref_cfg = dataclasses.replace(REF_ARCHS["mixtral-8x22b"].reduced(), **replace)
    cfg = dataclasses.replace(ARCHS["mixtral-8x22b"].reduced(), **replace)
    ref_params, _ = RT.init_params(ref_cfg, jax.random.key(0))
    return ref_cfg, ref_params, cfg, convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, ref_params),
                                                               cfg, "cpu")


@pytest.mark.parametrize("S0", [3, 9])
def test_mixtral_ring_decode_past_the_window(S0):
    """Window 4 (the reference's test_sliding_window_cache_is_ring_buffer):
    the cache holds 4 slots; a prompt past the window is ring-packed; decode
    from the port's prefill and from the JAX prefill's state follows forward."""
    ref_cfg, ref_params, cfg, params = _mixtral(window=4, capacity_factor=8.0)
    B, S = 1, 12
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    fwd = np.asarray(RT.forward(ref_params, ref_cfg, {"tokens": jnp.asarray(toks)}, remat=False)[0])
    tol = 1e-4 * np.abs(fwd).max()
    _, rstate = RT.prefill(ref_params, ref_cfg, {"tokens": jnp.asarray(toks[:, :S0])}, cache_len=S)
    lg, state = T.prefill(params, cfg, {"tokens": torch.tensor(toks[:, :S0], dtype=torch.long)}, S)
    assert state["layers"]["k"].shape[3] == 4
    np.testing.assert_allclose(state["layers"]["v"].numpy(), np.asarray(rstate["layers"]["v"]), atol=1e-5)
    from_ref = convert.decode_state_from_numpy(jax.tree_util.tree_map(np.asarray, rstate), cfg, "cpu")
    np.testing.assert_allclose(lg[:, 0].numpy(), fwd[:, S0 - 1], atol=tol)
    for t in range(S0, S):
        tok = torch.tensor(toks[:, t:t + 1], dtype=torch.long)
        lg, state = T.decode_step(params, cfg, tok, state)
        lg2, from_ref = T.decode_step(params, cfg, tok, from_ref)
        np.testing.assert_allclose(lg[:, 0].numpy(), fwd[:, t], atol=tol)
        np.testing.assert_allclose(lg2[:, 0].numpy(), fwd[:, t], atol=tol)


@pytest.mark.parametrize("schedule", ["serial", "prefetch"])
def test_mixtral_offloaded_decode_bitwise_equals_resident(schedule):
    """The uniform MoE stack streamed in 2 KV blocks (window 8, so the ring
    wraps): the same tokens, every step's logits and the final caches bitwise."""
    _, _, cfg, params = _mixtral(window=8)
    prompt = torch.tensor(np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 5)), dtype=torch.long)
    res_tok = D.generate(params, cfg, prompt, 7)
    off_tok = D.generate(params, cfg, prompt, 7, D.ServeConfig(kv_offload=True, kv_npart=2), kv_schedule=schedule)
    assert torch.equal(off_tok, res_tok)
    state = T.init_decode_state(cfg, 2, 12, dtype=L.dt(cfg), device="cpu")
    ostate, blocks = {"pos": 0}, D.make_kv_blocks(cfg, 2, 12, 2, dtype=L.dt(cfg), device="cpu")
    assert tuple(blocks[0][0].shape) == (2, 2, cfg.n_kv_heads, 8, cfg.hd)
    for t in range(12):
        lg, state = T.decode_step(params, cfg, res_tok[:, t:t + 1], state)
        olg, ostate, blocks = D.decode_step_offloaded(params, cfg, res_tok[:, t:t + 1], ostate, blocks,
                                                      schedule=schedule)
        assert torch.equal(olg, lg)
    for i, name in enumerate(("k", "v")):
        assert torch.equal(torch.cat([blk[i] for blk in blocks]), state["layers"][name])


@pytest.mark.parametrize("name,change,reason", [("gemma2-2b", {}, "pair stack"), ("deepseek-v2-236b", {}, "MLA"),
                                                ("deepseek-v2-236b", {"first_dense_layers": 0}, "MLA"),
                                                ("mixtral-8x22b", {"first_dense_layers": 1}, "first_dense_layers")])
def test_offload_outside_the_uniform_gqa_stack_raises(name, change, reason):
    """The reference asserts a uniform stack of GQA layers; the port raises,
    naming the reason, before any KV moves (prefill's ``out=`` too), and
    never decodes resident instead."""
    from repro_torch.serving import DecodeEngine

    cfg = dataclasses.replace(ARCHS[name].reduced(), **change)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    scfg = D.ServeConfig(kv_offload=True, kv_npart=2)
    prompt = torch.zeros((1, 4), dtype=torch.long)
    for call in (lambda: D.make_kv_blocks(cfg, 1, 8, 2, device="cpu"),
                 lambda: D.decode_step_offloaded(params, cfg, prompt[:, :1], {"pos": 0}, []),
                 lambda: D.generate(params, cfg, prompt, 2, scfg),
                 lambda: T.prefill(params, cfg, {"tokens": prompt}, 8, out={"k": [], "v": []}),
                 lambda: DecodeEngine(cfg, params, serve=scfg, device="cpu")):
        with pytest.raises(ValueError, match=reason):
            call()
    if not change:  # the CLI exits non-zero, naming the reason
        from repro_torch.launch import serve

        with pytest.raises(SystemExit) as e:
            serve.main(["--engine", "decode", "--arch", name, "--offload-kv", "--device", "cpu"])
        assert "--offload-kv" in str(e.value.code) and reason in str(e.value.code)
