"""The four families that came last to the port: mamba2-780m (SSM),
zamba2-7b (Mamba groups with one shared attention block; reduced: 5 layers
at ``attn_every`` 2, so two groups and a remainder), whisper-small
(encoder-decoder) and internvl2-1b (VLM), reduced, fp32, in the port
against the JAX package, with the JAX ``init_params`` weights carried
across by ``convert.params_from_numpy``.

Tolerances are the reference's: logits within 5e-5·max|logits|
(tests/test_models.py:141), the Mamba states within 2e-5
(tests/test_models.py:201-248); greedy tokens equal where the reference's
``generate`` runs (not whisper: it needs frames, and the reference's
``generate`` fails on it); internvl2's offloaded KV bitwise its resident
run.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.models import transformer as RT
from repro.serving import decode as RD
from repro_torch import convert
from repro_torch.configs import ARCHS
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serving import DecodeEngine
from repro_torch.serving import decode as D

NAMES = ["mamba2-780m", "zamba2-7b", "whisper-small", "internvl2-1b"]
FRONT = 6  # whisper's frames, internvl2's patches


@functools.lru_cache(maxsize=None)  # the reference's init compiles per shape: once a family
def _setup(name):
    ref_cfg, cfg = REF_ARCHS[name].reduced(), ARCHS[name].reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    ref_params, _ = RT.init_params(ref_cfg, jax.random.key(0))
    params = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, ref_params), cfg, "cpu")
    return ref_cfg, ref_params, cfg, params


def _batches(cfg, toks, seed=2):
    """The same batch for both packages: tokens, and whisper's frames or
    internvl2's patches ``[B, 6, d_model]`` (the stub frontends' output)."""
    ref, mine = {"tokens": jnp.asarray(toks)}, {"tokens": torch.tensor(toks, dtype=torch.long)}
    key = {"encdec": "frames", "vlm": "patches"}.get(cfg.family)
    if key:
        x = np.random.default_rng(seed).normal(size=(toks.shape[0], FRONT, cfg.d_model)).astype(np.float32)
        ref[key], mine[key] = jnp.asarray(x), torch.tensor(x)
    return ref, mine


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)


@pytest.mark.parametrize("name", NAMES)
def test_forward_prefill_decode_match_reference(name):
    """``forward``; ``prefill`` (logits, and every cache of the state: the
    Mamba states, zamba2's shared-attention rows, whisper's ``enc_kv``); then
    decode from the port's prefill and from the JAX one's state, against the
    JAX decode and against ``forward``."""
    ref_cfg, ref_params, cfg, params = _setup(name)
    B, S0, NEW = 2, 8, 4
    toks = _tokens(cfg, B, S0 + NEW)
    rb, pb = _batches(cfg, toks)
    P = FRONT if cfg.family == "vlm" else 0  # positions before the tokens
    ref_fwd = np.asarray(jax.jit(lambda b: RT.forward(ref_params, ref_cfg, b, remat=False)[0])(rb))
    fwd, aux = T.forward(params, cfg, pb)
    scale = np.abs(ref_fwd).max()
    assert fwd.shape == ref_fwd.shape == (B, P + S0 + NEW, cfg.vocab_size) and float(aux) == 0.0
    np.testing.assert_allclose(fwd.numpy(), ref_fwd, atol=5e-5 * scale)

    rb0 = dict(rb, tokens=rb["tokens"][:, :S0])
    rlg, rstate = jax.jit(lambda b: RT.prefill(ref_params, ref_cfg, b, cache_len=P + S0 + NEW))(rb0)
    lg, state = T.prefill(params, cfg, dict(pb, tokens=pb["tokens"][:, :S0]), P + S0 + NEW)
    rnp = jax.tree_util.tree_map(np.asarray, rstate)
    assert state["pos"] == int(rnp["pos"]) == P + S0 and set(state) == set(rnp)
    for key in set(state) - {"pos"}:
        for leaf, want in rnp[key].items():
            got = state[key][leaf]
            assert tuple(got.shape) == want.shape and got.dtype == L.dt(cfg), (key, leaf)
            np.testing.assert_allclose(got.numpy(), want, atol=2e-5, err_msg=f"{key}/{leaf}")
    from_ref = convert.decode_state_from_numpy(rnp, cfg, "cpu")
    ref_step = jax.jit(lambda t, s: RT.decode_step(ref_params, ref_cfg, t, s))
    for t in range(S0, S0 + NEW + 1):
        np.testing.assert_allclose(lg[:, 0].numpy(), np.asarray(rlg[:, 0]), atol=5e-5 * scale)
        np.testing.assert_allclose(lg[:, 0].numpy(), ref_fwd[:, P + t - 1], atol=5e-5 * scale)
        if t == S0 + NEW:
            break
        tok = torch.tensor(toks[:, t:t + 1], dtype=torch.long)
        rlg, rstate = ref_step(jnp.asarray(toks[:, t:t + 1]), rstate)
        lg, state = T.decode_step(params, cfg, tok, state)
        lg2, from_ref = T.decode_step(params, cfg, tok, from_ref)
        np.testing.assert_allclose(lg2[:, 0].numpy(), ref_fwd[:, P + t], atol=5e-5 * scale)
    rnp = jax.tree_util.tree_map(np.asarray, rstate)
    for key in set(state) - {"pos"}:
        for leaf, want in rnp[key].items():
            np.testing.assert_allclose(state[key][leaf].numpy(), want, atol=2e-5, err_msg=f"{key}/{leaf}")


@pytest.mark.parametrize("name", ["mamba2-780m", "zamba2-7b", "internvl2-1b"])
def test_greedy_generate_and_engine_match_reference(name):
    """The reference prefills by decode, the port in one pass: the greedy
    tokens are equal all the same, and ``DecodeEngine`` serves them."""
    ref_cfg, ref_params, cfg, params = _setup(name)
    prompt = _tokens(cfg, 2, 5, seed=4)
    ref = np.asarray(RD.greedy_generate(ref_params, ref_cfg, jnp.asarray(prompt), 6))
    out = D.greedy_generate(params, cfg, torch.tensor(prompt, dtype=torch.long), 6)
    np.testing.assert_array_equal(out.numpy(), ref)
    eng = DecodeEngine(cfg, params, n_new=6, prompt_len=5, buckets=(2,), device="cpu")
    np.testing.assert_array_equal(eng.infer(prompt).y, ref[:, 5:])


def test_internvl2_offloaded_kv_is_bitwise_resident():
    """Text-only internvl2 through ``generate`` with its KV in 2 host blocks
    gives the resident tokens; stepped through both decode steps, every
    step's logits and the final caches are bitwise equal."""
    _, _, cfg, params = _setup("internvl2-1b")
    prompt = torch.tensor(_tokens(cfg, 2, 5, seed=5), dtype=torch.long)
    res = D.generate(params, cfg, prompt, 5)
    off = D.generate(params, cfg, prompt, 5, D.ServeConfig(kv_offload=True, kv_npart=2), kv_schedule="prefetch")
    assert torch.equal(off, res)
    state = T.init_decode_state(cfg, 2, 10, dtype=L.dt(cfg), device="cpu")
    ostate, blocks = {"pos": 0}, D.make_kv_blocks(cfg, 2, 10, 2, dtype=L.dt(cfg), device="cpu")
    for t in range(9):
        lg, state = T.decode_step(params, cfg, res[:, t:t + 1], state)
        olg, ostate, blocks = D.decode_step_offloaded(params, cfg, res[:, t:t + 1], ostate, blocks)
        assert torch.equal(olg, lg)
    for i, n in enumerate(("k", "v")):
        assert torch.equal(torch.cat([blk[i] for blk in blocks]), state["layers"][n])


@pytest.mark.parametrize("name", ["mamba2-780m", "zamba2-7b", "whisper-small"])
def test_offloaded_kv_refuses_the_other_families(name):
    cfg = ARCHS[name].reduced()
    with pytest.raises(ValueError, match="offloaded KV takes a uniform stack"):
        D.make_kv_blocks(cfg, 1, 8, 2, device="cpu")


@pytest.mark.parametrize("name", ["mamba2-780m", "zamba2-7b"])
def test_prompt_shorter_than_the_conv_state_is_refused(name):
    """The reference's prefill leaves ``conv: None`` for a prompt shorter
    than d_conv − 1 tokens, and its next decode step fails; the port refuses
    it in prefill, naming the conv state, and so does ``generate``."""
    cfg = ARCHS[name].reduced()
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    short = torch.zeros((1, cfg.d_conv - 2), dtype=torch.long)
    with pytest.raises(ValueError, match="conv state"):
        T.prefill(params, cfg, {"tokens": short}, 8)
    with pytest.raises(ValueError, match="conv state"):
        D.generate(params, cfg, short, 2)
    lg, state = T.prefill(params, cfg, {"tokens": torch.zeros((1, cfg.d_conv - 1), dtype=torch.long)}, 8)
    assert state["pos"] == cfg.d_conv - 1 and bool(torch.isfinite(lg).all())


def test_whisper_is_served_by_prefill_then_decode_step():
    """whisper needs frames beside its tokens: ``generate`` and
    ``DecodeEngine`` refuse it (the reference's ``generate`` decodes from an
    empty cross cache and fails), as do ``forward``/``prefill`` without
    frames and a decode state that holds none; ``prefill({"tokens",
    "frames"})`` then ``decode_step`` serves it."""
    _, _, cfg, params = _setup("whisper-small")
    prompt = torch.tensor(_tokens(cfg, 2, 4, seed=6), dtype=torch.long)
    for call in (lambda: D.generate(params, cfg, prompt, 2), lambda: DecodeEngine(cfg, params, device="cpu")):
        with pytest.raises(ValueError, match="frames"):
            call()
    for call in (lambda: T.forward(params, cfg, {"tokens": prompt}),
                 lambda: T.prefill(params, cfg, {"tokens": prompt}, 8),
                 lambda: T.decode_step(params, cfg, prompt[:, :1], T.init_decode_state(cfg, 2, 8, device="cpu"))):
        with pytest.raises(ValueError, match="frames"):
            call()
    _, batch = _batches(cfg, prompt.numpy())
    lg, state = T.prefill(params, cfg, batch, 8)
    assert tuple(state["enc_kv"]["k"].shape) == (cfg.n_layers, 2, cfg.n_kv_heads, FRONT, cfg.hd)
    for _ in range(3):
        lg, state = T.decode_step(params, cfg, lg[:, -1].argmax(-1, keepdim=True), state)
    assert state["pos"] == 7 and bool(torch.isfinite(lg).all())
