"""The LM serving slice as a whole: qwen3-1.7b and granite-8b, gemma2-2b's
local/global pair stack, mixtral-8x22b's MoE and deepseek-v2-236b's MLA with
its first dense stack (reduced, fp32) in the port against the JAX package,
with the JAX ``init_params`` weights carried across by
``convert.params_from_numpy``.

Tolerances: logits within 5e-5·max|logits| (tests/test_models.py:141, the
reference's prefill→decode bound), the windowed ring buffer within
1e-4·max|logits| (tests/test_models.py:160); the MoE's aux loss within 1e-6
relative (fp32 sums of the same terms in another order); greedy tokens
equal; offloaded decode bitwise equal to resident decode; ``DecodeEngine``
batched ≡ per-request bitwise.  Where decode must reproduce ``forward``, the
MoE runs at capacity factor 8.0, as the reference's own test does
(tests/test_models.py:121-122): its forward routes at the capacity factor,
its prefill dropless.
"""
import dataclasses

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

NAMES = ["qwen3-1.7b", "granite-8b", "gemma2-2b", "mixtral-8x22b", "deepseek-v2-236b"]


def _setup(name, **replace):
    ref_cfg = dataclasses.replace(REF_ARCHS[name].reduced(), **replace)
    cfg = dataclasses.replace(ARCHS[name].reduced(), **replace)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    ref_params, _ = RT.init_params(ref_cfg, jax.random.key(0))
    params = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, ref_params), cfg, "cpu")
    return ref_cfg, ref_params, cfg, params


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)


def _dropless(name):
    return {"capacity_factor": 8.0} if REF_ARCHS[name].n_experts else {}


@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_reference(name):
    ref_cfg, ref_params, cfg, params = _setup(name)
    toks = _tokens(cfg, 2, 16)
    ref, ref_aux = RT.forward(ref_params, ref_cfg, {"tokens": jnp.asarray(toks)}, remat=False)
    out, aux = T.forward(params, cfg, {"tokens": torch.tensor(toks, dtype=torch.long)})
    ref = np.asarray(ref)
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=5e-5 * np.abs(ref).max())
    # the MoE routes at the configs' own capacity factor and drops what the reference drops
    np.testing.assert_allclose(float(aux), float(ref_aux), rtol=1e-6)
    assert (float(aux) > 0) == bool(cfg.n_experts)


@pytest.mark.parametrize("name", NAMES)
def test_prefill_then_decode_matches_reference_and_forward(name):
    """Every stack's caches (``layers``; gemma2's ``local``/``global``; MLA's
    latents beside the first dense stack's) equal the JAX prefill's, and
    decode follows from the port's prefill and from the JAX one's state."""
    ref_cfg, ref_params, cfg, params = _setup(name, **_dropless(name))
    B, S0, NEW = 2, 8, 4
    toks = _tokens(cfg, B, S0 + NEW)
    fwd, _ = RT.forward(ref_params, ref_cfg, {"tokens": jnp.asarray(toks)}, remat=False)
    fwd = np.asarray(fwd)
    scale = np.abs(fwd).max()
    rlg, rstate = RT.prefill(ref_params, ref_cfg, {"tokens": jnp.asarray(toks[:, :S0])}, cache_len=S0 + NEW)
    lg, state = T.prefill(params, cfg, {"tokens": torch.tensor(toks[:, :S0], dtype=torch.long)}, S0 + NEW)
    rnp = jax.tree_util.tree_map(np.asarray, rstate)
    assert state["pos"] == S0 and set(state) == set(rnp)
    for key in set(state) - {"pos"}:
        for leaf, want in rnp[key].items():
            assert tuple(state[key][leaf].shape) == want.shape, (key, leaf)
            np.testing.assert_allclose(state[key][leaf].numpy(), want, atol=1e-5)
    from_ref = convert.decode_state_from_numpy(rnp, cfg, "cpu")
    for t in range(S0, S0 + NEW + 1):
        np.testing.assert_allclose(lg[:, 0].numpy(), np.asarray(rlg[:, 0]), atol=5e-5 * scale)
        np.testing.assert_allclose(lg[:, 0].numpy(), fwd[:, t - 1], atol=5e-5 * scale)
        if t == S0 + NEW:
            break
        tok = torch.tensor(toks[:, t:t + 1], dtype=torch.long)
        rlg, rstate = RT.decode_step(ref_params, ref_cfg, jnp.asarray(toks[:, t:t + 1]), rstate)
        lg, state = T.decode_step(params, cfg, tok, state)
        lg2, from_ref = T.decode_step(params, cfg, tok, from_ref)
        np.testing.assert_allclose(lg2[:, 0].numpy(), fwd[:, t], atol=5e-5 * scale)


@pytest.mark.parametrize("S0", [3, 9])
def test_window_ring_buffer(S0):
    """qwen3 reduced with window 4: the cache stays at the window's size; a
    prompt longer than the window is ring-rolled by prefill (S0 = 9), and
    decode continues from the JAX prefill's own cache too."""
    ref_cfg, ref_params, cfg, params = _setup("qwen3-1.7b", window=4)
    B, S = 1, 12
    toks = _tokens(cfg, B, S)
    fwd, _ = RT.forward(ref_params, ref_cfg, {"tokens": jnp.asarray(toks)}, remat=False)
    fwd = np.asarray(fwd)
    tol = 1e-4 * np.abs(fwd).max()
    rlg, rstate = RT.prefill(ref_params, ref_cfg, {"tokens": jnp.asarray(toks[:, :S0])}, cache_len=S)
    lg, state = T.prefill(params, cfg, {"tokens": torch.tensor(toks[:, :S0], dtype=torch.long)}, S)
    assert state["layers"]["k"].shape[3] == 4  # ring capacity == window
    np.testing.assert_allclose(state["layers"]["v"].numpy(), np.asarray(rstate["layers"]["v"]), atol=1e-5)
    from_ref = convert.decode_state_from_numpy(jax.tree_util.tree_map(np.asarray, rstate), cfg, "cpu")
    np.testing.assert_allclose(lg[:, 0].numpy(), fwd[:, S0 - 1], atol=tol)
    for t in range(S0, S):
        tok = torch.tensor(toks[:, t:t + 1], dtype=torch.long)
        lg, state = T.decode_step(params, cfg, tok, state)
        lg2, from_ref = T.decode_step(params, cfg, tok, from_ref)
        np.testing.assert_allclose(lg[:, 0].numpy(), fwd[:, t], atol=tol)
        np.testing.assert_allclose(lg2[:, 0].numpy(), fwd[:, t], atol=tol)


@pytest.mark.parametrize("name", NAMES)
def test_greedy_generate_matches_reference(name):
    ref_cfg, ref_params, cfg, params = _setup(name)
    # deepseek-v2 generates one sequence: the reference prefills by decode, whose
    # MLA MoE routes at the capacity factor, and one token at a time never
    # overflows (its top-k experts are distinct); the port's one-pass prefill is
    # dropless.  At B 2 the reference's prefill may drop a token that the port's
    # keeps (test_torch_mla.py shows the reference's capacity-limited decode).
    B = 1 if cfg.attn_type == "mla" else 2
    prompt = _tokens(cfg, B, 5, seed=4)
    ref = np.asarray(RD.greedy_generate(ref_params, ref_cfg, jnp.asarray(prompt), 6))
    out = D.greedy_generate(params, cfg, torch.tensor(prompt, dtype=torch.long), 6)
    assert out.shape == (B, 11)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("name", ["gemma2-2b", "mixtral-8x22b"])
def test_decode_engine_batched_equals_per_request(name):
    """A prompt served alone (padded to the bucket) gives its batched row
    bitwise; the tokens and the signature are the JAX engine's."""
    from repro.serving.engine import DecodeEngine as RefEngine

    ref_cfg, ref_params, cfg, params = _setup(name)
    prompts = _tokens(cfg, 3, 8, seed=7)
    eng = DecodeEngine(cfg, params, n_new=5, prompt_len=8, buckets=(4,), device="cpu")
    batched = eng.infer(prompts).y
    assert batched.shape == (3, 5)
    for i in range(3):
        np.testing.assert_array_equal(eng.infer(prompts[i:i + 1]).y[0], batched[i])
    ref = RefEngine(ref_cfg, ref_params, n_new=5, prompt_len=8, buckets=(4,))
    np.testing.assert_array_equal(ref.infer(prompts).y, batched)
    assert eng.signature() == ref.signature()


@pytest.mark.parametrize("name", ["gemma2-2b", "mixtral-8x22b", "deepseek-v2-236b"])
def test_convert_refuses_a_foreign_layout(name):
    _, ref_params, cfg, _ = _setup(name)
    tree = jax.tree_util.tree_map(np.asarray, ref_params)
    with pytest.raises(ValueError, match="layer stacks"):
        convert.params_from_numpy(tree, dataclasses.replace(cfg, n_layers=cfg.n_layers + 2), "cpu")
    with pytest.raises(ValueError, match="keys"):
        convert.params_from_numpy({k: v for k, v in tree.items() if k != "final_norm"}, cfg, "cpu")
    foreign = REF_ARCHS["qwen3-1.7b" if name == "gemma2-2b" else "gemma2-2b"].reduced()
    state = jax.tree_util.tree_map(np.asarray, RT.init_decode_state(foreign, 1, 4))
    with pytest.raises(ValueError, match="decode state"):
        convert.decode_state_from_numpy(state, cfg, "cpu")


@pytest.mark.parametrize("schedule", ["serial", "prefetch"])
def test_offloaded_generate_bitwise_equals_resident(schedule):
    _, _, cfg, params = _setup("qwen3-1.7b")
    prompt = torch.tensor(_tokens(cfg, 2, 5, seed=5), dtype=torch.long)
    res_tok = D.generate(params, cfg, prompt, 6)
    off_tok = D.generate(params, cfg, prompt, 6, D.ServeConfig(kv_offload=True, kv_npart=2), kv_schedule=schedule)
    assert torch.equal(off_tok, res_tok)
    # the same tokens stepped through both decode steps: every step's logits
    # and the final caches bitwise equal
    state = T.init_decode_state(cfg, 2, 11, dtype=L.dt(cfg), device="cpu")
    ostate, blocks = {"pos": 0}, D.make_kv_blocks(cfg, 2, 11, 2, dtype=L.dt(cfg), device="cpu")
    assert len(blocks) == 2 and tuple(blocks[0][0].shape) == (2, 2, cfg.n_kv_heads, 11, cfg.hd)
    for t in range(10):
        lg, state = T.decode_step(params, cfg, res_tok[:, t:t + 1], state)
        olg, ostate, blocks = D.decode_step_offloaded(params, cfg, res_tok[:, t:t + 1], ostate, blocks,
                                                      schedule=schedule)
        assert torch.equal(olg, lg)
    for i, name in enumerate(("k", "v")):
        assert torch.equal(torch.cat([blk[i] for blk in blocks]), state["layers"][name])


def test_sampling_is_seeded_and_greedy_is_exact():
    _, _, cfg, params = _setup("qwen3-1.7b")
    prompt = torch.tensor(_tokens(cfg, 2, 4, seed=6), dtype=torch.long)
    hot = D.ServeConfig(temperature=0.8, seed=3)
    a, b = D.generate(params, cfg, prompt, 5, hot), D.generate(params, cfg, prompt, 5, hot)
    assert torch.equal(a, b)
    assert torch.equal(D.generate(params, cfg, prompt, 5), D.greedy_generate(params, cfg, prompt, 5, hot))
    with pytest.raises(ValueError, match="temperature"):
        D.ServeConfig(temperature=-1.0)


@pytest.mark.parametrize("name", ["mamba2-780m", "zamba2-7b", "whisper-small", "internvl2-1b"])
def test_families_not_ported_raise(name):
    cfg = ARCHS[name].reduced()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.init_decode_state(cfg, 1, 8, device="cpu")


def test_configs_are_the_reference_configs():
    assert sorted(ARCHS) == sorted(REF_ARCHS)
    for name, cfg in ARCHS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(REF_ARCHS[name])
        if cfg.n_heads:
            assert cfg.hd == REF_ARCHS[name].hd
        assert dataclasses.asdict(cfg.reduced()) == dataclasses.asdict(REF_ARCHS[name].reduced())


def test_init_params_tree_matches_reference():
    for name in NAMES:
        ref_cfg, ref_params, cfg, _ = _setup(name)
        mine = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        ref_shapes = jax.tree_util.tree_map(lambda a: (tuple(a.shape), str(a.dtype)), ref_params)
        my_shapes = jax.tree_util.tree_map(lambda a: (tuple(a.shape), str(a.dtype).split(".")[1]), mine)
        assert my_shapes == ref_shapes, name
        attn = mine["layers"]["attn"]
        std = float(attn["wq" if "wq" in attn else "wq_b"].std())
        assert 0.018 < std < 0.022


def test_layers_match_reference():
    """Each layer function against its JAX counterpart on the same numpy
    inputs, fp32, atol 1e-5 (the gelu MLP and layernorm included, which no
    ported family reaches yet)."""
    from repro.models import layers as RL
    from repro_torch.models import layers as PL

    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    scale = rng.normal(size=(64,)).astype(np.float32)
    bias = rng.normal(size=(64,)).astype(np.float32)
    t = torch.tensor

    def close(a, b):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)

    close(PL.rmsnorm(t(x), t(scale)), RL.rmsnorm(jnp.asarray(x), jnp.asarray(scale)))
    close(PL.layernorm(t(x), {"scale": t(scale), "bias": t(bias)}),
          RL.layernorm(jnp.asarray(x), {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}))
    h = rng.normal(size=(2, 3, 7, 16)).astype(np.float32)
    close(PL.rope(t(h), torch.arange(7) + 100, 1e6), RL.rope(jnp.asarray(h), jnp.arange(7) + 100, 1e6))
    q = rng.normal(size=(2, 4, 1, 16)).astype(np.float32)
    kc, vc = (rng.normal(size=(2, 2, 9, 16)).astype(np.float32) for _ in range(2))
    mask = np.arange(9)[None].repeat(2, 0) <= 5
    close(PL.decode_attention(t(q), t(kc), t(vc), t(mask), softcap=20.0),
          RL.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(mask), softcap=20.0))
    for act in ("silu", "gelu"):
        rcfg = dataclasses.replace(REF_ARCHS["qwen3-1.7b"].reduced(), act=act)
        cfg = dataclasses.replace(ARCHS["qwen3-1.7b"].reduced(), act=act)
        rp, _ = RL.init_mlp(jax.random.key(3), rcfg)
        p = convert._tree(jax.tree_util.tree_map(np.asarray, rp), "cpu")
        assert set(p) == set(PL.init_mlp(torch.Generator().manual_seed(0), cfg, device="cpu"))
        close(PL.mlp(p, t(x), cfg), RL.mlp(rp, jnp.asarray(x), rcfg))
