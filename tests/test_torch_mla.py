"""DeepSeek-V2's MLA attention (``layers.init_mla``/``mla_attention``) and
deepseek-v2's capacity-limited decode in the port against the JAX package,
on the same numpy inputs (reduced config, fp32).

Tolerances: the layer within 1e-5 (the reference's layer tolerance, as in
test_torch_lm.py::test_layers_match_reference); logits within
5e-5·max|logits| (tests/test_models.py:141).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.models import layers as RL
from repro.models import transformer as RT
from repro_torch import convert
from repro_torch.configs import ARCHS
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

NAME = "deepseek-v2-236b"


def _mla_setup():
    ref_cfg, cfg = REF_ARCHS[NAME].reduced(), ARCHS[NAME].reduced()
    ref_p, _ = RL.init_mla(jax.random.key(3), ref_cfg)
    return ref_cfg, ref_p, cfg, convert._tree(jax.tree_util.tree_map(np.asarray, ref_p), "cpu")


def _close(a, b, atol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol)


def test_init_mla_tree_matches_reference():
    ref_cfg, ref_p, cfg, _ = _mla_setup()
    mine = L.init_mla(torch.Generator().manual_seed(0), cfg, (2,), device="cpu")
    ref2, _ = RL.init_mla(jax.random.key(3), ref_cfg, (2,))
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape), mine) == \
        jax.tree_util.tree_map(lambda a: tuple(a.shape), ref2)


def test_mla_prefill_matches_reference():
    """Prefill: the output (the flash kernel's plain version at dh = nq + nr,
    dv, scale (nq + nr)^-½) and the latents it hands the cache."""
    ref_cfg, ref_p, cfg, p = _mla_setup()
    x = np.random.default_rng(1).normal(size=(2, 9, cfg.d_model)).astype(np.float32)
    ref_out, (ref_ckv, ref_kr) = RL.mla_attention(ref_p, jnp.asarray(x), ref_cfg, positions=jnp.arange(9),
                                                  return_kv=True)
    out, (ckv, kr) = L.mla_attention(p, torch.tensor(x), cfg, positions=torch.arange(9), return_kv=True)
    assert tuple(ckv.shape) == (2, 9, cfg.kv_lora_rank) and tuple(kr.shape) == (2, 9, cfg.qk_rope_dim)
    _close(out, ref_out)
    _close(ckv, ref_ckv)
    _close(kr, ref_kr)
    out2, none = L.mla_attention(p, torch.tensor(x), cfg, positions=torch.arange(9))
    assert none is None and torch.equal(out2, out)


def test_mla_absorbed_decode_matches_reference():
    """Decode in the latent space over a half-filled cache, three steps: the
    output and the cache the step writes in place."""
    ref_cfg, ref_p, cfg, p = _mla_setup()
    rng = np.random.default_rng(2)
    B, C, pos = 2, 8, 3
    ckv = rng.normal(size=(B, C, cfg.kv_lora_rank)).astype(np.float32)
    kr = rng.normal(size=(B, C, cfg.qk_rope_dim)).astype(np.float32)
    ckv[:, pos:] = kr[:, pos:] = 0.0
    ref_cache = {"c_kv": jnp.asarray(ckv), "k_rope": jnp.asarray(kr), "pos": jnp.asarray(pos)}
    cache = {"c_kv": torch.tensor(ckv), "k_rope": torch.tensor(kr), "pos": pos}
    for step in range(3):
        x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
        ref_out, ref_cache = RL.mla_attention(ref_p, jnp.asarray(x), ref_cfg, positions=jnp.asarray([pos + step]),
                                              cache=ref_cache)
        out, cache = L.mla_attention(p, torch.tensor(x), cfg, positions=torch.tensor([pos + step]), cache=cache)
        _close(out, ref_out)
        _close(cache["c_kv"], ref_cache["c_kv"])
        _close(cache["k_rope"], ref_cache["k_rope"])
        assert cache["pos"] == pos + step + 1


def test_mla_decode_outside_its_cache_raises():
    """The latent cache is no ring (the reference's dynamic_update_slice
    clamps the slot silently): a position past it raises."""
    _, _, cfg, p = _mla_setup()
    cache = {"c_kv": torch.zeros(1, 4, cfg.kv_lora_rank), "k_rope": torch.zeros(1, 4, cfg.qk_rope_dim), "pos": 4}
    with pytest.raises(ValueError, match="no ring"):
        L.mla_attention(p, torch.zeros(1, 1, cfg.d_model), cfg, positions=torch.tensor([4]), cache=cache)


def _deepseek():
    ref_cfg, cfg = REF_ARCHS[NAME].reduced(), ARCHS[NAME].reduced()
    assert cfg.capacity_factor == 1.25 and cfg.first_dense_layers == 1
    ref_params, _ = RT.init_params(ref_cfg, jax.random.key(0))
    return ref_cfg, ref_params, cfg, convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, ref_params),
                                                               cfg, "cpu")


def test_capacity_limited_mla_decode_matches_reference():
    """deepseek-v2's decode routes at the capacity factor (the reference's
    ``_scan_mla`` passes no ``full_capacity``): at B 8 and capacity factor
    1.25, C is 5 of 16 picks over 4 experts, so a batch drops entries that
    one sequence alone keeps.  The port follows the reference, batched and
    alone, and so does the difference: in both packages a batched row is not
    the row decoded alone, and the first row always is (it comes first in
    each of its experts' queues)."""
    ref_cfg, ref_params, cfg, params = _deepseek()
    B, S0, NEW = 8, 6, 3
    toks = np.random.default_rng(11).integers(0, cfg.vocab_size, size=(B, S0 + NEW)).astype(np.int32)

    ref_prefill = jax.jit(lambda p, t: RT.prefill(p, ref_cfg, {"tokens": t}, cache_len=S0 + NEW))
    ref_decode = jax.jit(lambda p, t, s: RT.decode_step(p, ref_cfg, t, s))

    def run(rows):
        t = toks[rows]
        rlg, rst = ref_prefill(ref_params, jnp.asarray(t[:, :S0]))
        lg, st = T.prefill(params, cfg, {"tokens": torch.tensor(t[:, :S0], dtype=torch.long)}, S0 + NEW)
        ref, mine = [], []
        for i in range(S0, S0 + NEW):
            rlg, rst = ref_decode(ref_params, jnp.asarray(t[:, i:i + 1]), rst)
            lg, st = T.decode_step(params, cfg, torch.tensor(t[:, i:i + 1], dtype=torch.long), st)
            ref.append(np.asarray(rlg[:, 0]))
            mine.append(lg[:, 0].numpy())
        return np.stack(ref, 1), np.stack(mine, 1)

    ref_b, mine_b = run(slice(None))
    tol = 5e-5 * np.abs(ref_b).max()
    np.testing.assert_allclose(mine_b, ref_b, atol=tol)
    gaps_ref, gaps_mine = [], []
    for r in range(B):
        ref_1, mine_1 = run([r])
        np.testing.assert_allclose(mine_1, ref_1, atol=tol)
        gaps_ref.append(float(np.abs(ref_b[r] - ref_1[0]).max()))
        gaps_mine.append(float(np.abs(mine_b[r] - mine_1[0]).max()))
    assert gaps_ref[0] <= tol and gaps_mine[0] <= tol
    assert max(gaps_ref) > 100 * tol and max(gaps_mine) > 100 * tol, (gaps_ref, gaps_mine)
    assert [g > 100 * tol for g in gaps_mine] == [g > 100 * tol for g in gaps_ref]


def test_deepseek_state_layout():
    """Prefill's state keeps the dense stack's and the MoE stack's latents
    apart, in the activation dtype, and ``init_decode_state`` has its layout."""
    _, _, cfg, params = _deepseek()
    toks = torch.zeros((1, 5), dtype=torch.long)
    _, st = T.prefill(params, cfg, {"tokens": toks}, cache_len=7)
    empty = T.init_decode_state(cfg, 1, 7, dtype=torch.float32, device="cpu")
    for key in ("dense_layers", "layers"):
        for leaf in ("c_kv", "k_rope"):
            assert st[key][leaf].shape == empty[key][leaf].shape and st[key][leaf].dtype == torch.float32
    assert st["dense_layers"]["c_kv"].shape == (1, 1, 7, cfg.kv_lora_rank)
    assert st["layers"]["k_rope"].shape == (cfg.n_layers - 1, 1, 7, cfg.qk_rope_dim)
    assert float(st["layers"]["c_kv"][:, :, 5:].abs().max()) == 0.0
