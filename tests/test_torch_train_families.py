"""The trainable attention and every ported family's gradients against the
JAX package.

``FlashAttentionFn`` (the flash forward, a blocked recompute backward)
against ``jax.grad`` of ``layers.flash_attention_jnp`` over GQA, a window,
a softcap, dh ≠ dv, non-causal, Sq ≠ Skv and ragged query and key blocks
(past 512 and 1,024, with key blocks that the causal mask or the window
hides from a whole query block): the output within 1e-5·max|o|, each of
dq, dk, dv within 1e-4·max|g|; in bf16 on bf16 inputs, the output within
2^-8·max|o| and the gradients within 1e-2·max|g|, and no farther from the
fp32 gradients than the reference's bf16 ones, times 1.25.  Then the training loss (NLL + z-loss + the
MoE's aux term, ``remat=True``) and its gradient per parameter leaf of
each family other than qwen3 (``test_torch_training.py``) at its reduced
config, fp32, on one batch of ``data.batches`` with its frontend input:
the loss within 1e-5 relative, each leaf within 1e-4·max|g|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.models import layers as RL
from repro.models import transformer as RT
from repro.training import data as RD
from repro.training import train_step as RTS
from repro_torch import convert
from repro_torch.configs import ARCHS
from repro_torch.models import transformer as T
from repro_torch.models.layers import FlashAttentionFn
from repro_torch.training import data as D
from repro_torch.training import train_step as TS
from repro_torch.utils.tree import leaves_with_paths

# (B, Hq, Hkv, Sq, Skv, dh, dv, causal, window, softcap, scale, q scale)
CASES = {
    "gqa": (2, 4, 2, 40, 40, 16, 16, True, None, None, None, 1.0),
    "window": (1, 2, 2, 48, 48, 16, 16, True, 8, None, None, 1.0),
    "softcap": (1, 2, 1, 32, 32, 16, 16, True, None, 2.0, None, 3.0),
    "dh_ne_dv": (1, 4, 2, 30, 30, 24, 12, True, None, None, 0.3, 1.0),
    "noncausal_sq_lt_skv": (1, 2, 2, 20, 50, 16, 16, False, None, None, None, 1.0),
    "noncausal_sq_gt_skv": (1, 2, 1, 50, 20, 16, 16, False, None, None, None, 1.0),
    "causal_sq_lt_skv": (1, 2, 1, 20, 50, 16, 16, True, None, None, None, 1.0),
    "ragged_blocks": (1, 2, 1, 700, 1300, 16, 16, True, None, None, None, 1.0),
    "causal_skip": (1, 2, 1, 1300, 1300, 16, 16, True, None, None, None, 1.0),
    "window_skip": (1, 2, 1, 2100, 2100, 8, 8, True, 100, 20.0, None, 1.0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_flash_attention_fn_grads_match_jax(case):
    B, Hq, Hkv, Sq, Skv, dh, dv, causal, window, softcap, scale, qs = CASES[case]
    rng = np.random.default_rng(0)
    q = (rng.standard_normal((B, Hq, Sq, dh)) * qs).astype(np.float32)
    k = rng.standard_normal((B, Hkv, Skv, dh)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, Skv, dv)).astype(np.float32)
    do = rng.standard_normal((B, Hq, Sq, dv)).astype(np.float32)
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)

    def f(q_, k_, v_):
        return RL.flash_attention_jnp(q_, k_, v_, **kw)

    ref, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref_grads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = FlashAttentionFn.apply(tq, tk, tv, causal, window, softcap, scale)
    out.backward(torch.tensor(do))
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-5 * np.abs(ref).max())
    for name, got, want in zip("qkv", (tq.grad, tk.grad, tv.grad), ref_grads):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4 * np.abs(want).max(), err_msg=f"d{name}")


@pytest.mark.parametrize("case", list(CASES))
def test_flash_attention_fn_bf16_grads_match_jax(case):
    """The bf16 path that trains on the card (``p`` rounded to bf16 before
    P·V, dq, dk, dv cast back to bf16) on bf16 inputs against
    ``jax.vjp(flash_attention_jnp)`` on the same: the output within
    2^-8·max|o|, each gradient within 1e-2·max|g| (the largest reading over
    these cases is 6.4e-3, where the reference sums its bf16 cotangents
    over blocks in bf16 and the port in fp32).  And the port's gradients
    are no farther from the fp32 gradients on the same bf16-valued inputs
    (the port's, held to the reference's in fp32 above) than the
    reference's are, times 1.25 (readings: the port's distance is
    at most the reference's, 2e-3 to 6e-3 of max|g|)."""
    B, Hq, Hkv, Sq, Skv, dh, dv, causal, window, softcap, scale, qs = CASES[case]
    rng = np.random.default_rng(0)
    bf = lambda x: np.asarray(jnp.asarray(x, dtype=jnp.bfloat16).astype(jnp.float32))  # noqa: E731
    q = bf(rng.standard_normal((B, Hq, Sq, dh)) * qs)
    k = bf(rng.standard_normal((B, Hkv, Skv, dh)))
    v = bf(rng.standard_normal((B, Hkv, Skv, dv)))
    do = bf(rng.standard_normal((B, Hq, Sq, dv)))
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)

    def f(q_, k_, v_):
        return RL.flash_attention_jnp(q_, k_, v_, **kw)

    ref, vjp = jax.vjp(f, *(jnp.asarray(x, dtype=jnp.bfloat16) for x in (q, k, v)))
    ref_grads = [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(do, dtype=jnp.bfloat16))]
    t32 = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]  # held to JAX in fp32 above
    FlashAttentionFn.apply(*t32, causal, window, softcap, scale).backward(torch.tensor(do))
    grads32 = [x.grad.numpy() for x in t32]
    tq, tk, tv = (torch.tensor(x).bfloat16().requires_grad_() for x in (q, k, v))
    out = FlashAttentionFn.apply(tq, tk, tv, causal, window, softcap, scale)
    out.backward(torch.tensor(do).bfloat16())
    ref = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(out.detach().float().numpy(), ref, atol=2**-8 * np.abs(ref).max())
    for name, got, want, want32 in zip("qkv", (tq.grad, tk.grad, tv.grad), ref_grads, grads32):
        assert got.dtype == torch.bfloat16
        got = got.float().numpy()
        np.testing.assert_allclose(got, want, atol=1e-2 * np.abs(want).max(), err_msg=f"d{name}")
        port32, ref32 = np.abs(got - want32).max(), np.abs(want - want32).max()
        assert port32 <= 1.25 * ref32, f"d{name}: {port32} from fp32, the reference's bf16 {ref32}"


FAMILIES = ["granite-8b", "gemma2-2b", "mixtral-8x22b", "deepseek-v2-236b", "mamba2-780m", "zamba2-7b",
            "whisper-small", "internvl2-1b"]


def reference_loss_and_grads(name, B=2, S=16):
    """(port cfg, port params, batch as numpy, JAX loss, JAX grads as numpy)
    for the reduced ``name`` on one ``data.batches`` batch."""
    ref_cfg, cfg = REF_ARCHS[name].reduced(), ARCHS[name].reduced()
    ref_params, _ = RT.init_params(ref_cfg, jax.random.key(0))
    params = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, ref_params), cfg, "cpu")
    dcfg = RD.DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B, frontend=cfg.frontend,
                         d_model=cfg.d_model, n_frontend_tokens=cfg.n_frontend_tokens)
    batch = next(RD.batches(dcfg))
    loss_grad = jax.jit(jax.value_and_grad(RTS.make_loss_fn(ref_cfg, RTS.TrainConfig()), has_aux=True))
    (loss, _), grads = loss_grad(ref_params, {k: jnp.asarray(v) for k, v in batch.items()})
    return cfg, params, batch, float(loss), jax.tree_util.tree_map(np.asarray, grads)


def assert_grads_close(grads, ref_grads, cfg):
    """Per leaf within 1e-4·max|g|; the JAX tree carried across by
    ``convert.params_from_numpy`` (gradients are parameter-shaped)."""
    want = convert.params_from_numpy(ref_grads, cfg, "cpu")
    got_leaves, want_leaves = leaves_with_paths(grads), leaves_with_paths(want)
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (path, g), (_, w) in zip(got_leaves, want_leaves):
        w = w.numpy()
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4 * np.abs(w).max(), err_msg=path)


@pytest.mark.parametrize("name", FAMILIES)
def test_family_loss_and_grads_match_reference(name):
    cfg, params, batch, ref_loss, ref_grads = reference_loss_and_grads(name)
    torch_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    metrics, grads = TS.value_and_grad(TS.make_loss_fn(cfg, TS.TrainConfig()), params, torch_batch)
    np.testing.assert_allclose(float(metrics["loss"]), ref_loss, rtol=1e-5)
    assert_grads_close(grads, ref_grads, cfg)
    assert (float(metrics["aux"]) > 0) == bool(cfg.n_experts)


def test_remat_off_gives_the_same_gradients():
    """``remat=False`` keeps every activation instead of recomputing it: the
    same loss and gradients, bitwise (the same operations in the same
    order)."""
    cfg = ARCHS["whisper-small"].reduced()
    params = convert.params_from_numpy(jax.tree_util.tree_map(
        np.asarray, RT.init_params(REF_ARCHS["whisper-small"].reduced(), jax.random.key(0))[0]), cfg, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in next(D.batches(D.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=12, global_batch=2, frontend=cfg.frontend, d_model=cfg.d_model,
        n_frontend_tokens=cfg.n_frontend_tokens))).items()}
    runs = []
    for remat in (True, False):
        def loss_fn(p, b):
            logits, _ = T.forward(p, cfg, b, remat=remat)
            nll, _ = TS.cross_entropy(logits, b["labels"])
            return nll, {}
        runs.append(TS.value_and_grad(loss_fn, params, batch)[1])
    for (path, a), (_, b) in zip(leaves_with_paths(runs[0]), leaves_with_paths(runs[1])):
        assert torch.equal(a, b), path
