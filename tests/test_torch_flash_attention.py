"""The port's flash attention on CPU tensors (its plain version, the blocked
online softmax) against the JAX package's Pallas kernel in interpret mode
(as tests/test_kernels.py runs it) and its naive-softmax oracle
``attention_ref``, on the same numpy inputs.

Tolerances are the reference's (tests/test_kernels.py:121-166): fp32 atol
2e-5, bf16 atol 2e-2 at N(0,1) inputs, the Sq × Skv property 3e-5.  The
plain version is also run with small blocks, so that the online softmax
crosses several q and kv blocks with ragged edges at these small shapes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_ref, flash_attention_pallas
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

CASES = [
    (1, 2, 2, 64, 64, 32, True, None, None),
    (2, 4, 2, 100, 100, 64, True, None, None),   # GQA, ragged seq
    (1, 2, 1, 48, 160, 64, True, None, None),    # q shorter than kv (chunked prefill)
    (1, 2, 2, 96, 96, 64, True, 32, None),       # sliding window
    (1, 2, 2, 80, 80, 64, True, None, 30.0),     # gemma2 softcap
    (1, 3, 1, 64, 64, 40, False, None, None),    # cross-attn-like, odd head dim
]


def _inputs(seed, B, Hq, Hkv, Sq, Skv, dh, dv=None):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Hq, Sq, dh)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, Skv, dh)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, Skv, dv or dh)).astype(np.float32)
    return q, k, v


def _port(q, k, v, dtype=torch.float32, **kw):
    out = fa.flash_attention(*(torch.tensor(x).to(dtype) for x in (q, k, v)), **kw)
    assert out.dtype == dtype and out.device.type == "cpu"
    return out.float().numpy()


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,dh,causal,window,cap", CASES)
def test_matches_pallas_and_oracle(B, Hq, Hkv, Sq, Skv, dh, causal, window, cap):
    q, k, v = _inputs(0, B, Hq, Hkv, Sq, Skv, dh)
    kw = dict(causal=causal, window=window, softcap=cap)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    ref = np.asarray(attention_ref(jq, jk, jv, **kw))
    pal = np.asarray(flash_attention_pallas(jq, jk, jv, tq=32, tk=128, interpret=True, **kw))
    out = _port(q, k, v, **kw)
    np.testing.assert_allclose(out, pal, atol=2e-5)
    np.testing.assert_allclose(out, ref, atol=2e-5)
    small = flash_attention_ref(*(torch.tensor(x) for x in (q, k, v)), block_q=16, block_k=32, **kw)
    np.testing.assert_allclose(small.numpy(), ref, atol=2e-5)


@pytest.mark.parametrize("dtype,jdtype,atol", [(torch.float32, jnp.float32, 2e-5),
                                               (torch.bfloat16, jnp.bfloat16, 2e-2)])
def test_dtypes(dtype, jdtype, atol):
    q, k, v = _inputs(3, 1, 2, 2, 64, 64, 64)
    jq, jk, jv = (jnp.asarray(x, jdtype) for x in (q, k, v))
    ref = np.asarray(attention_ref(*(x.astype(jnp.float32) for x in (jq, jk, jv))))
    pal = np.asarray(flash_attention_pallas(jq, jk, jv, tq=32, tk=128, interpret=True), np.float32)
    # the same bf16 values on both sides: round through JAX's cast
    qt, kt, vt = (np.asarray(x.astype(jnp.float32)) for x in (jq, jk, jv))
    out = _port(qt, kt, vt, dtype)
    np.testing.assert_allclose(out, ref, atol=atol)
    np.testing.assert_allclose(out, pal, atol=atol)


@pytest.mark.parametrize("sq", [1, 7, 33, 130])
@pytest.mark.parametrize("skv", [64, 129, 200])
def test_ragged_sq_skv(sq, skv):
    """Any Sq ≤ Skv, decode (Sq = 1) included, matches the oracle."""
    sq = min(sq, skv)
    q, k, v = _inputs(sq * 1000 + skv, 1, 2, 1, sq, skv, 32)
    ref = np.asarray(attention_ref(*(jnp.asarray(x) for x in (q, k, v)), causal=True))
    np.testing.assert_allclose(_port(q, k, v, causal=True), ref, atol=3e-5)
    small = flash_attention_ref(*(torch.tensor(x) for x in (q, k, v)), causal=True, block_q=32, block_k=48)
    np.testing.assert_allclose(small.numpy(), ref, atol=3e-5)


def test_head_dims_differ():
    """dh ≠ dv (MLA's shape, cut down), with GQA and a window."""
    q, k, v = _inputs(5, 1, 4, 2, 40, 72, 24, dv=16)
    kw = dict(causal=True, window=20)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    ref = np.asarray(attention_ref(jq, jk, jv, **kw))
    pal = np.asarray(flash_attention_pallas(jq, jk, jv, tq=32, tk=128, interpret=True, **kw))
    out = _port(q, k, v, **kw)
    assert out.shape == (1, 4, 40, 16)
    np.testing.assert_allclose(out, pal, atol=2e-5)
    np.testing.assert_allclose(out, ref, atol=2e-5)


def test_strided_inputs_give_the_same_result():
    """The attention layer hands over transposed projections (strided views)."""
    q, k, v = _inputs(9, 2, 4, 2, 24, 24, 16)
    dense = _port(q, k, v)
    qs, ks, vs = (torch.tensor(x).transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v))
    assert not vs.is_contiguous()
    np.testing.assert_array_equal(fa.flash_attention(qs, ks, vs).numpy(), dense)


@pytest.mark.parametrize("dh,dv", [(36, 20), (40, 40), (192, 128)])
def test_tma_padding_leaves_the_result(dh, dv):
    """The layout step before the wgmma kernel: inputs padded to TMA's
    16-byte unit, run with the unpadded dh's scale and sliced back, give the
    unpadded result (v strided as the attention layer gives it)."""
    q, k, v = _inputs(11, 1, 4, 2, 40, 72, dh, dv=dv)
    qt, kt = torch.tensor(q), torch.tensor(k)
    vt = torch.tensor(v).transpose(1, 2).contiguous().transpose(1, 2)
    qp, kp, vp = fa.pad_for_tma(qt, kt, vt)
    for x, xp in ((qt, qp), (kt, kp), (vt, vp)):
        assert xp.shape[:3] == x.shape[:3] and xp.shape[3] % 8 == 0 and fa.tma_ready(xp)
        torch.testing.assert_close(xp[..., :x.shape[3]], x, rtol=0, atol=0)
        assert not xp[..., x.shape[3]:].any()
        assert (xp is x) == (x.shape[3] % 8 == 0)  # aligned inputs go in without a copy
    kw = dict(causal=True, window=24)
    want = flash_attention_ref(qt, kt, vt, **kw)
    got = flash_attention_ref(qp, kp, vp, scale=dh**-0.5, **kw)[..., :dv]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)


def test_tma_layout_checks():
    """Misaligned bases and strides are copied; extent-1 dimensions take a
    stride that TMA accepts, whatever torch gave them."""
    flat = torch.zeros(1 + 2 * 3 * 16, dtype=torch.bfloat16)
    odd = flat[1:].view(1, 2, 3, 16)  # base 2 bytes off 16-byte alignment
    assert not fa.tma_ready(odd)
    assert fa.pad_for_tma(odd, odd, odd)[0].data_ptr() % 16 == 0
    wide = torch.zeros(1, 2, 3, 20, dtype=torch.bfloat16)[..., :16]  # row stride 20: not a multiple of 8
    assert not fa.tma_ready(wide) and fa.tma_ready(fa.pad_for_tma(wide, wide, wide)[0])
    one = torch.zeros(4, 1, 8, 16, dtype=torch.bfloat16).as_strided((4, 1, 1, 16), (128, 3, 5, 1))
    assert fa.tma_strides(one) == (128, 16, 16) and fa.tma_ready(one)


def test_dtype_selects_the_kernel():
    """bf16 goes to the wgmma/TMA kernel and fp32 to the CUDA-core kernel,
    each with its own launch counter; the CUDA-core source has no bf16
    instance, and the Hopper source issues wgmma for both products and loads
    through TMA into an mbarrier-guarded ring."""
    from repro_torch import kernels
    from repro_torch.kernels import _build

    assert fa.ENTRY == {torch.bfloat16: "flash_attention_wgmma_bf16", torch.float32: "flash_attention_f32"}
    entries = {f"{base}_{s}" for base, (suffixes, _) in _build._ENTRY_POINTS.items() for s in suffixes}
    assert set(fa.ENTRY.values()) <= entries and "flash_attention_bf16" not in entries
    assert {c.name for c in fa.COUNTERS.values()} == {"flash_attention_bf16", "flash_attention_f32"}
    assert all(c.parent is fa.counter for c in fa.COUNTERS.values())
    assert set(kernels.instance_counts()) == {"flash_attention_bf16", "flash_attention_f32"}
    hopper = (_build.CSRC / "flash_attention_wgmma.cu").read_text()
    for ptx in ("wgmma.mma_async", "m64n64k16.f32.bf16.bf16", "cp.async.bulk.tensor", "mbarrier.try_wait",
                "setmaxnreg"):
        assert ptx in hopper
    assert "flash_attention_wgmma.cu" in _build.SOURCES
    assert "bfloat16" not in (_build.CSRC / "flash_attention.cu").read_text()


def test_launch_counter_parts():
    from repro_torch.kernels import LaunchCounter

    whole = LaunchCounter("k")
    a, b = LaunchCounter("k_a", parent=whole), LaunchCounter("k_b", parent=whole)
    a.add(), a.add(), b.add()
    assert (whole.n, a.n, b.n) == (3, 2, 1)
    whole.reset()
    assert (whole.n, a.n, b.n) == (0, 0, 0)
