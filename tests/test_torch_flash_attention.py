"""The port's flash attention on CPU tensors (its plain version, the blocked
online softmax) against the JAX package's Pallas kernel in interpret mode
(as tests/test_kernels.py runs it) and its naive-softmax oracle
``attention_ref``, on the same numpy inputs.

Tolerances are the reference's (tests/test_kernels.py:121-166): fp32 atol
2e-5, bf16 atol 2e-2 at N(0,1) inputs, the Sq × Skv property 3e-5.  The
plain version is also run with small blocks, so that the online softmax
crosses several q and kv blocks with ragged edges at these small shapes.

The fp32 CUDA kernel (``csrc/flash_attention.cu``) runs both products as
3×TF32 on the tensor cores, which only the card can execute.  A PyTorch
model of that arithmetic (``_tf32x3_flash``: each operand split into hi,
rounded to TF32 to nearest on the low 13 mantissa bits, and lo = x − hi,
read by the tensor core as its top 19 bits; lo·hi + hi·lo then hi·hi per
k-step of 8 in fp32, a score in two halves of k-steps, a tile's P·V apart
from O, over the kernel's key tiles in order) is held to the same
2e-5 against the oracle and the Pallas kernel, on the fp32 cases
``chip_smoke.py`` holds the kernel to and on one long causal prefill,
before the card sees it.

The bf16 kernel (``csrc/flash_attention_wgmma.cu``) computes the softcap's
tanh in one SFU instruction, ``tanh.approx.f32``.  A model of its arithmetic
(``_bf16_flash``: bf16 q, k and v; fp32 scores, scaled and capped as the
kernel folds the constants; the instance's key tiles in order; p rounded to
bf16 for P·V, the running sum of unrounded p; tanh moved by the relative
error the PTX ISA bounds tanh.approx.f32 by, 2^-10.987, in a fixed pattern
of signs) is held to the reference's bf16 atol 2e-2 against the oracle and
the Pallas kernel, at gemma2's and MLA's heads cut down and at the edges
``chip_smoke.py`` holds the kernel to.  ``wgmma_instance`` (the one rule for
the instance), the source's instances and ``chip_smoke.ptxas_report``'s
reading of their names are checked too.
"""
import os
import sys

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_ref, flash_attention_pallas
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import (FLASH_CASES, FLASH_EDGE_CASES, FLASH_FAMILY_CASES,  # noqa: E402  (the root's script)
                        _by_instance, flex_mods, ptxas_report)

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


def _cpu_sized(case):
    """A case as the CPU runs it: every head is computed alone (in the kernels,
    the plain version and the oracle), so a case of more than 2^20 (q, k)
    pairs a head keeps two of its query heads (and their KV heads, at least
    one: a GQA group past 2 keeps one) here."""
    B, Hq, Hkv, Sq, Skv = case[:5]
    if Sq * Skv < 2**20:
        return case
    return (B, 2, max(1, 2 * Hkv // Hq) if Hq > Hkv else 2, *case[3:])


@pytest.mark.parametrize("case", [_cpu_sized(c) for c in FLASH_FAMILY_CASES], ids=lambda c: "x".join(map(str, c[:10])))
def test_family_cases_match_the_oracle(case):
    """The shapes the SSM, hybrid, encoder-decoder and VLM families give the
    kernel (whisper's non-causal encoder and cross attention, Sq > Skv, Sq 1;
    internvl2's GQA group of 7; zamba2's dh 112): the plain version, also in
    small blocks with ragged edges, against the oracle in fp32, and in bf16
    on the same bf16 values (the Pallas kernel on these cases:
    ``test_tf32x3_model_holds_the_fp32_tolerance``)."""
    B, Hq, Hkv, Sq, Skv, dh, dv, causal, window, cap, _ = case
    q, k, v = _inputs(Sq * 1000 + Skv, B, Hq, Hkv, Sq, Skv, dh, dv=dv)
    kw = dict(causal=causal, window=window, softcap=cap)
    ref = np.asarray(attention_ref(*(jnp.asarray(x) for x in (q, k, v)), **kw))
    np.testing.assert_allclose(_port(q, k, v, **kw), ref, rtol=0, atol=2e-5)
    small = flash_attention_ref(*(torch.tensor(x) for x in (q, k, v)), block_q=320, block_k=448, **kw)
    np.testing.assert_allclose(small.numpy(), ref, rtol=0, atol=2e-5)
    qb, kb, vb = (_bf16(x).numpy() for x in (q, k, v))
    ref16 = np.asarray(attention_ref(*(jnp.asarray(x) for x in (qb, kb, vb)), **kw))
    np.testing.assert_allclose(_port(qb, kb, vb, torch.bfloat16, **kw), ref16, rtol=0, atol=2e-2)


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
    """bf16 goes to the wgmma/TMA kernel and fp32 to the 3×TF32 mma.sync
    kernel, each with its own launch counter; the fp32 source has no bf16
    instance and issues TF32 mma.sync fed by cp.async, and the bf16 source
    issues wgmma for both products and loads through TMA into an
    mbarrier-guarded ring."""
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
                "setmaxnreg", "tanh.approx.f32"):
        assert ptx in hopper
    assert "tanhf" not in hopper  # the softcap's tanh is one SFU instruction
    assert "flash_attention_wgmma.cu" in _build.SOURCES
    fp32 = (_build.CSRC / "flash_attention.cu").read_text()
    assert "bfloat16" not in fp32
    for ptx in ("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32", "cp.async.cg.shared.global",
                "cp.async.wait_group"):
        assert ptx in fp32


def test_launch_counter_parts():
    from repro_torch.kernels import LaunchCounter

    whole = LaunchCounter("k")
    a, b = LaunchCounter("k_a", parent=whole), LaunchCounter("k_b", parent=whole)
    a.add(), a.add(), b.add()
    assert (whole.n, a.n, b.n) == (3, 2, 1)
    whole.reset()
    assert (whole.n, a.n, b.n) == (0, 0, 0)


def test_wgmma_launches_are_counted_by_instance():
    """The bf16 kernel's launches are counted where the wrapper passes the
    instance (DK, DV) to the C entry: a counter an instance, each a part of
    the bf16 count, reset with the others; CPU tensors launch nothing."""
    from repro_torch import kernels

    assert set(fa.WGMMA_COUNTERS) == set(fa.WGMMA_INSTANCES)
    assert all(c.parent is fa.COUNTERS[torch.bfloat16] for c in fa.WGMMA_COUNTERS.values())
    kernels.reset_launch_counts()
    x = torch.randn(1, 2, 16, 192).bfloat16()
    fa.flash_attention(x, x, x[..., :128])
    assert not any(fa.wgmma_launch_counts().values()) and _by_instance() == {}
    fa.WGMMA_COUNTERS[(192, 128)].add()
    assert fa.wgmma_launch_counts() == {(64, 64): 0, (128, 128): 0, (192, 128): 1, (256, 256): 0}
    assert _by_instance() == {"192x128": 1}
    assert kernels.instance_counts() == {"flash_attention_bf16": 1, "flash_attention_f32": 0}
    assert kernels.launch_counts()["flash_attention"] == 1
    kernels.reset_launch_counts()
    assert not any(fa.wgmma_launch_counts().values()) and kernels.launch_counts()["flash_attention"] == 0


@pytest.mark.parametrize("window", [None, 24])
def test_flex_yardstick_computes_the_softcapped_function(window):
    """``chip_smoke.py``'s library call for gemma2's rows, ``flex_attention``
    with ``flex_mods``' softcap and causal (windowed) mask and GQA, computes
    the plain version's function (eager here, fp32, scores past the cap)."""
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    rng = np.random.default_rng(7)
    q = torch.tensor(4 * rng.standard_normal((1, 4, 80, 32)), dtype=torch.float32)
    k = torch.tensor(rng.standard_normal((1, 2, 80, 32)), dtype=torch.float32)
    v = torch.tensor(rng.standard_normal((1, 2, 80, 32)), dtype=torch.float32)
    score_mod, mask_mod = flex_mods(window, 5.0)
    mask = create_block_mask(mask_mod, None, None, 80, 80, device="cpu")
    got = flex_attention(q, k, v, score_mod=score_mod, block_mask=mask, enable_gqa=True)
    want = flash_attention_ref(q, k, v, causal=True, window=window, softcap=5.0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5)


# ---------------------------------------------------------------------------
# a model of the fp32 kernel's 3×TF32 arithmetic
# ---------------------------------------------------------------------------

# (B, Hq, Hkv, Sq, Skv, dh, dv, causal, window, softcap): the cases chip_smoke.py
# holds the fp32 kernel to on the card, their layout flag dropped (heads cut as
# ``_cpu_sized`` cuts them)
KERNEL_CASES = [_cpu_sized(case)[:10] for case in FLASH_CASES]


def _tf32(x):
    """Round fp32 to TF32 (10 mantissa bits): to nearest, ties away from zero."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _top19(x):
    """What the tensor core reads of an fp32 register passed as TF32."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _top19(x - hi)


def _mma3(a, b, halves=1):
    """``a [..., M, K] @ b [..., K, N]`` as the kernel's 3×TF32 mma.sync:
    per k-step of 8, lo·hi + hi·lo, then hi·hi, into fp32 accumulators, k-step
    i into sum ``i % halves``; the sums are added last."""
    K = a.shape[-1]
    pad = -K % (8 * halves)
    C = (K + pad) // 8
    a_hi, a_lo = _split(torch.nn.functional.pad(a, (0, pad)).unflatten(-1, (C, 8)))
    b_hi, b_lo = _split(torch.nn.functional.pad(b, (0, 0, 0, pad)).unflatten(-2, (C, 8)))
    # each k-step's three products [..., C, M, N], each an 8-term sum in fp32
    steps = [torch.einsum("...mck,...ckn->...cmn", x, y) for x, y in ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi))]
    acc = [torch.zeros((*a.shape[:-1], b.shape[-1]), dtype=torch.float32) for _ in range(halves)]
    for i in range(C):
        for prod in steps:
            acc[i % halves] = acc[i % halves] + prod[..., i, :, :]
    return sum(acc[1:], acc[0])


def _tf32x3_flash(q, k, v, *, causal=True, window=None, softcap=None):
    """The fp32 kernel's function and arithmetic on the CPU: key tiles of 64,
    32 or 16 (head-dim bucket 64, 128, 256) in order, the online softmax in
    fp32.  Every row runs over every tile: a tile the kernel skips for a row
    adds exactly nothing (p = 0 and a correction of 1 after the row's first
    visible key, or garbage wiped by a correction of exactly 0 before it)."""
    B, Hq, Sq, dh = q.shape
    Hkv, Skv, dv = k.shape[1], k.shape[2], v.shape[3]
    d = max(dh, dv)
    BK = 64 if d <= 64 else 32 if d <= 128 else 16
    kk, vv = (x.repeat_interleave(Hq // Hkv, dim=1) for x in (k, v))
    scale = dh**-0.5
    qpos = torch.arange(Sq) + Skv - Sq
    m = torch.full((B, Hq, Sq, 1), -1e30)
    l = torch.zeros((B, Hq, Sq, 1))
    acc = torch.zeros((B, Hq, Sq, dv))
    for k0 in range(0, Skv, BK):
        kb, vb = kk[:, :, k0:k0 + BK], vv[:, :, k0:k0 + BK]
        s = _mma3(q, kb.transpose(-1, -2), halves=2) * scale
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        kpos = torch.arange(k0, k0 + kb.shape[2])
        ok = torch.ones((Sq, kb.shape[2]), dtype=torch.bool)
        if causal:
            ok &= kpos[None, :] <= qpos[:, None]
        if window:
            ok &= qpos[:, None] - kpos[None, :] < window
        s = torch.where(ok, s, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + _mma3(p, vb)
        m = m_new
    return acc / (l + 1e-30)


@pytest.fixture
def one_thread():
    """The model runs thousands of small tensor operations: with the test
    workers sharing the cores, torch's intra-op threads would spend their
    time waiting on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_tf32_rounding_and_split():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-12, -(1.0 + 2**-11), 3.0e-5, -7.25e3, 0.0])
    hi, lo = _split(x)
    assert hi.tolist()[:4] == [1.0, 1.0 + 2**-10, 1.0 + 2**-10, -(1.0 + 2**-10)]  # ties away from zero
    assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all()) and bool(((lo.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(((x - hi).abs() <= 2**-11 * x.abs()).all())
    assert bool(((x - (hi + lo)).abs() <= 2**-21 * x.abs()).all())


@pytest.mark.parametrize("case", KERNEL_CASES + [(1, 2, 1, 2048, 2048, 128, 128, True, None, None)],
                         ids=lambda c: "x".join(map(str, c)))
def test_tf32x3_model_holds_the_fp32_tolerance(case, one_thread):
    """The 3×TF32 arithmetic of the fp32 kernel within the reference's fp32
    atol 2e-5 of the oracle and the Pallas kernel (interpret mode), and the
    plain version beside it."""
    B, Hq, Hkv, Sq, Skv, dh, dv, causal, window, cap = case
    q, k, v = _inputs(Sq * 1000 + Skv, B, Hq, Hkv, Sq, Skv, dh, dv=dv)
    kw = dict(causal=causal, window=window, softcap=cap)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    ref = np.asarray(attention_ref(jq, jk, jv, **kw))
    tq = 128 if Sq > 1024 else 32
    pal = np.asarray(flash_attention_pallas(jq, jk, jv, tq=tq, tk=128, interpret=True, **kw))
    model = _tf32x3_flash(*(torch.tensor(x) for x in (q, k, v)), **kw).numpy()
    np.testing.assert_allclose(model, ref, rtol=0, atol=2e-5)
    np.testing.assert_allclose(model, pal, rtol=0, atol=2e-5)
    np.testing.assert_allclose(_port(q, k, v, **kw), pal, rtol=0, atol=2e-5)


def test_one_tf32_pass_misses_the_fp32_tolerance(monkeypatch, one_thread):
    """Why three passes: the same model with one TF32 product (operands
    rounded to TF32) is ~40× off the reference's 2e-5 at qwen3's heads."""
    case = (2, 16, 8, 100, 150, 128, 128, True, None, None)
    B, Hq, Hkv, Sq, Skv, dh, dv, causal, window, cap = case
    q, k, v = (torch.tensor(x) for x in _inputs(Sq * 1000 + Skv, B, Hq, Hkv, Sq, Skv, dh, dv=dv))
    ref = flash_attention_ref(q.double(), k.double(), v.double()).float()
    err3 = float((_tf32x3_flash(q, k, v) - ref).abs().max())
    monkeypatch.setitem(globals(), "_mma3", lambda a, b, halves=1: _tf32(a) @ _tf32(b))
    err1 = float((_tf32x3_flash(q, k, v) - ref).abs().max())
    assert err3 < 5e-6 < 2e-5 < 10 * 2e-5 < err1


# ---------------------------------------------------------------------------
# the bf16 kernel's instances and its arithmetic with the approximate tanh
# ---------------------------------------------------------------------------

def _layouts():
    """Each instance of the wgmma kernel, (DK, DV) → (keys per tile, whether
    it runs the slim loop), from the source's ``Layout<...>``."""
    from repro_torch.kernels import _build

    text = (_build.CSRC / "flash_attention_wgmma.cu").read_text()
    return {(int(dk), int(dv)): (int(keys), slim == "true") for dk, dv, keys, slim in
            re.findall(r"struct Inst<(\d+), (\d+)> : Layout<(\d+), \d+, \d+, \d+, (true|false)\b", text)}


@pytest.mark.parametrize("dh,dv,want", [((32), 32, (64, 64)), (36, 20, (64, 64)), (128, 128, (128, 128)),
                                        (160, 96, (192, 128)), (192, 128, (192, 128)), (256, 256, (256, 256)),
                                        (200, 100, (256, 256))])
def test_wgmma_instance(dh, dv, want):
    """MLA-like heads (128 < dh ≤ 192, dv ≤ 128) go to (192, 128), every other
    pair to the smallest (D, D) that holds max(dh, dv); the instance exists in
    the source and the C entry launches it."""
    from repro_torch.kernels import _build

    assert fa.wgmma_instance(dh, dv) == want
    assert want in fa.WGMMA_INSTANCES and set(fa.WGMMA_INSTANCES) == set(_layouts())
    text = (_build.CSRC / "flash_attention_wgmma.cu").read_text()
    launched = {(int(a), int(b)) for a, b in re.findall(r"return launch<(\d+), (\d+)>", text)}
    assert launched == set(fa.WGMMA_INSTANCES)


def test_wgmma_instance_refuses_head_dims_past_the_kernel():
    for dh, dv in ((0, 64), (64, 0), (264, 64), (64, 264)):
        with pytest.raises(ValueError, match="head dims"):
            fa.wgmma_instance(dh, dv)


def test_ptxas_report_names_both_instance_dims():
    """``chip_smoke.ptxas_report`` on an ``-Xptxas -v`` log of the bf16 kernel's
    two-argument instances beside the fp32 kernel: registers, spills and
    ptxas' reason for serialising an instance's wgmma, per instance."""
    ns = "_ZN57_GLOBAL__N__1a2b3c4d_24_flash_attention_wgmma_cu_5e6f7a8b"
    big = f"{ns}18flash_wgmma_kernelILi256ELi256EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16NS_6ParamsE"
    mla = f"{ns}18flash_wgmma_kernelILi192ELi128EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16NS_6ParamsE"
    f32 = "_ZN12_GLOBAL__N_112flash_kernelILi128EEEvPKfS2_S2_Pf6Params"
    log = f"""ptxas info    : (C7512) Potential Performance Loss: wgmma.mma_async instructions are serialized due to insufficient register resources for the function '{big}'
ptxas info    : Compiling entry function '{big}' for 'sm_90a'
ptxas info    : Function properties for {big}
    312 bytes stack frame, 392 bytes spill stores, 764 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers, 312 bytes cumulative stack size
ptxas info    : Compiling entry function '{mla}' for 'sm_90a'
ptxas info    : Function properties for {mla}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers
ptxas info    : Compiling entry function '{f32}' for 'sm_90a'
ptxas info    : Function properties for {f32}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 235 registers, used 1 barriers
"""
    assert ptxas_report(log) == {
        "flash_wgmma_kernel<bf16, 256, 256>": {"registers": 168, "spill_store_bytes": 392, "spill_load_bytes": 764,
                                               "wgmma_serialized": "insufficient register resources"},
        "flash_wgmma_kernel<bf16, 192, 128>": {"registers": 168, "spill_store_bytes": 0, "spill_load_bytes": 0,
                                               "wgmma_serialized": None},
        "flash_kernel<float, 128>": {"registers": 235, "spill_store_bytes": 0, "spill_load_bytes": 0},
    }


TANH_APPROX_REL_ERR = 2**-10.987  # PTX ISA: tanh.approx.f32, maximum relative error
# tanh.approx.f32's largest relative error over every fp32 in [2^-20, 20] on an
# H100 (tools/flash_ab.py --tanh-error; PERF.md): 2^-16.46, at x ≈ 0.59
TANH_APPROX_REL_ERR_H100 = 2**-16.45
LOG2E = 1.4426950408889634


def _bf16(x):
    return torch.tensor(x).bfloat16().float()


def _bf16_flash(q, k, v, *, causal=True, window=None, softcap=None, scale=None, tanh_err=TANH_APPROX_REL_ERR):
    """The bf16 kernel's function and arithmetic on the CPU (fp32 tensors
    holding bf16 values): scores in fp32, scaled by scale·log2(e) or capped as
    (softcap·log2 e)·tanh(x·(scale/softcap)) with tanh moved by its bound in
    a checkerboard of signs over (query, key); the instance's key tiles in
    order, p = 2^(x − m) in fp32 (the slim loop's instances keep m in the
    units of the raw or tanh score u and take p = 2^(u·c − m·c)), its bf16
    rounding into P·V and the sum of it unrounded; acc / (l + 1e-30) rounded
    to bf16."""
    B, Hq, Sq, dh = q.shape
    Hkv, Skv, dv = k.shape[1], k.shape[2], v.shape[3]
    BN, slim = _layouts()[fa.wgmma_instance(dh, dv)]
    kk, vv = (x.repeat_interleave(Hq // Hkv, dim=1) for x in (k, v))
    scale = dh**-0.5 if scale is None else scale
    f32 = np.float32
    c = float(f32(softcap * LOG2E)) if softcap else float(f32(scale * LOG2E))
    qpos = torch.arange(Sq) + Skv - Sq
    m = torch.full((B, Hq, Sq, 1), -1e30)
    l = torch.zeros((B, Hq, Sq, 1))
    acc = torch.zeros((B, Hq, Sq, dv))
    for k0 in range(0, Skv, BN):
        kb, vb = kk[:, :, k0:k0 + BN], vv[:, :, k0:k0 + BN]
        kpos = torch.arange(k0, k0 + kb.shape[2])
        s = q @ kb.transpose(-1, -2)
        if softcap:
            sign = 1.0 - 2.0 * ((qpos[:, None] + kpos[None, :]) % 2)
            s = torch.tanh(s * float(f32(scale / softcap))) * (1.0 + sign * tanh_err)
        if not slim:
            s = s * c
        ok = kpos[None, :] < Skv
        if causal:
            ok = ok & (kpos[None, :] <= qpos[:, None])
        if window:
            ok = ok & (qpos[:, None] - kpos[None, :] < window)
        s = torch.where(ok, s, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        if slim:  # a row masked so far takes p = 0
            corr = torch.exp2((m - m_new) * c)
            p = torch.exp2(s * c - torch.where(m_new == -1e30, 0.0, m_new * c))
        else:
            corr = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + p.bfloat16().float() @ vb
        m = m_new
    return (acc / (l + 1e-30)).bfloat16().float()


# (B, Hq, Hkv, Sq, Skv, dh, dv, window, softcap, scale, q scale), causal: gemma2's
# heads cut down (dh 256, softcap 50, window, GQA), MLA's (dh 192, dv 128,
# scale 192^-½), then the edges chip_smoke.py holds the kernel to on the card,
# with the relative error of tanh.approx.f32 the model gives it: the PTX ISA's
# bound, except where the scores sit far past the cap.  There a capped score
# is softcap·tanh ≈ ±50, and the bound (2^-10.987, 0.024 of a score of 50)
# moves each p by up to 2.5%: in a checkerboard of signs the model then lands
# 2.1e-2 from the oracle at q × 1,000 (4.3e-2 at q × 100), past the
# reference's 2e-2.  The card's own tanh.approx.f32 is 45 times closer
# (2^-16.46 at worst, 2^-21 past |x| = 5, exactly ±1 past 9.01), and with
# that error the model holds 2e-2; the kernel itself is held there on the
# card against the plain version (chip_smoke.py's FLASH_EDGE_CASES).
BF16_MODEL_CASES = [
    ((1, 4, 2, 200, 200, 256, 256, 64, 50.0, None, 1.0), TANH_APPROX_REL_ERR),
    ((1, 4, 4, 160, 160, 192, 128, None, None, 192**-0.5, 1.0), TANH_APPROX_REL_ERR),
] + [(case, TANH_APPROX_REL_ERR if case[-1] == 1.0 else TANH_APPROX_REL_ERR_H100) for case in FLASH_EDGE_CASES]


@pytest.mark.parametrize("case,tanh_err", BF16_MODEL_CASES, ids=lambda c: "x".join(map(str, c)) if isinstance(c, tuple)
                         else f"tanh_err{c:.2e}")
def test_bf16_model_with_approximate_tanh(case, tanh_err, one_thread):
    """The bf16 kernel's arithmetic, tanh.approx.f32's error included, within
    the reference's bf16 atol 2e-2 of the oracle and of the Pallas kernel
    (interpret mode) on the same bf16 inputs."""
    B, Hq, Hkv, Sq, Skv, dh, dv, window, cap, scale, q_scale = case
    q, k, v = _inputs(Sq * 1000 + Skv, B, Hq, Hkv, Sq, Skv, dh, dv=dv)
    q, k, v = _bf16(q_scale * q), _bf16(k), _bf16(v)
    kw = dict(causal=True, window=window, softcap=cap, scale=scale)
    jq, jk, jv = (jnp.asarray(x.numpy()) for x in (q, k, v))
    ref = np.asarray(attention_ref(jq, jk, jv, **kw))
    pal = np.asarray(flash_attention_pallas(*(x.astype(jnp.bfloat16) for x in (jq, jk, jv)), tq=32, tk=128,
                                            interpret=True, **kw), np.float32)
    model = _bf16_flash(q, k, v, tanh_err=tanh_err, **kw).numpy()
    assert model.shape == (B, Hq, Sq, dv)
    np.testing.assert_allclose(model, ref, rtol=0, atol=2e-2)
    np.testing.assert_allclose(model, pal, rtol=0, atol=2e-2)


# (B, Hq, Hkv, Sq, Skv), non-causal, dh = dv = 64: whisper-small's cross attention cut
# down, one query row and one consumer's 64 over keys that end in a ragged tile
LONG_KEYS_MODEL_CASES = [(1, 2, 1, 1, 1000), (1, 2, 2, 64, 900)]


@pytest.mark.parametrize("case", LONG_KEYS_MODEL_CASES, ids=lambda c: "x".join(map(str, c)))
def test_bf16_model_of_the_64_instance_over_long_keys(case, one_thread):
    """The (64, 64) instance's arithmetic (its key tiles, the slim exponent)
    over many key tiles, the last one ragged, within the reference's bf16
    atol 2e-2 of the oracle and of the Pallas kernel (interpret mode) on the
    same bf16 inputs."""
    B, Hq, Hkv, Sq, Skv = case
    keys, slim = _layouts()[fa.wgmma_instance(64, 64)]
    assert slim and Skv // keys >= 4 and Skv % keys
    q, k, v = (_bf16(x) for x in _inputs(Sq * 1000 + Skv, B, Hq, Hkv, Sq, Skv, 64))
    jq, jk, jv = (jnp.asarray(x.numpy()) for x in (q, k, v))
    ref = np.asarray(attention_ref(jq, jk, jv, causal=False))
    pal = np.asarray(flash_attention_pallas(*(x.astype(jnp.bfloat16) for x in (jq, jk, jv)), tq=32, tk=128,
                                            interpret=True, causal=False), np.float32)
    model = _bf16_flash(q, k, v, causal=False).numpy()
    assert model.shape == (B, Hq, Sq, 64)
    np.testing.assert_allclose(model, ref, rtol=0, atol=2e-2)
    np.testing.assert_allclose(model, pal, rtol=0, atol=2e-2)
