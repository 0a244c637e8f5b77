"""The port's serving tier against the JAX package's, both on the same numpy
inputs on the CPU: the engines (surrogate, trajectory, decode, sharded),
their signatures and checkpoints across packages, and the reference's
microbatcher, result-cache and serving-degradation cases against the
port's copies.

The reference's params cross over as numpy (``convert.surrogate_params_
from_numpy``, ``convert.params_from_numpy``).  Tolerances: the ensemble
mean within 1e-5·max|y| and the disagreement score within 1e-5 of the
reference's; signatures, decode tokens and batched ≡ per-request exactly.
"""
import dataclasses
import time
from concurrent.futures import Future

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.models import transformer as RT
from repro.serving import engine as ref_engine
from repro.surrogate import model as ref_model
from repro.surrogate import seqmodel as ref_seq
from repro.surrogate import train as ref_train
from repro.surrogate import trajectory as ref_traj
from repro_torch import convert
from repro_torch.configs import ARCHS
from repro_torch.launch.mesh import make_case_mesh
from repro_torch.serving import (DecodeEngine, Engine, InferResult, MicroBatcher, ResultCache, ServeConfig,
                                 ShardedEngine, SurrogateEngine, TrajectoryEngine)
from repro_torch.serving.batcher import CircuitOpenError, DeadlineExceededError, NonFiniteOutputError, Request
from repro_torch.serving.engine import _params_digest
from repro_torch.surrogate import model, seqmodel, train, trajectory

NT = 16
FAMILIES = {
    # name: (reference module, port module, config kwargs, reference engine, port engine, ref save, port save)
    "surrogate": (ref_model, model, dict(n_c=2, n_lstm=1, latent=8), ref_engine.SurrogateEngine, SurrogateEngine,
                  ref_train.save_surrogate, train.save_surrogate),
    "trajectory": (ref_seq, seqmodel, dict(latent=8, state=4, n_layers=1, obs_every=2), ref_engine.TrajectoryEngine,
                   TrajectoryEngine, ref_traj.save_trajectory, trajectory.save_trajectory),
}


def waves(n, nt=NT, seed=0):
    return np.random.default_rng(seed).standard_normal((n, nt, 3)).astype(np.float32)


def _members(family, n=2):
    """(ref cfg, ref members, port cfg, port members): the reference's init
    carried across as numpy."""
    ref_mod, mod, kw = FAMILIES[family][:3]
    ref_cfg = (ref_mod.SurrogateConfig if family == "surrogate" else ref_mod.TrajectoryConfig)(**kw)
    cfg = (mod.SurrogateConfig if family == "surrogate" else mod.TrajectoryConfig)(**kw)
    ref = [jax.tree_util.tree_map(np.asarray, ref_mod.init_params(ref_cfg, jax.random.key(s))) for s in range(n)]
    return ref_cfg, ref, cfg, [convert.surrogate_params_from_numpy(m, "cpu") for m in ref]


def _engines(family, n=2, **kw):
    ref_cfg, ref, cfg, port = _members(family, n)
    kw = {"scale": 2.0, "buckets": (8,), "nt": NT, **kw}
    return FAMILIES[family][3](ref_cfg, ref, **kw), FAMILIES[family][4](cfg, port, device="cpu", **kw)


def _close(a, b, rel=1e-5):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and float(np.abs(a - b).max()) <= rel * float(np.abs(b).max())


# ---------------------------------------------------------------------------
# surrogate and trajectory engines
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", FAMILIES)
def test_engine_matches_reference_with_equal_signature(family):
    ref, eng = _engines(family)
    assert isinstance(eng, Engine)
    x = waves(3)
    want, got = ref.infer(x), eng.infer(x)
    assert isinstance(got.y, np.ndarray) and got.y.dtype == np.float32 and got.score.dtype == np.float64
    _close(got.y, want.y)
    assert float(np.abs(got.score - want.score).max()) <= 1e-5 and (got.score > 0).all()
    assert eng.signature() == ref.signature()


@pytest.mark.parametrize("family", FAMILIES)
def test_single_member_scores_zero(family):
    ref, eng = _engines(family, n=1, buckets=(4,))
    res = eng.infer(waves(2))
    assert (res.score == 0).all()
    _close(res.y, ref.infer(waves(2)).y)
    assert eng.signature() == ref.signature()


@pytest.mark.parametrize("family", FAMILIES)
def test_batched_equals_per_request_bit_identical(family):
    """A row's result does not depend on what else rode in its batch: one
    bucket shape, row-independent ops, the reductions at the padded shape."""
    _, eng = _engines(family)
    x = waves(5)
    batched = eng.infer(x)
    for i in range(5):
        solo = eng.infer(x[i:i + 1])
        np.testing.assert_array_equal(batched.y[i], solo.y[0])
        np.testing.assert_array_equal(batched.score[i], solo.score[0])


def test_signature_tracks_params_and_scale():
    _, _, cfg, members = _members("surrogate")
    eng = SurrogateEngine(cfg, members, scale=2.0, device="cpu")
    assert eng.signature() == eng.signature()
    resc = SurrogateEngine(cfg, members, scale=3.0, device="cpu")
    sub = SurrogateEngine(cfg, members[:1], scale=2.0, device="cpu")
    assert len({eng.signature(), resc.signature(), sub.signature()}) == 3


def test_trajectory_stride_and_signature_distinct_from_surrogate():
    _, eng = _engines("trajectory")
    res = eng.infer(waves(2))
    assert res.y.shape == (2, NT // 2, 3)  # obs_every=2 strides the output
    assert eng.signature() != _engines("surrogate")[1].signature()
    assert eng.signature() != _engines("trajectory", n=1)[1].signature()


@pytest.mark.parametrize("writer", ["reference", "port"])
@pytest.mark.parametrize("family", FAMILIES)
def test_checkpoints_serve_across_packages(tmp_path, family, writer):
    """An ensemble saved by either package serves from the other's
    ``from_checkpoint`` with the same step, scale, members and signature."""
    ref_cfg, ref, cfg, port = _members(family)
    ref_cls, cls, ref_save, save = FAMILIES[family][3:]
    ckpt = str(tmp_path / "ckpt")
    if writer == "reference":
        ref_save(ckpt, ref_cfg, ref, scale=2.0, step=7)
        loaded = cls.from_checkpoint(ckpt, buckets=(8,), nt=NT, device="cpu")
        other = ref_cls(ref_cfg, ref, scale=2.0, buckets=(8,), nt=NT)
    else:
        save(ckpt, cfg, port, scale=2.0, step=7)
        loaded = ref_cls.from_checkpoint(ckpt, buckets=(8,), nt=NT)
        other = cls(cfg, port, scale=2.0, buckets=(8,), nt=NT, device="cpu")
    assert (loaded.step, loaded.scale, len(loaded.members)) == (7, 2.0, 2)
    assert loaded.signature() == other.signature()
    _close(loaded.infer(waves(3)).y, other.infer(waves(3)).y)


def test_params_digest_names_bf16_as_the_reference():
    """A bf16 leaf has no numpy dtype: it is hashed as ``bfloat16`` and its
    16-bit patterns, as the reference hashes an ml_dtypes array."""
    x = np.linspace(-3, 3, 12, dtype=np.float32).reshape(3, 4)
    ref_tree = {"b": [jax.numpy.asarray(x, jax.numpy.bfloat16)], "a": jax.numpy.asarray(x)}
    tree = {"b": [torch.tensor(x).bfloat16()], "a": torch.tensor(x)}
    assert _params_digest([tree]) == ref_engine._params_digest([ref_tree])


# ---------------------------------------------------------------------------
# sharded engine
# ---------------------------------------------------------------------------


def test_sharded_engine_identity_and_shared_signature():
    _, eng = _engines("surrogate")
    sh = ShardedEngine(eng)
    x = waves(3)
    np.testing.assert_array_equal(sh.infer(x).y, eng.infer(x).y)
    assert sh.signature() == eng.signature() and sh.n_devices == 1 and sh.buckets == eng.buckets
    with pytest.raises(NotImplementedError, match="not ported"):
        ShardedEngine(eng, make_case_mesh(2))
    with pytest.raises(NotImplementedError, match="not ported"):
        ShardedEngine(eng, object())


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lm():
    ref_cfg = REF_ARCHS["qwen3-1.7b"].reduced()
    cfg = ARCHS["qwen3-1.7b"].reduced()
    ref_params, _ = RT.init_params(ref_cfg, jax.random.key(0))
    params = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, ref_params), cfg, "cpu")
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 4)).astype(np.int32)
    return ref_cfg, ref_params, cfg, params, prompt


def test_decode_engine_matches_reference_and_pads(lm):
    ref_cfg, ref_params, cfg, params, prompt = lm
    ref = ref_engine.DecodeEngine(ref_cfg, ref_params, n_new=3, prompt_len=4, buckets=(2,))
    eng = DecodeEngine(cfg, params, n_new=3, prompt_len=4, buckets=(2,), device="cpu")
    want, res = ref.infer(prompt), eng.infer(prompt)
    np.testing.assert_array_equal(res.y, want.y)
    assert res.y.dtype == np.int32 and (res.score == 0).all()
    assert eng.signature() == ref.signature()
    # a single prompt pads to the 2-bucket and still matches its batched row
    np.testing.assert_array_equal(eng.infer(prompt[:1]).y, want.y[:1])
    with pytest.raises(ValueError, match="expects prompts"):
        eng.infer(prompt[:, :3])  # wrong prompt length


def test_decode_engine_offloaded_kv_gives_resident_tokens(lm):
    *_, cfg, params, prompt = lm
    kw = dict(n_new=3, prompt_len=4, buckets=(2,), device="cpu")
    res = DecodeEngine(cfg, params, **kw).infer(prompt)
    for schedule in ("serial", "prefetch"):
        off = DecodeEngine(cfg, params, serve=ServeConfig(kv_offload=True, kv_npart=2), kv_schedule=schedule, **kw)
        np.testing.assert_array_equal(off.infer(prompt).y, res.y)


def test_temperature_zero_is_greedy_and_sampling_is_seeded(lm):
    from repro_torch.serving.decode import generate, greedy_generate

    *_, cfg, params, prompt = lm
    p = torch.tensor(prompt, dtype=torch.long)
    np.testing.assert_array_equal(generate(params, cfg, p, 3, ServeConfig(temperature=0.0)),
                                  greedy_generate(params, cfg, p, 3))
    hot = DecodeEngine(cfg, params, n_new=3, prompt_len=4, buckets=(2,), serve=ServeConfig(temperature=1.0, seed=3),
                       device="cpu")
    np.testing.assert_array_equal(hot.infer(prompt).y, hot.infer(prompt).y)
    with pytest.raises(ValueError):
        ServeConfig(temperature=-1.0)


# ---------------------------------------------------------------------------
# microbatcher and result cache (the reference's cases)
# ---------------------------------------------------------------------------


class DoublerEngine:
    """Protocol-conformant fake: y = 2x, score = per-row max; counts calls.
    ``delay_s`` holds each call; ``poison`` raises on a row holding that
    value; ``fail_until`` raises for the first N calls."""

    def __init__(self, delay_s=0.0, poison=None, fail_until=0, sig="doubler-v1"):
        self.calls = 0
        self.delay_s = delay_s
        self.poison = poison
        self.fail_until = fail_until
        self.sig = sig

    def warmup(self):
        pass

    def signature(self):
        return self.sig

    def infer(self, x):
        self.calls += 1
        if self.delay_s:
            time.sleep(self.delay_s)
        x = np.asarray(x)
        if self.fail_until and self.calls <= self.fail_until:
            raise RuntimeError(f"down (call {self.calls})")
        if self.poison is not None and (x == self.poison).any():
            raise RuntimeError("poison row")
        return InferResult(y=2.0 * x, score=x.reshape(x.shape[0], -1).max(1))


def _x(v, n=1):
    return np.full((n, 4), float(v), np.float32)


def test_fake_engine_is_protocol_instance():
    assert isinstance(DoublerEngine(), Engine)


def test_flush_on_full():
    eng = DoublerEngine()
    with MicroBatcher(eng, max_batch=4, max_wait_ms=60_000.0) as mb:
        futs = [mb.submit(f"k{i}", np.full((1, 2), float(i))) for i in range(4)]
        for i, f in enumerate(futs):
            r = f.result(timeout=10)
            np.testing.assert_array_equal(r.y, np.full((1, 2), 2.0 * i))
            assert not r.cached
    st = mb.stats()
    assert st["flush_full"] == 1 and st["flush_timeout"] == 0
    assert st["batches"] == 1 and eng.calls == 1  # coalesced, not per-request


def test_flush_on_timeout():
    with MicroBatcher(DoublerEngine(), max_batch=64, max_wait_ms=30.0) as mb:
        r = mb.submit("k", np.ones((1, 2))).result(timeout=10)  # resolves without ever filling the batch
        assert r.wait_ms >= 25.0
    st = mb.stats()
    assert st["flush_timeout"] == 1 and st["flush_full"] == 0


def test_close_drains_pending():
    mb = MicroBatcher(DoublerEngine(), max_batch=64, max_wait_ms=60_000.0)
    f = mb.submit("k", np.ones((1, 2)))
    mb.close()  # long max-wait: only the drain can resolve this future
    np.testing.assert_array_equal(f.result(timeout=10).y, 2 * np.ones((1, 2)))
    assert mb.stats()["flush_drain"] == 1
    with pytest.raises(RuntimeError):
        mb.submit("k2", np.ones((1, 2)))


def test_engine_error_fails_request_not_loop():
    with MicroBatcher(DoublerEngine(fail_until=1), max_batch=1, max_wait_ms=5.0) as mb:
        with pytest.raises(RuntimeError, match="down"):
            mb.submit("a", np.ones((1, 2))).result(timeout=10)
        # the loop survived: the next request computes normally
        assert mb.submit("b", np.ones((1, 2))).result(timeout=10).y[0, 0] == 2.0


def test_multirow_requests_split_correctly():
    with MicroBatcher(DoublerEngine(), max_batch=4, max_wait_ms=60_000.0) as mb:
        fa = mb.submit("a", np.full((3, 2), 1.0))
        fb = mb.submit("b", np.full((1, 2), 5.0))
        ra, rb = fa.result(timeout=10), fb.result(timeout=10)
    np.testing.assert_array_equal(ra.y, np.full((3, 2), 2.0))
    np.testing.assert_array_equal(rb.y, np.full((1, 2), 10.0))
    assert ra.score == 1.0 and rb.score == 5.0  # per-request row max


def test_cache_hit_skips_engine_and_is_bit_identical():
    eng = DoublerEngine()
    with MicroBatcher(eng, max_batch=1, max_wait_ms=5.0, cache=ResultCache(8)) as mb:
        first = mb.submit("k", waves(1)).result(timeout=10)
        assert not first.cached and eng.calls == 1
        second = mb.submit("k", waves(1)).result(timeout=10)
        assert second.cached and eng.calls == 1  # engine never invoked
        np.testing.assert_array_equal(second.y, first.y)
        assert second.score == first.score
    st = mb.stats()
    assert st["cache_hits"] == 1 and st["cache"]["hits"] == 1


@pytest.mark.parametrize("family", FAMILIES)
def test_cache_hit_skips_a_real_engine(family):
    """A repeat is answered from host memory: the second result is the first
    one's host array, and the engine's ``infer`` runs once."""
    _, inner = _engines(family)

    class Counting:
        calls = 0
        signature = inner.signature
        warmup = inner.warmup

        def infer(self, x):
            Counting.calls += 1
            return inner.infer(x)

    eng = Counting()
    with MicroBatcher(eng, max_batch=4, max_wait_ms=2.0, cache=ResultCache(8)) as mb:
        r1 = mb.submit("k", waves(1)).result(timeout=60)
        r2 = mb.submit("k", waves(1)).result(timeout=60)
    assert Counting.calls == 1 and not r1.cached and r2.cached
    assert isinstance(r2.y, np.ndarray)
    np.testing.assert_array_equal(r1.y, r2.y)


def test_cache_keyed_by_engine_signature():
    cache = ResultCache(8)
    x = np.ones((1, 2))
    with MicroBatcher(DoublerEngine(), max_batch=1, max_wait_ms=5.0, cache=cache) as mb:
        mb.submit("k", x).result(timeout=10)
    eng2 = DoublerEngine(sig="doubler-v2")
    with MicroBatcher(eng2, max_batch=1, max_wait_ms=5.0, cache=cache) as mb2:
        r = mb2.submit("k", x).result(timeout=10)
    assert not r.cached and eng2.calls == 1  # new model ⇒ stale entry unusable


def test_lru_eviction_order():
    c = ResultCache(2)
    c.put("a", 1)
    c.put("b", 2)
    assert c.get("a") == 1          # refresh a → b is now least-recent
    c.put("c", 3)                   # evicts b
    assert "b" not in c and c.get("b") is None
    assert c.keys() == ["a", "c"]   # LRU → MRU
    st = c.stats()
    assert st["evictions"] == 1 and st["size"] == 2
    with pytest.raises(ValueError):
        ResultCache(0)


# ---------------------------------------------------------------------------
# serving degradation (the reference's health cases)
# ---------------------------------------------------------------------------


def test_close_sentinel_does_not_abandon_requests():
    """A request that lands in the queue *behind* the close sentinel is
    still flushed, not abandoned with its future forever unresolved."""
    eng = DoublerEngine(delay_s=0.25)
    mb = MicroBatcher(eng, max_batch=1, max_wait_ms=1.0)
    first = mb.submit("r0", _x(1))           # occupies the loop for 0.25 s
    time.sleep(0.05)                         # loop is now inside _flush
    mb._q.put(None)                          # close sentinel...
    late = Future()
    mb._q.put(Request(key="late", x=_x(3), t_submit=time.monotonic(), future=late))  # ...with a request BEHIND it
    mb._thread.join(timeout=5.0)
    assert not mb._thread.is_alive()
    np.testing.assert_array_equal(first.result(timeout=1).y, _x(2))
    np.testing.assert_array_equal(late.result(timeout=1).y, _x(6))
    mb.close()


def test_deadline_expires_stale_request():
    eng = DoublerEngine(delay_s=0.2)
    with MicroBatcher(eng, max_batch=1, max_wait_ms=1.0) as mb:
        slow = mb.submit("s", _x(1))         # holds the loop for 0.2 s
        stale = mb.submit("t", _x(2), deadline_ms=50.0)
        with pytest.raises(DeadlineExceededError, match="expired"):
            stale.result(timeout=2)
        slow.result(timeout=2)
        assert mb.stats()["deadline_expired"] == 1
    assert eng.calls == 1                    # expired request never inferred


def test_split_retry_isolates_poison_request():
    eng = DoublerEngine(poison=666.0)
    with MicroBatcher(eng, max_batch=5, max_wait_ms=2000.0) as mb:
        futs = [mb.submit(f"r{i}", _x(i)) for i in (1, 2, 3, 4)]
        bad = mb.submit("poison", _x(666))   # 5 pending rows → flush-on-full
        for i, f in zip((1, 2, 3, 4), futs):
            np.testing.assert_array_equal(f.result(timeout=2).y, _x(2 * i))
        with pytest.raises(RuntimeError, match="poison row"):
            bad.result(timeout=2)
        st = mb.stats()
    assert st["poison_requests"] == 1 and st["split_retries"] >= 1
    assert st["engine_failures"] >= 1 and st["breaker_trips"] == 0


def test_nonfinite_output_fails_only_that_request():
    cache = ResultCache(8)
    with MicroBatcher(DoublerEngine(), max_batch=4, max_wait_ms=2000.0, cache=cache) as mb:
        good = mb.submit("g", _x(1))
        nan = mb.submit("n", np.full((3, 4), np.nan, np.float32))
        np.testing.assert_array_equal(good.result(timeout=2).y, _x(2))
        with pytest.raises(NonFiniteOutputError, match="non-finite"):
            nan.result(timeout=2)
        assert mb.stats()["nonfinite_outputs"] == 1
    assert cache.keys() == [("doubler-v1", "g")]  # the refused result was never cached


@pytest.mark.parametrize("fail_until,trips,calls", [(2, 1, 3), (3, 2, 4)])
def test_circuit_breaker_trips_then_heals_or_reopens(fail_until, trips, calls):
    """Two consecutive failures open the breaker (fail fast, engine
    untouched); after the cooldown a half-open probe closes it, or, when
    the probe fails too, re-opens it until the next cooldown."""
    eng = DoublerEngine(fail_until=fail_until)
    with MicroBatcher(eng, max_batch=1, max_wait_ms=1.0, breaker_threshold=2, breaker_cooldown_s=0.15) as mb:
        for i in range(2):
            with pytest.raises(RuntimeError, match="down"):
                mb.submit(f"f{i}", _x(i)).result(timeout=2)
        assert mb.stats()["breaker_state"] == "open"
        with pytest.raises(CircuitOpenError):
            mb.submit("rejected", _x(9)).result(timeout=2)
        assert eng.calls == 2
        time.sleep(0.2)                      # cooldown elapses → half-open
        if fail_until == 3:
            with pytest.raises(RuntimeError, match="down"):
                mb.submit("probe", _x(7)).result(timeout=2)
            assert mb.stats()["breaker_state"] == "open"
            time.sleep(0.2)
        ok = mb.submit("heal", _x(5)).result(timeout=2)
        np.testing.assert_array_equal(ok.y, _x(10))
        st = mb.stats()
    assert st["breaker_state"] == "closed" and st["breaker_trips"] == trips
    assert st["breaker_rejected"] == 1 and st["engine_failures"] == fail_until and eng.calls == calls


def test_served_results_are_host_arrays_and_faulty_engine_delegates():
    """``--inject``'s wrapper around a port engine: the signature carries the
    spec, the engine's attributes show through, and the batcher's split-retry
    gives every request its result."""
    from repro_torch.core import faults

    _, eng = _engines("surrogate")
    bad = faults.wrap_engine(faults.parse("fail_infer_every_n=1,limit=1"), eng)
    assert bad.signature().startswith(eng.signature()) and bad.buckets == (8,) and bad.nt == NT
    with MicroBatcher(bad, max_batch=2, max_wait_ms=2000.0) as mb:
        futs = [mb.submit(f"r{i}", waves(1, seed=i)) for i in range(2)]
        out = [f.result(timeout=60) for f in futs]
        st = mb.stats()
    assert st["split_retries"] == 1 and st["engine_failures"] == 1 and st["poison_requests"] == 0
    for i, r in enumerate(out):
        assert isinstance(r.y, np.ndarray) and r.y.shape == (1, NT, 3)
        np.testing.assert_array_equal(r.y, eng.infer(waves(1, seed=i)).y)


def test_engine_configs_hold_the_reference_fields():
    """The signatures hash ``dataclasses.asdict`` of these configs, so the
    port's must have the reference's fields and defaults."""
    from repro.serving.decode import ServeConfig as RefServe

    for ref_cls, cls in ((ref_model.SurrogateConfig, model.SurrogateConfig),
                         (ref_seq.TrajectoryConfig, seqmodel.TrajectoryConfig), (RefServe, ServeConfig)):
        assert dataclasses.asdict(cls()) == dataclasses.asdict(ref_cls())
        assert [f.name for f in dataclasses.fields(cls)] == [f.name for f in dataclasses.fields(ref_cls)]
