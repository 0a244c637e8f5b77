"""The port's shard stream and its consumers against the JAX package's, on
the same shard directories on the CPU.

``ShardStream`` walks the reference's order for every layout, replays the
recorded paths on re-iteration, re-loads any consumed shard by index,
blocks until the next scenario in order commits (``wait_s``) and times out
on a scenario that never does; ``plan_scenario_order`` reads the same
manifests.  Live ``fit_stream`` over a cache a writer thread is still
filling ≡ post-hoc ``fit_shards`` (val MAE within 1e-6, as the
reference's test holds it; params within 1e-6), in plan order, and the
port's ``fit_shards`` against the reference's from the same init on the
same directory within 1e-4 relative (val MAE and every history entry).
Shards hold one row of 15 samples, so every gradient sum of MAE signs has
an odd count (see ``_pairs``).
"""
import json
import os
import threading
import time

import jax
import numpy as np
import pytest

from repro.surrogate import dataset as ref_dataset
from repro.surrogate import model as ref_model
from repro.surrogate import train as ref_train
from repro_torch import convert
from repro_torch.surrogate import dataset, model, train

PLAN = ["zeta_first", "alpha_second", "mid_third"]  # sorted() reorders these


def _pairs(n, nt=15, seed=0):
    """Smooth waves and a saturating response.  ``nt`` odd: a head bias's
    MAE gradient is a sum of ±1/(B·T) terms; with an odd count it cannot
    cancel to an exact zero, which the reference's fp32 reduction leaves
    as a ~1e-9 residue that Adam's first step scales up to 0.16·lr."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 4 * np.pi, nt)
    x = rng.uniform(0.5, 1.5, (n, 1, 3)) * np.sin(t[None, :, None] + rng.uniform(0, 2 * np.pi, (n, 1, 3)))
    return x.astype(np.float32), np.tanh(1.5 * x).astype(np.float32)


def _write_cache(out, names=PLAN, rows=2, delay=0.0):
    for i, name in enumerate(names):
        if delay:
            time.sleep(delay)
        dataset.save_shards(os.path.join(out, name), *_pairs(rows, seed=i), shard_size=1)


def _write_plan(out, names=PLAN):
    with open(os.path.join(out, "plan.json"), "w") as f:
        json.dump({"groups": [{"scenarios": [{"name": n}]} for n in names]}, f)


def test_plan_scenario_order_reads_the_reference_manifests(tmp_path):
    cases = {
        "plan": {"groups": [{"scenarios": [{"name": "b"}, {"name": "a"}]}, {"scenarios": [{"name": "c"}]}]},
        "unnamed": {"groups": [{"scenarios": [{"name": ""}, {"x": 1}]}]},
        "nogroups": {"other": 1},
    }
    for name, body in cases.items():
        with open(tmp_path / f"{name}.json", "w") as f:
            json.dump(body, f)
    (tmp_path / "broken.json").write_text("{not json")
    for name in (*cases, "broken", "absent"):
        path = str(tmp_path / f"{name}.json")
        assert dataset.plan_scenario_order(path) == ref_dataset.plan_scenario_order(path)
    assert dataset.plan_scenario_order(str(tmp_path / "plan.json")) == ["b", "a", "c"]
    assert dataset.plan_scenario_order(str(tmp_path / "absent.json")) is None


@pytest.mark.parametrize("layout", ["flat", "processes", "scenarios"])
def test_stream_order_replay_and_getitem_match_the_reference(tmp_path, layout):
    out = str(tmp_path / "out")
    if layout == "flat":
        dataset.save_shards(out, *_pairs(5), shard_size=2)
    elif layout == "processes":
        for p in (10, 2):  # numeric (p02 before p10), not lexical
            dataset.save_shards(os.path.join(out, f"p{p:02d}"), *_pairs(3, seed=p), shard_size=2)
    else:
        _write_cache(out)
    streams = [dataset.ShardStream.from_dir(out), ref_dataset.ShardStream.from_dir(out)]
    if layout == "scenarios":
        streams += [dataset.ShardStream.from_cache(out, PLAN), ref_dataset.ShardStream.from_cache(out, PLAN)]
    for port, ref in zip(streams[::2], streams[1::2]):
        got, want = list(port), list(ref)
        assert port.paths == ref.paths and len(got) == len(want) > 1
        for (xa, ya), (xb, yb) in zip(got, want):
            np.testing.assert_array_equal(xa, xb, strict=True)
            np.testing.assert_array_equal(ya, yb, strict=True)
        again = list(port)  # re-iteration replays the recorded order
        assert len(again) == len(got) and all(np.array_equal(a[0], b[0]) for a, b in zip(again, got))
        for i in (0, len(got) - 1):
            np.testing.assert_array_equal(port[i][1], got[i][1], strict=True)
        assert port.wait_s == 0.0 or layout == "scenarios"
    if layout == "scenarios":  # plan order, not sorted names
        assert [os.path.basename(os.path.dirname(p)) for p in streams[2].paths] == [n for n in PLAN for _ in (0, 1)]


def test_stream_blocks_until_commit_and_times_out(tmp_path):
    out = str(tmp_path / "out")
    writer = threading.Thread(target=_write_cache, args=(out, PLAN[:2]), kwargs=dict(delay=0.2), daemon=True)
    writer.start()
    stream = dataset.ShardStream.from_cache(out, PLAN[:2], poll_s=0.01, timeout_s=30.0)
    n = sum(1 for _ in stream)
    writer.join(timeout=30.0)
    assert not writer.is_alive() and n == 4 and stream.wait_s > 0.1
    dead = dataset.ShardStream.from_cache(str(tmp_path), ["never-arrives"], poll_s=0.01, timeout_s=0.05)
    with pytest.raises(TimeoutError, match="not committed"):
        list(dead)


def test_fit_stream_live_equals_posthoc_fit_shards(tmp_path):
    """A trainer consuming the cache WHILE a writer commits it reaches the
    params a post-hoc ``fit_shards`` reaches on the finished directory: the
    batch order is a function of (plan order, seed), never arrival timing.
    An explicit ``order=`` or a ``plan.json`` fixes plan order; the
    sorted-name fallback is another batch sequence."""
    out = str(tmp_path / "out")
    writer = threading.Thread(target=_write_cache, args=(out,), kwargs=dict(delay=0.3), daemon=True)
    writer.start()
    cfg = model.SurrogateConfig(n_c=2, n_lstm=1, kernel=5, latent=16, lr=3e-3)
    kw = dict(steps=8, batch=2, val_shards=1, steps_per_shard=2, seed=0, device="cpu")
    stream = dataset.ShardStream.from_cache(out, PLAN, poll_s=0.01, timeout_s=60.0)
    params_live, live = train.fit_stream(cfg, stream, **kw)
    writer.join(timeout=60.0)
    assert not writer.is_alive()
    assert live["n_shards"] == 6 and live["stream_wait_s"] > 0.0  # it really overlapped

    params_post, post = train.fit_shards(cfg, out, order=PLAN, **kw)
    assert post["val_mae"] == pytest.approx(live["val_mae"], abs=1e-6)
    assert [h[0] for h in live["history"]] == [h[0] for h in post["history"]]
    np.testing.assert_allclose(params_live["enc"][0]["w"].numpy(), params_post["enc"][0]["w"].numpy(), atol=1e-6)
    _write_plan(out)
    assert train.fit_shards(cfg, out, **kw)[1]["val_mae"] == pytest.approx(live["val_mae"], abs=1e-6)
    sorted_run = train.fit_stream(cfg, dataset.ShardStream.from_dir(out), **kw)[1]
    assert sorted_run["val_mae"] != pytest.approx(live["val_mae"], abs=1e-7)
    with pytest.raises(ValueError, match="only the 2 validation"):
        train.fit_shards(cfg, os.path.join(out, PLAN[0]), **{**kw, "steps": 1, "val_shards": 2})


def test_fit_shards_matches_the_reference(tmp_path):
    """The same shard directory (with its plan.json) through both packages'
    ``fit_shards`` from the reference's init: both phases (the streaming
    window and the full-dataset draws) in step."""
    out = str(tmp_path / "out")
    _write_cache(out, rows=3)
    _write_plan(out)
    kw = dict(n_c=2, n_lstm=1, kernel=5, latent=16, lr=3e-3)
    rcfg, cfg = ref_model.SurrogateConfig(**kw), model.SurrogateConfig(**kw)
    pn = jax.tree_util.tree_map(np.asarray, ref_model.init_params(rcfg, jax.random.key(0)))

    class Shim:
        init_params = staticmethod(lambda cfg, gen, device: convert.surrogate_params_from_numpy(pn, device))
        mae_loss = staticmethod(model.mae_loss)
        predict = staticmethod(model.predict)

    fit_kw = dict(steps=30, batch=2, val_shards=2, steps_per_shard=3, window=3, seed=0)
    _, want = ref_train.fit_shards(rcfg, out, **fit_kw)
    _, got = train.fit_shards(cfg, out, model=Shim, device="cpu", **fit_kw)
    assert (got["n_shards"], got["scale"]) == (want["n_shards"], want["scale"]) == (9, got["scale"])
    assert got["val_mae"] == pytest.approx(want["val_mae"], rel=1e-4)
    assert [h[0] for h in got["history"]] == [h[0] for h in want["history"]] == [0, 25, 29]
    for (_, lw, vw), (_, lg, vg) in zip(want["history"], got["history"]):
        assert lg == pytest.approx(lw, rel=1e-4) and vg == pytest.approx(vw, rel=1e-4)
