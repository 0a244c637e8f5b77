"""The port's active-learning loop and serve CLI against the JAX package's,
on the CPU: the planner's declarative half (``expand``, ``make_plan``,
``manifest``) gives the reference's scenario names, signatures, group keys
and manifests on ``tests/test_scenario.py``'s sweeps; ``load_feedback``'s
edge cases; feedback logs written by either package load in the other as
the same scenarios; and ``python -m repro_torch.launch.serve`` in-process
(``--device cpu``) for all three engines, the surrogate one writing the
reference CLI's feedback records on the same checkpoint (scores within
1e-5)."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro import scenario as ref_sc
from repro.launch import serve as ref_serve
from repro.scenario.catalog import Scenario as RefScenario, WaveSpec as RefWaveSpec
from repro.serving import FeedbackLog as RefFeedbackLog, load_feedback as ref_load_feedback
from repro_torch import scenario as sc
from repro_torch.launch import serve
from repro_torch.scenario.catalog import ObsSpec, Scenario, SoilSpec, WaveSpec
from repro_torch.serving import FeedbackLog, MicroBatcher, SurrogateEngine, feedback_plan, load_feedback
from repro_torch.surrogate import model, seqmodel, train, trajectory

NT = 16


def _tiny(pkg=sc, **kw):
    kw.setdefault("mesh_n", (2, 2, 2))
    kw.setdefault("n_cases", 2)
    kw.setdefault("nt", 6)
    return pkg.Scenario(**kw)


_AXES = (
    ("wave.family", ("band_noise", "ricker")),
    ("soil.vs", ((1.0, 1.0), (0.8, 1.0))),
)
_JSON_SPEC = json.dumps({
    "base": {"n_cases": 2, "nt": 6, "mesh_n": [2, 2, 2], "wave": {"fmax": 3.0}},
    "axes": {"wave.family": ["band_noise", "chirp"]},
})


def _specs(pkg):
    full = pkg.SweepSpec(base=_tiny(pkg), axes=_AXES)
    return {"grid": full, "sampled": dataclasses.replace(full, samples=3, seed=1),
            "json": pkg.sweep_from_json(_JSON_SPEC), "no_axes": pkg.SweepSpec(base=_tiny(pkg))}


# ---------------------------------------------------------------------------
# planner, declarative half
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["grid", "sampled", "json", "no_axes"])
def test_planner_matches_reference(case):
    spec, ref_spec = _specs(sc)[case], _specs(ref_sc)[case]
    scns, ref_scns = sc.expand(spec), ref_sc.expand(ref_spec)
    assert [s.name for s in scns] == [s.name for s in ref_scns]
    assert [s.signature() for s in scns] == [s.signature() for s in ref_scns]
    assert [dataclasses.asdict(s) for s in scns] == [dataclasses.asdict(s) for s in ref_scns]
    plan, ref_plan = sc.make_plan(spec), ref_sc.make_plan(ref_spec)
    assert [g.key for g in plan.groups] == [g.key for g in ref_plan.groups]
    assert [g.signature() for g in plan.groups] == [g.signature() for g in ref_plan.groups]
    assert (plan.n_scenarios, plan.n_cases) == (ref_plan.n_scenarios, ref_plan.n_cases)
    assert sc.manifest(plan) == ref_sc.manifest(ref_plan)
    assert json.dumps(sc.manifest(plan)) == json.dumps(ref_sc.manifest(ref_plan))


def test_planner_groups_and_refusals():
    plan = sc.make_plan(sc.SweepSpec(base=_tiny(), axes=_AXES))
    assert plan.n_scenarios == 4 and plan.n_cases == 8 and len(plan.groups) == 2  # one per soil profile
    for g in plan.groups:
        assert {s.compile_key() for s in g.scenarios} == {g.key} and g.case_slices() == [(0, 2), (2, 4)]
    with pytest.raises(ValueError, match="unknown sweep axis"):
        sc.expand(sc.SweepSpec(base=_tiny(), axes=(("wave.nope", (1, 2)),)))
    with pytest.raises(ValueError, match="nests too deep"):
        sc.expand(sc.SweepSpec(base=_tiny(), axes=(("wave.fmax.x", (1, 2)),)))
    with pytest.raises(ValueError, match="no values"):
        sc.SweepSpec(base=_tiny(), axes=(("seed", ()),))
    with pytest.raises(ValueError, match="neither"):
        sc.sweep_from_json("{not json")
    with pytest.raises(ValueError, match="bad scenario field"):
        sc.scenario_from_dict({"nope": 1})


# ---------------------------------------------------------------------------
# feedback log
# ---------------------------------------------------------------------------

BASE = Scenario(name="fb", wave=WaveSpec(family="ricker"), n_cases=2, nt=NT, mesh_n=(2, 2, 2), nspring=3)
REF_BASE = RefScenario(name="fb", wave=RefWaveSpec(family="ricker"), n_cases=2, nt=NT, mesh_n=(2, 2, 2), nspring=3)


def test_feedback_roundtrip_to_plan(tmp_path):
    path = str(tmp_path / "fb.jsonl")
    fb = FeedbackLog(path, threshold=0.1)
    other = dataclasses.replace(BASE, wave=WaveSpec(family="band_noise"))
    assert fb.observe(BASE, 0.5, key="a")
    assert not fb.observe(BASE, 0.9)            # duplicate signature
    assert not fb.observe(other, 0.05)          # below threshold
    assert not fb.observe("not-a-scenario", 9)  # non-scenario meta
    assert fb.observe(other, 0.2)
    assert fb.stats()["routed"] == 2 and fb.stats()["observed"] == 5
    assert [s.signature() for s in load_feedback(path)] == [BASE.signature(), other.signature()]
    plan = feedback_plan(path)
    assert plan.n_scenarios == 2
    assert {s.compile_key() for g in plan.groups for s in g.scenarios} == {BASE.compile_key()}
    with pytest.raises(ValueError, match="threshold"):
        FeedbackLog(path, threshold=-1.0)


def test_feedback_name_collisions_get_signature_suffix(tmp_path):
    path = str(tmp_path / "fb.jsonl")
    fb = FeedbackLog(path, threshold=0.0)
    fb.observe(BASE, 1.0)
    fb.observe(dataclasses.replace(BASE, seed=9), 1.0)  # same name, new physics
    names = [s.name for s in load_feedback(path)]
    assert len(set(names)) == 2 and names[0] == "fb"
    assert names[1] == f"fb-{dataclasses.replace(BASE, seed=9).signature()[:6]}"


def test_feedback_torn_tail_tolerated_malformed_interior_raises(tmp_path):
    path = str(tmp_path / "fb.jsonl")
    FeedbackLog(path, threshold=0.0).observe(BASE, 1.0)
    with open(path, "a") as f:
        f.write('{"torn": ')          # killed mid-append
    assert len(load_feedback(path)) == 1
    with open(path, "a") as f:
        f.write("\n")                 # now the torn record is *interior*
        f.write(json.dumps({"scenario": {}}) + "\n")
    with pytest.raises(ValueError, match="malformed"):
        load_feedback(path)


def test_feedback_signature_mismatch_raises(tmp_path):
    path = str(tmp_path / "fb.jsonl")
    FeedbackLog(path, threshold=0.0).observe(BASE, 1.0)
    with open(path) as f:
        rec = json.loads(f.read())
    rec["scenario"]["seed"] = rec["scenario"]["seed"] + 1  # edit the physics
    with open(path, "w") as f:
        f.write(json.dumps(rec) + "\n")
    with pytest.raises(ValueError, match="hashes to"):
        load_feedback(path)
    empty = str(tmp_path / "empty.jsonl")
    open(empty, "w").close()
    with pytest.raises(ValueError, match="no scenario records"):
        feedback_plan(empty)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_feedback_logs_cross_packages(tmp_path, writer):
    """A log written by either package loads in the other as the same
    scenarios (fields, signatures, names with collision suffixes)."""
    path = str(tmp_path / "fb.jsonl")
    variants = [{}, {"seed": 9}, {"soil": "soft"}, {"obs": (2, 2)}]

    def make(base, pkg_soil, pkg_obs, v):
        kw = {"seed": v.get("seed", 0)}
        if "soil" in v:
            kw["soil"] = pkg_soil(vs=(0.8, 1.0))
        if "obs" in v:
            kw["obs"] = pkg_obs(grid=v["obs"])
        return dataclasses.replace(base, **kw)

    from repro.scenario.catalog import ObsSpec as RefObs, SoilSpec as RefSoil

    log = RefFeedbackLog(path, threshold=0.0) if writer == "reference" else FeedbackLog(path, threshold=0.0)
    base, soil, obs = (REF_BASE, RefSoil, RefObs) if writer == "reference" else (BASE, SoilSpec, ObsSpec)
    for i, v in enumerate(variants):
        assert log.observe(make(base, soil, obs, v), 0.5 + i, key=f"k{i}")
    ours, theirs = load_feedback(path), ref_load_feedback(path)
    assert [s.signature() for s in ours] == [s.signature() for s in theirs]
    assert [s.name for s in ours] == [s.name for s in theirs]
    assert [dataclasses.asdict(s) for s in ours] == [dataclasses.asdict(s) for s in theirs]
    assert len({s.name for s in ours}) == len(variants)


def test_batcher_routes_high_uncertainty_to_feedback(tmp_path):
    cfg = model.SurrogateConfig(n_c=2, n_lstm=1, latent=8)
    members = [model.init_params(cfg, torch.Generator().manual_seed(s), device="cpu") for s in (0, 1)]
    engine = SurrogateEngine(cfg, members, scale=2.0, buckets=(8,), nt=NT, device="cpu")
    path = str(tmp_path / "fb.jsonl")
    with MicroBatcher(engine, max_batch=2, max_wait_ms=5.0, feedback=FeedbackLog(path, threshold=0.0)) as mb:
        r = mb.submit(BASE.signature(), BASE.waves().astype(np.float32), meta=BASE).result(timeout=60)
    assert r.score > 0  # two disagreeing members
    plan = feedback_plan(path)
    assert plan.n_scenarios == 1 and plan.groups[0].scenarios[0].signature() == BASE.signature()


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------

SWEEP = json.dumps({"base": {"n_cases": 4, "nt": NT}, "axes": {"wave.family": ["ricker", "chirp", "band_noise"]}})


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_serve_cli_surrogate_writes_the_reference_records(tmp_path, capsys):
    cfg = model.SurrogateConfig(n_c=2, n_lstm=1, latent=8)
    members = [model.init_params(cfg, torch.Generator().manual_seed(s), device="cpu") for s in (0, 1)]
    ckpt = str(tmp_path / "ckpt")
    train.save_surrogate(ckpt, cfg, members, scale=2.0, step=4)
    flags = ["--engine", "surrogate", "--ckpt", ckpt, "--sweep", SWEEP, "--repeat", "2", "--feedback-threshold", "0",
             "--max-batch", "4"]  # a request (4 cases) a batch, whatever the timing
    result = {}
    assert serve.main(["--device", "cpu", *flags, "--feedback-out", str(tmp_path / "port.jsonl")], result) == 0
    out = capsys.readouterr().out
    assert ref_serve.main([*flags, "--feedback-out", str(tmp_path / "ref.jsonl")]) == 0
    ours, theirs = _records(tmp_path / "port.jsonl"), _records(tmp_path / "ref.jsonl")
    assert len(ours) == 3
    assert [{k: r[k] for k in ("signature", "key", "scenario")} for r in ours] == \
        [{k: r[k] for k in ("signature", "key", "scenario")} for r in theirs]
    assert max(abs(a["score"] - b["score"]) for a, b in zip(ours, theirs)) <= 1e-5
    st = result["stats"]
    assert st["requests"] == 6 and st["cache_hits"] == 3 and st["batches"] == st["flush_full"] == 3
    assert all(r.cached for rnd, _, r in result["served"] if rnd == 1)  # round 2: all cache hits
    assert result["feedback_plan"].n_scenarios == 3
    assert "feedback plan: 3 scenario(s) in 1 compile group(s)" in out and "cache: 3/256 entries, 3 hit(s)" in out


def test_serve_cli_trajectory_and_decode_report(tmp_path, capsys):
    tcfg = seqmodel.TrajectoryConfig(latent=8, state=4, n_layers=1, obs_every=2)
    members = [seqmodel.init_params(tcfg, torch.Generator().manual_seed(s), device="cpu") for s in (0, 1)]
    ckpt = str(tmp_path / "traj")
    trajectory.save_trajectory(ckpt, tcfg, members, scale=2.0, step=5)
    result = {}
    assert serve.main(["--device", "cpu", "--engine", "trajectory", "--ckpt", ckpt, "--repeat", "2", "--shard",
                       "--inject", "fail_infer_every_n=2,limit=1"], result) == 0
    out = capsys.readouterr().out
    (_, _, r0), (_, _, r1) = result["served"]
    assert r0.y.shape == (8, 32, 3) and r1.cached  # ricker-soft-basin: 8 cases × nt 64, every 2nd sample
    for line in ("[serve] trajectory step=5 members=2", "sharding batch axis over 1 device(s)",
                 "[inject] fail_infer_every_n=2,limit=1", "requests=2 rows=8 batches=1", "health: engine_failures=0",
                 "cache: 1/256 entries, 1 hit(s)"):
        assert line in out, line
    result = {}
    assert serve.main(["--device", "cpu", "--engine", "decode", "--arch", "qwen3-1.7b", "--reduced", "--batch", "3",
                       "--prompt-len", "5", "--new", "4", "--max-batch", "4", "--repeat", "2"], result) == 0
    out = capsys.readouterr().out
    assert result["tokens"].shape == (3, 4) and result["tokens"].dtype == np.int32
    for line in ("decode arch=qwen3-1.7b-reduced [KV resident] greedy on cpu", "generated 4 × batch 3",
                 "requests=6 rows=3", "cache_hits=3", "breaker_state=closed"):
        assert line in out, line
    offloaded = {}
    assert serve.main(["--device", "cpu", "--engine", "decode", "--arch", "qwen3-1.7b", "--batch", "3",
                       "--prompt-len", "5", "--new", "4", "--max-batch", "4", "--offload-kv", "--npart", "2",
                       "--kv-schedule", "prefetch"], offloaded) == 0
    np.testing.assert_array_equal(offloaded["tokens"], result["tokens"])
    assert "[KV host-offloaded, 2 blocks]" in capsys.readouterr().out


def test_serve_cli_refusals(tmp_path, capsys):
    assert serve.main(["--device", "cpu", "--engine", "surrogate"]) == 2
    assert "needs --ckpt" in capsys.readouterr().err
    cfg = model.SurrogateConfig(n_c=2, n_lstm=1, latent=8)
    ckpt = str(tmp_path / "ckpt")
    train.save_surrogate(ckpt, cfg, model.init_params(cfg, torch.Generator(), device="cpu"))
    two_nts = json.dumps({"base": {"n_cases": 1}, "axes": {"nt": [8, 16]}})
    assert serve.main(["--device", "cpu", "--ckpt", ckpt, "--sweep", two_nts]) == 2
    assert "disagree on nt" in capsys.readouterr().err
    # whisper needs frames beside its tokens: the decode engine refuses it, naming why
    assert serve.main(["--device", "cpu", "--engine", "decode", "--arch", "whisper-small"]) == 2
    err = capsys.readouterr().err
    assert "--arch whisper-small" in err and "frames" in err and "decode_step" in err
