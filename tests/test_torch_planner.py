"""The port's planner execution (``run_group``/``run_plan``), its manifests
and the campaign CLI's sweep modes against the JAX package's, on the CPU,
at the reference tests' sizes: mesh (2, 2, 2), 2 cases a scenario, nt 6,
nspring 12, the soil axis of tests/test_scheduler.py (two compile groups).
The reference runs in x64.

Tolerances: responses within 1e-6·max|v| (Proposed 2: the fp32 inner
solve sums in another order than XLA's), max|v| taken over the whole run
as tests/test_torch_campaign.py takes it over a campaign (a scenario whose
response is 100× smaller than its group's sits at the solver's relative
tolerance of the group), waves bitwise; manifests equal
apart from the time fields (``wall_s``, ``cases_per_s``); the model's
tuned choices, health records and quarantine lists exactly equal."""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest

from repro import scenario as ref_sc
from repro.core import faults as ref_faults
from repro.surrogate import dataset as ref_dataset
from repro_torch import scenario as sc
from repro_torch.core import faults
from repro_torch.scenario import autotune, planner
from repro_torch.serving.feedback import FeedbackLog
from repro_torch.surrogate import dataset

VS_AXIS = ("soil.vs", ((0.8, 1.0), (1.0, 1.0)))
TIME_FIELDS = ("wall_s", "cases_per_s")


def _spec(pkg, **kw):
    base = dict(mesh_n=(2, 2, 2), n_cases=2, nt=6, **kw)
    return pkg.SweepSpec(base=pkg.Scenario(**base), axes=(VS_AXIS,))


def _strip(m):
    """A manifest without its time fields."""
    m = json.loads(json.dumps(m))
    for g in m["groups"]:
        for k in TIME_FIELDS:
            g.pop(k, None)
    return m


def _load(path):
    with open(path) as f:
        return json.load(f)


def _assert_shards_close(port_dir, ref_dir, names):
    """Shards of each scenario: waves bitwise, responses within 1e-6·max|y|
    over all of them."""
    port = {n: dataset.load_shards(str(port_dir / n)) for n in names}
    ref = {n: ref_dataset.load_shards(str(ref_dir / n)) for n in names}
    scale = max(np.abs(y).max() for _, y in ref.values())
    assert scale > 0
    for n in names:
        np.testing.assert_array_equal(port[n][0], ref[n][0])
        np.testing.assert_allclose(port[n][1], ref[n][1], atol=1e-6 * scale, rtol=0)
        assert dataset.shard_meta(str(port_dir / n))["n"] == len(port[n][0])


def _assert_responses_close(a, b):
    """Port results ``a`` against reference results ``b``, scenario by scenario."""
    assert sorted(a) == sorted(b)
    scale = max(np.abs(np.asarray(r.responses)).max() for r in b.values())
    assert scale > 0
    for name in a:
        np.testing.assert_array_equal(a[name].waves, b[name].waves)
        rb = np.asarray(b[name].responses)
        assert a[name].responses.shape == rb.shape
        np.testing.assert_allclose(a[name].responses, rb, atol=1e-6 * scale, rtol=0)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One autotuned (model) two-group sweep through both packages, with
    checkpoints and shards."""
    root = tmp_path_factory.mktemp("plan")
    kw = dict(autotune=True, ckpt_every=4, shard_size=1)
    port = sc.run_plan(sc.make_plan(_spec(sc)), device="cpu", ckpt_dir=str(root / "p_ck"),
                       out_dir=str(root / "p_out"), **kw)
    with jax.enable_x64(True):
        ref = ref_sc.run_plan(ref_sc.make_plan(_spec(ref_sc)), ckpt_dir=str(root / "r_ck"),
                              out_dir=str(root / "r_out"), **kw)
    return root, port, ref


def test_run_plan_matches_reference(runs):
    root, port, ref = runs
    assert len(port.plan.groups) == 2 and port.plan.n_scenarios == 2
    assert all(st["completed"] and not st.get("failed") for st in port.group_stats.values())
    _assert_responses_close(port.scenarios, ref.scenarios)
    mp, mr = _load(port.manifest_path), _load(ref.manifest_path)
    assert _strip(mp) == _strip(mr)
    assert all(g["choice"]["source"] == "model" and g["health"]["diverged"] == [] for g in mp["groups"])
    _assert_shards_close(root / "p_out", root / "r_out", list(port.scenarios))


def test_prior_choices_cross_packages(runs):
    root, port, ref = runs
    mine = planner._prior_choices(port.manifest_path)
    theirs = planner._prior_choices(ref.manifest_path)
    assert mine == theirs and len(mine) == 2
    assert all(isinstance(c, autotune.TuneChoice) for c in theirs.values())
    assert {k: dataclasses.asdict(v) for k, v in ref_sc.planner._prior_choices(port.manifest_path).items()} == \
        {k: dataclasses.asdict(v) for k, v in mine.items()}
    assert planner._prior_choices(str(root / "none.json")) == {} and planner._prior_choices(None) == {}


def test_resumed_plan_reuses_recorded_choices(runs, monkeypatch):
    """A relaunched --autotune sweep re-uses the manifest's choices instead of
    re-tuning (a probe re-run could flip the winner and refuse the group's
    own checkpoint): choose() must not run, and the result is the first
    run's, restored from the banked rounds."""
    root, port, _ = runs

    def boom(*a, **k):
        raise AssertionError("choose() must not re-run on resume")

    monkeypatch.setattr(autotune, "choose", boom)
    plan = sc.make_plan(_spec(sc))
    again = sc.run_plan(plan, device="cpu", autotune=True, ckpt_every=4, ckpt_dir=str(root / "p_ck"))
    assert len(again.scenarios) == 2
    assert [g.choice for g in plan.groups] == [g.choice for g in port.plan.groups]
    for name, sr in again.scenarios.items():
        np.testing.assert_array_equal(sr.responses, port.scenarios[name].responses)


def test_resume_under_changed_scenario_refused(tmp_path):
    """scenario_sig closes the soil hole: a soil perturbation changes the mesh
    but not the waves or the config, so only the scenario signature can
    refuse the checkpoint."""
    from repro_torch.campaign import CampaignConfig, run_campaign

    a = sc.Scenario(mesh_n=(2, 2, 2), n_cases=2, nt=6)
    b = dataclasses.replace(a, soil=sc.SoilSpec(vs=(0.8, 1.0)))
    waves = a.waves()
    np.testing.assert_array_equal(waves, b.waves())
    cc = CampaignConfig(kset=2, method="proposed2", checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=2,
                        scenario_sig=a.signature())
    part = run_campaign(a.build_mesh(), a.sim_config(), waves, campaign=cc, device="cpu", stop_after_steps=3)
    assert not part.completed
    with pytest.raises(ValueError, match="different campaign"):
        run_campaign(b.build_mesh(), a.sim_config(), waves, device="cpu",
                     campaign=dataclasses.replace(cc, scenario_sig=b.signature()))
    res = run_campaign(a.build_mesh(), a.sim_config(), waves, campaign=cc, device="cpu")
    assert res.completed and res.resumed_from is not None


def test_injected_nan_gives_the_reference_quarantine(tmp_path, monkeypatch):
    """A NaN in case 1's wave: the same health record as the reference's,
    and the case left out of the shards."""
    scn, rscn = (pkg.Scenario(name="hq", n_cases=3, nt=6, mesh_n=(2, 2, 2)) for pkg in (sc, ref_sc))
    port_waves, ref_waves = sc.Scenario.waves, ref_sc.Scenario.waves
    monkeypatch.setattr(sc.Scenario, "waves", lambda self: faults.nan_at_step(port_waves(self), 3, case=1))
    monkeypatch.setattr(ref_sc.Scenario, "waves", lambda self: ref_faults.nan_at_step(ref_waves(self), 3, case=1))
    plan, rplan = sc.make_plan([scn]), ref_sc.make_plan([rscn])
    res, st = sc.run_group(plan.groups[0], device="cpu", out_dir=str(tmp_path / "p"))
    with jax.enable_x64(True):
        rres, rst = ref_sc.run_group(rplan.groups[0], out_dir=str(tmp_path / "r"))
    assert st["health"] == rst["health"] and st["health"]["diverged"] == [1]
    assert st["mean_iters"] == rst["mean_iters"]
    x, y = dataset.load_shards(str(tmp_path / "p" / "hq"))
    rx, _ = ref_dataset.load_shards(str(tmp_path / "r" / "hq"))
    assert len(x) == 2 and np.isfinite(y).all()
    np.testing.assert_array_equal(x, rx)
    mpath = sc.write_manifest(plan, str(tmp_path / "plan.json"), {plan.groups[0].key: st})
    assert _load(mpath)["groups"][0]["health"]["diverged"] == [1]


def test_failed_group_is_recorded_and_the_next_runs(tmp_path, monkeypatch):
    plan = sc.make_plan(_spec(sc))
    bad = plan.groups[0].key

    def runner(group, **kw):
        if group.key == bad:
            raise RuntimeError("mesh went singular")
        name = group.scenarios[0].name
        sr = planner.ScenarioResult(scenario=group.scenarios[0], waves=np.zeros((1, 4, 3), np.float32),
                                    responses=np.zeros((1, 4, 1, 3), np.float32))
        return {name: sr}, {"completed": True, "wall_s": 0.01, "cases_per_s": 1.0, "mean_iters": 1.0}

    monkeypatch.setattr(planner, "run_group", runner)
    run = sc.run_plan(plan, ckpt_dir=str(tmp_path / "ck"))
    assert run.group_stats[bad]["failed"] and "mesh went singular" in run.group_stats[bad]["error"]
    assert len(run.scenarios) == 1
    recs = {g["key"]: g for g in _load(run.manifest_path)["groups"]}
    assert recs[bad]["failed"] and recs[plan.groups[1].key]["completed"]


def test_write_manifest_survives_concurrent_writers(tmp_path):
    """Queue workers write one plan's manifest as their groups settle: four
    threads writing at once never fail, and the file always parses (the
    reference's shared ``.tmp`` name fails here with FileNotFoundError)."""
    import threading

    plan, path, errors = sc.make_plan(_spec(sc)), str(tmp_path / "plan.json"), []

    def write():
        try:
            for _ in range(200):
                sc.write_manifest(plan, path, {})
        except OSError as e:
            errors.append(e)

    threads = [threading.Thread(target=write) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and errors == []
    assert _load(path)["n_scenarios"] == 2 and os.listdir(tmp_path) == ["plan.json"]


def test_run_group_refuses_a_device_mesh(tmp_path):
    """Several devices in one process run rounds of ``kset × 2``: the
    group's two cases sit in entry 0's k-set as in the one-device run, so
    its responses are bitwise that run's.  A process mesh with ``out_dir``
    is refused (every process would write the same shards)."""
    from repro_torch.launch.mesh import CaseDevice, CaseMesh

    group = sc.make_plan(_spec(sc)).groups[0]
    two_here = CaseMesh(np.array([CaseDevice(0, "cpu")] * 2, dtype=object))
    one, _ = sc.run_group(group, device="cpu")
    two, st = sc.run_group(dataclasses.replace(group, choice=None), device="cpu", device_mesh=two_here)
    assert st["completed"] and sorted(two) == sorted(one)
    for name in one:
        np.testing.assert_array_equal(two[name].responses, one[name].responses)
    two_processes = CaseMesh(np.array([CaseDevice(0, "cpu"), CaseDevice(1, "cpu")], dtype=object))
    with pytest.raises(ValueError, match="every process would write the same"):
        sc.run_group(group, device="cpu", device_mesh=two_processes, out_dir=str(tmp_path / "out"))
    assert not os.path.exists(tmp_path / "out")


def test_generate_sweep_pools_like_the_reference(tmp_path):
    spec_kw = dict(base=dict(mesh_n=(2, 2, 2), n_cases=1, nt=4), axes=(("wave.family", ("band_noise", "ricker")),))
    spec = sc.SweepSpec(base=sc.Scenario(**spec_kw["base"]), axes=spec_kw["axes"])
    x, y = dataset.generate_sweep(spec, device="cpu", out_dir=str(tmp_path / "out"))
    with jax.enable_x64(True):
        rx, ry = ref_dataset.generate_sweep(ref_sc.SweepSpec(base=ref_sc.Scenario(**spec_kw["base"]),
                                                             axes=spec_kw["axes"]))
    assert x.shape == rx.shape == (2, 4, 3) and x.dtype == y.dtype == np.float32
    np.testing.assert_array_equal(x, rx)
    np.testing.assert_allclose(y, ry, atol=1e-6 * np.abs(ry).max(), rtol=0)
    dirs = [d for d in sorted(os.listdir(tmp_path / "out")) if (tmp_path / "out" / d).is_dir()]
    assert len(dirs) == 2 and all(dataset.load_shards(str(tmp_path / "out" / d))[0].shape == (1, 4, 3) for d in dirs)


def _cli_args(mode, tmp_path):
    if mode == "sweep":
        spec = {"base": {"n_cases": 2, "nt": 6, "mesh_n": [2, 2, 2]}, "axes": {"soil.vs": [[0.8, 1.0], [1.0, 1.0]]}}
        return ["--sweep", json.dumps(spec)]
    if mode == "scenario":
        return ["--scenario", "ricker-soft-basin", "--waves", "2", "--nt", "6", "--mesh-n", "2x2x2"]
    log = FeedbackLog(str(tmp_path / "feedback.jsonl"), threshold=0.0)
    for fam in ("ricker", "chirp"):  # the serving tier's routed scenarios
        log.observe(sc.Scenario(name=f"fb-{fam}", wave=sc.WaveSpec(family=fam), n_cases=1, nt=6,
                                mesh_n=(2, 2, 2)), score=0.5)
    return ["--scenarios", str(tmp_path / "feedback.jsonl")]


@pytest.mark.parametrize("mode", ["sweep", "scenario", "scenarios"])
def test_cli_modes_write_the_reference_shards_and_manifest(tmp_path, mode, capsys):
    from repro_torch.launch import campaign as cli

    args = _cli_args(mode, tmp_path)
    got = {}
    assert cli.main([*args, "--device", "cpu", "--out", str(tmp_path / "p"), "--shard-size", "1"], result=got) == 0
    out = capsys.readouterr().out
    assert "compile group(s)" in out and "[done]" in out and "[plan] manifest" in out
    with jax.enable_x64(True):
        from repro.launch import campaign as ref_cli

        assert ref_cli.main([*args, "--out", str(tmp_path / "r"), "--shard-size", "1"]) == 0
    mp, mr = _load(tmp_path / "p" / "plan.json"), _load(tmp_path / "r" / "plan.json")
    assert _strip(mp) == _strip(mr)
    names = [s["name"] for g in mp["groups"] for s in g["scenarios"]]
    assert sorted(got["plan_run"].scenarios) == sorted(names)
    _assert_shards_close(tmp_path / "p", tmp_path / "r", names)
