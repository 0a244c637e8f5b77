"""The port's elastic scheduler (``repro_torch.scenario.scheduler``) on the
CPU: the reference tests' lease protocol (tests/test_scheduler.py) against
the port's :class:`JobQueue`, queue files that cross between the packages,
kill-and-rejoin (bitwise the port's serial ``run_plan``, within
1e-6·max|v| of the reference's), train-while-generating, the heartbeat
watchdog and a two-worker CLI run.  Sizes are the reference tests': mesh
(2, 2, 2), 2 cases a scenario, nt 6, nspring 12, the soil axis (two
compile groups); the reference runs in x64."""
import dataclasses
import errno
import fcntl
import json
import os
import threading
import time

import jax
import numpy as np
import pytest

from repro import scenario as ref_sc
from repro.scenario import scheduler as ref_sched
from repro_torch import scenario as sc
from repro_torch.scenario import scheduler as sched
from repro_torch.scenario.scheduler import JobQueue, LeaseLost, QueueWatch, SchedulerConfig, _beat, run_worker
from repro_torch.surrogate.dataset import ShardStream, load_shards, save_shards, shard_paths

VS_AXIS = ("soil.vs", ((0.8, 1.0), (1.0, 1.0)))
FAST = SchedulerConfig(lease_s=30.0, poll_s=0.02, backoff_s=0.01)


def _plan(pkg=sc, **base_kw):
    base = dict(mesh_n=(2, 2, 2), n_cases=2, nt=6, **base_kw)
    return pkg.make_plan(pkg.SweepSpec(base=pkg.Scenario(**base), axes=(VS_AXIS,)))


def _ok_stats():
    return {"completed": True, "wall_s": 0.01, "cases_per_s": 1.0, "mean_iters": 1.0}


def _load(path):
    with open(path) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# lease protocol (tests/test_scheduler.py:49-248, one case each)
# ---------------------------------------------------------------------------


def _exclusive_claim(tmp_path, plan):
    q = JobQueue.create(str(tmp_path), plan)
    key = plan.groups[0].key
    c = q.try_claim(key, "w0")
    assert c is not None and c.attempt == 1
    assert q.try_claim(key, "w1") is None          # filesystem arbitration
    assert q.state(key) == "leased"
    q.release(key, c.token)
    assert q.state(key) == "ready"
    c2 = q.try_claim(key, "w1")
    assert c2 is not None and c2.token != c.token


def _single_takeover(tmp_path, plan):
    q = JobQueue.create(str(tmp_path), plan, SchedulerConfig(lease_s=0.05, backoff_s=0.0))
    key = plan.groups[0].key
    c0 = q.try_claim(key, "w0")
    time.sleep(0.1)
    assert q.state(key) == "expired"
    c1 = q.try_claim(key, "w1")                    # takeover: tombstone + claim
    assert c1 is not None and c1.attempt == 2
    recs = [_load(p) for p in q.fail_paths(key)]
    assert len(recs) == 1 and recs[0]["kind"] == "expired" and "w0" in recs[0]["error"]
    with pytest.raises(LeaseLost):                 # the usurped holder notices
        q.renew(key, c0.token)
    q.renew(key, c1.token)                         # the usurper's is live


def _backoff_then_dead(tmp_path, plan):
    q = JobQueue.create(str(tmp_path), plan, SchedulerConfig(lease_s=30.0, max_attempts=2, backoff_s=0.05))
    key = plan.groups[0].key
    c = q.try_claim(key, "w0")
    q.release(key, c.token, fail={"kind": "error", "error": "boom"})
    assert q.state(key) == "backoff" and q.try_claim(key, "w0") is None
    time.sleep(0.08)
    c2 = q.try_claim(key, "w0")
    assert c2 is not None and c2.attempt == 2
    q.release(key, c2.token, fail={"kind": "error", "error": "boom again"})
    assert q.state(key) == "dead" and q.try_claim(key, "w1") is None
    other = plan.groups[1].key                     # a dead job settles the queue
    co = q.try_claim(other, "w0")
    q.mark_done(other, co.token, {"key": other, **_ok_stats()})
    assert q.settled(plan)


def _preemption_never_counts(tmp_path, plan):
    cfg = SchedulerConfig(lease_s=30.0, max_attempts=2, backoff_s=0.0)
    q = JobQueue.create(str(tmp_path), plan, cfg)
    key = plan.groups[0].key
    for _ in range(cfg.max_attempts + 2):          # >> max_attempts preemptions
        c = q.try_claim(key, "w0")
        assert c is not None
        q.release(key, c.token, fail={"kind": "preempted", "error": "stopped"})
        assert q.state(key) == "ready"
    for n, want in ((1, "ready"), (2, "dead")):    # errors alone exhaust it
        c = q.try_claim(key, "w0")
        q.release(key, c.token, fail={"kind": "error", "error": f"boom {n}"})
        assert (q.state(key) == "dead") == (want == "dead")
    stats = q.stats(plan)
    assert stats[key]["failed"] and stats[key]["attempts"] == 2


def _no_takeover_mid_renewal(tmp_path, plan):
    q = JobQueue.create(str(tmp_path), plan, SchedulerConfig(lease_s=0.05, backoff_s=0.0))
    key = plan.groups[0].key
    c0 = q.try_claim(key, "w0")
    time.sleep(0.1)
    assert q.state(key) == "expired"
    fd = os.open(os.path.join(str(tmp_path), f"job_{key}.lock"), os.O_CREAT | os.O_RDWR)
    fcntl.flock(fd, fcntl.LOCK_EX)                 # w0 wedged inside its renew
    try:
        assert q.try_claim(key, "w1") is None      # takeover deferred
        assert q.fail_paths(key) == []             # no expiry attempt spent
    finally:
        os.close(fd)
    c1 = q.try_claim(key, "w1")
    assert c1 is not None and c1.attempt == 2
    with pytest.raises(LeaseLost):
        q.renew(key, c0.token)


def _manifest_seed(tmp_path, plan):
    g0, g1 = plan.groups
    mpath = str(tmp_path / "plan.json")
    sc.write_manifest(plan, mpath, {g0.key: {"completed": False, "failed": True, "error": "boom"},
                                    g1.key: _ok_stats()})
    q = JobQueue.create(str(tmp_path / "queue"), plan, SchedulerConfig(backoff_s=0.0), manifest_path=mpath)
    assert q.state(g1.key) == "done" and len(q.fail_paths(g0.key)) == 1
    c = q.try_claim(g0.key, "w0")
    assert c is not None and c.attempt == 2


def _manifest_seed_startup_race(tmp_path, plan, monkeypatch):
    g0 = plan.groups[0]
    mpath = str(tmp_path / "plan.json")
    sc.write_manifest(plan, mpath, {g0.key: {"completed": False, "failed": True, "error": "boom"}})
    qdir, cfg = str(tmp_path / "queue"), SchedulerConfig(backoff_s=0.0)
    q = JobQueue.create(qdir, plan, cfg, manifest_path=mpath)
    monkeypatch.setattr(JobQueue, "fail_paths", lambda self, key: [])  # the racing loser
    JobQueue.create(qdir, plan, cfg, manifest_path=mpath)
    monkeypatch.undo()
    assert len(q.fail_paths(g0.key)) == 1          # one spent attempt, not two
    rec = _load(q.fail_paths(g0.key)[0])
    assert rec["kind"] == "error" and rec["from_manifest"]
    assert q.try_claim(g0.key, "w0").attempt == 2


LEASE_CASES = {
    "exclusive_claim_and_release": _exclusive_claim,
    "single_takeover": _single_takeover,
    "backoff_then_dead": _backoff_then_dead,
    "preemption_never_counts": _preemption_never_counts,
    "no_takeover_during_renewal": _no_takeover_mid_renewal,
    "manifest_seed": _manifest_seed,
    "manifest_seed_startup_race": _manifest_seed_startup_race,
}


@pytest.mark.parametrize("case", list(LEASE_CASES))
def test_lease_protocol(tmp_path, monkeypatch, case):
    fn = LEASE_CASES[case]
    args = (tmp_path, _plan()) + ((monkeypatch,) if case == "manifest_seed_startup_race" else ())
    fn(*args)


@pytest.mark.parametrize("case", ["plain", "duplicate", "exdev", "eacces"])
def test_publish_discards_only_a_duplicate(tmp_path, monkeypatch, case):
    """Duplicate → staged copy discarded; EXDEV → copy + rename; any other
    rename failure → raised, the staged shards intact."""
    src = tmp_path / "stage" / "a"
    src.mkdir(parents=True)
    (src / "shard_00000.npz").write_bytes(b"x")
    dst = tmp_path / "out" / "a"
    dst.parent.mkdir()
    real_rename = os.rename
    if case == "duplicate":
        dst.mkdir()
        (dst / "shard_00000.npz").write_bytes(b"first")
    elif case == "exdev":
        def exdev_once(a, b, _seen=[]):
            if not _seen and not a.endswith(".pub.tmp"):
                _seen.append(1)
                raise OSError(errno.EXDEV, "cross-device link", a, b)
            return real_rename(a, b)
        monkeypatch.setattr(os, "rename", exdev_once)
    elif case == "eacces":
        def eacces(a, b):
            raise OSError(errno.EACCES, "permission denied", a, b)
        monkeypatch.setattr(os, "rename", eacces)
        with pytest.raises(OSError):
            sched._publish_dir(str(src), str(dst))
        monkeypatch.undo()
        assert (src / "shard_00000.npz").exists() and not dst.exists()
        return
    sched._publish_dir(str(src), str(dst))
    monkeypatch.undo()
    assert not src.exists()
    assert (dst / "shard_00000.npz").read_bytes() == (b"first" if case == "duplicate" else b"x")


def _worker_retries(tmp_path, plan):
    g0, calls = plan.groups[0].key, {}

    def runner(group, **kw):
        calls[group.key] = calls.get(group.key, 0) + 1
        if group.key == g0 and calls[group.key] == 1:
            raise RuntimeError("transient solver blowup")
        return {}, _ok_stats()

    s = run_worker(plan, worker="w0", scheduler=FAST, ckpt_dir=str(tmp_path / "ck"), _group_runner=runner)
    assert s.settled and not s.dead and s.failed == [g0] and calls[g0] == 2
    assert sorted(s.done) == sorted(g.key for g in plan.groups)
    m = _load(tmp_path / "ck" / "plan.json")
    assert all(g.get("completed") for g in m["groups"]) and {g["worker"] for g in m["groups"]} == {"w0"}


def _worker_gives_up(tmp_path, plan):
    bad = plan.groups[0].key

    def runner(group, **kw):
        if group.key == bad:
            raise RuntimeError("deterministic failure")
        return {}, _ok_stats()

    s = run_worker(plan, worker="w0", scheduler=dataclasses.replace(FAST, max_attempts=2),
                   ckpt_dir=str(tmp_path / "ck"), _group_runner=runner)
    assert s.settled and s.dead == [bad] and s.done == [plan.groups[1].key]
    rec = next(g for g in _load(tmp_path / "ck" / "plan.json")["groups"] if g["key"] == bad)
    assert rec["failed"] and rec["attempts"] == 2 and "deterministic failure" in rec["error"]


def _quarantine_once(tmp_path, plan):
    g0, seen = plan.groups[0].key, {}

    def runner(group, **kw):
        n = seen[group.key] = seen.get(group.key, 0) + 1
        st = {**_ok_stats(), "health": {"guarded": True, "diverged": [], "nonconverged_steps": 0}}
        if group.key == g0 and n == 1:
            st["health"]["diverged"] = [1]
        if n == 2:
            assert kw.get("tol") == pytest.approx(1e-7)  # the fallback config
        return {}, st

    s = run_worker(plan, worker="w0", scheduler=FAST, ckpt_dir=str(tmp_path / "ck"), _group_runner=runner)
    assert s.settled and not s.dead and s.quarantined == [g0] and seen[g0] == 2
    rec = JobQueue(str(tmp_path / "ck" / "queue"), FAST).quarantine_record(g0)
    assert rec["diverged"] == [1] and rec["fallback_tol"] == pytest.approx(1e-7)


def _quarantine_bounded(tmp_path, plan):
    calls = {}

    def runner(group, **kw):
        calls[group.key] = calls.get(group.key, 0) + 1
        return {}, {**_ok_stats(), "health": {"guarded": True, "diverged": [0], "nonconverged_steps": 3}}

    s = run_worker(plan, worker="w0", scheduler=FAST, ckpt_dir=str(tmp_path / "ck"), _group_runner=runner)
    assert s.settled and not s.dead and all(calls[g.key] == 2 for g in plan.groups)
    for g in _load(tmp_path / "ck" / "plan.json")["groups"]:
        assert g["completed"] and g["quarantine"] == {"round": "fallback", "diverged": [0], "fallback_tol": 1e-7}


WORKER_CASES = {"retries_until_done": _worker_retries, "gives_up_after_max_attempts": _worker_gives_up,
                "quarantine_round_once": _quarantine_once, "quarantine_bounded_to_one_round": _quarantine_bounded}


@pytest.mark.parametrize("case", list(WORKER_CASES))
def test_worker_retry_and_quarantine(tmp_path, case):
    WORKER_CASES[case](tmp_path, _plan())


# ---------------------------------------------------------------------------
# queue files across packages
# ---------------------------------------------------------------------------


def _populate(q, plan, cfg_kw):
    """done, dead, errored (backoff) and leased jobs over a four-group plan."""
    keys = [g.key for g in plan.groups]
    c = q.try_claim(keys[0], "w0")
    q.mark_done(keys[0], c.token, {"key": keys[0], "worker": "w0", "attempt": 1, **_ok_stats(),
                                   "choice": {"method": "proposed2", "npart": 1, "kset": 2, "source": "model",
                                              "modeled_case_s": 0.5, "probed_case_s": None, "considered": 5,
                                              "calibration": None}})
    for n in range(cfg_kw["max_attempts"]):
        c = q.try_claim(keys[1], "w1")
        q.release(keys[1], c.token, fail={"kind": "error", "error": f"boom {n}"})
    c = q.try_claim(keys[2], "w0")
    q.release(keys[2], c.token, fail={"kind": "error", "error": "once"})
    q.try_claim(keys[3], "w1")
    return keys


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_queue_files_read_alike_across_packages(tmp_path, writer):
    cfg_kw = dict(lease_s=30.0, max_attempts=2, backoff_s=60.0)
    axes = (VS_AXIS, ("soil.gamma_r", ((1.0, 1.0), (0.7, 1.0))))
    base = dict(mesh_n=(2, 2, 2), n_cases=2, nt=6)
    plan = sc.make_plan(sc.SweepSpec(base=sc.Scenario(**base), axes=axes))
    rplan = ref_sc.make_plan(ref_sc.SweepSpec(base=ref_sc.Scenario(**base), axes=axes))
    assert [g.key for g in plan.groups] == [g.key for g in rplan.groups] and len(plan.groups) == 4
    qdir = str(tmp_path / "queue")
    pkg_q, pkg_cfg, pkg_plan = ((JobQueue, SchedulerConfig, plan) if writer == "port"
                                else (ref_sched.JobQueue, ref_sched.SchedulerConfig, rplan))
    pkg_q.create(qdir, pkg_plan, pkg_cfg(**cfg_kw))
    keys = _populate(pkg_q(qdir, pkg_cfg(**{**cfg_kw, "backoff_s": 0.0})), pkg_plan, cfg_kw)
    theirs = ref_sched.JobQueue(qdir, ref_sched.SchedulerConfig(**cfg_kw))
    mine = JobQueue(qdir, SchedulerConfig(**cfg_kw))
    now = time.time()
    assert [mine.state(k, now) for k in keys] == [theirs.state(k, now) for k in keys] == \
        ["done", "dead", "backoff", "leased"]
    assert mine.stats(plan) == theirs.stats(rplan)
    assert [mine.recorded_choice(k) for k in keys] == [theirs.recorded_choice(k) for k in keys]
    assert plan.groups[0].choice == sc.TuneChoice(**mine.recorded_choice(keys[0]))
    assert not mine.settled(plan) and not theirs.settled(rplan)


# ---------------------------------------------------------------------------
# kill-and-rejoin determinism (the acceptance contract)
# ---------------------------------------------------------------------------


def test_scheduled_kill_rejoin_is_bitwise_the_serial_run(tmp_path):
    """Worker 0 checkpoints mid-first-group and leaves (the deterministic
    stand-in for SIGKILL); worker 1 joins later and finishes the plan.  The
    shards equal the port's serial run_plan bitwise, and the reference's
    serial run within 1e-6·max|v|."""
    kw = dict(ckpt_every=2, shard_size=1)
    serial = str(tmp_path / "serial")
    sc.run_plan(_plan(), device="cpu", ckpt_dir=str(tmp_path / "serial_ck"), out_dir=serial, **kw)
    out, ck = str(tmp_path / "out"), str(tmp_path / "ck")
    w0 = run_worker(_plan(), worker="w0", scheduler=FAST, device="cpu", ckpt_dir=ck, out_dir=out,
                    stop_after_steps=3, **kw)
    assert w0.preempted and not w0.done and not w0.settled
    w1 = run_worker(_plan(), worker="w1", scheduler=FAST, device="cpu", ckpt_dir=ck, out_dir=out, **kw)
    assert w1.settled and not w1.dead and sorted(w1.done) == sorted(g.key for g in _plan().groups)
    fails = [_load(p) for p in JobQueue(os.path.join(ck, "queue")).fail_paths(w0.preempted[0])]
    assert [f["kind"] for f in fails] == ["preempted"]
    ref = str(tmp_path / "ref")
    with jax.enable_x64(True):
        ref_sc.run_plan(_plan(ref_sc), ckpt_dir=str(tmp_path / "ref_ck"), out_dir=ref, **kw)
    names = [s.name for g in _plan().groups for s in g.scenarios]
    assert sorted(os.listdir(out)) == sorted(os.listdir(serial)) == sorted(names)
    scale = max(np.abs(load_shards(os.path.join(ref, n))[1]).max() for n in names)
    for name in names:
        a, b, r = (os.path.join(d, name) for d in (serial, out, ref))
        assert [os.path.basename(p) for p in shard_paths(a)] == [os.path.basename(p) for p in shard_paths(b)]
        (xa, ya), (xb, yb), (xr, yr) = load_shards(a), load_shards(b), load_shards(r)
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)
        np.testing.assert_array_equal(xb, xr)
        np.testing.assert_allclose(yb, yr, atol=1e-6 * scale, rtol=0)
    m = _load(os.path.join(ck, "plan.json"))
    assert all(g["completed"] and g["worker"] == "w1" for g in m["groups"])


# ---------------------------------------------------------------------------
# train-while-generating
# ---------------------------------------------------------------------------


def test_fit_stream_alongside_a_worker_matches_posthoc_fit_shards(tmp_path):
    """fit_stream consuming the cache WHILE a worker generates reaches the
    post-hoc fit_shards result (val MAE and parameters within 1e-6): batch
    order is a function of (plan order, seed), never arrival timing."""
    from repro_torch.surrogate.model import SurrogateConfig
    from repro_torch.surrogate.train import fit_shards, fit_stream

    plan, out = _plan(), str(tmp_path / "out")
    order = [s.name for g in plan.groups for s in g.scenarios]
    worker = threading.Thread(target=run_worker, args=(plan,), kwargs=dict(
        worker="w0", scheduler=FAST, device="cpu", ckpt_dir=str(tmp_path / "ck"), out_dir=out, shard_size=1),
        daemon=True)
    worker.start()
    stream = ShardStream.from_cache(out, order, poll_s=0.05, timeout_s=300.0)
    cfg = SurrogateConfig()
    kw = dict(steps=8, batch=2, val_shards=1, seed=0, device="cpu")
    params_live, live = fit_stream(cfg, stream, **kw)
    worker.join(timeout=300.0)
    assert not worker.is_alive()
    assert live["n_shards"] == 4 and live["stream_wait_s"] > 0.0
    params_post, post = fit_shards(cfg, out, **kw)
    assert live["val_mae"] == pytest.approx(post["val_mae"], abs=1e-6)
    assert [h[:1] for h in live["history"]] == [h[:1] for h in post["history"]]
    np.testing.assert_allclose(params_live["enc"][0]["w"].numpy(), params_post["enc"][0]["w"].numpy(), atol=1e-6)


def test_fit_shards_follows_plan_order_not_sorted_names(tmp_path):
    from repro_torch.surrogate.model import SurrogateConfig
    from repro_torch.surrogate.train import fit_shards, fit_stream

    rng = np.random.default_rng(0)
    out = tmp_path / "out"
    plan_order = ["zeta_first", "alpha_second"]    # sorted() flips these
    for name in plan_order:
        save_shards(str(out / name), rng.normal(size=(2, 6, 3)).astype(np.float32),
                    rng.normal(size=(2, 6, 3)).astype(np.float32), shard_size=1)
    cfg = SurrogateConfig()
    kw = dict(steps=6, batch=2, val_shards=1, seed=0, device="cpu")
    live = fit_stream(cfg, ShardStream.from_cache(str(out), plan_order), **kw)[1]
    assert fit_shards(cfg, str(out), order=plan_order, **kw)[1]["val_mae"] == pytest.approx(live["val_mae"], abs=1e-7)
    with open(out / "plan.json", "w") as f:  # a plan.json next to the shards supplies plan order
        json.dump({"groups": [{"scenarios": [{"name": n}]} for n in plan_order]}, f)
    assert fit_shards(cfg, str(out), **kw)[1]["val_mae"] == pytest.approx(live["val_mae"], abs=1e-7)
    sorted_run = fit_stream(cfg, ShardStream.from_dir(str(out)), **kw)[1]
    assert sorted_run["val_mae"] != pytest.approx(live["val_mae"], abs=1e-7)


def test_shard_stream_times_out_on_dead_sweep(tmp_path):
    stream = ShardStream.from_cache(str(tmp_path), ["never-arrives"], poll_s=0.01, timeout_s=0.05)
    with pytest.raises(TimeoutError, match="not committed"):
        list(stream)


# ---------------------------------------------------------------------------
# heartbeat watchdog
# ---------------------------------------------------------------------------


def test_queue_watch_flags_silent_worker(tmp_path):
    qdir = str(tmp_path / "queue")
    q = JobQueue(qdir)
    names = ["w0", "w1", "w2", "w3"]
    for w in names:
        _beat(q, w, None, 0)
    watch = QueueWatch(qdir, names, slack=3.0, patience=2)
    rep = None
    for _ in range(3):
        time.sleep(0.12)
        for w in names[:3]:                        # w3 goes silent
            _beat(q, w, "job", 0)
        rep = watch.poll()
    assert rep is not None and rep.slow_hosts == (3,)
    _beat(q, names[3], "job", 0)                   # w3 recovers
    for w in names[:3]:
        _beat(q, w, "job", 0)
    assert watch.poll().slow_hosts == ()


def test_step_watchdog_equals_reference():
    from repro.training.elastic import StepWatchdog as RefWatchdog
    from repro_torch.training.elastic import StepWatchdog

    rng = np.random.default_rng(3)
    a, b = StepWatchdog(5, slack=1.5, patience=2), RefWatchdog(5, slack=1.5, patience=2)
    for step in range(12):
        for h in range(5):
            d = float(rng.uniform(0.9, 1.1) * (4.0 if h == 2 and step > 3 else 1.0))
            a.report(h, step, d)
            b.report(h, step, d)
        ra, rb = a.snapshot(step), b.snapshot(step)
        assert dataclasses.asdict(ra) == dataclasses.asdict(rb)
    assert ra.slow_hosts == (2,)


# ---------------------------------------------------------------------------
# the CLI's worker pool
# ---------------------------------------------------------------------------


def test_cli_schedule_two_workers_settles(tmp_path, capsys):
    from repro_torch.launch import campaign as cli

    spec = {"base": {"n_cases": 2, "nt": 6, "mesh_n": [2, 2, 2]}, "axes": {"soil.vs": [[0.8, 1.0], [1.0, 1.0]]}}
    res = {}
    rc = cli.main(["--sweep", json.dumps(spec), "--schedule", "--workers", "2", "--device", "cpu",
                   "--out", str(tmp_path / "out"), "--ckpt-dir", str(tmp_path / "ck"), "--shard-size", "1"],
                  result=res)
    out = capsys.readouterr().out
    assert rc == 0 and "plan settled" in out, out
    assert res["rcs"] == [0, 0] and res["settled"] and res["dead"] == []
    m = _load(tmp_path / "ck" / "plan.json")
    assert all(g["completed"] for g in m["groups"]) and {g["worker"] for g in m["groups"]} <= {"w0", "w1"}
    for g in m["groups"]:
        for s in g["scenarios"]:
            x, y = load_shards(str(tmp_path / "out" / s["name"]))
            assert x.shape == (2, 6, 3) and np.isfinite(y).all()
