"""The case mesh over several devices in one process: a campaign's rounds
of ``kset × entries``, each entry of this process in a host thread of its
own, on two CPU entries, at the sizes of tests/test_campaign.py:245 and
tests/test_campaign_distributed.py: mesh (2, 2, 2) padded to 4 elements,
12 springs, 5 waves × 6 steps, kset 2, Proposed 2, a checkpoint every 3
steps (5 waves in rounds of 4: the tail round is padded).

The reference runs once, in a subprocess over two forced host devices (in
x64): its sharded and single-device campaigns, the kill at step 7 and the
resume, and ``run_plan`` over its two-device mesh.

Tolerances: the two-entry campaign within 1e-9·max|v| of the port's
one-entry run (the reference's own tolerance for sharded against single);
against the reference's two-device run within 1e-6·max|v| (Proposed 2's
fp32 inner solve sums in another order than XLA's, the tolerance of
tests/test_torch_campaign.py); kill-and-resume bitwise.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from repro.campaign.runner import case_topology as ref_case_topology
from repro_torch import scenario as sc
from repro_torch.campaign import CampaignConfig, case_topology, run_campaign
from repro_torch.fem import meshgen, methods
from repro_torch.launch import mesh as launch_mesh
from repro_torch.parallel import distributed as dist
from repro_torch.scenario import scheduler as sched
from repro_torch.training.checkpoint import CheckpointManager

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(dt=0.01, tol=1e-8, maxiter=600, npart=2, nspring=12)
VS_AXIS = ("soil.vs", ((0.8, 1.0), (1.0, 1.0)))
TIME_FIELDS = ("wall_s", "cases_per_s")
CLI_FLAGS = ["--waves", "5", "--nt", "6", "--mesh-n", "2x2x2", "--kset", "2", "--nspring", "12"]


def _waves():
    rng = np.random.default_rng(0)
    w = np.zeros((5, 6, 3))
    w[:, :, 0] = 0.3 * rng.normal(size=(5, 6))
    return w


def _cc(**kw):
    return CampaignConfig(kset=2, method="proposed2", checkpoint_every=3, **kw)


def _run(**kw):
    return run_campaign(meshgen.generate(2, 2, 2, pad_elems_to=4), methods.SeismicConfig(**KW), _waves(),
                        device="cpu", **kw)


def _two():
    return launch_mesh.make_case_mesh(device="cpu", host_devices=2)


def _strip(m):
    m = json.loads(json.dumps(m))
    for g in m["groups"]:
        for k in TIME_FIELDS:
            g.pop(k, None)
    return m


def _plan():
    return sc.make_plan(sc.SweepSpec(base=sc.Scenario(mesh_n=(2, 2, 2), n_cases=3, nt=6), axes=(VS_AXIS,)))


_REFERENCE = """
    import json, os
    import jax
    jax.config.update("jax_enable_x64", True)
    import numpy as np
    from repro import scenario as sc
    from repro.campaign import CampaignConfig, run_campaign
    from repro.fem import meshgen, methods
    from repro.launch.mesh import make_case_mesh

    work = os.environ["CASE_MESH_WORK"]
    assert len(jax.devices()) == 2
    mesh = meshgen.generate(2, 2, 2, pad_elems_to=4)
    cfg = methods.SeismicConfig(dt=0.01, tol=1e-8, maxiter=600, npart=2, nspring=12)
    rng = np.random.default_rng(0)
    waves = np.zeros((5, 6, 3)); waves[:, :, 0] = 0.3 * rng.normal(size=(5, 6))
    dmesh = make_case_mesh(2)
    cc = lambda **kw: CampaignConfig(kset=2, method="proposed2", checkpoint_every=3, **kw)
    single = run_campaign(mesh, cfg, waves, campaign=cc())
    sharded = run_campaign(mesh, cfg, waves, campaign=cc(), device_mesh=dmesh)
    d = os.path.join(work, "ref_ckpt")
    part = run_campaign(mesh, cfg, waves, campaign=cc(checkpoint_dir=d), device_mesh=dmesh, stop_after_steps=7)
    assert not part.completed and part.steps_done == 9
    os.rename(d, d + "_killed")
    import shutil
    shutil.copytree(d + "_killed", d)
    res = run_campaign(mesh, cfg, waves, campaign=cc(checkpoint_dir=d), device_mesh=dmesh)
    assert res.completed and res.resumed_from == 9
    assert np.array_equal(np.asarray(res.velocity_history), np.asarray(sharded.velocity_history))
    np.savez(os.path.join(work, "ref.npz"), single=np.asarray(single.velocity_history),
             sharded=np.asarray(sharded.velocity_history), ids=np.asarray(sharded.case_indices))
    spec = sc.SweepSpec(base=sc.Scenario(mesh_n=(2, 2, 2), n_cases=3, nt=6),
                        axes=(("soil.vs", ((0.8, 1.0), (1.0, 1.0))),))
    run = sc.run_plan(sc.make_plan(spec), device_mesh=dmesh, ckpt_dir=os.path.join(work, "ref_plan"))
    np.savez(os.path.join(work, "ref_plan.npz"), **{n: np.asarray(r.responses) for n, r in run.scenarios.items()})
    print("REF_OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's runs over two forced host devices, in one subprocess."""
    work = str(tmp_path_factory.mktemp("case_mesh_ref"))
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=2", CASE_MESH_WORK=work,
               PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(_REFERENCE)], capture_output=True, text=True,
                         timeout=600, env=env)
    assert out.returncode == 0 and "REF_OK" in out.stdout, out.stderr[-3000:]
    return work


@pytest.fixture(scope="module")
def single():
    """The port's one-entry campaign."""
    return _run(campaign=_cc())


@pytest.fixture(scope="module")
def two(single):
    return _run(campaign=_cc(), device_mesh=_two())


# ---------------------------------------------------------------------------
# ownership, against the reference's case_topology on its fake meshes
# ---------------------------------------------------------------------------


class _Dev:
    def __init__(self, process_index):
        self.process_index = process_index


class _Mesh:
    axis_names = ("case",)

    def __init__(self, procs):
        self.devices = np.array([_Dev(p) for p in procs], dtype=object)


@pytest.mark.parametrize("procs,me", [([0], 0), ([0, 0], 0), ([0, 0, 0, 0], 0), ([0, 1], 0), ([0, 1], 1),
                                      ([0, 0, 1, 1], 1), ([0, 1, 2], 1), ([0, 0, 1, 1, 2, 2], 2)])
def test_case_topology_equals_the_reference(procs, me, monkeypatch):
    """The same ownership, offsets and local sizes as the reference's on its
    fake meshes, for one process of several entries and for processes of
    one or several entries each; a local mesh of exactly this process's
    entries wherever the reference has one."""
    import jax

    monkeypatch.setattr(dist, "process_index", lambda: me)
    monkeypatch.setattr(jax, "process_index", lambda: me)
    m = _Mesh(procs)
    port, ref = case_topology(m, kset=2), ref_case_topology(m, kset=2)
    assert (port.n_dev, port.process_index, port.process_count, port.offset, port.local) == \
        (ref.n_dev, ref.process_index, ref.process_count, ref.offset, ref.local)
    assert (port.exec_mesh is None) == (ref.exec_mesh is None)
    if port.exec_mesh is not None:
        assert [d.process_index for d in port.exec_mesh.devices.flat] == [me] * (port.local // 2)


@pytest.mark.parametrize("procs,message", [([1, 2], "owns none"), ([0, 0, 1], "unbalanced"),
                                           ([0, 1, 0, 1], "interleaves")])
def test_case_topology_refuses_as_the_reference(procs, message):
    for fn in (case_topology, ref_case_topology):
        with pytest.raises(ValueError, match=message):
            fn(_Mesh(procs), kset=1)


def test_make_case_mesh_over_host_devices(monkeypatch):
    """``host_devices`` CPU entries in this process, process-major under a
    group; more devices than there are raise the reference's message."""
    m = _two()
    assert m.axis_names == ("case",) and [(d.process_index, str(d.device)) for d in m.devices.flat] == \
        [(0, "cpu"), (0, "cpu")]
    assert launch_mesh.make_case_mesh(1, device="cpu", host_devices=2) is None
    with pytest.raises(ValueError, match="requested 3 devices, have 2"):
        launch_mesh.make_case_mesh(3, device="cpu", host_devices=2)
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        launch_mesh.make_case_mesh(2, device="cpu")
    assert launch_mesh.local_case_devices("cpu") == ["cpu"]
    monkeypatch.setattr(dist, "process_count", lambda: 2)
    assert [d.process_index for d in launch_mesh.make_case_mesh(device="cpu", host_devices=2).devices.flat] == \
        [0, 0, 1, 1]


# ---------------------------------------------------------------------------
# the campaign over two CPU entries in one process
# ---------------------------------------------------------------------------


def test_two_entries_match_one_entry_and_the_reference(single, two, ref):
    """Rounds of 4 over two entries (the tail round padded) against the
    port's one entry at 1e-9·max|v|, and against the reference's two
    forced host devices at 1e-6·max|v|; the reference's own sharded run
    sits within 1e-9 of its single-device run, as its test holds it."""
    assert two.completed and two.rounds_done == 2 and two.case_indices.tolist() == list(range(5))
    assert two.velocity_history.shape == single.velocity_history.shape == (5, 6, 1, 3)
    scale = np.abs(single.velocity_history).max()
    assert scale > 0
    np.testing.assert_allclose(two.velocity_history, single.velocity_history, atol=1e-9 * scale, rtol=0)
    r = np.load(os.path.join(ref, "ref.npz"))
    assert r["ids"].tolist() == two.case_indices.tolist()
    np.testing.assert_allclose(r["sharded"], r["single"], atol=1e-9 * np.abs(r["single"]).max(), rtol=0)
    np.testing.assert_allclose(two.velocity_history, r["sharded"], atol=1e-6 * np.abs(r["sharded"]).max(), rtol=0)


def test_two_entries_run_in_threads_of_their_own(monkeypatch):
    """Each entry's chunk runs in a host thread of its own (two threads at
    once), and an exception in one entry's thread fails the campaign in
    the caller, naming the entry."""
    import threading

    from repro_torch.campaign import runner

    seen, orig = set(), runner.make_campaign_chunk

    def spying(*a, **kw):
        chunk, new = orig(*a, **kw)

        def spy(box, wave):
            seen.add(threading.get_ident())
            if float(wave[0, 0, 0]) == float(_waves()[2, 0, 0]):  # entry 1's first lane in round 0
                raise FloatingPointError("entry 1 broke")
            return chunk(box, wave)

        return spy, new

    monkeypatch.setattr(runner, "make_campaign_chunk", spying)
    with pytest.raises(FloatingPointError, match="entry 1 broke") as e:
        _run(campaign=_cc(), device_mesh=_two())
    assert len(seen) == 2 and threading.get_ident() not in seen
    assert any("case-mesh entry 1 on cpu" in n for n in e.value.__notes__)


def test_kill_and_resume_over_two_entries_with_the_reference_checkpoints(two, ref, tmp_path):
    """Killed after step 7 (mid-round 1), resumed: bitwise the unkilled run.
    One file a round and no ``.pNN`` (one process); the mid-round step's
    leaf names and array shapes are the reference's (the carry as one array
    of 4 lanes a leaf, the two entries' k-sets end to end); round-boundary
    steps hold no carry in the port (module docstring of the runner)."""
    d = str(tmp_path / "ckpt")
    part = _run(campaign=_cc(checkpoint_dir=d), device_mesh=_two(), stop_after_steps=7)
    assert not part.completed and part.steps_done == 9 and part.rounds_done == 1
    ref_killed = os.path.join(ref, "ref_ckpt_killed")
    assert sorted(os.listdir(os.path.join(d, "rounds"))) == sorted(os.listdir(os.path.join(ref_killed, "rounds"))) \
        == ["round_00000.npz"]
    assert sorted(os.listdir(d)) == sorted(os.listdir(ref_killed))
    with np.load(os.path.join(d, "rounds", "round_00000.npz")) as a, \
            np.load(os.path.join(ref_killed, "rounds", "round_00000.npz")) as b:
        assert {k: a[k].shape for k in a.files} == {k: b[k].shape for k in b.files}
    step = os.path.join("step_000000009")
    with open(os.path.join(d, step, "manifest.json")) as f:
        mine = json.load(f)
    with open(os.path.join(ref_killed, step, "manifest.json")) as f:
        theirs = json.load(f)
    assert mine["leaves"] == theirs["leaves"] and mine["meta"] == theirs["meta"]
    for name, keys in mine["leaves"].items():
        for i in range(len(keys)):
            fn = os.path.join(name, f"{i:05d}.npy")
            a = np.load(os.path.join(d, step, fn), mmap_mode="r")
            b = np.load(os.path.join(ref_killed, step, fn), mmap_mode="r")
            assert a.shape == b.shape, (fn, a.shape, b.shape)
    res = _run(campaign=_cc(checkpoint_dir=d), device_mesh=_two())
    assert res.completed and res.resumed_from == 9
    assert np.array_equal(res.velocity_history, two.velocity_history)
    assert np.array_equal(res.iters, two.iters)
    # a one-entry campaign on the two-entry directory: another round geometry, refused
    with pytest.raises(ValueError, match="different campaign"):
        _run(campaign=_cc(checkpoint_dir=d))
    assert CheckpointManager(d).latest_step() == 12  # the finished campaign's round-boundary step


def test_two_distinct_devices_hold_an_operator_set_each_and_resume_bitwise(single, two, tmp_path, monkeypatch):
    """Entries on two distinct device objects (``cpu`` and ``cpu:0``): one
    ``FemOperators`` a device, each entry's carry on its own device, the
    kill at step 7 restored into both (a spread leaf over two devices), and
    the resumed run bitwise the two-entry run over one device."""
    import torch

    from repro_torch.campaign import runner
    from repro_torch.launch.mesh import CaseDevice, CaseMesh

    made, orig = [], runner.fem_backend.make_operators

    def counting(*a, **kw):
        made.append(kw["device"])
        return orig(*a, **kw)

    monkeypatch.setattr(runner.fem_backend, "make_operators", counting)
    pair = CaseMesh(np.array([CaseDevice(0, torch.device("cpu")), CaseDevice(0, torch.device("cpu", 0))],
                             dtype=object))
    d = str(tmp_path / "ckpt")
    part = _run(campaign=_cc(checkpoint_dir=d), device_mesh=pair, stop_after_steps=7)
    assert not part.completed and part.steps_done == 9
    assert made == [torch.device("cpu"), torch.device("cpu", 0)]
    res = _run(campaign=_cc(checkpoint_dir=d), device_mesh=pair)
    assert res.completed and res.resumed_from == 9
    assert np.array_equal(res.velocity_history, two.velocity_history) and np.array_equal(res.iters, two.iters)
    scale = np.abs(single.velocity_history).max()
    np.testing.assert_allclose(res.velocity_history, single.velocity_history, atol=1e-9 * scale, rtol=0)


# ---------------------------------------------------------------------------
# the campaign CLI
# ---------------------------------------------------------------------------


_CLI_CHILD = """
    import os, sys
    import numpy as np
    from repro_torch.launch import campaign
    result = {}
    assert campaign.main(sys.argv[1:], result) == 0
    res = result["campaign"]
    np.savez(os.environ["CLI_OUT"], vel=res.velocity_history, ids=res.case_indices)
"""


def test_campaign_cli_over_host_devices(single, tmp_path, capsys):
    """``--device cpu --host-devices 2`` in this process, and ``--num-processes 2
    --host-devices 2`` (four entries, two a process): rounds of ``kset ×
    entries``, each case within 1e-9·max|v| of the one-entry run."""
    from repro_torch.launch import campaign as cli

    flags = [*CLI_FLAGS, "--method", "proposed2", "--no-health"]
    base, mine = {}, {}
    assert cli.main([*flags, "--device", "cpu"], base) == 0
    assert cli.main([*flags, "--host-devices", "2"], mine) == 0
    out = capsys.readouterr().out
    assert "2 device(s) × kset=2 → rounds of 4" in out and "(2 entries here, a host thread each)" in out
    ref_v = base["campaign"].velocity_history
    scale = np.abs(ref_v).max()
    np.testing.assert_allclose(mine["campaign"].velocity_history, ref_v, atol=1e-9 * scale, rtol=0)

    port = str(dist.free_port())
    procs, logs = [], []
    for pid in range(2):
        env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="2",
                   CLI_OUT=str(tmp_path / f"p{pid}.npz"))
        log = open(tmp_path / f"p{pid}.log", "w+")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(_CLI_CHILD), *flags, "--host-devices", "2", "--cpu-backend",
             "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2", "--process-id", str(pid)],
            stdout=log, stderr=subprocess.STDOUT, text=True, env=env))
    try:
        for p, log in zip(procs, logs):
            p.wait(timeout=300)
            log.seek(0)
            text = log.read()
            assert p.returncode == 0, text[-3000:]
            assert "4 device(s) × kset=2 → rounds of 8 across 2 processes" in text
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for log in logs:
            log.close()
    got = [np.load(tmp_path / f"p{pid}.npz") for pid in range(2)]
    # 5 waves in one round of 8: process 0 owns lanes 0–3, process 1 lane 4 (and three padded lanes)
    assert got[0]["ids"].tolist() == [0, 1, 2, 3] and got[1]["ids"].tolist() == [4]
    for g in got:
        np.testing.assert_allclose(g["vel"], ref_v[g["ids"]], atol=1e-9 * scale, rtol=0)


# ---------------------------------------------------------------------------
# sweeps over two entries
# ---------------------------------------------------------------------------


def test_run_plan_and_worker_over_two_entries_match_the_reference(ref, tmp_path):
    """``run_plan`` over two CPU entries, and ``scheduler.run_worker`` over
    them, against the reference's ``run_plan(device_mesh=…)`` over two
    forced host devices: manifests equal apart from the time fields (the
    worker's apart from the queue's fields too), responses within
    1e-6·max|v|, and the worker's bitwise the serial run's."""
    run = sc.run_plan(_plan(), device="cpu", device_mesh=_two(), ckpt_dir=str(tmp_path / "plan"))
    with open(run.manifest_path) as f, open(os.path.join(ref, "ref_plan", "plan.json")) as g:
        assert _strip(json.load(f)) == _strip(json.load(g))
    r = np.load(os.path.join(ref, "ref_plan.npz"))
    assert sorted(r.files) == sorted(run.scenarios)
    scale = max(np.abs(r[n]).max() for n in r.files)
    for n in r.files:
        np.testing.assert_allclose(run.scenarios[n].responses, r[n], atol=1e-6 * scale, rtol=0)
    plan = _plan()
    s = sched.run_worker(plan, worker="w0", device="cpu", device_mesh=_two(), ckpt_dir=str(tmp_path / "queue"),
                         scheduler=sched.SchedulerConfig(lease_s=30.0, poll_s=0.02, backoff_s=0.01))
    assert s.settled and len(s.done) == len(plan.groups) and not s.failed
    with open(os.path.join(tmp_path / "queue", "plan.json")) as f:
        worker_manifest = json.load(f)
    with open(run.manifest_path) as f:
        serial_manifest = _strip(json.load(f))
    worker_groups = _strip(worker_manifest)["groups"]  # the queue adds its attempt and worker fields
    assert [{k: g[k] for k in want} for g, want in zip(worker_groups, serial_manifest["groups"])] == \
        serial_manifest["groups"]
    serial = sc.run_plan(_plan(), device="cpu", device_mesh=_two(), ckpt_dir=str(tmp_path / "queue"))
    for n, sr in serial.scenarios.items():
        np.testing.assert_array_equal(sr.responses, run.scenarios[n].responses)


# ---------------------------------------------------------------------------
# launch counts under several host threads
# ---------------------------------------------------------------------------


def test_launch_counter_is_exact_under_eight_threads():
    """Eight threads add to one instance counter (and through it to its
    parent) at once: no add is lost, and a reset zeroes both."""
    import threading

    from repro_torch.kernels import LaunchCounter

    parent = LaunchCounter("parent")
    part = LaunchCounter("part", parent)
    n, start = 20_000, threading.Barrier(8)

    def add():
        start.wait()
        for _ in range(n):
            part.add()

    threads = [threading.Thread(target=add) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert part.n == parent.n == 8 * n
    parent.reset()
    assert part.n == parent.n == 0


def test_guard_runs_in_each_entry_and_a_fault_keeps_its_global_case():
    """A NaN injected into case 2 (entry 1's first lane of round 0) trips
    that case's health word alone, under its global index; every other
    case is bitwise the clean guarded run over the same two entries."""
    from repro_torch.core import faults

    mesh, cfg = meshgen.generate(2, 2, 2, pad_elems_to=4), methods.SeismicConfig(**KW, health=True)
    kw = dict(device="cpu", campaign=_cc(), device_mesh=_two())
    clean = run_campaign(mesh, cfg, _waves(), **kw)
    hit = run_campaign(mesh, cfg, faults.nan_at_step(_waves(), 3, case=2), **kw)
    assert not clean.diverged_cases().size and hit.diverged_cases().tolist() == [2]
    assert hit.health.shape == (5,) and (hit.health[[0, 1, 3, 4]] == 0).all() and hit.health[2] != 0
    for c in (0, 1, 3, 4):
        assert np.array_equal(hit.velocity_history[c], clean.velocity_history[c])
