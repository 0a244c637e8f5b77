"""Multi-process campaigns of the port: two CPU processes joined by the
port's ``distributed_init`` (a gloo process group), each owning half the
case axis, checkpointing their own shards with a process-0 commit.  The
checks of tests/test_campaign_distributed.py, on its config: mesh (2,2,2)
padded to 4 elements, nspring 12, npart 2, dt 0.01, tol 1e-8, 5 waves × 6
steps, kset 2, Proposed 2, a checkpoint every 3 steps.

Tolerances: a killed and resumed pair is bitwise the unkilled pair; each
process's cases are bitwise the one-process port run's (each k-set holds
the same two waves in the same lanes in both runs: process 0's round 1
pairs case 4 with its padding repeat, as the one-process run's round 2
does), and within 1e-6·max|v| of the JAX package's one-process campaign
(Proposed 2's fp32 inner solve sums in another order than XLA's).

The children run in subprocesses that import only ``repro_torch``, with
log files rather than pipes: a child blocked on a full pipe would stall
its sibling at a barrier.
"""
import os
import socket
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

from repro.campaign import CampaignConfig as RefCampaignConfig, run_campaign as ref_run_campaign
from repro.fem import meshgen as ref_meshgen, methods as ref_methods
from repro_torch.campaign import CampaignConfig, CaseTopology, case_topology, run_campaign
from repro_torch.fem import meshgen, methods
from repro_torch.launch import mesh as launch_mesh
from repro_torch.parallel import distributed as dist
from repro_torch.surrogate import dataset
from repro_torch.training.checkpoint import CheckpointManager

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(dt=0.01, tol=1e-8, maxiter=600, npart=2, nspring=12)


def _waves():
    rng = np.random.default_rng(3)
    w = np.zeros((5, 6, 3))
    w[:, :, 0] = 0.3 * rng.normal(size=(5, 6))
    return w


# ---------------------------------------------------------------------------
# case ownership (no processes), with the reference test's fakes
# ---------------------------------------------------------------------------


class _Dev:
    def __init__(self, process_index):
        self.process_index = process_index


class _Mesh:
    axis_names = ("case",)

    def __init__(self, procs):
        self.devices = np.array([_Dev(p) for p in procs], dtype=object)


def test_case_topology_single_process():
    assert case_topology(None, kset=3) == CaseTopology(1, 0, 1, 0, 3, None)
    assert case_topology(_Mesh([0]), kset=2) == CaseTopology(1, 0, 1, 0, 2, None)
    # several devices of one process: its local mesh, as the reference's
    m = _Mesh([0, 0])
    t = case_topology(m, kset=2)
    assert (t.n_dev, t.offset, t.local, t.process_count) == (2, 0, 4, 1)
    assert t.exec_mesh is m  # single-process mesh used as-is


def test_case_topology_multi_process_ownership(monkeypatch):
    t = case_topology(_Mesh([0, 1]), kset=2)  # this process is rank 0
    assert (t.n_dev, t.process_count, t.offset, t.local) == (2, 2, 0, 2)
    assert t.exec_mesh is None  # one local device, no mesh
    monkeypatch.setattr(dist, "process_index", lambda: 1)
    t = case_topology(_Mesh([0, 1, 2]), kset=2)
    assert (t.n_dev, t.process_index, t.process_count, t.offset, t.local) == (3, 1, 3, 2, 2)


def test_case_topology_rejects_bad_meshes():
    with pytest.raises(ValueError, match="owns none"):
        case_topology(_Mesh([1, 2]), kset=1)
    with pytest.raises(ValueError, match="unbalanced"):
        case_topology(_Mesh([0, 0, 1]), kset=1)
    with pytest.raises(ValueError, match="interleaves"):
        case_topology(_Mesh([0, 1, 0, 1]), kset=1)


def test_case_mesh_follows_the_process_group(monkeypatch):
    """One process: no mesh.  Under a group of two: one entry a process,
    process-major, that ``case_topology`` reads."""
    assert launch_mesh.make_case_mesh() is None
    monkeypatch.setattr(dist, "process_count", lambda: 2)
    m = launch_mesh.make_case_mesh(device="cpu")
    assert m.axis_names == ("case",) and m.devices.dtype == object
    assert [(d.process_index, d.device) for d in m.devices.flat] == [(0, "cpu"), (1, "cpu")]
    assert [d.process_index for d in launch_mesh.make_case_mesh(2).devices.flat] == [0, 1]
    assert case_topology(m, kset=1) == CaseTopology(2, 0, 2, 0, 1, None)
    with pytest.raises(ValueError, match="requested 3 devices, have 2"):
        launch_mesh.make_case_mesh(3)
    # two CPU entries a process: four in all, process-major; this one owns the first two
    m4 = launch_mesh.make_case_mesh(device="cpu", host_devices=2)
    assert [d.process_index for d in m4.devices.flat] == [0, 0, 1, 1]
    t = case_topology(m4, kset=2)
    assert (t.n_dev, t.process_index, t.process_count, t.offset, t.local) == (4, 0, 2, 0, 4)
    assert [d.process_index for d in t.exec_mesh.devices.flat] == [0, 0]
    monkeypatch.setattr(dist, "process_index", lambda: 1)
    t = case_topology(m4, kset=2)
    assert (t.offset, t.local) == (4, 4) and [d.process_index for d in t.exec_mesh.devices.flat] == [1, 1]


def test_a_group_member_without_a_spanning_mesh_refuses_a_checkpoint_dir(tmp_path, monkeypatch):
    """Under a process group, a campaign whose mesh spans only this process
    would write a one-process layout into a directory its peers share."""
    monkeypatch.setattr(dist, "process_count", lambda: 2)
    with pytest.raises(ValueError, match="the case mesh spans only this one"):
        run_campaign(meshgen.generate(2, 2, 2, pad_elems_to=4), methods.SeismicConfig(**KW), _waves(),
                     device="cpu", campaign=CampaignConfig(kset=2, checkpoint_dir=str(tmp_path / "ckpt")))
    assert not os.path.exists(tmp_path / "ckpt")


# ---------------------------------------------------------------------------
# two processes on the CPU
# ---------------------------------------------------------------------------

_PRELUDE = """
    import os
    pid = int(os.environ["DIST_PID"])
    from repro_torch.launch.bootstrap import distributed_init
    from repro_torch.parallel import distributed as dist
    distributed_init(coordinator="127.0.0.1:" + os.environ["DIST_PORT"], num_processes=2, process_id=pid,
                     cpu_backend=True)
    assert (dist.process_index(), dist.process_count()) == (pid, 2)

    import numpy as np
    from repro_torch.campaign import CampaignConfig, run_campaign
    from repro_torch.fem import meshgen, methods
    from repro_torch.launch.mesh import make_case_mesh

    work = os.environ["DIST_WORK"]
    mesh = meshgen.generate(2, 2, 2, pad_elems_to=4)
    cfg = methods.SeismicConfig(dt=0.01, tol=1e-8, maxiter=600, npart=2, nspring=12)
    rng = np.random.default_rng(3)
    waves = np.zeros((5, 6, 3)); waves[:, :, 0] = 0.3 * rng.normal(size=(5, 6))
    dmesh = make_case_mesh(device="cpu")  # spans both processes
    cc = lambda **kw: CampaignConfig(kset=2, method="proposed2", checkpoint_every=3, **kw)
    run = lambda **kw: run_campaign(mesh, cfg, waves, device="cpu", **kw)
"""


def _env(work, **extra):
    env = dict(os.environ)
    env.update({"PYTHONPATH": os.path.join(REPO, "src"), "DIST_WORK": work, "OMP_NUM_THREADS": "2", **extra})
    return env


def _spawn(cmds, work, timeout=300) -> list[str]:
    """Run each ``(argv, env)`` as a child with its own log file, all at
    once; returns their outputs, and fails naming the child that failed."""
    procs, logs = [], []
    try:
        for i, (argv, env) in enumerate(cmds):
            log = open(os.path.join(work, f"spawn_{len(os.listdir(work))}_{i}.log"), "w+")
            logs.append(log)
            procs.append(subprocess.Popen(argv, stdout=log, stderr=subprocess.STDOUT, text=True, env=env))
        outs = []
        for i, p in enumerate(procs):
            p.wait(timeout=timeout)
            logs[i].seek(0)
            out = logs[i].read()
            assert p.returncode == 0, f"child {i} ({cmds[i][0][1:3]}) failed:\n{out[-3000:]}"
            outs.append(out)
        return outs
    finally:
        for q in procs:
            if q.poll() is None:
                q.kill()
                q.wait()
        for log in logs:
            log.close()


def _spawn_pair(body: str, work: str) -> list[str]:
    port = str(dist.free_port())
    code = textwrap.dedent(_PRELUDE) + textwrap.dedent(body)
    return _spawn([([sys.executable, "-c", code], _env(work, DIST_PID=str(pid), DIST_PORT=port))
                   for pid in range(2)], work)


def test_free_port_lies_below_the_ephemeral_range():
    """A coordinator's port is free and below the OS's ephemeral range, so
    no socket the OS numbers can take it before the store binds it."""
    low = dist._ephemeral_low()
    for _ in range(8):
        port = dist.free_port()
        assert max(1024, low - 12288) <= port < low
        with socket.socket() as s:
            s.bind(("127.0.0.1", port))


def test_two_process_campaign_kill_resume_and_world_size(tmp_path):
    """In three acts sharing one checkpoint directory:

    1. an unkilled pair (each process keeps its own cases), the one-process
       port run beside it, and a pair stopped after step 7 (mid-round 1);
       the shards, the commit and the banked round's ``.ok`` are on disk;
    2. a fresh pair resumes bitwise the unkilled one, its cases bitwise the
       one-process run's and within 1e-6·max|v| of the JAX package's;
    3. another world size is refused both ways: one process on the pair's
       directory, and the pair on a one-process directory."""
    work = str(tmp_path)
    ckpt = os.path.join(work, "ckpt")
    outs = _spawn_pair("""
        ref = run(campaign=cc(), device_mesh=dmesh)
        assert ref.completed and ref.rounds_done == 2
        # 5 waves in rounds of 4: process 0 owns {0, 1, 4} (+ a padded lane), process 1 {2, 3} (+ two)
        assert ref.case_indices.tolist() == ([0, 1, 4] if pid == 0 else [2, 3])
        np.savez(os.path.join(work, f"ref_p{pid}.npz"), vel=ref.velocity_history, iters=ref.iters,
                 ids=ref.case_indices, health=ref.health)
        if pid == 0:  # no checkpoint directory: one process may run alone beside the group
            single = run(campaign=cc())
            np.savez(os.path.join(work, "single.npz"), vel=single.velocity_history, iters=single.iters)
        part = run(campaign=cc(checkpoint_dir=os.path.join(work, "ckpt")), device_mesh=dmesh, stop_after_steps=7)
        assert not part.completed and part.steps_done == 9 and part.rounds_done == 1
        print("ACT1_OK", pid, part.steps_done)
    """, work)
    assert all("ACT1_OK" in o for o in outs)
    names = os.listdir(ckpt)
    assert any(n.endswith(".p00") for n in names), names
    assert any(n.endswith(".p01") for n in names), names
    assert any(n.endswith(".commit.json") for n in names), names
    assert sorted(os.listdir(os.path.join(ckpt, "rounds"))) == [
        "round_00000.ok", "round_00000.p00.npz", "round_00000.p01.npz"]

    # a one-process checkpoint directory, for act 3's refusal the other way
    mesh, cfg, waves = meshgen.generate(2, 2, 2, pad_elems_to=4), methods.SeismicConfig(**KW), _waves()
    one_dir = os.path.join(work, "ckpt_one")
    cc_one = CampaignConfig(kset=2, method="proposed2", checkpoint_every=3, checkpoint_dir=one_dir)
    assert not run_campaign(mesh, cfg, waves, device="cpu", campaign=cc_one, stop_after_steps=3).completed

    outs = _spawn_pair("""
        res = run(campaign=cc(checkpoint_dir=os.path.join(work, "ckpt")), device_mesh=dmesh)
        assert res.completed and res.resumed_from == 9
        ref = np.load(os.path.join(work, f"ref_p{pid}.npz"))
        assert np.array_equal(res.case_indices, ref["ids"])
        assert np.array_equal(res.velocity_history, ref["vel"])
        assert np.array_equal(res.iters, ref["iters"]) and np.array_equal(res.health, ref["health"])
        single = np.load(os.path.join(work, "single.npz"))
        assert np.array_equal(res.velocity_history, single["vel"][res.case_indices])
        assert np.array_equal(res.iters, single["iters"][res.case_indices])
        try:
            run(campaign=cc(checkpoint_dir=os.path.join(work, "ckpt_one")), device_mesh=dmesh)
            raise SystemExit("the pair resumed a one-process checkpoint")
        except ValueError as e:
            assert "world size" in str(e), e
        print("ACT2_OK", pid, res.resumed_from)
    """, work)
    assert all("ACT2_OK" in o for o in outs)

    # the JAX package's one-process campaign on the same waves
    with jax.enable_x64(True):
        jref = ref_run_campaign(ref_meshgen.generate(2, 2, 2, pad_elems_to=4), ref_methods.SeismicConfig(**KW),
                                waves, campaign=RefCampaignConfig(kset=2, method="proposed2", checkpoint_every=3))
        jv = np.asarray(jref.velocity_history)
    scale = np.abs(jv).max()
    assert scale > 0
    for pid in range(2):
        ref = np.load(os.path.join(work, f"ref_p{pid}.npz"))
        np.testing.assert_allclose(ref["vel"], jv[ref["ids"]], atol=1e-6 * scale, rtol=0)

    # act 3: one process on the pair's directory
    with pytest.raises(ValueError, match="world size"):
        CheckpointManager(ckpt).restore_latest({"meta": {"round": np.zeros((), np.int64)}})
    with pytest.raises(ValueError, match="world size"):
        run_campaign(mesh, cfg, waves, device="cpu",
                     campaign=CampaignConfig(kset=2, method="proposed2", checkpoint_every=3, checkpoint_dir=ckpt))


def test_two_process_cli_writes_per_process_shards(tmp_path):
    """The CLI with ``--cpu-backend --num-processes 2``, one command per
    process, beside the one-process CLI: ``OUT/p00`` and ``OUT/p01``, read
    back through ``load_shards`` in (process, shard) order, are the
    one-process shards' rows of the cases each process owns."""
    work = str(tmp_path)
    flags = ["--waves", "5", "--nt", "6", "--mesh-n", "2x2x2", "--kset", "2", "--shard-size", "2"]
    cli = [sys.executable, "-m", "repro_torch.launch.campaign", *flags]
    port = str(dist.free_port())
    pair = ["--cpu-backend", "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2", "--out",
            os.path.join(work, "out")]
    outs = _spawn([(cli + pair + ["--process-id", str(pid)], _env(work)) for pid in range(2)]
                  + [(cli + ["--device", "cpu", "--out", os.path.join(work, "single")], _env(work))], work)
    assert "[campaign p0]" in outs[0] and "(cases 0–4 of 5)" in outs[0]
    assert "[campaign p1]" in outs[1] and "(cases 2–3 of 5)" in outs[1]
    assert sorted(os.listdir(os.path.join(work, "out"))) == ["p00", "p01"]
    x, y = dataset.load_shards(os.path.join(work, "out"))
    sx, sy = dataset.load_shards(os.path.join(work, "single"))
    order = [0, 1, 4, 2, 3]  # process 0's cases, then process 1's
    assert np.array_equal(x, sx[order]) and np.array_equal(y, sy[order])
    assert len(dataset.load_shards(os.path.join(work, "out", "p01"))[0]) == 2
