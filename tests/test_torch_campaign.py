"""The port's campaign runner against the reference's, both packages on the
same numpy inputs on the CPU (the reference in x64), on the config of
tests/test_campaign.py: mesh (2,2,2) padded to 4 elements, nspring 12,
npart 2, dt 0.01, tol 1e-8.

Tolerances: the CRS rungs (Proposed 1) within 1e-12·max|v| at equal
iterations, Proposed 2 within 1e-6·max|v| (its fp32 inner solve sums in
another order than XLA's); a campaign lane against the port's own
``methods.run`` within 1e-9·max|v|, as the reference's test holds it.
Kill-and-resume and a pure restore are bitwise; a NaN injected into one
case gives the reference's health words exactly, and leaves its siblings
bitwise unchanged.
"""
import dataclasses
import glob
import os

import jax
import numpy as np
import pytest

from repro.campaign import CampaignConfig as RefCampaignConfig, run_campaign as ref_run_campaign
from repro.fem import meshgen as ref_meshgen, methods as ref_methods
from repro_torch import convert
from repro_torch.campaign import CampaignConfig, CaseTopology, case_topology, run_campaign
from repro_torch.campaign.runner import _campaign_sig, _chunk_bounds
from repro_torch.core import faults, health
from repro_torch.fem import methods
from repro_torch.launch import mesh as launch_mesh

KW = dict(dt=0.01, tol=1e-8, maxiter=600, npart=2, nspring=12)
TOL = {"proposed1": 1e-12, "proposed2": 1e-6}


@pytest.fixture(scope="module")
def meshes():
    ref = ref_meshgen.generate(2, 2, 2, pad_elems_to=4)
    return ref, convert.mesh_from_arrays(ref)


def _waves(M, nt, seed=0):
    rng = np.random.default_rng(seed)
    w = np.zeros((M, nt, 3))
    w[:, :, 0] = 0.3 * rng.normal(size=(M, nt))
    return w


def _cfg(**kw):
    return methods.SeismicConfig(**{**KW, **kw})


def _run(mesh, cfg, waves, **kw):
    return run_campaign(mesh, cfg, waves, device="cpu", **kw)


@pytest.mark.parametrize("method", ["proposed1", "proposed2"])
def test_campaign_matches_reference(meshes, method):
    """M 3 in rounds of 2 (the tail padded), 4 steps: the port's campaign
    against the reference's, lane by lane."""
    ref_mesh, mesh = meshes
    waves = _waves(3, 4)
    with jax.enable_x64(True):
        ref = ref_run_campaign(ref_mesh, ref_methods.SeismicConfig(**KW), waves,
                               campaign=RefCampaignConfig(kset=2, method=method))
        ref_v, ref_iters = np.asarray(ref.velocity_history), np.asarray(ref.iters)
    res = _run(mesh, _cfg(), waves, campaign=CampaignConfig(kset=2, method=method))
    assert res.completed and res.rounds_done == ref.rounds_done == 2
    assert res.velocity_history.shape == ref_v.shape == (3, 4, 1, 3)
    assert res.velocity_history.dtype == np.float64
    np.testing.assert_array_equal(res.case_indices, np.arange(3))
    scale = np.abs(ref_v).max()
    assert scale > 0
    np.testing.assert_allclose(res.velocity_history, ref_v, atol=TOL[method] * scale, rtol=0)
    if method == "proposed1":
        np.testing.assert_array_equal(res.iters, ref_iters)


def test_chunk_bounds():
    assert _chunk_bounds(10, 0) == [(0, 10)]
    assert _chunk_bounds(10, 4) == [(0, 4), (4, 8), (8, 10)]
    assert _chunk_bounds(10, 100) == [(0, 10)]


def test_campaign_remainder_pad_mask(meshes):
    """n_waves=3 with rounds of 2: the padded lane is masked out and every
    real case matches the port's own ``methods.run``."""
    _, mesh = meshes
    cfg = _cfg()
    waves = _waves(3, 4)
    res = _run(mesh, cfg, waves, campaign=CampaignConfig(kset=2, method="proposed1"))
    assert res.completed and res.rounds_done == 2
    assert res.velocity_history.shape[0] == res.iters.shape[0] == len(res.case_indices) == 3
    for i in range(3):
        ref = methods.run(mesh, cfg, waves[i], method="proposed1", device="cpu")["velocity_history"].numpy()
        np.testing.assert_allclose(res.velocity_history[i], ref, atol=1e-9 * (np.abs(ref).max() + 1e-30), rtol=0)


@pytest.mark.parametrize("knobs", [{}, {"warm_start": True, "precond_every": 2}])
def test_campaign_resume_bit_identical(meshes, tmp_path, knobs, monkeypatch):
    """checkpoint → kill → resume reproduces the uninterrupted velocities and
    iterations bit-for-bit; re-invoking the finished campaign is a pure
    restore.  With ``warm_start`` the carry has a ``du_prev`` leaf, with
    ``precond_every`` 2 the lagged preconditioner and its step counter (a
    python int) — Proposed 2 then, since only its carry has them.  The
    resume builds one carry and restores into it; the pure restore builds
    none."""
    _, mesh = meshes
    built = []
    fresh = methods.initial_ensemble_carry
    monkeypatch.setattr(methods, "initial_ensemble_carry", lambda *a, **kw: built.append(1) or fresh(*a, **kw))
    cfg = _cfg(**knobs)
    method = "proposed2" if knobs else "proposed1"
    waves = _waves(3, 6, seed=1)
    chunks = []
    base = _run(mesh, cfg, waves, campaign=CampaignConfig(kset=2, method=method, checkpoint_every=2),
                on_chunk=chunks.append)
    assert base.completed
    assert [(c["round"], c["t0"], c["t1"]) for c in chunks] == [(r, t, t + 2) for r in (0, 1) for t in (0, 2, 4)]
    assert all(c["seconds"] > 0 for c in chunks)
    cc = CampaignConfig(kset=2, method=method, checkpoint_dir=str(tmp_path / "ckpt"), checkpoint_every=2)
    part = _run(mesh, cfg, waves, campaign=cc, stop_after_steps=7)
    assert not part.completed and part.steps_done < 2 * 6  # genuinely mid-campaign
    assert part.rounds_done == 1 and part.velocity_history.shape[0] == 2
    built.clear()
    res = _run(mesh, cfg, waves, campaign=cc)
    assert res.completed and res.resumed_from == 8 and len(built) == 1  # round 1, restored into
    assert [c["op"] for c in res.checkpoints][:2] == ["restore", "restore"]  # the meta head, then the carry
    assert np.array_equal(res.velocity_history, base.velocity_history)
    assert np.array_equal(res.iters, base.iters)
    built.clear()
    again = _run(mesh, cfg, waves, campaign=cc)
    assert again.completed and again.resumed_from == 12 and not built
    assert np.array_equal(again.velocity_history, base.velocity_history)
    assert np.array_equal(again.iters, base.iters)


def test_campaign_rejects_foreign_checkpoint(meshes, tmp_path):
    """A checkpoint of another seed, method, dt, wave data or kernel backend
    is refused by its signature, not by a structure error."""
    _, mesh = meshes
    cfg = _cfg()
    cc = CampaignConfig(kset=2, method="proposed1", seed=0, checkpoint_dir=str(tmp_path / "ckpt"),
                        checkpoint_every=2)
    _run(mesh, cfg, _waves(2, 4), campaign=cc, stop_after_steps=2)
    for campaign, cfg_, waves in (
        (dataclasses.replace(cc, seed=1), cfg, _waves(2, 4)),          # another wave set
        (dataclasses.replace(cc, method="baseline1"), cfg, _waves(2, 4)),  # the same carry structure
        (cc, _cfg(dt=0.02), _waves(2, 4)),                               # other physics
        (cc, cfg, _waves(2, 4, seed=9)),                                 # other wave data
        (cc, _cfg(tile_e=8), _waves(2, 4)),                              # another kernel backend
    ):
        with pytest.raises(ValueError, match="different campaign"):
            _run(mesh, cfg_, waves, campaign=campaign)
    # the resolved backend is in the signature: the card's kernels and their
    # plain versions never share a checkpoint
    waves, obs = _waves(2, 4), mesh.surface[:1]
    on_cpu = _campaign_sig(cc, cfg, waves, 2, obs, "ebe=torch,ms=torch,tile_e=16,tile_p=4")
    on_card = _campaign_sig(cc, cfg, waves, 2, obs, "ebe=cuda,ms=cuda,tile_e=16,tile_p=4")
    assert not np.array_equal(on_cpu, on_card)
    assert np.array_equal(on_cpu, _campaign_sig(cc, cfg, waves, 2, obs, "ebe=torch,ms=torch,tile_e=16,tile_p=4"))


def test_case_topology_one_device_only(meshes):
    """One device is no mesh.  Two entries in this process own rounds of
    ``2·kset`` and run as its local mesh; more devices than this process
    has raise the reference's message.  Two CPU entries at kset 2 over two
    waves: entry 0 holds the one-entry run's k-set, lane for lane, so its
    cases are bitwise that run's (entry 1 holds padding repeats only)."""
    assert case_topology(None, 3) == CaseTopology(1, 0, 1, 0, 3, None)
    assert launch_mesh.make_case_mesh() is None and launch_mesh.make_case_mesh(1) is None
    two_here = launch_mesh.CaseMesh(np.array([launch_mesh.CaseDevice(0, "cpu")] * 2, dtype=object))
    assert case_topology(two_here, 2) == CaseTopology(2, 0, 1, 0, 4, two_here)
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        launch_mesh.make_case_mesh(2)
    _, mesh = meshes
    waves = _waves(2, 4)
    one = _run(mesh, _cfg(), waves, campaign=CampaignConfig(kset=2))
    two = _run(mesh, _cfg(), waves, campaign=CampaignConfig(kset=2), device_mesh=two_here)
    assert two.completed and two.rounds_done == 1 and two.case_indices.tolist() == [0, 1]
    assert np.array_equal(two.velocity_history, one.velocity_history)
    assert np.array_equal(two.iters, one.iters)


# ---------------------------------------------------------------------------
# guarded campaigns (tests/test_health.py:175-268)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["proposed2", "proposed1"])
def test_nan_injection_quarantines_without_contagion(meshes, method):
    """A NaN in case 1's forcing trips its health word (the reference's
    word, bit for bit) and freezes it; cases 0 and 2 are bitwise the
    uninjected guarded run, and that one bitwise the unguarded run.
    Proposed 1's θ is a PartitionedState of ``[k, chunk, S]`` blocks: the
    guard checks and freezes them too."""
    ref_mesh, mesh = meshes
    waves = _waves(3, 8)
    poisoned = faults.nan_at_step(waves, 3, case=1)
    obs = mesh.surface[:1]
    with jax.enable_x64(True):
        ref = ref_run_campaign(ref_mesh, ref_methods.SeismicConfig(**KW, health=True), poisoned, observe=obs,
                               campaign=RefCampaignConfig(kset=3, method=method))
        ref_health, ref_ncg = np.asarray(ref.health), np.asarray(ref.nonconverged)
    cc = CampaignConfig(kset=3, method=method, seed=0)
    cfg_g = _cfg(health=True)
    clean = _run(mesh, cfg_g, waves, observe=obs, campaign=cc)
    bad = _run(mesh, cfg_g, poisoned, observe=obs, campaign=cc)
    plain = _run(mesh, _cfg(), waves, observe=obs, campaign=cc)
    np.testing.assert_array_equal(bad.health, ref_health)
    np.testing.assert_array_equal(bad.nonconverged, ref_ncg)
    np.testing.assert_array_equal(bad.diverged_cases(), ref.diverged_cases())
    assert clean.health.shape == (3,) and not clean.diverged_cases().size
    assert plain.health.size == 0 and not plain.diverged_cases().size
    np.testing.assert_array_equal(clean.velocity_history, plain.velocity_history)
    assert list(bad.diverged_cases()) == [1]
    assert "solver_nonfinite" in health.describe(bad.health[1])
    for sib in (0, 2):
        np.testing.assert_array_equal(bad.velocity_history[sib], clean.velocity_history[sib])
    assert np.isfinite(bad.velocity_history).all()


def test_guarded_kill_and_resume_bit_identity(tmp_path, meshes):
    """The health words ride the carry, so checkpoints capture them: a killed
    and resumed guarded campaign equals the straight-through run."""
    _, mesh = meshes
    waves = faults.nan_at_step(_waves(4, 8), 2, case=2)
    obs = mesh.surface[:1]
    cfg = _cfg(health=True)
    cc = CampaignConfig(kset=2, method="proposed2", seed=0, checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=3)
    ref = _run(mesh, cfg, waves, observe=obs, campaign=CampaignConfig(kset=2, method="proposed2"))
    part = _run(mesh, cfg, waves, observe=obs, campaign=cc, stop_after_steps=5)
    assert not part.completed
    full = _run(mesh, cfg, waves, observe=obs, campaign=cc)
    assert full.completed and full.resumed_from is not None
    np.testing.assert_array_equal(full.velocity_history, ref.velocity_history)
    np.testing.assert_array_equal(full.iters, ref.iters)
    np.testing.assert_array_equal(full.health, ref.health)
    np.testing.assert_array_equal(full.nonconverged, ref.nonconverged)
    assert list(full.diverged_cases()) == [2]


def test_campaign_resumes_past_corrupt_checkpoint(tmp_path, meshes, capsys):
    """A flipped byte in the newest checkpoint costs one chunk, not the
    campaign: the resume falls back to the previous step and the finished
    trajectory is still bitwise the straight run's."""
    _, mesh = meshes
    waves = _waves(4, 8)
    obs = mesh.surface[:1]
    cfg = _cfg(health=True)
    d = str(tmp_path / "ck")
    cc = CampaignConfig(kset=2, method="proposed2", seed=0, checkpoint_dir=d, checkpoint_every=3)
    ref = _run(mesh, cfg, waves, observe=obs, campaign=CampaignConfig(kset=2, method="proposed2"))
    part = _run(mesh, cfg, waves, observe=obs, campaign=cc, stop_after_steps=5)
    assert not part.completed
    steps = sorted(glob.glob(os.path.join(d, "step_*")))
    assert len(steps) >= 2
    leaf = sorted(glob.glob(os.path.join(steps[-1], "carry", "*.npy")))[0]
    faults.corrupt_shard_byte(leaf, offset=-8)
    full = _run(mesh, cfg, waves, observe=obs, campaign=cc)
    newest = max(int(os.path.basename(s).split("_")[1]) for s in steps)
    assert full.completed and full.resumed_from < newest
    assert "falling back" in capsys.readouterr().err
    np.testing.assert_array_equal(full.velocity_history, ref.velocity_history)
    np.testing.assert_array_equal(full.health, ref.health)
