"""The port's scenario catalog, dataset shards and campaign CLI against the
reference's, both packages on the same numpy inputs on the CPU.

Waves are bitwise the reference's (both run the same numpy); shards
written by either package are read by the other, with their CRCs checked;
a flipped byte and a non-finite payload are refused.  The port's CLI runs a
checkpointed campaign killed with ``--stop-after-steps`` and relaunched,
bitwise equal to an uninterrupted run, and its shards agree with the
reference CLI's for the same flags within 1e-6·max|y| (Proposed 2, whose
fp32 inner solve sums in another order than XLA's).
"""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest

from repro.core import faults as ref_faults
from repro.scenario import catalog as ref_catalog
from repro.surrogate import dataset as ref_dataset
from repro_torch.fem import meshgen, methods
from repro_torch.launch import campaign as cli
from repro_torch.scenario import catalog
from repro_torch.surrogate import dataset


@pytest.mark.parametrize("family", catalog.WAVE_FAMILIES)
def test_wave_families_bitwise(family):
    kw = dict(family=family, fmax=3.0, f0=1.2, pulses=4, amp_xy=0.5, amp_z=0.2, taper_frac=0.1)
    for n, nt, dt, seed in ((3, 64, 0.01, 0), (2, 9, 0.02, 7)):
        w = catalog.WaveSpec(**kw).synthesize(n, nt, dt, seed)
        np.testing.assert_array_equal(w, ref_catalog.WaveSpec(**kw).synthesize(n, nt, dt, seed), strict=True)
        assert w.shape == (n, nt, 3) and np.abs(w.mean(axis=1)).max() < 1e-12


def test_band_limited_waves_and_taper_bitwise():
    for n, nt, seed in ((5, 32, 0), (3, 7, 3)):
        cfg = dataset.EnsembleConfig(n_waves=n, nt=nt, seed=seed)
        ref_cfg = ref_dataset.EnsembleConfig(n_waves=n, nt=nt, seed=seed)
        np.testing.assert_array_equal(dataset.random_band_limited_waves(cfg),
                                      ref_dataset.random_band_limited_waves(ref_cfg), strict=True)
    for nt, frac in ((10, 0.05), (7, 0.4), (3, 0.0)):
        np.testing.assert_array_equal(catalog.cosine_taper(nt, frac), ref_catalog.cosine_taper(nt, frac))


def test_scenarios_match_the_reference():
    """Signatures and compile keys are the reference's digests; soil
    perturbations give the reference's materials, and observation grids
    its nodes, on the port's mesh."""
    for name in catalog.CATALOG:
        scn, ref = catalog.get(name), ref_catalog.get(name)
        assert (scn.signature(), scn.compile_key()) == (ref.signature(), ref.compile_key())
        np.testing.assert_array_equal(scn.waves(), ref.waves(), strict=True)
        assert [dataclasses.asdict(m) for m in scn.soil.materials()] == [
            dataclasses.asdict(m) for m in ref.soil.materials()]
    scn = dataclasses.replace(catalog.get("pulse-grid-obs"), mesh_n=(2, 2, 2))
    ref = dataclasses.replace(ref_catalog.get("pulse-grid-obs"), mesh_n=(2, 2, 2))
    mesh = scn.build_mesh()
    np.testing.assert_array_equal(scn.obs.indices(mesh), ref.obs.indices(ref.build_mesh()))
    np.testing.assert_array_equal(mesh.coords, ref.build_mesh().coords)
    cfg = scn.sim_config(warm_start=True)
    assert isinstance(cfg, methods.SeismicConfig) and (cfg.dt, cfg.nspring, cfg.warm_start) == (0.01, 12, True)
    assert scn.signature() != dataclasses.replace(scn, soil=catalog.SoilSpec(vs=(0.9, 1.0))).signature()
    assert scn.signature() == dataclasses.replace(scn, name="other").signature()
    with pytest.raises(KeyError, match="unknown scenario"):
        catalog.get("nonesuch")
    with pytest.raises(ValueError, match="wave family"):
        catalog.WaveSpec(family="sine")


def _xy(n=5, nt=6, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, nt, 3)).astype(np.float32)
    return x, (2 * x).astype(np.float32)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_shards_cross_packages(tmp_path, writer):
    """Flat shards with ``meta`` and a process tree (``p00/``, ``p01/``)
    written by either package are read back by the other."""
    W, R = (ref_dataset, dataset) if writer == "reference" else (dataset, ref_dataset)
    x, y = _xy()
    d = str(tmp_path / "flat")
    paths = W.save_shards(d, x, y, shard_size=2, meta={"trajectories": True, "obs_every": 2})
    assert [os.path.basename(p) for p in paths] == ["shard_00000.npz", "shard_00001.npz", "shard_00002.npz"]
    assert R.committed(d)
    xs, ys = R.load_shards(d)
    np.testing.assert_array_equal(xs, x, strict=True)
    np.testing.assert_array_equal(ys, y, strict=True)
    assert [a.shape[0] for a, _ in R.iter_shards(d)] == [2, 2, 1]
    meta = R.shard_meta(d)
    assert (meta["n"], meta["nt"], meta["shards"], meta["obs_every"]) == (5, 6, 3, 2)
    assert meta == json.load(open(os.path.join(d, "index.json")))
    tree = str(tmp_path / "tree")
    for k in range(2):
        W.save_shards(os.path.join(tree, f"p{k:02d}"), x[k::2], y[k::2], shard_size=2)
    xs, _ = R.load_shards(tree)
    np.testing.assert_array_equal(xs, np.concatenate([x[0::2], x[1::2]]))
    assert R.shard_paths(tree) == W.shard_paths(tree)


def test_shard_checksum_refusal_and_nonfinite_payload(tmp_path):
    x, y = _xy(4, 8)
    d = str(tmp_path / "sh")
    paths = dataset.save_shards(d, x, y, shard_size=2)
    ref_faults.corrupt_shard_byte(paths[0], offset=-1)
    with pytest.raises(dataset.ShardIntegrityError, match="checksum"):
        dataset.load_shards(d)
    with pytest.raises(ref_dataset.ShardIntegrityError, match="checksum"):
        ref_dataset.load_shards(d)  # the port's CRC is the reference's
    ref_faults.corrupt_shard_byte(paths[0], offset=-1)  # un-flip: loads again
    np.testing.assert_array_equal(dataset.load_shards(d)[0], x)
    idx = json.load(open(os.path.join(d, "index.json")))
    del idx["checksums"]  # a legacy index without checksums verifies nothing
    json.dump(idx, open(os.path.join(d, "index.json"), "w"))
    dataset.load_shards(d)
    y_bad = y.copy()
    y_bad[1, 0, 0] = np.inf
    with pytest.raises(dataset.NonFinitePayloadError, match="case"):
        dataset.save_shards(str(tmp_path / "bad"), x, y_bad, shard_size=2)
    assert not os.path.exists(os.path.join(str(tmp_path / "bad"), "index.json"))
    with pytest.raises(ValueError, match="reserved"):
        dataset.save_shards(str(tmp_path / "r"), x, y, meta={"n": 3})
    with pytest.raises(FileNotFoundError):
        dataset.load_shards(str(tmp_path / "none"))


FLAGS = ["--waves", "3", "--nt", "6", "--mesh-n", "2x2x2", "--kset", "2", "--ckpt-every", "2", "--shard-size", "2"]


def test_cli_kill_resume_and_reference_shards(tmp_path, capsys):
    """The port's CLI on the CPU: killed after step 7 and relaunched, its
    velocities and iterations are bitwise an uninterrupted run's; a third
    launch is a pure restore; its shards agree with the reference CLI's."""
    port = [*FLAGS, "--device", "cpu"]
    straight = {}
    assert cli.main([*port, "--out", str(tmp_path / "straight")], result=straight) == 0
    ck = ["--ckpt-dir", str(tmp_path / "ck"), "--out", str(tmp_path / "out")]
    assert cli.main([*port, *ck, "--stop-after-steps", "7"]) == 0
    assert "[stopped] after 8 global steps (1 rounds banked)" in capsys.readouterr().out
    assert not dataset.committed(str(tmp_path / "out"))
    resumed, again = {}, {}
    assert cli.main([*port, *ck], result=resumed) == 0
    out = capsys.readouterr().out
    assert "[resume] from checkpoint step 8" in out and "[done] 3 responses" in out and "[shards] wrote 2" in out
    assert cli.main([*port, *ck], result=again) == 0
    for r in (resumed, again):
        np.testing.assert_array_equal(r["campaign"].velocity_history, straight["campaign"].velocity_history)
        np.testing.assert_array_equal(r["campaign"].iters, straight["campaign"].iters)
    x, y = dataset.load_shards(str(tmp_path / "out"))
    np.testing.assert_array_equal(y, straight["responses"])
    with jax.enable_x64(True):
        from repro.launch import campaign as ref_cli

        assert ref_cli.main([*FLAGS, "--out", str(tmp_path / "ref")]) == 0
    rx, ry = ref_dataset.load_shards(str(tmp_path / "ref"))
    np.testing.assert_array_equal(x, rx, strict=True)
    assert ry.shape == y.shape == (3, 6, 3) and np.abs(ry).max() > 0
    np.testing.assert_allclose(y, ry, atol=1e-6 * np.abs(ry).max(), rtol=0)
    meta, ref_meta = dataset.shard_meta(str(tmp_path / "out")), ref_dataset.shard_meta(str(tmp_path / "ref"))
    assert meta.pop("checksums").keys() == ref_meta.pop("checksums").keys() and meta == ref_meta


def test_cli_quarantines_injected_nan_and_harvests_trajectories(tmp_path, capsys):
    d = str(tmp_path / "out")
    assert cli.main([*FLAGS, "--device", "cpu", "--out", d, "--inject", "nan_at_step=2,case=1",
                     "--trajectories", "--obs-every", "2"]) == 0
    out = capsys.readouterr().out
    assert "[inject] nan_at_step=2,case=1" in out and "[quarantine] case 1: " in out
    meta = dataset.shard_meta(d)
    assert (meta["quarantine"], meta["n"], meta["trajectories"], meta["obs_every"]) == ([1], 2, True, 2)
    x, y = ref_dataset.load_shards(d)
    waves = dataset.random_band_limited_waves(dataset.EnsembleConfig(n_waves=3, nt=6))
    np.testing.assert_array_equal(x, waves[[0, 2]].astype(np.float32))
    assert y.shape == (2, 3, 3) and np.isfinite(y).all()


def test_generate_matches_the_campaign(tmp_path):
    """``generate`` is the campaign at the basin's observation point: the
    CLI's responses for the same ensemble, and its trajectory stride."""
    cfg = dataset.EnsembleConfig(n_waves=3, nt=6, mesh_n=(2, 2, 2))
    res = {}
    cli.main([*FLAGS, "--device", "cpu", "--no-warm-start", "--no-health"], result=res)
    x, y = dataset.generate(cfg, device="cpu", checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=2)
    np.testing.assert_array_equal(x, dataset.random_band_limited_waves(cfg).astype(np.float32))
    np.testing.assert_array_equal(y, res["campaign"].velocity_history[:, :, 0, :].astype(np.float32))
    _, yt = dataset.generate(cfg, device="cpu", trajectories=True, obs_every=4)
    np.testing.assert_array_equal(yt, y[:, ::4])
    assert meshgen.generate(2, 2, 2, pad_elems_to=8).n_elem % 8 == 0
