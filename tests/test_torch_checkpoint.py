"""The port's CheckpointManager: the cases of tests/test_checkpoint.py run on
it (empty/torn directories, GC, sharded checkpoints emulated in one process
with a no-op barrier, world-size refusal, meta agreement), its torch
leaves, and the on-disk format shared with the JAX package: a plain tree
written by either package is restored by the other, and a campaign
checkpoint the reference wrote is refused by the port's runner as a
different campaign."""
import json
import os
import shutil
from collections import namedtuple

import jax
import numpy as np
import pytest
import torch

from repro.campaign import CampaignConfig as RefCampaignConfig, run_campaign as ref_run_campaign
from repro.core import faults as ref_faults
from repro.fem import meshgen as ref_meshgen, methods as ref_methods
from repro.training.checkpoint import CheckpointManager as RefCheckpointManager
from repro_torch import convert
from repro_torch.campaign import CampaignConfig, run_campaign
from repro_torch.core.hetmem import PartitionedState
from repro_torch.fem import methods
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.checkpoint import CheckpointCorruptError, CheckpointManager

NOOP = lambda: None  # noqa: E731
Pair = namedtuple("Pair", "u v")


def _state(v):
    return {"params": {"w": np.full((3,), float(v))}}


def _like():
    return {"params": {"w": np.zeros((3,))}}


# ---------------------------------------------------------------------------
# single-process edge cases (tests/test_checkpoint.py)
# ---------------------------------------------------------------------------


def test_restore_latest_empty_directory(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.restore_latest(_like()) is None
    assert mgr.latest_step() is None and mgr.all_steps() == []


def test_restore_latest_skips_torn_final_checkpoint(tmp_path):
    d = str(tmp_path / "ckpt")
    mgr = CheckpointManager(d)
    mgr.save(1, _state(1.0), blocking=True)
    mgr.save(2, _state(2.0), blocking=True)
    os.makedirs(os.path.join(d, "step_000000003"))      # torn: no manifest
    os.makedirs(os.path.join(d, "step_000000004.tmp"))  # in-flight debris
    step, st = mgr.restore_latest(_like())
    assert step == 2
    np.testing.assert_array_equal(st["params"]["w"], 2.0)
    mgr.save(5, _state(5.0), blocking=True)
    with open(os.path.join(d, "step_000000005", "manifest.json"), "w") as f:
        f.write("{not json")
    step, _ = mgr.restore_latest(_like())
    assert step == 2


def test_gc_keeps_newest(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _state(s), blocking=True)
    assert mgr.all_steps() == [3, 4]


def test_meta_recorded_in_single_process_manifest(tmp_path):
    d = str(tmp_path / "ckpt")
    CheckpointManager(d).save(1, _state(1.0), blocking=True, meta={"round": 4, "t": 2})
    with open(os.path.join(d, "step_000000001", "manifest.json")) as f:
        assert json.load(f)["meta"] == {"round": 4, "t": 2}


def test_corrupt_leaf_refused_and_restore_latest_falls_back(tmp_path, capsys):
    d = str(tmp_path / "ckpt")
    mgr = CheckpointManager(d)
    mgr.save(1, {"params": {"w": np.ones((4,))}}, blocking=True)
    mgr.save(2, {"params": {"w": np.full((4,), 2.0)}}, blocking=True)
    like = {"params": {"w": np.zeros((4,))}}
    ckpt_leaf = os.path.join(d, "step_000000002", "params", "00000.npy")
    ref_faults.corrupt_shard_byte(ckpt_leaf, offset=-1)
    with pytest.raises(CheckpointCorruptError, match="checksum"):
        mgr.restore(2, like)
    step, st = mgr.restore_latest(like)
    assert step == 1
    np.testing.assert_array_equal(st["params"]["w"], 1.0)
    assert "falling back" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# sharded checkpoints, emulated in-process (tests/test_checkpoint.py)
# ---------------------------------------------------------------------------


def _pair(d, **kw):
    return [CheckpointManager(d, process_index=k, process_count=2, barrier=NOOP, **kw) for k in range(2)]


def _save_pair(mgrs, step, vals, meta):
    # p1 first: with a no-op barrier, p0's save commits the manifest
    for mgr, v in list(zip(mgrs, vals))[::-1]:
        mgr.save(step, _state(v), meta=meta)


def test_sharded_save_restore_roundtrip(tmp_path):
    d = str(tmp_path / "ckpt")
    mgrs = _pair(d)
    _save_pair(mgrs, 7, (10.0, 20.0), {"round": 1, "t": 3})
    for k, mgr in enumerate(mgrs):
        step, st = mgr.restore_latest(_like())
        assert step == 7
        np.testing.assert_array_equal(st["params"]["w"], (k + 1) * 10.0)
    assert os.path.exists(os.path.join(d, "step_000000007.commit.json"))


def test_sharded_uncommitted_step_is_invisible(tmp_path):
    d = str(tmp_path / "ckpt")
    mgrs = _pair(d)
    _save_pair(mgrs, 1, (1.0, 2.0), {"round": 0, "t": 1})
    mgrs[1].save(2, _state(9.0), meta={"round": 0, "t": 2})  # p1 only, no commit
    for mgr in mgrs:
        assert mgr.restore_latest(_like())[0] == 1


def test_sharded_round_meta_mismatch_refused(tmp_path):
    d = str(tmp_path / "ckpt")
    mgrs = _pair(d)
    _save_pair(mgrs, 3, (1.0, 2.0), {"round": 1, "t": 0})
    shard = os.path.join(d, "step_000000003.p01", "manifest.json")
    with open(shard) as f:
        man = json.load(f)
    man["meta"] = {"round": 2, "t": 5}
    with open(shard, "w") as f:
        json.dump(man, f)
    with pytest.raises(ValueError, match="disagree"):
        mgrs[0].restore_latest(_like())


def test_sharded_missing_shard_refused(tmp_path):
    d = str(tmp_path / "ckpt")
    mgrs = _pair(d)
    _save_pair(mgrs, 3, (1.0, 2.0), {"round": 1, "t": 0})
    shutil.rmtree(os.path.join(d, "step_000000003.p01"))
    with pytest.raises(ValueError, match="missing"):
        mgrs[0].restore_latest(_like())


def test_world_size_mismatch_refused_both_directions(tmp_path):
    d2 = str(tmp_path / "two")
    _save_pair(_pair(d2), 5, (1.0, 2.0), {"round": 0, "t": 5})
    with pytest.raises(ValueError, match="world size"):
        CheckpointManager(d2).restore_latest(_like())
    d1 = str(tmp_path / "one")
    CheckpointManager(d1).save(5, _state(1.0), blocking=True)
    mgr = CheckpointManager(d1, process_index=0, process_count=2, barrier=NOOP)
    with pytest.raises(ValueError, match="world size"):
        mgr.restore_latest(_like())


def test_sharded_gc_cleans_shards_commits_and_orphans(tmp_path):
    d = str(tmp_path / "ckpt")
    mgrs = _pair(d, keep=1)
    _save_pair(mgrs, 1, (1.0, 2.0), {"round": 0, "t": 1})
    mgrs[1].save(2, _state(9.9), meta={"round": 0, "t": 2})  # orphan shard
    _save_pair(mgrs, 3, (3.0, 4.0), {"round": 0, "t": 3})
    for mgr in mgrs:
        mgr._gc()
    assert sorted(os.listdir(d)) == ["step_000000003.commit.json", "step_000000003.p00", "step_000000003.p01"]


def test_sharded_manager_needs_a_barrier(tmp_path, monkeypatch):
    """A sharded manager without an injected barrier synchronises through
    the process group's (``parallel.distributed.barrier``, tag ``ckpt``),
    once before process 0 commits and once after."""
    from repro_torch.parallel import distributed as dist

    tags = []
    monkeypatch.setattr(dist, "barrier", tags.append)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), process_index=0, process_count=2)
    mgr.save(1, _state(1.0), meta={"round": 0, "t": 1})
    assert tags == ["ckpt", "ckpt"]
    assert os.path.exists(tmp_path / "ckpt" / "step_000000001.commit.json")
    with pytest.raises(ValueError, match="outside"):
        CheckpointManager(str(tmp_path / "ckpt"), process_index=2, process_count=2, barrier=NOOP)


# ---------------------------------------------------------------------------
# the port's leaves, and the format shared with the JAX package
# ---------------------------------------------------------------------------


def _tree(xp):
    """A plain tree of dicts, lists, tuples and a NamedTuple, in numpy or torch."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((2, 3))
    return {"model": {"w": xp(a), "b": xp(np.arange(4, dtype=np.int32))},
            "layers": [xp(a[0]), (xp(np.float32(1.5) * np.ones(2, np.float32)), xp(np.zeros((0, 3))))],
            "nm": Pair(u=xp(a.T.copy()), v=xp(np.array([True, False])))}


def test_leaf_names_are_jax_keystr():
    tree = _tree(np.asarray)
    want = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert [name for name, _ in ckpt._paths(tree)] == want
    assert [name for name, _ in ckpt._paths(_tree(torch.as_tensor))] == want
    ps = PartitionedState(blocks=[[torch.zeros(1), torch.ones(2)], [torch.ones(3), torch.zeros(4)]])
    assert [n for n, _ in ckpt._paths({"s": ps, "n": None})] == [
        "['s'].blocks[0][0]", "['s'].blocks[0][1]", "['s'].blocks[1][0]", "['s'].blocks[1][1]"]


def test_torch_leaves_round_trip(tmp_path):
    """Tensors come back as tensors of their dtype and shape, on the like's
    device; python numbers as python numbers; numpy as numpy; a
    PartitionedState as one."""
    ps = PartitionedState(blocks=[[torch.arange(3.0)], [torch.arange(3.0, 6.0)]])
    state = {"carry": (Pair(u=torch.randn(2, 4, dtype=torch.float64), v=torch.arange(5, dtype=torch.int32)), ps, 7,
                       2.5, True),
             "obs": np.arange(6.0).reshape(2, 3)}
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(3, state, blocking=True)
    like = {"carry": (Pair(u=torch.zeros(1, dtype=torch.float64), v=torch.zeros(1, dtype=torch.int32)),
                      PartitionedState(blocks=[[torch.zeros(1)], [torch.zeros(1)]]), 0, 0.0, False),
            "obs": np.zeros(())}
    step, st = mgr.restore_latest(like)
    assert step == 3
    nm, ps2, n, x, flag = st["carry"]
    assert isinstance(nm, Pair) and torch.equal(nm.u, state["carry"][0].u) and nm.v.dtype == torch.int32
    assert torch.equal(nm.v, state["carry"][0].v)
    assert isinstance(ps2, PartitionedState) and all(torch.equal(a[0], b[0]) for a, b in zip(ps2.blocks, ps.blocks))
    assert (type(n), n, type(x), x, type(flag), flag) == (int, 7, float, 2.5, bool, True)
    assert isinstance(st["obs"], np.ndarray)
    np.testing.assert_array_equal(st["obs"], state["obs"])
    assert [r["op"] for r in mgr.log] == ["save", "restore"]
    assert mgr.log[0]["bytes"] == mgr.log[1]["bytes"] > 0


def test_restore_in_place_fills_the_like(tmp_path):
    """``in_place`` returns ``like``'s own tensors holding the saved values
    (python numbers still come back as values) and refuses a tensor of
    another shape or dtype."""
    saved = (torch.randn(2, 4, dtype=torch.float64), torch.arange(3, dtype=torch.int32), 7)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(1, {"carry": saved}, blocking=True)
    like = (torch.zeros(2, 4, dtype=torch.float64), torch.zeros(3, dtype=torch.int32), 0)
    u, v, n = mgr.restore(1, {"carry": like}, in_place=True)["carry"]
    assert u is like[0] and v is like[1] and n == 7
    assert torch.equal(u, saved[0]) and torch.equal(v, saved[1])
    for wrong in ((torch.zeros(4, 2, dtype=torch.float64), like[1], 0),
                  (torch.zeros(2, 4, dtype=torch.float32), like[1], 0)):
        with pytest.raises(ValueError, match="to restore into"):
            mgr.restore(1, {"carry": wrong}, in_place=True)


@pytest.mark.parametrize("arr", [
    np.random.default_rng(2).standard_normal((3, 5)), np.int64(7), np.arange(6, dtype=np.int32) > 2,
    np.asfortranarray(np.arange(12.0).reshape(3, 4)), np.zeros((0, 3)),
], ids=["f64", "scalar", "bool", "fortran", "empty"])
def test_crc_taken_while_writing_is_the_file_crc(tmp_path, arr):
    """The manifest's CRC, taken from host memory as the leaf is written, is
    the CRC32 of the file's bytes that restore checks."""
    arr = np.asarray(arr)
    p = str(tmp_path / "leaf.npy")
    np.save(p, arr)
    assert ckpt._crc_saved(p, arr) == ckpt._crc(p)


def test_save_copies_before_it_returns(tmp_path):
    """The background write reads host copies taken in ``save``: a tensor
    changed in place right after ``save`` returns is saved as it was."""
    t = torch.zeros(1 << 16, dtype=torch.float64)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(1, {"carry": {"x": t}})
    t.fill_(1.0)  # as the health guard writes a tripped lane into the carry
    mgr.wait()
    _, st = mgr.restore_latest({"carry": {"x": torch.empty(0, dtype=torch.float64)}})
    assert float(st["carry"]["x"].abs().max()) == 0.0


def test_background_write_error_surfaces(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(1, {"a": {"x": np.ones(2)}}, blocking=True)
    shutil.rmtree(str(tmp_path / "ckpt"))
    with open(str(tmp_path / "ckpt"), "w"):  # the directory is now a file
        pass
    mgr.save(2, {"a": {"x": np.ones(2)}})
    with pytest.raises(OSError):
        mgr.wait()


def test_crc_is_chunked_crc32(tmp_path, monkeypatch):
    import zlib

    p = str(tmp_path / "blob")
    data = np.random.default_rng(1).bytes(1000)
    with open(p, "wb") as f:
        f.write(data)
    monkeypatch.setattr(ckpt, "_CRC_CHUNK", 7)
    assert ckpt._crc(p) == zlib.crc32(data) & 0xFFFFFFFF


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_plain_trees_cross_packages(tmp_path, writer):
    """A dict-of-arrays tree with ``meta`` written by either package is
    restored by the other, bitwise, with its manifest's meta."""
    d = str(tmp_path / "ckpt")
    tree = _tree(np.asarray)
    meta = {"round": 2, "t": 5}
    W, R = (RefCheckpointManager, CheckpointManager) if writer == "reference" else (CheckpointManager,
                                                                                  RefCheckpointManager)
    saved = {"state": tree, "head": {"sig": np.arange(5, dtype=np.int64)}}
    like = {"state": _tree(np.zeros_like), "head": {"sig": np.zeros(5, np.int64)}}
    with jax.enable_x64(True):  # the reference restores fp64 and int64 leaves only under x64
        W(d).save(11, saved, blocking=True, meta=meta)
        step, st = R(d).restore_latest(like)
    assert step == 11
    got, want = ckpt._paths(st), ckpt._paths(saved)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), b, strict=True)
    with open(os.path.join(d, "step_000000011", "manifest.json")) as f:
        assert json.load(f)["meta"] == meta


def test_reference_campaign_checkpoint_is_a_different_campaign(tmp_path):
    """The reference's campaign checkpoint reads as a checkpoint to the
    port (the meta head restores), and its signature refuses it — not a
    structure error."""
    ref_mesh = ref_meshgen.generate(2, 2, 2, pad_elems_to=4)
    kw = dict(dt=0.01, tol=1e-8, maxiter=600, npart=2, nspring=12)
    rng = np.random.default_rng(0)
    waves = np.zeros((2, 4, 3))
    waves[:, :, 0] = 0.3 * rng.normal(size=(2, 4))
    d = str(tmp_path / "ckpt")
    with jax.enable_x64(True):
        part = ref_run_campaign(ref_mesh, ref_methods.SeismicConfig(**kw), waves, stop_after_steps=2,
                                campaign=RefCampaignConfig(kset=2, method="proposed2", checkpoint_dir=d,
                                                           checkpoint_every=2))
    assert not part.completed
    with pytest.raises(ValueError, match="different campaign"):
        run_campaign(convert.mesh_from_arrays(ref_mesh), methods.SeismicConfig(**kw), waves, device="cpu",
                     campaign=CampaignConfig(kset=2, method="proposed2", checkpoint_dir=d, checkpoint_every=2))
