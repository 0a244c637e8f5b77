"""LM training over a (data, model) device mesh, on the CPU.

Reduced qwen3 (4 query heads over 2 kv heads, vocab 256, fp32) on a global
batch of 8 × 64 tokens, with AdamW's clip norm small enough to bind, over
two meshes of four gloo CPU processes (one group, both meshes in turn):

* (2, 2) over (data, model): heads and kv heads split over ``model``, the
  residual stream sequence-split (``act_seq``);
* (1, 4): 2 kv heads do not divide 4, so the rules pick split-Q
  (``attn_q``); the port lays the heads out over ``model`` with the kv
  heads replicated, each process reading its query heads' kv heads.

Held against the JAX package's ``make_train_step`` on four forced host
devices laid out as the same mesh (a subprocess), from the same numpy
parameters and tokens: the first loss and 3 steps' losses within 1e-5
relative, step 1's gradients within 1e-4·max|g| per leaf (the tolerances
of ``test_torch_training.py``); and against the port on one process within
the same.  Each process holds ``ShardSpec.shard_shape`` of every leaf; the
offloaded optimizer equals the resident one bitwise on every process; a
(2, 2) checkpoint restores bitwise onto (1, 4) and onto one process; the
compressed all-reduce runs over the mesh's ``data`` axis; one token a row
trains as on one process.  The train CLI trains on a (2, 2) mesh of four
processes it launches itself (``--host-devices 4``), and refuses a mesh
whose processes' whole parameter trees exceed the host's memory.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import ARCHS
from repro_torch.models import transformer as T
from repro_torch.parallel.distributed import free_port
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.optimizer import AdamWConfig, global_norm
from repro_torch.training.train_step import TrainConfig, init_train_state, make_loss_fn, make_train_step, value_and_grad
from repro_torch.utils.tree import leaves_with_paths

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = [(2, 2), (1, 4)]
CLIP = 0.05
STEPS = 3
CFG = ARCHS["qwen3-1.7b"].reduced()

REFERENCE = """
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import ARCHS
from repro.launch.mesh import make_host_mesh
from repro.models import transformer as T
from repro.parallel import sharding as sh
from repro.training.optimizer import AdamWConfig
from repro.training.train_step import TrainConfig, init_train_state, make_loss_fn, make_train_step

d = pickle.load(open(sys.argv[1], "rb"))
cfg = ARCHS["qwen3-1.7b"].reduced()
tcfg = TrainConfig(adamw=AdamWConfig(learning_rate=1e-3, warmup_steps=2, grad_clip_norm=d["clip"]))
out = {}
for shape in d["meshes"]:
    mesh = make_host_mesh(shape)
    rules = sh.rules_for(cfg, mesh, kind="train", global_batch=8, seq_len=64)
    with mesh, sh.use_mesh(mesh, rules):
        _, pspecs = T.init_params(cfg, jax.random.key(0))
        pshard = sh.tree_shardings(pspecs, mesh, rules)
        params = jax.tree_util.tree_map(lambda a, s: jax.device_put(jnp.asarray(a), s), d["params"], pshard)
        batch = {"tokens": jnp.asarray(d["tokens"]), "labels": jnp.asarray(d["tokens"])}
        (loss, _), grads = jax.jit(jax.value_and_grad(make_loss_fn(cfg, tcfg), has_aux=True))(params, batch)
        opt = init_train_state(cfg, tcfg, params)
        step = jax.jit(make_train_step(cfg, tcfg))
        losses = []
        for _ in range(d["steps"]):
            params, opt, m = step(params, opt, batch)
            losses.append(float(m["loss"]))
        out[tuple(shape)] = {"loss": float(loss), "grads": jax.tree_util.tree_map(np.asarray, grads),
                             "losses": losses}
pickle.dump(out, open(sys.argv[2], "wb"))
"""

WORKER = """
import dataclasses, json, os, pickle, sys
import numpy as np, torch
torch.set_num_threads(1)
from repro_torch.launch import bootstrap
rank, coordinator, tmp = int(sys.argv[1]), sys.argv[2], sys.argv[3]
bootstrap.distributed_init(coordinator=coordinator, num_processes=4, process_id=rank)
from repro_torch import convert
from repro_torch.configs import ARCHS
from repro_torch.core.offload import OffloadConfig
from repro_torch.launch.mesh import make_auto_mesh
from repro_torch.models import transformer as T
from repro_torch.parallel import compression, sharding as sh
from repro_torch.training import data as D
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.optimizer import AdamWConfig, global_norm
from repro_torch.training.train_step import TrainConfig, init_train_state, make_loss_fn, make_train_step, value_and_grad
from repro_torch.utils.tree import leaves_with_paths, tree_leaves

d = pickle.load(open(os.path.join(tmp, "inputs.pkl"), "rb"))
cfg = ARCHS["qwen3-1.7b"].reduced()
tcfg = TrainConfig(adamw=AdamWConfig(learning_rate=1e-3, warmup_steps=2, grad_clip_norm=d["clip"]))
ckpt = os.path.join(tmp, "ckpt")
res, flags = {}, {}
for shape in d["meshes"]:
    shape = tuple(shape)
    mesh = make_auto_mesh(shape, ("data", "model"), "cpu")
    rules = sh.rules_for(cfg, mesh, kind="train", global_batch=8, seq_len=64)
    r, f = res.setdefault(shape, {}), flags.setdefault("x".join(map(str, shape)), {})
    with sh.use_mesh(mesh, rules):
        shards = sh.tree_shardings(T.param_specs(cfg), mesh, rules)
        fresh = lambda: convert.distribute_params(d["params"], T.param_specs(cfg), mesh, rules, cfg, device="cpu")
        params = fresh()
        f["shard_shapes"] = [[p, list(x.to_local().shape), list(s.shard_shape(x.shape))]
                             for (p, x), (_, s) in zip(leaves_with_paths(params), leaves_with_paths(shards))]
        rows = D.local_rows({"tokens": d["tokens"], "labels": d["tokens"]}, mesh, rules)
        f["rows"] = [int(rows["tokens"][0, 0]), len(rows["tokens"])]
        batch = D.batch_to_mesh({k: torch.from_numpy(v) for k, v in rows.items()}, mesh, rules)
        m, g = value_and_grad(make_loss_fn(cfg, tcfg), params, batch)
        r["loss"], r["norm"] = float(m["loss"]), float(global_norm(g))
        r["grads"] = convert.params_to_numpy(g)
        runs = {}
        for off in (False, True):
            tc = dataclasses.replace(tcfg, offload=OffloadConfig(optimizer_state=off, optimizer_npart=3))
            p = fresh()
            opt, step, losses = init_train_state(cfg, tc, p), make_train_step(cfg, tc), []
            for _ in range(d["steps"]):
                p, opt, mm = step(p, opt, batch)
                losses.append(float(mm["loss"]))
            runs[off] = (losses, p)
        r["losses"] = runs[False][0]
        f["offload_bitwise"] = runs[True][0] == runs[False][0] and all(
            torch.equal(a.to_local(), b.to_local()) for a, b in zip(tree_leaves(runs[True][1]), tree_leaves(runs[False][1])))
        mgr = CheckpointManager(ckpt, process_index=rank, process_count=4, whole_leaves=True)
        if shape == (2, 2):
            r["trained"] = convert.params_to_numpy(runs[False][1])
            mgr.save(STEPS, {"params": runs[False][1]}, blocking=True)
            f["saved_bytes"] = mgr.log[-1]["bytes"]  # the leaves this process wrote, and held whole
        else:
            step_, state = mgr.restore_latest({"params": fresh()}, shardings={"params": shards})
            r["restored_step"] = step_
            r["restored"] = convert.params_to_numpy(state["params"])
            f["restored_shards"] = all(x.placements == s.placements for (_, x), (_, s) in
                                       zip(leaves_with_paths(state["params"]), leaves_with_paths(shards)))
        # the compressed all-reduce over the data axis: each process's own gradient
        mine = {"w": torch.full((4, 8), float(rank + 1)) + torch.linspace(0, 1, 32).reshape(4, 8)}
        mean, _ = compression.compressed_mean_grads(mine, compression.init_residual(mine), mesh=mesh, axis="data")
        f["compressed"] = mean["w"].tolist()
        if shape == (2, 2):  # one token a row (no sequence to split)
            rules1 = sh.rules_for(cfg, mesh, kind="train", global_batch=8, seq_len=1)
            with sh.use_mesh(mesh, rules1):
                one = {k: v[:, :1] for k, v in {"tokens": d["tokens"], "labels": d["tokens"]}.items()}
                b1 = D.batch_to_mesh({k: torch.from_numpy(v) for k, v in D.local_rows(one, mesh, rules1).items()},
                                     mesh, rules1)
                m1, g1 = value_and_grad(make_loss_fn(cfg, tcfg), params, b1)
            r["s1"] = {"loss": float(m1["loss"]), "grads": convert.params_to_numpy(g1)}
        # shard_map: a function of each process's local rows, laid out by the specs
        x = D.batch_to_mesh({"x": torch.arange(8.0).reshape(8, 1) * (1 + rank % 2)}, mesh, rules)["x"]
        doubled = sh.shard_map(lambda t: 2 * t, mesh, [sh.spec_for("batch", None)], sh.spec_for("batch", None))(x)
        f["shard_map"] = [list(doubled.to_local().flatten().tolist()), str(doubled.placements)]
json.dump(flags, open(os.path.join(tmp, f"flags_{rank}.json"), "w"))
if rank == 0:
    pickle.dump(res, open(os.path.join(tmp, "port.pkl"), "wb"))
""".replace("STEPS", "d['steps']")


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    return dict(env, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1", **extra)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX package's runs and the port's four processes, side by side;
    then the port on one process."""
    tmp = tmp_path_factory.mktemp("mesh_train")
    params = convert.params_to_numpy(T.init_params(CFG, torch.Generator().manual_seed(0), "cpu"))
    tokens = np.random.default_rng(1).integers(0, CFG.vocab_size, (8, 64)).astype(np.int32)
    inputs = {"params": params, "tokens": tokens, "clip": CLIP, "steps": STEPS, "meshes": MESHES}
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    procs = [subprocess.Popen([sys.executable, "-c", textwrap.dedent(REFERENCE), str(tmp / "inputs.pkl"),
                               str(tmp / "ref.pkl")], env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4",
                                                               JAX_PLATFORMS="cpu"),
                              stdout=open(tmp / "ref.log", "w"), stderr=subprocess.STDOUT)]
    coordinator = f"127.0.0.1:{free_port()}"
    procs += [subprocess.Popen([sys.executable, "-c", textwrap.dedent(WORKER), str(k), coordinator, str(tmp)],
                               env=_env(), stdout=open(tmp / f"w{k}.log", "w"), stderr=subprocess.STDOUT)
              for k in range(4)]
    one = _one_process(params, tokens)
    for p in procs:
        p.wait(timeout=600)
    logs = {n: (tmp / n).read_text()[-3000:] for n in ("ref.log", *(f"w{k}.log" for k in range(4)))}
    assert [p.returncode for p in procs] == [0] * 5, logs
    with open(tmp / "ref.pkl", "rb") as f:
        ref = pickle.load(f)
    with open(tmp / "port.pkl", "rb") as f:
        port = pickle.load(f)
    flags = [__import__("json").load(open(tmp / f"flags_{k}.json")) for k in range(4)]
    return {"ref": ref, "port": port, "flags": flags, "one": one, "tmp": tmp, "tokens": tokens}


def _one_process(params, tokens):
    """The port on one process: the first loss, its gradients and norm, the
    3 steps' losses, and the first loss and gradients on one token a row."""
    tcfg = TrainConfig(adamw=AdamWConfig(learning_rate=1e-3, warmup_steps=2, grad_clip_norm=CLIP))
    p = convert.params_from_numpy(params, CFG, "cpu")
    batch = {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(tokens)}
    m, g = value_and_grad(make_loss_fn(CFG, tcfg), p, batch)
    out = {"loss": float(m["loss"]), "grads": convert.params_to_numpy(g), "norm": float(global_norm(g))}
    m1, g1 = value_and_grad(make_loss_fn(CFG, tcfg), p, {k: v[:, :1] for k, v in batch.items()})
    out["s1"] = {"loss": float(m1["loss"]), "grads": convert.params_to_numpy(g1)}
    opt, step, losses = init_train_state(CFG, tcfg, p), make_train_step(CFG, tcfg), []
    for _ in range(STEPS):
        p, opt, mm = step(p, opt, batch)
        losses.append(float(mm["loss"]))
    out["losses"] = losses
    return out


def _grads_close(got, want):
    got, want = dict(leaves_with_paths(got)), dict(leaves_with_paths(want))
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-4 * np.abs(w).max(), err_msg=k)


@pytest.mark.parametrize("shape", MESHES, ids=["2x2", "1x4"])
def test_mesh_matches_reference_mesh(runs, shape):
    """Losses and step 1's gradients against the JAX package on the same mesh."""
    ref, port = runs["ref"][shape], runs["port"][shape]
    np.testing.assert_allclose(port["loss"], ref["loss"], rtol=1e-5)
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=1e-5)
    _grads_close(port["grads"], ref["grads"])


@pytest.mark.parametrize("shape", MESHES, ids=["2x2", "1x4"])
def test_mesh_matches_one_process(runs, shape):
    """Losses, step 1's gradients and their global norm against the port on one process."""
    one, port = runs["one"], runs["port"][shape]
    np.testing.assert_allclose(port["loss"], one["loss"], rtol=1e-5)
    np.testing.assert_allclose(port["losses"], one["losses"], rtol=1e-5)
    _grads_close(port["grads"], one["grads"])
    np.testing.assert_allclose(port["norm"], one["norm"], rtol=1e-5)


def test_one_token_rows_match_one_process(runs):
    """At S = 1 (``act_seq`` off: one token does not split over ``model``)
    the loss and the gradients of the one-process port."""
    port, one = runs["port"][(2, 2)]["s1"], runs["one"]["s1"]
    np.testing.assert_allclose(port["loss"], one["loss"], rtol=1e-5)
    _grads_close(port["grads"], one["grads"])


def test_clip_binds(runs):
    """The clip norm is below every run's gradient norm, so every step is
    clipped, and the norm over the mesh counts each replicated leaf once."""
    want = np.sqrt(sum(float(np.square(g.astype(np.float64)).sum()) for _, g in leaves_with_paths(runs["one"]["grads"])))
    for shape in MESHES:
        assert runs["port"][shape]["norm"] > 4 * CLIP
        np.testing.assert_allclose(runs["port"][shape]["norm"], want, rtol=1e-5)


@pytest.mark.parametrize("shape", MESHES, ids=["2x2", "1x4"])
def test_each_process_holds_its_shard(runs, shape):
    """Every leaf on every process has ``ShardSpec.shard_shape``; processes
    that differ only in their ``model`` coordinate take the same rows."""
    name = "x".join(map(str, shape))
    for f in runs["flags"]:
        for path, got, want in f[name]["shard_shapes"]:
            assert got == want, (name, path)
    rows = [tuple(f[name]["rows"]) for f in runs["flags"]]
    data, model = shape
    assert all(r[1] == 8 // data for r in rows)
    for k in range(4):  # rank k sits at (k // model, k % model)
        assert rows[k] == rows[(k // model) * model], rows
    assert len({rows[k] for k in range(0, 4, model)}) == data


@pytest.mark.parametrize("shape", MESHES, ids=["2x2", "1x4"])
def test_offloaded_equals_resident_on_every_process(runs, shape):
    assert all(f["x".join(map(str, shape))]["offload_bitwise"] for f in runs["flags"])


def test_checkpoint_restores_on_another_mesh_and_on_one_process(runs):
    """The (2, 2) run's whole-leaf checkpoint, restored onto (1, 4) (each
    process laid out by the rules) and onto one process, bitwise; on save
    each process held whole only the leaves it wrote."""
    trained = dict(leaves_with_paths(runs["port"][(2, 2)]["trained"]))
    saved = [f["2x2"]["saved_bytes"] for f in runs["flags"]]
    assert sum(saved) == sum(w.nbytes for w in trained.values()) and all(0 < b < sum(saved) for b in saved), saved
    restored = dict(leaves_with_paths(runs["port"][(1, 4)]["restored"]))
    assert runs["port"][(1, 4)]["restored_step"] == STEPS
    assert all(f["1x4"]["restored_shards"] for f in runs["flags"])
    like = T.init_params(CFG, torch.Generator().manual_seed(1), "cpu")
    step, state = CheckpointManager(str(runs["tmp"] / "ckpt")).restore_latest({"params": like})
    assert step == STEPS
    one = dict(leaves_with_paths(convert.params_to_numpy(state["params"])))
    for k, w in trained.items():
        assert np.array_equal(restored[k], w) and np.array_equal(one[k], w), k


def test_compressed_mean_over_the_data_axis(runs):
    """Each process's gradient is ``rank + 1`` plus a ramp: over (2, 2)'s
    ``data`` axis ranks k and k + 2 average, over (1, 4)'s it is the
    process alone; the int8 quantisation keeps the mean within scale/2."""
    ramp = np.linspace(0, 1, 32).reshape(4, 8)
    for k, f in enumerate(runs["flags"]):
        for name, peers in (("2x2", (k % 2, k % 2 + 2)), ("1x4", (k,))):
            want = np.mean([p + 1 + ramp for p in peers], axis=0)
            scale = max(p + 2 for p in peers) / 127
            np.testing.assert_allclose(np.array(f[name]["compressed"]), want, atol=scale / 2 * 1.0001)


def test_shard_map_runs_on_local_rows(runs):
    """``shard_map`` over a ``DeviceMesh``: each process's local rows of the
    batch layout, doubled, come back in that layout."""
    for k, f in enumerate(runs["flags"]):
        for name in ("2x2", "1x4"):
            got, pl = f[name]["shard_map"]
            assert got == [2.0 * i * (1 + k % 2) for i in range(8)], (name, k)
            assert pl == "(Shard(dim=0), Replicate())", pl


def test_placements_follow_the_spec():
    """A spec entry over two mesh axes is ``Shard`` on both, outer to inner;
    an order other than the mesh's, or one mesh axis on two dimensions,
    raises."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.mesh import LogicalMesh
    from repro_torch.parallel import sharding as sh

    mesh = LogicalMesh((2, 2, 2), ("pod", "data", "model"))
    assert sh.placements((("pod", "data"), None, "model"), mesh) == (Shard(0), Shard(0), Shard(2))
    assert sh.placements((None, "data"), mesh) == (Replicate(), Shard(1), Replicate())
    assert sh.ShardSpec(mesh, ("model", None)).placements == (Replicate(), Replicate(), Shard(0))
    with pytest.raises(ValueError, match="another order"):
        sh.placements((("data", "pod"),), mesh)
    with pytest.raises(ValueError, match="splits two dimensions"):
        sh.placements(("model", "model"), mesh)


@pytest.mark.parametrize("name", ["gemma2-2b", "whisper-small", "internvl2-1b", "mamba2-780m", "zamba2-7b",
                                  "mixtral-8x22b", "deepseek-v2-236b"])
def test_train_step_builds_every_family_on_a_mesh(name, monkeypatch):
    """``make_train_step`` builds every family under a mesh of several
    devices, as on one device, and the train CLI's checks pass a (2, 2)
    mesh of four processes for it (the families train there in
    ``test_torch_mesh_families.py`` and ``test_torch_mesh_moe.py``)."""
    from repro_torch.launch import train as cli
    from repro_torch.launch.mesh import LogicalMesh, make_card_mesh
    from repro_torch.parallel import sharding as sh

    cfg = ARCHS[name].reduced()
    with sh.use_mesh(LogicalMesh((2, 2), ("data", "model"))):
        assert callable(make_train_step(cfg, TrainConfig()))
    with sh.use_mesh(make_card_mesh()):
        assert callable(make_train_step(cfg, TrainConfig()))
    monkeypatch.setattr(cli, "_host_bytes", lambda: 1 << 50)
    cli._refuse(cli._build_parser().parse_args(["--arch", name, "--reduced", "--mesh", "2x2"]), 4)


def test_train_cli_on_a_mesh_of_four_cpu_processes(tmp_path):
    """``--mesh 2x2 --host-devices 4`` launches four CPU processes, trains 3
    steps on the mesh and checkpoints; a relaunch on one process resumes."""
    flags = ["--arch", "qwen3-1.7b", "--reduced", "--ckpt-dir", str(tmp_path / "ck")]
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *flags, "--mesh", "2x2",
                          "--host-devices", "4", "--steps", "3"], env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "training complete" in out.stdout
    for k in range(4):
        assert f"[train] process {k}: backend gloo, mesh {{'data': 2, 'model': 2}}" in out.stdout
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_000000003.commit.json"] + [f"step_000000003.p0{k}"
                                                                                      for k in range(4)]
    from repro_torch.launch import train as cli

    assert cli.main([*flags, "--steps", "3", "--device", "cpu"]) == 0


def test_train_cli_refuses_a_mesh_beyond_host_memory(monkeypatch, capsys):
    """Each process of a mesh draws the whole fp32 parameter tree on its
    host: a mesh whose processes on one host need more than its memory
    exits non-zero with the sizes, before any process starts; within it,
    the check passes."""
    from repro_torch.launch import train as cli

    tree = sum(x.numel() * x.element_size() for _, x in leaves_with_paths(T.init_params(CFG, torch.Generator(),
                                                                                        "meta")))
    monkeypatch.setattr(cli, "_host_bytes", lambda: 4 * tree - 1)
    with pytest.raises(SystemExit, match=r"4 processes on this host need .* GB .*ROADMAP queue 1 item 2"):
        cli.main(["--arch", "qwen3-1.7b", "--reduced", "--mesh", "2x2", "--host-devices", "4"])
    monkeypatch.setattr(cli, "_host_bytes", lambda: 4 * tree)
    cli._refuse_host_memory(CFG, 4)
