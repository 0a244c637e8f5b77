"""The other LM families training over a (data, model) device mesh, on the CPU.

Reduced gemma2 (its local/global pair stack, post-norms, embedding scale
and final soft-cap on the vocabulary-split logits), whisper (the frames
frontend, a non-causal encoder, and the cross attention: Sq ≠ Skv through
``mesh_attention``), internvl2 (the projected patches before the tokens),
mamba2 (the SSD on each process's SSM heads) and zamba2 (Mamba groups and
the shared attention block), fp32, on a global batch of 8 × 64 tokens from
``data.batches`` with its frontend input, over a (2, 2) (data, model) mesh
of four gloo CPU processes, and mamba2 also over (1, 4) (8 SSM heads over 4).
mamba2's 8 SSM heads also read B and C in groups: 4 groups over (2, 2) (a
process's 4 heads read 2 of them) and 2 over (1, 4) (a process's 2 heads lie
in one); an arch ``name:g<G>`` is ``name`` with ``ssm_groups`` G.

Held against the JAX package's ``value_and_grad`` of its loss on four
forced host devices laid out as the same mesh (one subprocess, one jit a
family and mesh), from the same numpy parameters and batch: the first loss
within 1e-5 relative, the gradients within 1e-4·max|g| per leaf (the
tolerances of ``test_torch_training.py``).  Against the port on one
process: the first loss and 3 training steps' losses within 1e-5 relative,
the gradients within 1e-4·max|g|.  Each process holds
``ShardSpec.shard_shape`` of every leaf.  The train CLI trains reduced
whisper on a (2, 2) mesh of four processes it launches itself.

:func:`run_meshes` is the harness; ``test_torch_mesh_moe.py`` runs the MoE
families through it.
"""
import dataclasses
import inspect
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
from repro_torch.training import data as D
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_step import TrainConfig, init_train_state, make_loss_fn, make_train_step, value_and_grad
from repro_torch.utils.tree import leaves_with_paths

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3
BATCH, SEQ = 8, 64
CASES = [("gemma2-2b", (2, 2)), ("whisper-small", (2, 2)), ("internvl2-1b", (2, 2)), ("mamba2-780m", (2, 2)),
         ("mamba2-780m", (1, 4)), ("mamba2-780m:g4", (2, 2)), ("mamba2-780m:g2", (1, 4)), ("zamba2-7b", (2, 2))]


def config(key):
    """The reduced arch of ``key``: ``name``, or ``name:g<G>`` with ``ssm_groups`` G."""
    name, _, groups = key.partition(":g")
    cfg = ARCHS[name].reduced()
    return dataclasses.replace(cfg, ssm_groups=int(groups)) if groups else cfg


CONFIG = "import dataclasses\n" + inspect.getsource(config)  # the same in the reference and the workers

REFERENCE = """
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import ARCHS
from repro.launch.mesh import make_host_mesh
from repro.models import transformer as T
from repro.parallel import sharding as sh
from repro.training.train_step import TrainConfig, make_loss_fn
""" + CONFIG + """
d = pickle.load(open(sys.argv[1], "rb"))
out = {}
for name, shape in d["cases"]:
    cfg = config(name)
    mesh = make_host_mesh(shape, ("pod", "data", "model")[-len(shape):])
    rules = sh.rules_for(cfg, mesh, kind="train", global_batch=d["batch"], seq_len=d["seq"])
    with mesh, sh.use_mesh(mesh, rules):
        _, pspecs = T.init_params(cfg, jax.random.key(0))
        pshard = sh.tree_shardings(pspecs, mesh, rules)
        params = jax.tree_util.tree_map(lambda a, s: jax.device_put(jnp.asarray(a), s), d[name]["params"], pshard)
        batch = {k: jnp.asarray(v) for k, v in d[name]["batch"].items()}
        (loss, _), grads = jax.jit(jax.value_and_grad(make_loss_fn(cfg, TrainConfig()), has_aux=True))(params, batch)
        out[(name, tuple(shape))] = {"loss": float(loss), "grads": jax.tree_util.tree_map(np.asarray, grads)}
pickle.dump(out, open(sys.argv[2], "wb"))
"""

WORKER = """
import os, pickle, sys
import numpy as np, torch
torch.set_num_threads(1)
from repro_torch.launch import bootstrap
rank, coordinator, tmp = int(sys.argv[1]), sys.argv[2], sys.argv[3]
bootstrap.distributed_init(coordinator=coordinator, num_processes=4, process_id=rank)
from repro_torch import convert
from repro_torch.configs import ARCHS
from repro_torch.launch.mesh import make_auto_mesh
from repro_torch.models import transformer as T
from repro_torch.parallel import sharding as sh
from repro_torch.training import data as D
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_step import TrainConfig, init_train_state, make_loss_fn, make_train_step, value_and_grad
from repro_torch.utils.tree import leaves_with_paths
""" + CONFIG + """
d = pickle.load(open(os.path.join(tmp, "inputs.pkl"), "rb"))
tcfg = TrainConfig(adamw=AdamWConfig(learning_rate=1e-3, warmup_steps=2))
meshes, res, shards = {}, {}, {}
for name, shape in d["cases"]:
    shape = tuple(shape)
    if shape not in meshes:
        meshes[shape] = make_auto_mesh(shape, ("pod", "data", "model")[-len(shape):], "cpu")
    mesh = meshes[shape]
    cfg = config(name)
    rules = sh.rules_for(cfg, mesh, kind="train", global_batch=d["batch"], seq_len=d["seq"])
    with sh.use_mesh(mesh, rules):
        specs = sh.tree_shardings(T.param_specs(cfg), mesh, rules)
        fresh = lambda: convert.distribute_params(d[name]["params"], T.param_specs(cfg), mesh, rules, cfg, device="cpu")
        params = fresh()
        shards[(name, shape)] = [[p, list(x.to_local().shape), list(s.shard_shape(x.shape))]
                                 for (p, x), (_, s) in zip(leaves_with_paths(params), leaves_with_paths(specs))]
        rows = D.local_rows(d[name]["batch"], mesh, rules)
        batch = D.batch_to_mesh({k: torch.from_numpy(v) for k, v in rows.items()}, mesh, rules)
        m, g = value_and_grad(make_loss_fn(cfg, tcfg), params, batch)
        r = res[(name, shape)] = {"loss": float(m["loss"]), "grads": convert.params_to_numpy(g)}
        opt, step, r["losses"] = init_train_state(cfg, tcfg, params), make_train_step(cfg, tcfg), []
        for _ in range(d["steps"]):
            params, opt, mm = step(params, opt, batch)
            r["losses"].append(float(mm["loss"]))
pickle.dump(shards, open(os.path.join(tmp, f"shards_{rank}.pkl"), "wb"))
if rank == 0:
    pickle.dump(res, open(os.path.join(tmp, "port.pkl"), "wb"))
"""


def env(**extra):
    """The subprocesses' environment: the repo's sources, one thread each."""
    base = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    return dict(base, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1", **extra)


def inputs(name, kind="bigram"):
    """The same numpy parameters (the port's seeded draw) and global batch
    (``data.batches`` of ``kind``, with the frontend's frames or patches)
    for both packages."""
    cfg = config(name)
    params = convert.params_to_numpy(T.init_params(cfg, torch.Generator().manual_seed(0), "cpu"))
    dcfg = D.DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=BATCH, frontend=cfg.frontend,
                        d_model=cfg.d_model, n_frontend_tokens=cfg.n_frontend_tokens, kind=kind)
    return {"params": params, "batch": next(D.batches(dcfg))}


def one_process(name, data, steps):
    """The port on one process: the first loss, its gradients, and ``steps``
    training steps' losses."""
    cfg = config(name)
    tcfg = TrainConfig(adamw=AdamWConfig(learning_rate=1e-3, warmup_steps=2))
    p = convert.params_from_numpy(data["params"], cfg, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in data["batch"].items()}
    m, g = value_and_grad(make_loss_fn(cfg, tcfg), p, batch)
    out = {"loss": float(m["loss"]), "grads": convert.params_to_numpy(g), "losses": []}
    opt, step = init_train_state(cfg, tcfg, p), make_train_step(cfg, tcfg)
    for _ in range(steps):
        p, opt, mm = step(p, opt, batch)
        out["losses"].append(float(mm["loss"]))
    return out


def run_meshes(tmp, cases, one=(), side=(), kind="bigram"):
    """The JAX package's ``value_and_grad`` on forced host devices (one
    subprocess) and the port's four gloo processes, over every (arch, mesh)
    of ``cases`` (a mesh of two sizes over (data, model), of three over
    (pod, data, model)), side by side, while this process runs the port on one
    process for each arch of ``one``, and then the commands of ``side``,
    on ``kind``'s tokens → ``{"ref", "port", "shards" (one dict a rank),
    "one", "side" (return codes and output)}``."""
    names = sorted({n for n, _ in cases} | set(one))
    data = {n: inputs(n, kind) for n in names}
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump({**data, "cases": cases, "steps": STEPS, "batch": BATCH, "seq": SEQ}, f)
    ref = subprocess.Popen([sys.executable, "-c", textwrap.dedent(REFERENCE), str(tmp / "inputs.pkl"),
                            str(tmp / "ref.pkl")], env=env(XLA_FLAGS="--xla_force_host_platform_device_count=4",
                                                           JAX_PLATFORMS="cpu"),
                           stdout=open(tmp / "ref.log", "w"), stderr=subprocess.STDOUT)
    coordinator = f"127.0.0.1:{free_port()}"
    workers = [subprocess.Popen([sys.executable, "-c", textwrap.dedent(WORKER), str(k), coordinator, str(tmp)],
                                env=env(), stdout=open(tmp / f"w{k}.log", "w"), stderr=subprocess.STDOUT)
               for k in range(4)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # beside five busy processes, more threads only wait on each other
    try:
        ones = {n: one_process(n, data[n], STEPS) for n in one}
    finally:
        torch.set_num_threads(threads)
    for p in workers:
        p.wait(timeout=600)
    side_out = []
    for cmd in side:  # each after the workers, beside the reference's compiles
        p = subprocess.run(cmd, env=env(), capture_output=True, text=True, timeout=600)
        side_out.append((p.returncode, p.stdout, p.stderr))
    ref.wait(timeout=600)
    codes = [p.returncode for p in (ref, *workers)]
    if codes != [0] * 5:
        for n in ("ref.log", *(f"w{k}.log" for k in range(4))):  # whole, in the report's captured output
            print(f"===== {n} =====\n{(tmp / n).read_text()}")
    assert codes == [0] * 5, codes
    out = {"one": ones, "side": side_out, "shards": []}
    for key, path in (("ref", "ref.pkl"), ("port", "port.pkl")):
        with open(tmp / path, "rb") as f:
            out[key] = pickle.load(f)
    for k in range(4):
        with open(tmp / f"shards_{k}.pkl", "rb") as f:
            out["shards"].append(pickle.load(f))
    return out


def grads_close(got, want):
    """Every leaf within 1e-4·max|g| of ``want``'s."""
    got, want = dict(leaves_with_paths(got)), dict(leaves_with_paths(want))
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-4 * np.abs(w).max(), err_msg=k)


def case_id(case):
    return f"{case[0]}-{'x'.join(map(str, case[1]))}"


CLI = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "whisper-small", "--reduced", "--mesh", "2x2",
       "--host-devices", "4", "--steps", "2", "--ckpt-every", "0"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_families")
    return run_meshes(tmp, CASES, one=sorted({n for n, _ in CASES}),
                      side=[CLI + ["--ckpt-dir", str(tmp / "cli_ckpt")]])


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_mesh_matches_reference_mesh(runs, case):
    """The first loss and its gradients against the JAX package on the same mesh."""
    ref, port = runs["ref"][case], runs["port"][case]
    np.testing.assert_allclose(port["loss"], ref["loss"], rtol=1e-5)
    grads_close(port["grads"], ref["grads"])


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_mesh_matches_one_process(runs, case):
    """The first loss, 3 steps' losses and the gradients against the port on one process."""
    one, port = runs["one"][case[0]], runs["port"][case]
    np.testing.assert_allclose(port["loss"], one["loss"], rtol=1e-5)
    np.testing.assert_allclose(port["losses"], one["losses"], rtol=1e-5)
    grads_close(port["grads"], one["grads"])


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_each_process_holds_its_shard(runs, case):
    """Every leaf on every process has ``ShardSpec.shard_shape`` of its rules' layout."""
    for shards in runs["shards"]:
        for path, got, want in shards[case]:
            assert got == want, (case, path)


def test_train_cli_trains_whisper_on_a_mesh(runs, tmp_path):
    """``--mesh 2x2 --host-devices 4`` trains reduced whisper for 2 steps
    on four CPU processes it launches, and checkpoints the result."""
    rc, out, err = runs["side"][0]
    assert rc == 0, err[-3000:]
    assert "training complete" in out
    for k in range(4):
        assert f"[train] process {k}: backend gloo, mesh {{'data': 2, 'model': 2}}" in out
