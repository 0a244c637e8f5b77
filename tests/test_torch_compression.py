"""Port parity of the int8 compressed all-reduce: ``compressed_mean_grads``
in two gloo processes on the CPU against the JAX package's over two forced
host devices (one subprocess each side, as ``tests/test_distributed.py``
runs the reference), on the same seeded gradients for 5 steps with the
residual carried: the mean and the residual within 1e-6, and bitwise
where the arithmetic allows."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 5
# leaf shapes of one member's gradients (a stacked layer's weight, a vector, a bf16 leaf)
LEAVES = {"w": ((3, 16, 8), "float32"), "b": ((33,), "float32"), "h": ((4, 12), "bfloat16")}


def _grads(step, member):
    rng = np.random.default_rng(1000 * step + member)
    return {k: (rng.normal(size=shape) * (1 + member)).astype(np.float32) for k, (shape, _) in LEAVES.items()}


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    return dict(env, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="2", **extra)


JAX_SIDE = """
import sys, jax, jax.numpy as jnp, numpy as np
sys.path.insert(0, {tests!r})
from test_torch_compression import LEAVES, STEPS, _grads
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.launch.mesh import make_host_mesh
from repro.parallel.compression import compressed_mean_grads, init_residual

mesh = make_host_mesh((2,), ("pod",))
spec = {{k: NamedSharding(mesh, P("pod")) for k in LEAVES}}
out = {{}}
r = None
with mesh:
    for step in range(STEPS):
        g = {{k: jnp.asarray(np.stack([_grads(step, m)[k] for m in (0, 1)]), LEAVES[k][1]) for k in LEAVES}}
        r = init_residual(g) if r is None else r
        mean, r = compressed_mean_grads(jax.device_put(g, spec), r, mesh, axis="pod")
        for k in LEAVES:
            out[f"mean_{{step}}_{{k}}"] = np.asarray(mean[k].astype(jnp.float32))
            out[f"res_{{step}}_{{k}}"] = np.asarray(r[k])
np.savez({path!r}, **out)
"""

PORT_SIDE = """
import sys, numpy as np, torch, torch.distributed as dist
sys.path.insert(0, {tests!r})
from test_torch_compression import LEAVES, STEPS, _grads
from repro_torch.parallel.compression import compressed_mean_grads, init_residual

rank = int(sys.argv[1])
dist.init_process_group("gloo", init_method="tcp://127.0.0.1:{port}", rank=rank, world_size=2)
out, r = {{}}, None
for step in range(STEPS):
    g = {{k: torch.tensor(_grads(step, rank)[k][None]).to(getattr(torch, LEAVES[k][1])) for k in LEAVES}}
    r = init_residual(g) if r is None else r
    mean, r = compressed_mean_grads(g, r)
    for k in LEAVES:
        out[f"mean_{{step}}_{{k}}"] = mean[k].float().numpy()[0]
        out[f"res_{{step}}_{{k}}"] = r[k].numpy()[0]
dist.destroy_process_group()
np.savez({path!r} + f"_{{rank}}.npz", **out)
"""


def test_compressed_mean_grads_matches_reference(tmp_path):
    from repro_torch.parallel.distributed import free_port

    tests = os.path.dirname(os.path.abspath(__file__))
    ref_path, port_path = str(tmp_path / "ref.npz"), str(tmp_path / "port")
    logs = {name: open(tmp_path / f"{name}.log", "w") for name in ("jax", "p0", "p1")}
    code = {"jax": JAX_SIDE.format(tests=tests, path=ref_path),
            "port": PORT_SIDE.format(tests=tests, path=port_path, port=free_port())}
    procs = {"jax": subprocess.Popen([sys.executable, "-c", textwrap.dedent(code["jax"])], stdout=logs["jax"],
                                     stderr=subprocess.STDOUT,
                                     env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=2"))}
    for rank in (0, 1):
        procs[f"p{rank}"] = subprocess.Popen([sys.executable, "-c", textwrap.dedent(code["port"]), str(rank)],
                                             stdout=logs[f"p{rank}"], stderr=subprocess.STDOUT, env=_env())
    for name, p in procs.items():
        rc = p.wait(timeout=240)
        logs[name].close()
        assert rc == 0, (name, open(tmp_path / f"{name}.log").read()[-3000:])
    ref = np.load(ref_path)
    bitwise = 0
    for rank in (0, 1):
        mine = np.load(f"{port_path}_{rank}.npz")
        for step in range(STEPS):
            for k in LEAVES:
                true = np.mean([_grads(step, m)[k] for m in (0, 1)], axis=0)
                err = np.abs(mine[f"mean_{step}_{k}"] - true).max()
                assert err < 0.05 * np.abs(true).max() + 1e-3, (step, k, err)  # the reference test's bound
                for what in ("mean", "res"):
                    a, b = mine[f"{what}_{step}_{k}"], ref[f"{what}_{step}_{k}"][rank]
                    np.testing.assert_allclose(a, b, rtol=0, atol=1e-6, err_msg=f"{what} {k} step {step} rank {rank}")
                    bitwise += int(np.array_equal(a, b))
    # both members hold the same mean
    m0, m1 = (np.load(f"{port_path}_{r}.npz") for r in (0, 1))
    for k in LEAVES:
        np.testing.assert_array_equal(m0[f"mean_{STEPS - 1}_{k}"], m1[f"mean_{STEPS - 1}_{k}"])
    assert bitwise == 2 * STEPS * len(LEAVES) * 2, f"{bitwise} of {2 * STEPS * len(LEAVES) * 2} arrays bitwise"


def test_one_member_is_the_dequantised_gradient():
    """Without a process group the axis has one member: the mean is its
    int8-dequantised gradient (within scale/2 an element) and the residual
    what quantisation left, exactly."""
    from repro_torch.parallel.compression import compressed_mean_grads, init_residual

    g = {"a": torch.tensor(_grads(0, 0)["w"]), "b": torch.tensor(_grads(0, 0)["b"]).bfloat16()}
    r = init_residual(g)
    mean, r2 = compressed_mean_grads(g, r)
    for k in g:
        g32 = g[k].float()
        scale = float(g32.abs().max()) / 127.0
        assert mean[k].dtype == g[k].dtype and r2[k].dtype == torch.float32
        assert float((mean[k].float() - g32).abs().max()) <= scale / 2 + (0.01 * scale if k == "b" else 1e-6)
    assert torch.equal(r2["a"], g["a"] - mean["a"])
