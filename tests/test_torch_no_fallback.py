"""The port stands alone and never falls back: no module of it (nor
chip_smoke.py) imports JAX or the JAX package, or calls a library's
attention in place of the flash kernel; on CPU tensors the kernel launch
counters stay 0; the CUDA bindings refuse CPU tensors; no spec puts the
plain version on a CUDA tensor; and with no card the default device raises
instead of running on the CPU."""
import ast
import os
import re

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.configs import ARCHS
from repro_torch.fem import backend, meshgen, methods, multispring as ms, newmark
from repro_torch.kernels.ebe_matvec import ops as ebe_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.multispring import ops as ms_ops
from repro_torch.models import transformer as T
from repro_torch.serving import decode as D

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)")
# a library's attention, or a compiler, in place of the hand-written kernel
LIBRARY_ATTENTION = re.compile(r"scaled_dot_product_attention|flash_attn|cudnn|torch\.compile|sdp_kernel")


def _port_files():
    root = os.path.join(REPO, "src", "repro_torch")
    files = [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs if f.endswith(".py")]
    return files + [os.path.join(REPO, "chip_smoke.py")]


def test_port_imports_neither_jax_nor_reference():
    files = _port_files()
    assert len(files) > 20
    for path in files:
        with open(path) as f:
            src = f.read()
        for node in ast.walk(ast.parse(src, path)):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), f"{path} imports {name}"
        bad = [line for line in src.splitlines() if FORBIDDEN.match(line)]
        assert not bad, f"{path}: {bad}"


def _tiny_run():
    mesh = meshgen.generate(1, 1, 2, pad_elems_to=4)
    cfg = methods.SeismicConfig(dt=0.01, npart=2, nspring=6, maxiter=200)
    wave = np.full((2, 3), 0.1)
    return methods.run(mesh, cfg, wave, device="cpu")


def test_no_port_file_calls_a_library_attention():
    """SDPA, cuDNN and torch.compile are no port of the flash kernel; the
    only place that may time SDPA (as ``library_ms``) is chip_smoke.py."""
    for path in _port_files():
        if path.endswith("chip_smoke.py"):
            continue
        with open(path) as f:
            src = f.read()
        assert not LIBRARY_ATTENTION.search(src), f"{path} calls a library attention or compiler"
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        smoke = f.read()
    assert "torch.compile" not in smoke and "cudnn.allow_tf32" in smoke
    assert smoke.count("scaled_dot_product_attention") == 1  # the yardstick in phase timing


def _tiny_lm():
    cfg = ARCHS["qwen3-1.7b"].reduced()
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 6), generator=torch.Generator().manual_seed(1))
    return cfg, params, toks


def test_cpu_run_launches_no_kernel():
    kernels.reset_launch_counts()
    out = _tiny_run()
    assert bool(torch.isfinite(out["velocity_history"]).all())
    cfg, params, toks = _tiny_lm()
    logits, state = T.prefill(params, cfg, {"tokens": toks}, cache_len=8)
    logits, state = T.decode_step(params, cfg, toks[:, :1], state)
    D.generate(params, cfg, toks[:, :3], 2, D.ServeConfig(kv_offload=True, kv_npart=2))
    assert bool(torch.isfinite(logits).all())
    assert kernels.launch_counts() == {"multispring": 0, "ebe_matvec_f64": 0, "ebe_matvec_f32": 0,
                                       "flash_attention": 0}


def test_cuda_bindings_refuse_cpu_tensors():
    P, S = 3, 6
    st = ms.init_state(P, S, device="cpu")
    prm = ms.SpringParams(*(torch.ones(P, dtype=torch.float64) for _ in range(4)))
    n, w = (torch.tensor(a) for a in ms.spring_directions(S))
    with pytest.raises(ValueError, match="CUDA"):
        ms_ops.multispring_cuda(torch.zeros(P, 6, dtype=torch.float64), st, prm, n, w)
    E = 2
    with pytest.raises(ValueError, match="CUDA"):
        ebe_ops.ebe_matvec_cuda(torch.zeros(5, 3), torch.zeros(E, 10, dtype=torch.int32),
                                torch.zeros(E, 4, 6, 6), torch.zeros(E, 3, 3), torch.zeros(E, 4))
    q = torch.zeros(1, 2, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        fa_ops.flash_attention_cuda(q, q[:, :1], q[:, :1])
    assert kernels.launch_counts()["multispring"] == 0
    assert kernels.launch_counts()["flash_attention"] == 0
    assert kernels.launch_counts()["ebe_matvec_f32"] == 0


def _ebe_args(E=3, N=5, dt=torch.float64):
    return (torch.zeros(N, 3, dtype=dt), torch.zeros(E, 10, dtype=torch.int32), torch.zeros(E, 4, 6, 6, dtype=dt),
            torch.zeros(E, 3, 3, dtype=dt), torch.zeros(E, 4, dtype=dt), torch.ones(E, dtype=dt))


@pytest.mark.parametrize("case,match", [
    ("x_float16", "dtype"), ("conn_int64", "int32"), ("D_float32", "D must be"), ("conn_shape", "conn must be"),
    ("coef_shape", "coef must be"), ("x_noncontiguous", "x must be"), ("Jinv_misaligned", "16-byte"),
    ("tile_e_30", "tile_e"), ("tile_e_68", "tile_e"),
])
def test_ebe_binding_refuses_bad_arguments(case, match):
    """The fused EBE entry checks every argument before it needs a card, so
    each refusal is a clear ValueError on the CPU too."""
    x, conn, D, Jinv, wdet, coef = _ebe_args()
    kw = {}
    if case == "x_float16":
        x = x.half()
    elif case == "conn_int64":
        conn = conn.long()
    elif case == "D_float32":
        D = D.float()
    elif case == "conn_shape":
        conn = conn[:, :9].contiguous()
    elif case == "coef_shape":
        coef = torch.ones(4, dtype=torch.float64)
    elif case == "x_noncontiguous":
        x = torch.zeros(3, 5, dtype=torch.float64).t()
    elif case == "Jinv_misaligned":  # a contiguous view 72 B into its storage
        Jinv = torch.zeros(4, 3, 3, dtype=torch.float64)[1:]
    else:
        kw["tile_e"] = int(case.rsplit("_", 1)[1])
    with pytest.raises(ValueError, match=match):
        ebe_ops.ebe_matvec_cuda(x, conn, D, Jinv, wdet, coef, **kw)
    with pytest.raises(ValueError, match="CUDA"):  # the same arguments, all well formed, still need a card
        ebe_ops.ebe_matvec_cuda(*_ebe_args())
    assert kernels.launch_counts()["ebe_matvec_f64"] == 0


def test_multispring_binding_refuses_bad_arguments():
    P, S = 3, 6
    st = ms.init_state(P, S, device="cpu")
    prm = ms.SpringParams(*(torch.ones(P, dtype=torch.float64) for _ in range(4)))
    n, w = (torch.tensor(a) for a in ms.spring_directions(S))
    eps = torch.zeros(P, 6, dtype=torch.float64)
    with pytest.raises(ValueError, match="dtype"):
        ms_ops.multispring_cuda(eps.half(), st, prm, n, w)
    with pytest.raises(ValueError, match="direction must be"):
        ms_ops.multispring_cuda(eps, dict(st, direction=st["direction"].long()), prm, n, w)
    with pytest.raises(ValueError, match="tile_p"):
        ms_ops.multispring_cuda(eps, st, prm, n, w, tile_p=9)
    assert kernels.launch_counts()["multispring"] == 0


def test_tile_knobs_defaults_and_ranges():
    """``tile_e`` counts elements per tile of the EBE kernel's persistent
    grid (4 threads each; a multiple of 4 in [4, 64]), ``tile_p`` warps per
    multispring block ([1, 8]); the config, the backend and the wrappers
    share one default and one check."""
    cfg = methods.SeismicConfig()
    assert (cfg.tile_e, cfg.tile_p) == (ebe_ops.TILE_E, ms_ops.TILE_P) == (16, 4)
    for te in (4, 8, 64):
        assert backend.KernelBackend(tile_e=te).tile_e == te
    for te in (0, 2, 30, 68, 128):
        with pytest.raises(ValueError, match="tile_e"):
            backend.KernelBackend(tile_e=te)
    for tp in (1, 8):
        assert backend.KernelBackend(tile_p=tp).tile_p == tp
    for tp in (0, 9, 32):
        with pytest.raises(ValueError, match="tile_p"):
            backend.KernelBackend(tile_p=tp)
    with pytest.raises(ValueError, match="tile_e"):
        backend.resolve(methods.SeismicConfig(tile_e=128), device="cpu")


def test_backend_spec_follows_the_device():
    assert backend.resolve_spec("auto", "cpu") == "torch"
    assert backend.resolve_spec("auto", "cuda") == "cuda"
    with pytest.raises(ValueError, match="cannot run"):
        backend.resolve_spec("torch", "cuda")  # no plain version on a CUDA tensor
    with pytest.raises(ValueError, match="cannot run"):
        backend.resolve_spec("cuda", "cpu")
    with pytest.raises(ValueError, match="unknown"):
        backend.resolve_spec("pallas", "cpu")
    kb = backend.resolve(methods.SeismicConfig(), device="cpu")
    assert (kb.ebe, kb.multispring, kb.tile_e, kb.tile_p) == ("torch", "torch", 16, 4)
    with pytest.raises(ValueError):
        backend.resolve(methods.SeismicConfig(ebe_backend="cuda"), device="cpu")


@pytest.mark.parametrize("name", methods.METHODS)
def test_make_step_covers_every_method(name):
    mesh = meshgen.generate(1, 1, 1, pad_elems_to=2)
    ops = backend.make_operators(mesh, methods.SeismicConfig(npart=2, nspring=6), device="cpu")
    step, streamed = methods.make_step(name, ops)
    assert callable(step) and streamed == (name in ("proposed1", "proposed2"))
    with pytest.raises(KeyError):
        methods.make_step("proposed3", ops)


def test_baseline2_runs_the_multispring_on_the_host_explicitly():
    """Baseline 2's host multispring is the method (Algorithm 2), named in the
    operators, not a fallback chosen by where a tensor happens to lie: it
    never goes through the device's multispring, and refuses θ off the host."""
    mesh = meshgen.generate(1, 1, 1, pad_elems_to=2)
    cfg = methods.SeismicConfig(npart=2, nspring=6)
    ops = backend.make_operators(mesh, cfg, device="cpu")
    assert ops.host == methods.HOST == torch.device("cpu")

    def refuse(*args, **kwargs):
        raise AssertionError("went through the device's multispring")

    ops.multispring_fn = refuse
    with pytest.raises(AssertionError, match="device's multispring"):
        methods.initial_carry(ops)  # Baseline 1's carry uses the device's multispring
    step, streamed = methods.make_step("baseline2", ops)
    carry = methods.initial_carry(ops, streamed=streamed, host=True)
    assert all(v.device == methods.HOST for v in carry[1].values())
    carry, aux = step(carry, torch.tensor([0.3, 0.0, 0.1], dtype=torch.float64))
    assert aux.converged and all(v.device == methods.HOST for v in carry[1].values())
    eps = torch.zeros((mesh.n_elem * 4, 6), dtype=torch.float64)
    with pytest.raises(ValueError, match="keeps θ on cpu"):
        ops.multispring_host(eps, {k: v.to("meta") for k, v in carry[1].items()})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            methods.run(mesh, cfg, np.zeros((1, 3)), method="baseline2")


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    mesh = meshgen.generate(1, 1, 1, pad_elems_to=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        methods.run(mesh, methods.SeismicConfig(npart=2, nspring=6), np.zeros((1, 3)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        methods.resolve_device(None)
    cfg = methods.SeismicConfig(npart=2, nspring=6)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        backend.make_operators(mesh, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        methods.FemOperators(mesh, cfg)
    assert methods.FemOperators(mesh, cfg, device="cpu").device.type == "cpu"
    for make in (lambda **kw: backend.resolve(cfg, **kw), lambda **kw: ms.init_state(2, 6, **kw),
                 lambda **kw: newmark.init_state(2, **kw), lambda **kw: ms.material_params_for_mesh(mesh, **kw)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
        make(device="cpu")


def test_lm_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    cfg = ARCHS["qwen3-1.7b"].reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init_decode_state(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        D.make_kv_blocks(cfg, 1, 8, 2)
    assert T.init_decode_state(cfg, 1, 8, device="cpu")["layers"]["k"].device.type == "cpu"
