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
        ebe_ops.ebe_element_matvec_cuda(torch.zeros(E, 10, 3), torch.zeros(E, 4, 6, 6),
                                        torch.zeros(E, 3, 3), torch.zeros(E, 4))
    q = torch.zeros(1, 2, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        fa_ops.flash_attention_cuda(q, q[:, :1], q[:, :1])
    assert kernels.launch_counts()["multispring"] == 0
    assert kernels.launch_counts()["flash_attention"] == 0


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
    assert (kb.ebe, kb.multispring, kb.tile_e, kb.tile_p) == ("torch", "torch", 128, 4)
    with pytest.raises(ValueError):
        backend.resolve(methods.SeismicConfig(ebe_backend="cuda"), device="cpu")


def test_crs_rungs_not_ported_yet():
    mesh = meshgen.generate(1, 1, 1, pad_elems_to=2)
    ops = backend.make_operators(mesh, methods.SeismicConfig(npart=2, nspring=6), device="cpu")
    for name in ("baseline1", "baseline2", "proposed1"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            methods.make_step(name, ops)
    with pytest.raises(KeyError):
        methods.make_step("proposed3", ops)


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
