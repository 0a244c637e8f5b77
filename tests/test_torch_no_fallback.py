"""The port stands alone and never falls back: no module of it (nor
chip_smoke.py) imports JAX or the JAX package; on CPU tensors the kernel
launch counters stay 0; the CUDA bindings refuse CPU tensors; no spec puts
the plain version on a CUDA tensor; and with no card the default device
raises instead of running on the CPU."""
import ast
import os
import re

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.fem import backend, meshgen, methods, multispring as ms
from repro_torch.kernels.ebe_matvec import ops as ebe_ops
from repro_torch.kernels.multispring import ops as ms_ops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)")


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


def test_cpu_run_launches_no_kernel():
    kernels.reset_launch_counts()
    out = _tiny_run()
    assert bool(torch.isfinite(out["velocity_history"]).all())
    assert kernels.launch_counts() == {"multispring": 0, "ebe_matvec_f64": 0, "ebe_matvec_f32": 0}


def test_cuda_bindings_refuse_cpu_tensors():
    P, S = 3, 6
    st = ms.init_state(P, S)
    prm = ms.SpringParams(*(torch.ones(P, dtype=torch.float64) for _ in range(4)))
    n, w = (torch.tensor(a) for a in ms.spring_directions(S))
    with pytest.raises(ValueError, match="CUDA"):
        ms_ops.multispring_cuda(torch.zeros(P, 6, dtype=torch.float64), st, prm, n, w)
    E = 2
    with pytest.raises(ValueError, match="CUDA"):
        ebe_ops.ebe_element_matvec_cuda(torch.zeros(E, 10, 3), torch.zeros(E, 4, 6, 6),
                                        torch.zeros(E, 3, 3), torch.zeros(E, 4))
    assert kernels.launch_counts()["multispring"] == 0


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
