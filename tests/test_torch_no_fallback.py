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
LIBRARY_ATTENTION = re.compile(r"scaled_dot_product_attention|flash_attn|flex_attention|cudnn|torch\.compile|sdp_kernel")
LIBRARY_LSTM = re.compile(r"nn\.LSTM\b|_VF\.lstm|torch\.lstm\b")
CUDNN_CONV_FLAGS = "torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True, allow_tf32=False)"


def _port_files():
    root = os.path.join(REPO, "src", "repro_torch")
    files = [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs if f.endswith(".py")]
    return files + [os.path.join(REPO, "chip_smoke.py")]


def test_port_imports_neither_jax_nor_reference():
    files = _port_files()
    assert len(files) > 20
    scanned = {os.path.relpath(os.path.dirname(p), os.path.join(REPO, "src", "repro_torch")) for p in files}
    assert {"campaign", "training", "parallel", "launch", "scenario", "surrogate"} <= scanned
    assert os.path.join(REPO, "src", "repro_torch", "models", "moe.py") in files
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
    """SDPA, flex_attention, cuDNN and torch.compile are no port of the flash
    kernel, and cuDNN's LSTM is none of the surrogate's loop; the only place
    that may time SDPA, compiled flex_attention or ``nn.LSTM`` (as
    yardsticks) is chip_smoke.py.  The one
    use of cuDNN in the port is the surrogate's convolutions (the
    reference's XLA convolutions, no TPU kernel) held to full fp32 and
    deterministic algorithms, by exactly this call."""
    files = _port_files()
    assert os.path.join(REPO, "src", "repro_torch", "models", "moe.py") in files
    for path in files:
        if path.endswith("chip_smoke.py"):
            continue
        with open(path) as f:
            src = f.read()
        if path.endswith(os.path.join("surrogate", "model.py")):
            assert src.count(CUDNN_CONV_FLAGS) == 1, f"{path} no longer holds its convolutions to fp32"
            src = src.replace(CUDNN_CONV_FLAGS, "")
        assert not LIBRARY_ATTENTION.search(src), f"{path} calls a library attention or compiler"
        assert not LIBRARY_LSTM.search(src), f"{path} calls a library LSTM"
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        smoke = f.read()
    assert "cudnn.allow_tf32" in smoke
    # the one compiled call: flex_attention, the yardstick of gemma2's softcapped rows in phase timing
    assert smoke.count("torch.compile") == 1 and "torch.compile(flex_attention, " in smoke
    assert smoke.count("scaled_dot_product_attention") == 1  # the yardstick in phase timing
    assert smoke.count("nn.LSTM(") == 1  # the yardstick of the LSTM loop in phase timing


def _tiny_lm():
    cfg = ARCHS["qwen3-1.7b"].reduced()
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 6), generator=torch.Generator().manual_seed(1))
    return cfg, params, toks


def _tiny_ensemble():
    mesh = meshgen.generate(1, 1, 1, pad_elems_to=2)
    waves = np.zeros((2, 2, 3))
    waves[:, :, 0] = [[0.3, -0.1], [0.2, 0.05]]
    return mesh, methods.SeismicConfig(npart=2, nspring=6), waves


def test_cpu_run_launches_no_kernel():
    kernels.reset_launch_counts()
    out = _tiny_run()
    assert bool(torch.isfinite(out["velocity_history"]).all())
    cfg, params, toks = _tiny_lm()
    logits, state = T.prefill(params, cfg, {"tokens": toks}, cache_len=8)
    logits, state = T.decode_step(params, cfg, toks[:, :1], state)
    D.generate(params, cfg, toks[:, :3], 2, D.ServeConfig(kv_offload=True, kv_npart=2))
    assert bool(torch.isfinite(logits).all())
    ms_ = methods.run_ensemble(*_tiny_ensemble(), device="cpu")
    assert bool(torch.isfinite(ms_["velocity_history"]).all())
    assert kernels.launch_counts() == {"multispring": 0, "ebe_matvec_f64": 0, "ebe_matvec_f32": 0,
                                       "multispring_kset": 0, "ebe_matvec_kset_f64": 0, "ebe_matvec_kset_f32": 0,
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
    # tensors on a device other than the thread's current one (here: ``meta``): refused as well, and the
    # context a wrapper launches in makes only a CUDA device current
    with pytest.raises(ValueError, match="CUDA tensors, got meta"):
        ms_ops.multispring_cuda(torch.zeros(P, 6, dtype=torch.float64, device="meta"),
                                {k: v.to("meta") for k, v in st.items()},
                                ms.SpringParams(*(torch.ones(P, dtype=torch.float64, device="meta") for _ in range(4))),
                                n.to("meta"), w.to("meta"))
    qm = q.to("meta")
    with pytest.raises(ValueError, match="CUDA tensors, got meta"):
        fa_ops.flash_attention_cuda(qm, qm[:, :1], qm[:, :1])
    with kernels.on_device(torch.device("cpu")), kernels.on_device(torch.device("meta")):
        pass
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
    assert (kb.name, kb.describe()) == ("torch", "ebe=torch,ms=torch,tile_e=16,tile_p=4")
    mixed = backend.KernelBackend(ebe="cuda", multispring="torch", tile_e=8, tile_p=2)
    assert (mixed.name, mixed.describe()) == ("mixed", "ebe=cuda,ms=torch,tile_e=8,tile_p=2")
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


@pytest.mark.parametrize("name", ["gemma2-2b", "mixtral-8x22b", "deepseek-v2-236b"])
def test_family_entry_points_raise_without_a_card(name):
    """gemma2's pair stack, the MoE and MLA default to the card like the dense
    stack, and raise without one; mixtral's offloaded KV blocks too."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    cfg = ARCHS[name].reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init_decode_state(cfg, 1, 8)
    if name == "mixtral-8x22b":
        with pytest.raises(RuntimeError, match="no CUDA device"):
            D.make_kv_blocks(cfg, 1, 8, 2)
    from repro_torch.serving import DecodeEngine

    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DecodeEngine(cfg, params)
    state = T.init_decode_state(cfg, 1, 8, device="cpu")
    assert all(t.device.type == "cpu" for k, c in state.items() if k != "pos" for t in c.values())


@pytest.mark.parametrize("name", ["mamba2-780m", "zamba2-7b", "whisper-small", "internvl2-1b"])
def test_ssm_hybrid_encdec_vlm_entry_points_raise_without_a_card(name):
    """The SSM, hybrid, encoder-decoder and VLM families default to the card
    too and raise without one; the CPU runs them only when asked for.  The
    decode engine serves three of them (and internvl2's offloaded KV blocks
    need the card too); whisper it refuses before any device, for the frames
    its requests would need."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    from repro_torch.serving import DecodeEngine

    cfg = ARCHS[name].reduced()
    calls = [lambda: T.init_params(cfg, torch.Generator().manual_seed(0)), lambda: T.init_decode_state(cfg, 1, 8)]
    if name == "internvl2-1b":
        calls.append(lambda: D.make_kv_blocks(cfg, 1, 8, 2))
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    if name == "whisper-small":
        with pytest.raises(ValueError, match="frames"):
            DecodeEngine(cfg, params)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DecodeEngine(cfg, params)
    state = T.init_decode_state(cfg, 1, 8, device="cpu", enc_len=3)
    assert all(t.device.type == "cpu" for k, c in state.items() if k != "pos" for t in c.values())


def _kset_ebe_args(k=2, E=3, N=5, dt=torch.float64):
    return (torch.zeros(k, N, 3, dtype=dt), torch.zeros(E, 10, dtype=torch.int32),
            torch.zeros(k, E, 4, 6, 6, dtype=dt), torch.zeros(E, 3, 3, dtype=dt), torch.zeros(E, 4, dtype=dt),
            torch.ones(k, E, dtype=dt))


@pytest.mark.parametrize("case", ["x_no_k", "D_no_k", "D_other_k", "coef_no_k", "coef_other_k"])
def test_kset_ebe_entries_refuse_a_missing_or_mismatched_k(case):
    """The k-set EBE entries check the leading member axis before anything
    else (before the device, so a CPU test sees it), in the CUDA binding and
    in the public entry alike."""
    x, conn, D, Jinv, wdet, coef = _kset_ebe_args()
    if case == "x_no_k":
        x = x[0]
    elif case == "D_no_k":
        D = D[0]
    elif case == "D_other_k":
        D = torch.zeros(3, *D.shape[1:], dtype=D.dtype)
    elif case == "coef_no_k":
        coef = coef[0]
    else:
        coef = torch.ones(3, coef.shape[1], dtype=coef.dtype)
    for fn in (ebe_ops.ebe_matvec_kset_cuda, ebe_ops.element_kernel_kset):
        with pytest.raises(ValueError, match="k-set"):
            fn(x, conn, D, Jinv, wdet, coef)
    with pytest.raises(ValueError, match="CUDA"):  # well formed, it still needs a card
        ebe_ops.ebe_matvec_kset_cuda(*_kset_ebe_args())
    with pytest.raises(ValueError, match="16-byte"):  # the shared geometry's alignment, before the device
        ebe_ops.ebe_matvec_kset_cuda(*_kset_ebe_args()[:3], torch.zeros(4, 3, 3, dtype=torch.float64)[1:],
                                     *_kset_ebe_args()[4:])
    assert kernels.launch_counts()["ebe_matvec_kset_f64"] == 0


def test_kset_multispring_entries_refuse_a_missing_or_mismatched_k():
    k, P, S = 2, 3, 6
    st = {key: v.expand(k, P, S).clone() for key, v in ms.init_state(P, S, device="cpu").items()}
    prm = ms.SpringParams(*(torch.ones(P, dtype=torch.float64) for _ in range(4)))
    n, w = (torch.tensor(a) for a in ms.spring_directions(S))
    eps = torch.zeros(k, P, 6, dtype=torch.float64)
    for fn in (ms_ops.multispring_kset_cuda, ms_ops.update_kset):
        with pytest.raises(ValueError, match="k-set"):
            fn(eps[0], st, prm, n, w)  # ε without the member axis
        with pytest.raises(ValueError, match="k-set"):
            fn(eps, dict(st, virgin=st["virgin"][0]), prm, n, w)  # one leaf without it
        with pytest.raises(ValueError, match="k-set"):
            fn(torch.zeros(3, P, 6, dtype=torch.float64), st, prm, n, w)  # another k
    with pytest.raises(ValueError, match="G0 must be"):  # the parameters are one member's [P]
        ms_ops.multispring_kset_cuda(eps, st, ms.SpringParams(*(torch.ones(k, P, dtype=torch.float64)
                                                                for _ in range(4))), n, w)
    with pytest.raises(ValueError, match="CUDA"):
        ms_ops.multispring_kset_cuda(eps, st, prm, n, w)
    assert kernels.launch_counts()["multispring_kset"] == 0


def test_guard_step_refuses_an_offloaded_theta():
    """A tripped lane is frozen by writing its old carry back.  guard_step no
    longer refuses θ in host blocks updated in place (offload=True): it gives
    θ a second set of blocks, each pass writes the set it did not read, and
    the old θ outlives the step.  What it still refuses is such a step whose
    carry holds θ in another form than a PartitionedState."""
    from repro_torch.core import health

    mesh = meshgen.generate(1, 1, 1, pad_elems_to=2)
    ops = backend.make_operators(mesh, methods.SeismicConfig(npart=2, nspring=6), device="cpu")
    step, carry = methods.make_ensemble_step(ops, "proposed1", kset=2, offload=True)
    assert step.theta_in_place
    gstep = health.guard_step(step)
    hc = health.initial_guard_carry(carry)
    first = carry[1].blocks
    for f in torch.zeros((2, 2, 3), dtype=torch.float64).unbind(1):
        hc, _ = gstep(hc, f)
        theta = hc[0][1]
        assert theta.spare is not None and theta.blocks is not theta.spare
        assert all(x is not y for b1, b2 in zip(theta.blocks, theta.spare) for x, y in zip(b1, b2))
    # two passes: back in the set the carry came with
    assert all(x is y for b1, b2 in zip(theta.blocks, first) for x, y in zip(b1, b2))
    assert hc[1].tolist() == [0, 0]
    _, resident = methods.make_ensemble_step(ops, "baseline1", kset=2)
    with pytest.raises(ValueError, match="PartitionedState"):
        gstep(health.initial_guard_carry(resident), torch.zeros((2, 3), dtype=torch.float64))
    step, _ = methods.make_ensemble_step(ops, "proposed1", kset=2, offload=False)
    assert callable(health.guard_step(step)) and not step.theta_in_place


def test_run_ensemble_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        methods.run_ensemble(*_tiny_ensemble())


def test_campaign_and_its_cli_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    from repro_torch.campaign import run_campaign
    from repro_torch.launch import campaign as cli
    from repro_torch.surrogate import dataset

    mesh, cfg, waves = _tiny_ensemble()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_campaign(mesh, cfg, waves)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--waves", "2", "--nt", "4", "--mesh-n", "1x1x1", "--out", str(tmp_path / "out")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dataset.generate(dataset.EnsembleConfig(n_waves=2, nt=4, mesh_n=(1, 1, 1)))
    assert not os.path.exists(tmp_path / "out")
    assert run_campaign(mesh, cfg, waves, device="cpu").completed


def test_sweeps_and_the_probe_refuse_the_cpu_without_a_card(tmp_path):
    """No sweep, probe or worker falls back to the CPU: with no card the
    sweep CLI and the probe raise; ``run_plan`` records each group's failure
    (the reference's design: one bad group does not end the plan) and writes
    no shard; ``generate_sweep`` raises on the incomplete sweep."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    from repro_torch import scenario as sc
    from repro_torch.launch import campaign as cli
    from repro_torch.scenario import autotune
    from repro_torch.surrogate import dataset

    spec = sc.SweepSpec(base=sc.Scenario(mesh_n=(1, 1, 1), n_cases=1, nt=4),
                        axes=(("soil.vs", ((0.8, 1.0), (1.0, 1.0))),))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--sweep", SWEEP, "--out", str(tmp_path / "cli")])
    run = sc.run_plan(sc.make_plan(spec), out_dir=str(tmp_path / "out"))
    assert not run.scenarios and len(run.group_stats) == 2
    assert all(st["failed"] and "no CUDA device" in st["error"] for st in run.group_stats.values())
    assert os.listdir(tmp_path / "out") == ["plan.json"]
    with pytest.raises(RuntimeError, match="sweep incomplete"):
        dataset.generate_sweep(spec)
    scn = spec.base
    mesh = scn.build_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        autotune.choose(mesh, scn.sim_config(), n_cases=1, probe=True, waves=scn.waves(), obs=scn.obs.indices(mesh))
    assert not os.path.exists(tmp_path / "cli")


SWEEP = '{"base": {"n_cases": 2, "nt": 6, "mesh_n": [2, 2, 2]}}'


@pytest.mark.parametrize("flags,message", [
    # the reference launcher's multi-process refusals
    (["--scenario", "ricker-soft-basin", "--num-processes", "2", "--coordinator", "localhost:1234"],
     "--scenario/--sweep are single-process for now"),
    # several devices in one process: more than there are, with the reference's message
    (["--devices", "2"], "requested 2 devices, have 1"),
    (["--host-devices", "2", "--devices", "3"], "requested 3 devices, have 2"),
    (["--host-devices", "2", "--device", "cuda"], "--host-devices 2 runs CPU entries; drop --device cuda"),
    (["--devices", "3", "--num-processes", "2", "--coordinator", "localhost:1234"],
     "a multi-host campaign must use every device on the global case mesh (2)"),
    (["--cpu-backend", "--device", "cuda"], "--cpu-backend runs on the CPU; drop --device cuda"),
    # the reference launcher's own refusals of its sweep modes
    (["--sweep", SWEEP, "--trajectories"], "--trajectories rides the plain campaign path"),
    (["--scenario", "ricker-soft-basin", "--inject", "nan_at_step=2,case=1"], "--inject rides the plain campaign"),
    (["--sweep", SWEEP, "--scenario", "ricker-soft-basin"], "pass one of --scenario / --sweep / --scenarios"),
    (["--sweep", SWEEP, "--schedule"], "--schedule needs --ckpt-dir or --out"),
    (["--sweep", SWEEP, "--schedule", "--ckpt-dir", "unused", "--train-while-generating"],
     "--train-while-generating streams shards from --out; pass --out"),
])
def test_unported_campaign_modes_exit_nonzero(flags, message, capsys):
    """The multi-device modes of the reference launcher are refused by name,
    and so are the combinations of its sweep modes that the reference
    refuses, each with the reference's message, before anything runs (no
    device is needed to see it)."""
    from repro_torch.launch import campaign as cli

    with pytest.raises(SystemExit) as e:
        cli.main(["--device", "cpu", *flags])
    assert e.value.code not in (0, None)
    assert message in str(e.value.code)
    if "requested" in message:  # the case mesh's refusal, before any campaign runs
        assert "[campaign]" in str(e.value.code)


def test_one_process_topology_and_its_limits(monkeypatch):
    import sys

    from repro_torch.launch import bootstrap
    from repro_torch.parallel import distributed as dist

    assert (dist.process_index(), dist.process_count(), dist.is_distributed()) == (0, 1, False)
    dist.barrier("noop")
    dist.make_barrier("ckpt")()
    assert 0 < dist.free_port() < 65536
    one = bootstrap.parse_distributed(["--waves", "3"])
    assert one == bootstrap.DistributedArgs() and not one.distributed
    assert bootstrap.distributed_init(one) is one
    two = bootstrap.parse_distributed(["--num-processes", "2", "--coordinator", "localhost:1", "--process-id", "1",
                                       "--cpu-backend"])
    assert two.distributed and two.process_id == 1 and two.cpu_backend
    # several processes join a gloo group at the coordinator (recorded here, not joined)
    import atexit

    import torch.distributed as torch_dist

    joined, at_exit = [], []
    monkeypatch.setattr(torch_dist, "init_process_group", lambda backend, **kw: joined.append((backend, kw)))
    monkeypatch.setattr(atexit, "register", at_exit.append)
    assert bootstrap.distributed_init(two) is two
    (backend, kw), = joined
    assert (backend, kw["init_method"], kw["rank"], kw["world_size"]) == ("gloo", "tcp://localhost:1", 1, 2)
    assert at_exit == [bootstrap._teardown]
    with pytest.raises(ValueError, match="coordinator"):
        bootstrap.DistributedArgs(num_processes=2)
    monkeypatch.setattr(sys, "argv", ["campaign", "--host-devices", "1"])
    assert bootstrap.force_host_devices() == 1
    # above 1 it launches that many CPU processes of a module, so it needs one
    monkeypatch.setattr(sys, "argv", ["campaign", "--host-devices", "2"])
    with pytest.raises(ValueError, match="needs the module to launch"):
        bootstrap.force_host_devices()
    monkeypatch.setenv(bootstrap.HOST_DEVICES_ENV, "2")  # one of the two launched: it runs on
    assert bootstrap.force_host_devices() == 2


def test_surrogate_entry_points_raise_without_a_card(tmp_path):
    """Training, prediction, loading and init default to the card and
    raise without one, before reading any data; the CPU runs only when
    asked for."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    from repro_torch.surrogate import dataset, model, seqmodel, train, trajectory

    cfg, tcfg = model.SurrogateConfig(latent=8, n_lstm=1), seqmodel.TrajectoryConfig(latent=8, state=2)
    x = np.zeros((4, 8, 3), np.float32)
    d = str(tmp_path / "shards")
    dataset.save_shards(d, x, x, shard_size=2)
    params = model.init_params(cfg, torch.Generator(), device="cpu")
    tparams = seqmodel.init_params(tcfg, torch.Generator(), device="cpu")
    train.save_surrogate(str(tmp_path / "cnn"), cfg, params)
    trajectory.save_trajectory(str(tmp_path / "traj"), tcfg, tparams)
    calls = [
        lambda: train.fit(cfg, x, x, steps=1),
        lambda: train.fit_stream(cfg, dataset.ShardStream.from_dir(d), steps=1),
        lambda: train.fit_shards(cfg, d, steps=1),
        lambda: train.search(x, x, trials=1, steps=1),
        lambda: trajectory.fit_trajectory(tcfg, x, x, steps=1),
        lambda: trajectory.fit_trajectory_stream(tcfg, dataset.ShardStream.from_dir(d), steps=1),
        lambda: trajectory.fit_trajectory_shards(tcfg, d, steps=1),
        lambda: model.predict(params, cfg, x),
        lambda: seqmodel.predict(tparams, tcfg, x),
        lambda: model.init_params(cfg, torch.Generator()),
        lambda: seqmodel.init_params(tcfg, torch.Generator()),
        lambda: seqmodel.init_state(tcfg, 2),
        lambda: train.load_surrogate(str(tmp_path / "cnn")),
        lambda: trajectory.load_trajectory(str(tmp_path / "traj")),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert model.predict(params, cfg, x, device="cpu").shape == x.shape
    assert train.load_surrogate(str(tmp_path / "cnn"), device="cpu")[0] == cfg


SERVING_MODULES = ("serving/cache.py", "serving/batcher.py", "serving/engine.py", "serving/feedback.py",
                   "serving/__init__.py", "scenario/planner.py", "launch/serve.py")


def test_serving_slice_imports_neither_jax_nor_reference():
    """The serving slice's modules (framework-free ones included) are scanned
    by the import test above, and a fresh interpreter that imports them all
    has loaded no module of JAX or of the JAX package."""
    import subprocess
    import sys

    files = {os.path.relpath(p, os.path.join(REPO, "src", "repro_torch")) for p in _port_files()}
    assert set(SERVING_MODULES) <= files
    names = ["repro_torch." + m[:-3].replace("/", ".").replace(".__init__", "") for m in SERVING_MODULES]
    code = (f"import sys\nfor n in {names!r}:\n    __import__(n)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    run = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr


def test_serving_engines_and_cli_raise_without_a_card(tmp_path):
    """Every engine and the serve CLI default to the card and raise without
    one, before serving anything; the CPU runs only when asked for."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    from repro_torch.launch import serve
    from repro_torch.serving import DecodeEngine, ShardedEngine, SurrogateEngine, TrajectoryEngine
    from repro_torch.surrogate import model, seqmodel, train, trajectory

    cfg, tcfg = model.SurrogateConfig(latent=8, n_lstm=1), seqmodel.TrajectoryConfig(latent=8, state=2)
    params = model.init_params(cfg, torch.Generator(), device="cpu")
    tparams = seqmodel.init_params(tcfg, torch.Generator(), device="cpu")
    train.save_surrogate(str(tmp_path / "cnn"), cfg, params)
    trajectory.save_trajectory(str(tmp_path / "traj"), tcfg, tparams)
    lm_cfg, lm_params, _ = _tiny_lm()
    calls = [
        lambda: SurrogateEngine(cfg, params),
        lambda: TrajectoryEngine(tcfg, tparams),
        lambda: SurrogateEngine.from_checkpoint(str(tmp_path / "cnn")),
        lambda: TrajectoryEngine.from_checkpoint(str(tmp_path / "traj")),
        lambda: DecodeEngine(lm_cfg, lm_params),
        lambda: serve.main(["--engine", "surrogate", "--ckpt", str(tmp_path / "cnn")]),
        lambda: serve.main(["--engine", "trajectory", "--ckpt", str(tmp_path / "traj")]),
        lambda: serve.main(["--engine", "decode", "--arch", "qwen3-1.7b"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    eng = ShardedEngine(SurrogateEngine(cfg, params, device="cpu"))
    assert eng.infer(np.zeros((1, 8, 3), np.float32)).y.shape == (1, 8, 3)


@pytest.mark.parametrize("n", [2, 4])
def test_serve_cli_multi_device_exits_nonzero(n):
    """``--host-devices N`` names CPU entries: asked for with the card, the
    serve CLI exits non-zero saying so, before any engine is built."""
    from repro_torch.launch import serve

    with pytest.raises(SystemExit) as e:
        serve.main(["--device", "cuda", "--host-devices", str(n), "--shard"])
    assert e.value.code not in (0, None)
    assert f"--host-devices {n} serves on CPU entries; drop --device cuda" in str(e.value.code)


def test_flash_cuda_entry_refuses_inputs_that_need_a_gradient():
    """The kernel writes its output into a new tensor, which carries no
    gradient: with grad mode on, q, k or v requiring one are refused before
    the device is looked at (so on the CPU too); under ``no_grad`` the
    device check follows; the trainable path (``FlashAttentionFn``) calls
    the entry with grad mode off and on the CPU runs the plain version."""
    from repro_torch.models.layers import FlashAttentionFn

    q = torch.zeros(1, 2, 4, 8)
    for needs in ("q", "k", "v"):
        args = [q.clone(), q[:, :1].clone(), q[:, :1].clone()]
        args["qkv".index(needs)].requires_grad_()
        with pytest.raises(ValueError, match="requires a gradient"):
            fa_ops.flash_attention_cuda(*args)
        with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
            fa_ops.flash_attention_cuda(*args)
        out = FlashAttentionFn.apply(*args, True, None, None, None)
        assert out.grad_fn is not None and type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    with torch.no_grad():
        assert FlashAttentionFn.apply(*args, True, None, None, None).grad_fn is None
    assert kernels.launch_counts()["flash_attention"] == 0
    assert FlashAttentionFn.apply(*args, True, None, None, None).requires_grad


def test_train_entry_points_raise_without_a_card(tmp_path):
    """The trainer defaults to the card like every entry point: the data
    prefetcher and the train CLI raise without one; the CPU runs only when
    asked for."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    from repro_torch.launch import train as train_cli
    from repro_torch.training import data

    it = data.batches(data.DataConfig(vocab_size=16, seq_len=4, global_batch=1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        data.Prefetcher(it)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--arch", "qwen3-1.7b", "--reduced", "--steps", "1", "--ckpt-dir", str(tmp_path / "ck")])
    assert not os.path.exists(tmp_path / "ck")
    pf = data.Prefetcher(it, device="cpu")
    assert next(pf)["tokens"].device.type == "cpu"
    pf.close()


@pytest.mark.parametrize("flags,message", [
    (["--mesh", "2x4"], "--mesh 2x4 needs 8 processes, one a device; this launch has 1"),
    (["--multi-pod", "--num-processes", "4", "--coordinator", "localhost:1"],
     "--multi-pod without --mesh is the (2, 16, 16) mesh, which needs 512 processes"),
    (["--host-devices", "2"], "2 processes and no --mesh: the reference's default mesh is (16, 16)")])
def test_train_cli_refuses_several_devices(flags, message):
    """A mesh whose size is not the world size, ``--multi-pod`` on fewer
    than 512 processes and several processes without a mesh exit non-zero
    by name, before any process is launched or joined."""
    from repro_torch.launch import train as train_cli

    with pytest.raises(SystemExit) as e:
        train_cli.main(["--arch", "qwen3-1.7b", "--reduced", "--device", "cpu", *flags])
    assert e.value.code not in (0, None)
    assert message in str(e.value.code)


def test_flash_on_meta_tensors_is_shape_only(monkeypatch):
    """The flash operator's fake runs on ``meta`` tensors (the dry run's):
    the output's shape and dtype, and neither the plain version nor the
    kernel's wrapper runs, nor does any launch counter move."""
    def refuse(*a, **kw):
        raise AssertionError("ran on meta tensors")

    monkeypatch.setattr(fa_ops, "flash_attention_ref", refuse)
    monkeypatch.setattr(fa_ops, "flash_attention_cuda", refuse)
    kernels.reset_launch_counts()
    meta = torch.device("meta")
    q = torch.empty((2, 8, 48, 192), dtype=torch.bfloat16, device=meta)
    k = torch.empty((2, 2, 64, 192), dtype=torch.bfloat16, device=meta)
    v = torch.empty((2, 2, 64, 128), dtype=torch.bfloat16, device=meta)
    out = fa_ops.flash_attention(q, k, v, window=16, softcap=30.0, scale=0.1)
    assert out.device == meta and out.dtype == torch.bfloat16 and tuple(out.shape) == (2, 8, 48, 128)
    assert kernels.launch_counts()["flash_attention"] == 0 and not any(fa_ops.wgmma_launch_counts().values())


def test_flash_on_cpu_tensors_runs_the_plain_version(monkeypatch):
    calls = []
    plain = fa_ops.flash_attention_ref

    def recorded(*a, **kw):
        calls.append(kw)
        return plain(*a, **kw)

    monkeypatch.setattr(fa_ops, "flash_attention_ref", recorded)
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 4, 24, 16), generator=g) for _ in range(3))
    out = fa_ops.flash_attention(q, k[:, :2], v[:, :2], window=8)
    assert calls == [dict(causal=True, window=8, softcap=None, scale=None)]
    assert torch.equal(out, plain(q, k[:, :2], v[:, :2], window=8))
    assert kernels.launch_counts()["flash_attention"] == 0


def test_flop_counter_sees_the_flash_operator():
    """``FlopCounterMode`` counts the operator by its formula, 2·B·Hq·(visible
    pairs)·(dh + dv), on CPU and meta tensors alike (the ops inside the
    plain version are not counted again)."""
    from torch.utils.flop_counter import FlopCounterMode

    for device in ("cpu", "meta"):
        q = torch.zeros((2, 4, 40, 16), device=device)
        k = torch.zeros((2, 2, 64, 16), device=device)
        v = torch.zeros((2, 2, 64, 8), device=device)
        with FlopCounterMode(display=False) as fc:
            fa_ops.flash_attention(q, k, v, window=10)
        # query i sits at key position 24 + i and sees keys (14 + i, 24 + i]: 10 each
        assert fa_ops.visible_pairs(40, 64, True, 10) == 40 * 10
        assert fc.get_total_flops() == 2 * 2 * 4 * 400 * (16 + 8)
        with FlopCounterMode(display=False) as fc:
            fa_ops.flash_attention(q, k, v, causal=False)
        assert fc.get_total_flops() == 2 * 2 * 4 * 40 * 64 * 24


def test_sharding_over_several_devices_raises():
    """A ``DeviceMesh`` needs a process group of its size: in one process
    without a group it raises naming both; over a ``LogicalMesh`` of
    several devices (no group, accounting only) ``constrain`` and
    ``shard_map`` raise; on one device they are the identity."""
    from repro_torch.launch import mesh as M
    from repro_torch.parallel import sharding as sh

    x = torch.ones(4)
    with pytest.raises(ValueError, match=re.escape("needs 8 processes, one a device; this launch has a world size "
                                                   "of 1")):
        M.make_host_mesh()
    with pytest.raises(ValueError, match="needs 512 processes"):
        M.make_production_mesh(multi_pod=True)
    with pytest.raises(ValueError, match="needs a process group"):
        M.make_auto_mesh((1, 1), ("data", "model"), "cpu")
    for mesh in (M.logical_host_mesh(), M.logical_production_mesh(), M.logical_production_mesh(multi_pod=True)):
        with sh.use_mesh(mesh), pytest.raises(NotImplementedError, match="a LogicalMesh has no devices"):
            sh.constrain(x, "batch")
        with pytest.raises(NotImplementedError, match="a LogicalMesh has no devices"):
            sh.shard_map(lambda a: a, mesh, None, None)
    with sh.use_mesh(M.make_card_mesh()):
        assert sh.constrain(x, "batch") is x


def test_launch_tail_imports_neither_jax_nor_reference():
    """The dry run, its accounting, the sharding rules and the compression
    load no module of JAX or of the JAX package in a fresh interpreter."""
    import subprocess
    import sys

    names = ["repro_torch.launch.dryrun", "repro_torch.launch.hlo_analysis", "repro_torch.parallel.sharding",
             "repro_torch.parallel.compression", "repro_torch.configs.granite_8b", "repro_torch.configs.llama3_405b"]
    code = (f"import sys\nfor n in {names!r}:\n    __import__(n)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    run = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr
