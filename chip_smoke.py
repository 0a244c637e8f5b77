#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA device and the CUDA toolkit (``nvcc``); exits non-zero with
no result without them, or without the rest of the repository beside it.
Phases, each followed by a JSON line with its seconds:

1.  device     the card's name and power limit, as ``nvidia-smi`` reports them;
2.  build      the CUDA kernels from ``src/repro_torch/csrc`` (registers and
               spills of every kernel instance);
3.  kernels    each kernel against its plain PyTorch version on the card:
               multispring in both dtypes, P ragged, flags exact, at the
               default and a non-default tangent floor; the EBE product
               (gather fused in) in both dtypes on a random x and a random
               int32 connectivity with repeated nodes, E ragged and E
               smaller than a tile, at three tile sizes;
               flash attention in fp32 (CUDA-core kernel) and bf16 (wgmma/TMA
               kernel) over GQA, ragged, Sq < Skv, window, softcap,
               non-causal, Sq × Skv, dh ∈ {128, 256, 192 with dv 128}, dh and
               dv not multiples of 8 (the padding step) and Sq 1 against
               4,096 keys;
4.  cpu        the FEM port on the card against the port on the CPU;
5.  prefetch   ``schedule="prefetch"`` ≡ ``"serial"`` bitwise on the card;
6.  crs_check  all four methods on a small mesh on the card, solved to 1e-10:
               Baseline 2 and Proposed 1 against Baseline 1 (1e-12·max|v|),
               Proposed 2 against it (1e-5·max|v|), each CRS rung against
               itself on the CPU (1e-6·max|v|), Proposed 1 prefetch ≡ serial
               bitwise;
7.  main       Proposed 2 at full size through ``methods.run``: 294,912 TET10
               elements, 150 springs per point (θ = 7.08 GB in pinned host
               memory), ``npart=8``, prefetch, fp64, 8 steps;
8.  crs_main   the CRS rungs at main's size and config through ``methods.run``:
               Baseline 1 (θ on the card) and Proposed 1 (θ streamed) 4
               steps each, Baseline 2 (θ and the multispring on the host) 2
               steps; per step the parts of the step, per rung the peak
               device memory against θ's bytes;
9.  lm_cpu     qwen3-1.7b at full width, 2 layers, fp32: prefill + 4 decode
               steps on the card against the CPU, and prefill→decode against
               ``forward`` on the card (the fp32 flash kernel's path);
10. lm_main    qwen3-1.7b at full width and depth (28 layers), bf16 compute:
               prefill of 4 × 4,096 tokens (28 launches of the wgmma flash
               kernel, none of the fp32 one), then 32 greedy decode steps
               (no flash launch);
11. lm_offload ``generate`` with the KV cache in pinned host memory (4 blocks
               of 7 layers, prefetch) gives the resident tokens; the same
               tokens stepped through both decode steps give bitwise equal
               logits and caches;
12. timing     each kernel at the shapes its main path gives it, against its
               plain version, its bound and (flash) SDPA, with flash held in
               fp32 and bf16 there too and timed in both; a breakdown of one
               whole EBE matvec (kernel, slot-table scatter) in both dtypes,
               of one full-size FEM step (with the multispring kernel summed
               over the step's blocks beside the streamed pass and the θ
               copy alone), of one ``bcsr_matvec`` against its byte bound and
               one ``crs_update`` by part, of one prefill and of one decode
               step.

It prints one ``{"kernels": [...]}`` line, and last
``{"ok": true, "device": {...}}``.  Any failed check raises, so the script
then exits non-zero before the last line.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM peaks (NVIDIA data sheet, dense, non-tensor-core for fp32/fp64)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"torch.float64": 34e12, "torch.float32": 67e12, "torch.bfloat16": 989e12}  # bf16: tensor cores
MS_OPS_PER_SPRING = 124  # counted from csrc/multispring.cu (pow as one op)
EBE_OPS_PER_ELEM = 2448  # 4 points × (2·90 g + 2·90 H + 2·36 Dε + 2·90 Bᵀσ)
FEM_KERNELS = ("multispring", "ebe_matvec_f64", "ebe_matvec_f32")
CRS_STEPS = {"baseline1": 4, "proposed1": 4, "baseline2": 2}  # crs_main; Baseline 2's host pass is slow
# (B, Hq, Hkv, Sq, Skv, dh, dv, causal, window, softcap, strided q/k/v)
FLASH_CASES = [
    (1, 2, 2, 64, 64, 32, 32, True, None, None, False),
    (2, 4, 2, 100, 100, 64, 64, True, None, None, False),   # GQA, ragged
    (1, 2, 1, 48, 160, 64, 64, True, None, None, False),    # Sq < Skv
    (1, 2, 2, 96, 96, 64, 64, True, 32, None, False),       # window
    (1, 2, 2, 80, 80, 64, 64, True, None, 30.0, False),     # softcap
    (1, 3, 1, 64, 64, 40, 40, False, None, None, False),    # non-causal, odd dh
] + [(1, 2, 1, min(sq, skv), skv, 32, 32, True, None, None, False)
     for sq in (1, 7, 33, 130) for skv in (64, 129, 200)] + [
    (2, 16, 8, 100, 150, 128, 128, True, None, None, True),  # qwen3's heads, strided as in the layer
    (1, 4, 2, 100, 150, 256, 256, True, 64, 50.0, False),
    (1, 4, 2, 100, 150, 192, 128, True, None, None, False),  # MLA's dh ≠ dv
    (1, 2, 1, 50, 90, 36, 20, True, None, None, True),     # dh, dv not multiples of 8: bf16 pads for TMA
    (1, 4, 2, 1, 4096, 128, 128, True, None, None, False),  # one query row against a long cache
]
FLASH_TOL = {"torch.float32": 2e-5, "torch.bfloat16": 2e-2}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def ptxas_report(log):
    """Registers and spill bytes of every kernel instance, from ``-Xptxas -v``."""
    kinds = {"d": "double", "f": "float"}
    out = {}
    for chunk in log.split("Compiling entry function '")[1:]:
        mangled = chunk.split("'", 1)[0]
        m = re.search(r"(ms_update_kernel|ebe_kernel)I(d|f)E", mangled)
        fa = re.search(r"(flash_kernel|flash_wgmma_kernel)ILi(\d+)E", mangled)
        regs = re.search(r"Used (\d+) registers", chunk)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", chunk)
        if (m or fa) and regs:
            if fa:  # flash_kernel is the fp32 CUDA-core kernel, flash_wgmma_kernel the bf16 one
                name = f"{fa.group(1)}<{'bf16' if 'wgmma' in fa.group(1) else 'float'}, {fa.group(2)}>"
            else:
                name = f"{m.group(1)}<{kinds[m.group(2)]}>"
            out[name] = {"registers": int(regs.group(1)),
                         "spill_store_bytes": int(spill.group(1)) if spill else None,
                         "spill_load_bytes": int(spill.group(2)) if spill else None}
    return out


# one fp64 power as the multispring kernel takes it, and one fp64 division
SASS_PROBE = r"""
extern "C" __global__ void probe_power(const double* x, const double* b, double* y) {
  y[threadIdx.x] = exp2(b[threadIdx.x] * log2(x[threadIdx.x]));
}
extern "C" __global__ void probe_division(const double* x, const double* b, double* y) {
  y[threadIdx.x] = b[threadIdx.x] / (1.0 + x[threadIdx.x]);
}
"""
FP64_OPS = ("DFMA", "DADD", "DMUL", "DSETP", "DMNMX")


def sass_fp64_counts(lib, nvcc):
    """Static fp64 instructions (and all instructions) of the FEM kernels'
    fp64 instances in the built library, and of one power and one division
    (``SASS_PROBE``), from ``cuobjdump -sass``."""
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    build_dir = os.path.dirname(lib)
    probe_src, probe_bin = os.path.join(build_dir, "sass_probe.cu"), os.path.join(build_dir, "sass_probe.cubin")
    with open(probe_src, "w") as f:
        f.write(SASS_PROBE)
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-cubin", "-o", probe_bin,
                    probe_src], check=True, capture_output=True)
    out = {}
    for path in (str(lib), probe_bin):
        text = subprocess.run([tool, "-sass", path], capture_output=True, text=True, check=True).stdout
        for chunk in re.split(r"\n\s+Function : ", text)[1:]:
            name = chunk.split("\n", 1)[0].strip()
            key = next((k for k in ("ms_update_kernelIdE", "ebe_kernelIdE", "probe_power", "probe_division")
                        if k in name), None)
            if key is None:
                continue
            ops = re.findall(r"^\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", chunk, re.M)
            out[key] = {"instructions": len(ops), "fp64": sum(op in FP64_OPS for op in ops),
                        "mufu": ops.count("MUFU")}
    return out


def emit(obj):
    print(json.dumps(obj), flush=True)


class Phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            emit({"phase": self.name, "seconds": time.perf_counter() - self.t0})
        return False


def require(cond, what):
    if not cond:
        raise AssertionError(what)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    import numpy as np

    from repro_torch import kernels
    from repro_torch.configs import ARCHS
    from repro_torch.core import hetmem
    from repro_torch.fem import assembly, meshgen, methods, multispring as ms, spmv
    from repro_torch.kernels import _build
    from repro_torch.kernels.ebe_matvec import ops as ebe_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.multispring import ops as ms_ops
    from repro_torch.models import layers as L, transformer as T
    from repro_torch.serving import decode as serve

    # plain versions run on the card below: full fp32, no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    with Phase("device"):
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
        print(smi, flush=True)
        emit({"torch": torch.__version__, "cuda": torch.version.cuda,
              "device": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()})

    with Phase("build"):
        lib = _build.build()
        _build.library()
        emit({"registers_spills": ptxas_report(_build.ptxas_log())})
        emit({"sass_static_counts": sass_fp64_counts(lib, _build._nvcc())})

    def rel_err(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))

    with Phase("kernels"):
        K = ms.STATE_KEYS
        for dt, tol in ((torch.float64, 1e-12), (torch.float32, 3e-5)):
            # P not a multiple of the block's points; S 195 takes two staged chunks
            for gmf, S in ((1e-3, 150), (0.3, 150), (1e-3, 195)):
                rng = np.random.default_rng(7)
                P = 29
                prm = ms.SpringParams(*(torch.tensor(rng.uniform(lo, hi, P), dtype=dt, device=dev)
                                        for lo, hi in ((5e7, 5e8), (5e-4, 5e-3), (0.7, 1.0), (1e8, 1e9))),
                                      g_min_frac=gmf)
                n, w = (torch.tensor(a, dtype=dt, device=dev) for a in ms.spring_directions(S))
                st_p = ms.init_state(P, S, dt, device=dev)
                st_k = {k: v.clone() for k, v in st_p.items()}
                eps = torch.zeros((P, 6), dtype=dt, device=dev)
                worst = 0.0
                for _ in range(6):
                    eps = eps + torch.tensor(rng.normal(scale=8e-4, size=(P, 6)), dtype=dt, device=dev)
                    sp, Dp, st_p, fp = ms_ops.multispring_ref(eps, st_p, prm, n, w)
                    sk, Dk, st_k, fk = ms_ops.multispring_cuda(eps, st_k, prm, n, w)
                    torch.cuda.synchronize()
                    worst = max(worst, rel_err(sk, sp), rel_err(Dk, Dp))
                    for key in ms.FLAG_KEYS:
                        require(st_k[key].dtype == torch.int32 and torch.equal(st_k[key], st_p[key]),
                                f"multispring flags {key} differ ({dt}, g_min_frac={gmf})")
                    require(torch.allclose(fk, fp, rtol=1e-4, atol=1e-6), "multispring frac differs")
                for key in K[:4]:
                    worst = max(worst, rel_err(st_k[key], st_p[key]))
                emit({"check": "multispring", "dtype": str(dt), "g_min_frac": gmf, "P": P, "S": S,
                      "max_rel_err": worst, "tol": tol})
                require(worst <= tol, f"multispring disagrees: {worst} > {tol}")
            g = torch.Generator(device=dev).manual_seed(1)
            etol = 1e-13 if dt == torch.float64 else 5e-6
            N = 400
            # E not a multiple of a tile, and E smaller than one
            for E, tiles in ((1001, (ebe_ops.TILE_E, 4, 64)), (5, (ebe_ops.TILE_E,))):
                x = torch.randn((N, 3), dtype=dt, device=dev, generator=g)
                conn = torch.randint(0, N, (E, 10), device=dev, generator=g, dtype=torch.int32)
                conn[::3, 9] = conn[::3, 0]  # repeated nodes within an element
                Q = torch.randn((E, 4, 6, 6), dtype=torch.float64, device=dev, generator=g)
                D = (Q @ Q.transpose(-1, -2)).to(dt).contiguous()
                Jinv = torch.randn((E, 3, 3), dtype=dt, device=dev, generator=g)
                wdet = torch.rand((E, 4), dtype=dt, device=dev, generator=g)
                coef = torch.rand((E,), dtype=dt, device=dev, generator=g) + 0.5
                u = spmv.gather_elem(x, conn.long())
                for c in (coef, None):
                    ref = ebe_ops.ebe_element_matvec_ref(u, D, Jinv, wdet, c)
                    for te in tiles:
                        err = rel_err(ebe_ops.ebe_matvec_cuda(x, conn, D, Jinv, wdet, c, tile_e=te), ref)
                        emit({"check": "ebe_matvec", "dtype": str(dt), "E": E, "N": N, "tile_e": te,
                              "coef": c is not None, "max_rel_err": err, "tol": etol})
                        require(err <= etol, f"ebe_matvec disagrees: {err} > {etol} (E {E}, tile_e {te})")

        for case in FLASH_CASES:
            B, Hq, Hkv, Sq, Skv, dh, dv, causal, window, cap, strided = case
            for dt in (torch.float32, torch.bfloat16):
                g = torch.Generator(device=dev).manual_seed(Sq * 1000 + Skv)

                def heads(H, S, d):  # [B,H,S,d], or a transposed view of [B,S,H,d] as the layer gives
                    shape = (B, S, H, d) if strided else (B, H, S, d)
                    x = torch.randn(shape, device=dev, generator=g).to(dt)
                    return x.transpose(1, 2) if strided else x

                q, k, v = heads(Hq, Sq, dh), heads(Hkv, Skv, dh), heads(Hkv, Skv, dv)
                kw = dict(causal=causal, window=window, softcap=cap)
                before = kernels.instance_counts()
                out_k = fa_ops.flash_attention_cuda(q, k, v, **kw)
                ran = {n: c - before[n] for n, c in kernels.instance_counts().items()}
                require(ran == {n: int(n == fa_ops.COUNTERS[dt].name) for n in ran},
                        f"flash {dt} went through {ran}, not {fa_ops.COUNTERS[dt].name} alone")
                out_p = fa_ops.flash_attention_ref(q, k, v, **kw)
                torch.cuda.synchronize()
                err = float((out_k.float() - out_p.float()).abs().max())
                tol = FLASH_TOL[str(dt)]
                emit({"check": "flash_attention", "dtype": str(dt), "case": case, "max_abs_err": err,
                      "tol": tol})
                require(out_k.dtype == dt and tuple(out_k.shape) == (B, Hq, Sq, dv), "flash output shape/dtype")
                require(err <= tol, f"flash_attention disagrees: {err} > {tol} at {case} ({dt})")

    def wave_for(nt, dt):
        t = np.arange(nt) * dt
        wave = np.zeros((nt, 3))
        wave[:, 0] = 0.3 * np.sin(2 * np.pi * 2.0 * t + 0.5)  # nonzero from step 0
        wave[:, 2] = 0.1 * np.cos(2 * np.pi * 1.5 * t)
        return wave

    with Phase("cpu"):
        mesh = meshgen.generate(8, 8, 4, pad_elems_to=8)
        cfg = methods.SeismicConfig(dt=0.01, npart=4, nspring=30, maxiter=600)
        wave = wave_for(3, cfg.dt)
        r_cpu = methods.run(mesh, cfg, wave, device="cpu")
        r_gpu = methods.run(mesh, cfg, wave, device=dev)
        a = r_cpu["velocity_history"].numpy()
        b = r_gpu["velocity_history"].cpu().numpy()
        err = float(np.abs(a - b).max())
        atol = 1e-6 * float(np.abs(a).max())
        emit({"check": "gpu_vs_cpu", "mesh": [8, 8, 4], "max_abs_err_v": err, "atol": atol,
              "iters_cpu": r_cpu["iters"].tolist(), "iters_gpu": r_gpu["iters"].tolist()})
        require(np.abs(a).max() > 0 and err <= atol, "port on the card disagrees with the port on the CPU")
        require(float((r_gpu["u"].cpu() - r_cpu["u"]).abs().max()) <= 1e-6 * float(r_cpu["u"].abs().max()),
                "u differs between card and CPU")

    with Phase("prefetch"):
        mesh = meshgen.generate(16, 16, 8, pad_elems_to=8)
        cfg = methods.SeismicConfig(dt=0.01, npart=4, nspring=30, maxiter=600)
        wave = wave_for(3, cfg.dt)
        serial = methods.run(mesh, cfg, wave, device=dev)
        pre = methods.run(mesh, dataclasses.replace(cfg, schedule="prefetch", prefetch=1), wave, device=dev)
        same_u = torch.equal(serial["u"], pre["u"])
        same_theta = all(torch.equal(x, y) for bs, bp in zip(serial["carry"][1].blocks, pre["carry"][1].blocks)
                         for x, y in zip(bs, bp))
        emit({"check": "prefetch_vs_serial", "mesh": [16, 16, 8], "u_bitwise": same_u,
              "theta_bitwise": same_theta})
        require(same_u and same_theta, "prefetch(1) is not bitwise serial on the card")

    def rungs_disagree(runs, ref, rel):
        """Each run's velocity history against ``ref``'s over their common
        steps, held to ``rel[m]``·max|v|."""
        v0 = runs[ref]["velocity_history"].cpu()
        scale = float(v0.abs().max())
        require(scale > 0, "the wave moved nothing")
        out = {}
        for m, r in runs.items():
            if m != ref:
                v = r["velocity_history"].cpu()[:v0.shape[0]]
                n = v.shape[0]
                err = float((v - v0[:n]).abs().max())
                atol = rel[m] * scale
                out[m] = {"max_abs_err_v": err, "rel_err_v": err / scale, "atol": atol,
                          "bitwise": torch.equal(v, v0[:n]), "steps": n}
                require(err <= atol, f"{m} disagrees with {ref}: {err} > {atol}")
        return out

    with Phase("crs_check"):
        mesh_c = meshgen.generate(8, 8, 4, pad_elems_to=8)
        # solved to 1e-10: at the default 1e-8 the CRS PCG stops near 9e-9 while
        # flexible CG lands near 1e-10, and Proposed 2 sits 1.149e-5·max|v| off
        # Baseline 1 on this mesh in the JAX package too; at 1e-10 both packages
        # put it 3.1e-7 off, so the comparison measures the physics
        cfg_c = methods.SeismicConfig(dt=0.01, npart=4, nspring=30, maxiter=600, tol=1e-10)
        wave_c = wave_for(3, cfg_c.dt)
        card, ran = {}, {}
        for m in methods.METHODS:
            kernels.reset_launch_counts()
            card[m] = methods.run(mesh_c, cfg_c, wave_c, method=m, device=dev)
            ran[m] = kernels.launch_counts()
            require(bool(card[m]["converged"].all()), f"{m} did not converge")
        vs_b1 = rungs_disagree(card, "baseline1", {"baseline2": 1e-12, "proposed1": 1e-12, "proposed2": 1e-5})
        vs_cpu = {}
        for m in CRS_STEPS:
            r_cpu = methods.run(mesh_c, cfg_c, wave_c, method=m, device="cpu")
            vs_cpu[m] = rungs_disagree({"cpu": r_cpu, "gpu": card[m]}, "cpu", {"gpu": 1e-6})["gpu"]
            vs_cpu[m]["iters_cpu"], vs_cpu[m]["iters_gpu"] = r_cpu["iters"].tolist(), card[m]["iters"].tolist()
        pre = methods.run(mesh_c, dataclasses.replace(cfg_c, schedule="prefetch", prefetch=1), wave_c,
                          method="proposed1", device=dev)
        same_u = torch.equal(pre["u"], card["proposed1"]["u"])
        same_theta = all(torch.equal(x, y) for bs, bp in zip(card["proposed1"]["carry"][1].blocks,
                                                              pre["carry"][1].blocks) for x, y in zip(bs, bp))
        b2_theta = card["baseline2"]["carry"][1]
        emit({"check": "crs_rungs", "mesh": [8, 8, 4], "nspring": cfg_c.nspring, "steps": 3,
              "vs_baseline1": vs_b1, "card_vs_cpu": vs_cpu, "launches": ran,
              "proposed1_prefetch_vs_serial": {"u_bitwise": same_u, "theta_bitwise": same_theta},
              "baseline2_theta_devices": sorted({str(x.device) for x in b2_theta.values()})})
        require(same_u and same_theta, "Proposed 1 prefetch(1) is not bitwise serial on the card")
        for m in CRS_STEPS:  # Baseline 2 computes the multispring on the host, the others launch the kernel
            require((ran[m]["multispring"] == 0) == (m == "baseline2"), f"{m} made multispring launches {ran[m]}")
            require(ran[m]["ebe_matvec_f64"] == ran[m]["ebe_matvec_f32"] == 0, f"{m} launched the EBE kernel")
        require(all(x.device.type == "cpu" for x in b2_theta.values()), "Baseline 2's θ left the host")
        del card, pre, r_cpu

    with Phase("main"):
        mesh = meshgen.generate(64, 64, 12, pad_elems_to=8)
        cfg = methods.SeismicConfig(npart=8, schedule="prefetch", prefetch=1, nspring=150)
        nt = 8
        wave = wave_for(nt, cfg.dt)
        theta_bytes = mesh.n_elem * 4 * cfg.nspring * 40
        emit({"mesh": [64, 64, 12], "elements": mesh.n_elem, "nodes": mesh.n_nodes, "dof": mesh.ndof,
              "nspring": cfg.nspring, "theta_GB": theta_bytes / 1e9, "npart": cfg.npart, "steps": nt})
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        last = dict(kernels.launch_counts())
        steps = []

        def on_step(k, info):
            counts = kernels.launch_counts()
            delta = {name: counts[name] - last[name] for name in counts}
            last.update(counts)
            row = dict(step=k, **info, launches=delta,
                       theta_GB_per_s_over_step=2 * theta_bytes / info["seconds"] / 1e9)
            steps.append(row)
            emit(row)

        kernels.reset_launch_counts()  # counts of the main path's run only
        last.update(kernels.launch_counts())
        res = methods.run(mesh, cfg, wave, device=dev, on_step=on_step)
        launches = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        blocks = res["carry"][1].blocks
        pinned = all(hetmem.is_pinned_host(x) for blk in blocks for x in blk)
        v = res["velocity_history"]
        emit({"launches": launches, "peak_device_bytes": peak, "theta_bytes": theta_bytes,
              "theta_pinned_host": pinned, "converged": res["converged"].tolist(),
              "max_abs_v_observed": float(v.abs().max()), "max_abs_v_field": float(res["v"].abs().max()),
              "max_abs_u_field": float(res["u"].abs().max())})
        require(bool(res["converged"].all()), "a full-size step did not converge")
        require(all(launches[n] > 0 for n in FEM_KERNELS), f"a kernel of the path never launched: {launches}")
        require(pinned, "θ blocks are not pinned host tensors")
        require(peak < theta_bytes, f"peak device memory {peak} ≥ θ bytes {theta_bytes}")
        require(bool(torch.isfinite(v).all()) and bool(torch.isfinite(res["u"]).all()), "result not finite")
        require(float(res["v"].abs().max()) > 0, "the wave moved nothing")
        require(tuple(res["u"].shape) == (mesh.n_nodes, 3), "u has the wrong shape")

    with Phase("crs_main"):
        # main's mesh and config (npart 8, prefetch(1), fp64, 150 springs, the same
        # wave); every node observed, since the wave reaches no surface node in 4 steps
        crs_runs, crs_launches = {}, {}
        every_node = np.arange(mesh.n_nodes)
        for m, nt_m in CRS_STEPS.items():
            crs_steps = []

            def on_crs_step(k, info, m=m):
                counts = kernels.launch_counts()
                delta = {name: counts[name] - last[name] for name in counts}
                last.update(counts)
                row = dict(method=m, step=k, **info, launches=delta)
                crs_steps.append(row)
                emit(row)

            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            resident_before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launch_counts()  # counts of this rung's run only
            last = dict(kernels.launch_counts())
            t0 = time.perf_counter()
            r = methods.run(mesh, cfg, wave_for(nt_m, cfg.dt), method=m, device=dev, on_step=on_crs_step,
                            observe=every_node)
            run_s = time.perf_counter() - t0
            crs_launches[m] = kernels.launch_counts()
            peak = torch.cuda.max_memory_allocated()
            theta = r["carry"][1]
            leaves = [x for blk in theta.blocks for x in blk] if m == "proposed1" else list(theta.values())
            row = {"method": m, "steps": nt_m, "run_s": run_s, "launches": crs_launches[m],
                   "peak_device_bytes": peak, "resident_before_bytes": resident_before,
                   "theta_bytes": theta_bytes, "theta_devices": sorted({str(x.device) for x in leaves}),
                   "theta_pinned_host": all(hetmem.is_pinned_host(x) for x in leaves),
                   "converged": r["converged"].tolist(), "iters": r["iters"].tolist(),
                   "step_s": [x["seconds"] for x in crs_steps],
                   "parts_ms": [x["ms"] for x in crs_steps]}
            if m == "baseline2":
                P = mesh.n_elem * 4
                row["host"] = {"threads": torch.get_num_threads(),
                               "host_compute_ms": [x["ms"]["host_compute"] for x in crs_steps],
                               "bytes_down_eps": P * 6 * 8, "bytes_up_sigma_D_frac": P * (6 + 36 + 1) * 8,
                               "points": P, "springs": P * cfg.nspring}
            emit(row)
            require(bool(r["converged"].all()), f"{m}: a full-size step did not converge")
            require(crs_launches[m]["ebe_matvec_f64"] == crs_launches[m]["ebe_matvec_f32"] == 0,
                    f"{m} launched the EBE kernel")
            v = r["velocity_history"]
            require(bool(torch.isfinite(v).all()) and bool(torch.isfinite(r["u"]).all()), f"{m}: result not finite")
            require(float(r["v"].abs().max()) > 0, f"{m}: the wave moved nothing")
            require(tuple(r["u"].shape) == (mesh.n_nodes, 3), f"{m}: u has the wrong shape")
            if m == "baseline2":
                require(crs_launches[m]["multispring"] == 0, "Baseline 2 launched the multispring kernel")
                require(all(x.device.type == "cpu" for x in leaves), "Baseline 2's θ left the host")
            else:
                require(crs_launches[m]["multispring"] > 0, f"{m} never launched the multispring kernel")
            if m == "proposed1":
                require(row["theta_pinned_host"], "Proposed 1's θ blocks are not pinned host tensors")
                require(peak < theta_bytes, f"Proposed 1's peak device memory {peak} ≥ θ bytes {theta_bytes}")
            crs_runs[m] = {"velocity_history": v.cpu()}
            del r, theta, leaves, v
        # 1e-10 here, 1e-12 in crs_check: the rungs' damping fractions are summed in
        # other orders (the kernel's, the plain version's on the card or the host),
        # and the solve carries that last bit into v through A's condition number,
        # larger at this size (Proposed 1 sat 8.2e-13·max|v| off on an H100, and
        # 2.25e-12 with the block products summed in another order)
        emit({"check": "crs_full_size_vs_baseline1", "observed": "every node",
              **rungs_disagree(crs_runs, "baseline1", {"baseline2": 1e-10, "proposed1": 1e-10})})

    qwen = ARCHS["qwen3-1.7b"]

    def greedy(logits):
        return logits[:, -1].argmax(-1, keepdim=True)

    with Phase("lm_cpu"):
        # full width, 2 layers, fp32: the card against the CPU on the same weights
        cfg_s = dataclasses.replace(qwen, n_layers=2, dtype="float32")
        p_cpu = T.init_params(cfg_s, torch.Generator().manual_seed(0), "cpu")
        p_gpu = _tree_to(p_cpu, dev)
        B, S0, NEW = 2, 64, 4
        toks = torch.randint(0, qwen.vocab_size, (B, S0 + NEW), generator=torch.Generator().manual_seed(1))
        runs = {}
        kernels.reset_launch_counts()  # counts of this path's run only: the fp32 flash kernel's path
        for name, params_, d in (("cpu", p_cpu, torch.device("cpu")), ("gpu", p_gpu, dev)):
            t = toks.to(d)
            lg, st = T.prefill(params_, cfg_s, {"tokens": t[:, :S0]}, cache_len=S0 + NEW)
            out = [lg[:, 0]]
            for i in range(S0, S0 + NEW):
                lg, st = T.decode_step(params_, cfg_s, t[:, i:i + 1], st)
                out.append(lg[:, 0])
            runs[name] = torch.stack(out, 1).cpu()
        fwd = T.forward(p_gpu, cfg_s, {"tokens": toks.to(dev)})[0][:, S0 - 1:].cpu()
        cpu_path_launches = kernels.instance_counts()
        scale = float(runs["cpu"].abs().max())
        err_cpu = float((runs["gpu"] - runs["cpu"]).abs().max())
        err_fwd = float((runs["gpu"] - fwd).abs().max())
        same_tokens = torch.equal(runs["gpu"].argmax(-1), runs["cpu"].argmax(-1))
        emit({"check": "lm_gpu_vs_cpu", "arch": cfg_s.name, "layers": 2, "dtype": "float32", "B": B,
              "prompt": S0, "decode_steps": NEW, "max_abs_err_vs_cpu": err_cpu, "max_abs_err_vs_forward": err_fwd,
              "atol": 5e-5 * scale, "greedy_tokens_equal": same_tokens, "flash_launches": cpu_path_launches})
        require(cpu_path_launches == {"flash_attention_bf16": 0, "flash_attention_f32": 2 * cfg_s.n_layers},
                f"fp32 prefill + forward made flash launches {cpu_path_launches}")
        require(err_cpu <= 5e-5 * scale, f"LM logits on the card differ from the CPU: {err_cpu}")
        require(err_fwd <= 5e-5 * scale, f"prefill→decode differs from forward on the card: {err_fwd}")
        require(same_tokens, "greedy tokens differ between card and CPU")
        del p_cpu, p_gpu, runs, fwd, st, lg

    with Phase("lm_main"):
        cfg_l = qwen  # 28 layers, bf16 compute, fp32 parameters
        params = T.init_params(cfg_l, torch.Generator(device=dev).manual_seed(0), dev)
        n_params = sum(x.numel() for x in _leaves(params))
        B, S0, NEW, C = 4, 4096, 32, 4128
        prompt_main = torch.randint(0, cfg_l.vocab_size, (B, S0), device=dev,
                                    generator=torch.Generator(device=dev).manual_seed(1))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()  # counts of the main path's run only
        t0 = time.perf_counter()
        logits, state = T.prefill(params, cfg_l, {"tokens": prompt_main}, cache_len=C)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        flash_prefill = kernels.launch_counts()["flash_attention"]
        prefill_by_kernel = kernels.instance_counts()
        require(bool(torch.isfinite(logits).all()), "prefill logits not finite")
        tok, gen = greedy(logits), []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(NEW):
            gen.append(tok)
            logits, state = T.decode_step(params, cfg_l, tok, state)
            tok = greedy(logits)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        lm_launches = kernels.launch_counts()
        gen = torch.cat(gen, 1)
        emit({"arch": cfg_l.name, "layers": cfg_l.n_layers, "params": n_params, "B": B, "prompt": S0,
              "cache_len": C, "new_tokens": NEW, "prefill_s": prefill_s,
              "prefill_tokens_per_s": B * S0 / prefill_s, "decode_s": decode_s,
              "decode_tokens_per_s": B * NEW / decode_s, "peak_device_bytes": torch.cuda.max_memory_allocated(),
              "flash_launches_prefill": prefill_by_kernel,
              "flash_launches_decode": lm_launches["flash_attention"] - flash_prefill,
              "launches": lm_launches, "tokens_row0": gen[0, :8].tolist()})
        require(prefill_by_kernel == {"flash_attention_bf16": cfg_l.n_layers, "flash_attention_f32": 0},
                f"prefill's flash launches {prefill_by_kernel}, not {cfg_l.n_layers} of the wgmma kernel alone")
        require(lm_launches["flash_attention"] == flash_prefill, "decode launched the flash kernel")
        require(bool(torch.isfinite(logits).all()), "decode logits not finite")
        require(tuple(gen.shape) == (B, NEW), f"generated {tuple(gen.shape)}, not {(B, NEW)}")
        require(state["pos"] == S0 + NEW, "decode state position")
        del state, logits

    with Phase("lm_offload"):
        B, S0, NEW, npart = 4, 64, 32, 4
        prompt = torch.randint(0, qwen.vocab_size, (B, S0), device=dev,
                               generator=torch.Generator(device=dev).manual_seed(2))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res_tok = serve.generate(params, qwen, prompt, NEW)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        off_tok = serve.generate(params, qwen, prompt, NEW, serve.ServeConfig(kv_offload=True, kv_npart=npart),
                                 kv_schedule="prefetch")
        torch.cuda.synchronize()
        res_s, off_s = t1 - t0, time.perf_counter() - t1
        # the generated tokens stepped through both decode steps, as generate
        # steps them: every step's logits, the last one's included, and the
        # final caches bitwise equal
        C = S0 + NEW
        state = T.init_decode_state(qwen, B, C, dtype=L.dt(qwen), device=dev)
        ostate, kv = {"pos": 0}, serve.make_kv_blocks(qwen, B, C, npart, dtype=L.dt(qwen), device=dev)
        steps_equal = 0
        for t in range(C):
            lg, state = T.decode_step(params, qwen, res_tok[:, t:t + 1], state)
            olg, ostate, kv = serve.decode_step_offloaded(params, qwen, res_tok[:, t:t + 1], ostate, kv,
                                                          schedule="prefetch")
            steps_equal += int(torch.equal(olg, lg))
        kv_equal = all(torch.equal(torch.cat([blk[i] for blk in kv]).to(dev), state["layers"][name])
                       for i, name in enumerate(("k", "v")))
        pinned = all(hetmem.is_pinned_host(x) for blk in kv for x in blk)
        emit({"check": "offloaded_vs_resident", "B": B, "prompt": S0, "new_tokens": NEW, "kv_npart": npart,
              "layers_per_block": qwen.n_layers // npart, "schedule": "prefetch",
              "tokens_equal": torch.equal(off_tok, res_tok), "steps_with_bitwise_logits": steps_equal,
              "steps": C, "kv_bitwise": kv_equal, "kv_blocks_pinned_host": pinned,
              "resident_generate_s": res_s, "offloaded_generate_s": off_s})
        require(tuple(off_tok.shape) == (B, S0 + NEW), "generate returned the wrong shape")
        require(torch.equal(off_tok, res_tok), "offloaded generate's tokens differ from resident")
        require(steps_equal == C, f"offloaded logits differ from resident at {C - steps_equal} of {C} steps")
        require(kv_equal, "offloaded KV cache differs from resident")
        require(pinned, "KV blocks are not pinned host tensors")
        del state, ostate, kv, lg, olg

    def cuda_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / reps

    def nbytes(*xs):
        return sum(x.numel() * x.element_size() for x in xs if x is not None)

    def bound(nbytes_, flops, dt):
        t_bytes, t_ops = nbytes_ / HBM_BYTES_PER_S, flops / PEAK_FLOPS[str(dt)]
        return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"

    with Phase("timing"):
        ops = methods.FemOperators(mesh, cfg, device=dev)
        nm, ps, D, alpha, beta_e = res["carry"][:5]
        rows = []
        # multispring at one streamed block of the main path, from its final state
        chunk = ops.n_elem * 4 // cfg.npart
        blk = {k: x.to(dev) for k, x in zip(ms.STATE_KEYS, ps.blocks[0])}
        eps = spmv.strain_at_points(nm.u, ops.maps[cfg.rdtype])[:chunk].contiguous()
        prm = ops.block_params(cfg.npart)[0]
        args = (eps, blk, prm, ops.n_dirs, ops.w_dirs)
        out_k, out_p = ms_ops.multispring_cuda(*args), ms_ops.multispring_ref(*args)
        require(all(torch.equal(out_k[2][k], out_p[2][k]) for k in ms.FLAG_KEYS), "flags differ at full size")
        err = max(float((out_k[i] - out_p[i]).abs().max()) for i in (0, 1, 3))
        rel = max(rel_err(out_k[i], out_p[i]) for i in (0, 1))
        require(rel <= 1e-12, f"multispring disagrees at full size: {rel}")
        b_ms, by = bound(nbytes(eps, *blk.values(), prm.G0, prm.gamma_r, prm.beta, prm.bulk, ops.n_dirs,
                                ops.w_dirs, out_k[0], out_k[1], out_k[3], *out_k[2].values()),
                         chunk * cfg.nspring * MS_OPS_PER_SPRING, cfg.rdtype)
        rows.append({"name": "multispring", "route": "cuda", "source": "src/repro_torch/csrc/multispring.cu",
                     "replaces": "src/repro/kernels/multispring/multispring.py:118",
                     "launches": launches["multispring"], "max_abs_err": err,
                     "ms": cuda_ms(lambda: ms_ops.multispring_cuda(*args), 20),
                     "plain_ms": cuda_ms(lambda: ms_ops.multispring_ref(*args), 5),
                     "bound_ms": b_ms, "bound_by": by, "library_ms": None,
                     "detail": {"P": chunk, "S": cfg.nspring, "dtype": str(cfg.rdtype),
                                "max_rel_err": rel, "tol": 1e-12, "tile_p": ms_ops.TILE_P,
                                "launches_by_rung": {"proposed2": launches["multispring"],
                                                     **{m: c["multispring"] for m, c in crs_launches.items()}},
                                "steps_by_rung": {"proposed2": nt, **CRS_STEPS}}})
        del blk, out_k, out_p, args
        # EBE element product (gather fused in) at the full mesh, fp64 (outer)
        # and fp32 (inner), and one whole matvec with its parts
        matvec_parts = {}
        for dt, name in ((torch.float64, "ebe_matvec_f64"), (torch.float32, "ebe_matvec_f32")):
            maps = ops.maps[dt]
            x = nm.u.to(dt).contiguous()
            Dx = D.to(dt).contiguous()
            coef = (1.0 + (2.0 / cfg.dt) * beta_e).to(dt)
            a = (x, maps.conn32, Dx, maps.Jinv, maps.wdet, coef)

            def plain(x, conn, *rest):
                return ebe_ops.ebe_element_matvec_ref(spmv.gather_elem(x, conn), *rest)

            fk, fp = ebe_ops.ebe_matvec_cuda(*a), plain(x, maps.conn, *a[2:])
            f64 = plain(x.double(), maps.conn, *(t.double() for t in a[2:]))  # same inputs, in fp64
            vs_fp64 = {"kernel": rel_err(fk.double(), f64), "plain": rel_err(fp.double(), f64)}
            del f64
            # fp32 on the main path's data: u is dominated by a smooth, nearly
            # rigid motion whose strain cancels, so K·u is small beside its
            # terms and two fp32 summation orders differ by more than on the
            # random inputs above (5e-6); vs_fp64 shows both orders' error.
            rel, etol = rel_err(fk, fp), (1e-13 if dt == torch.float64 else 2e-5)
            require(rel <= etol, f"{name} disagrees at full size: {rel} (vs fp64: {vs_fp64})")
            # the bytes the fused kernel must move: x once, conn as int32, D,
            # J⁻¹, wdet, coef and f_e (a kernel fed the gathered u_e [E,10,3]
            # would count u_e in place of x and conn)
            b_e, by = bound(nbytes(*a, fk), ops.n_elem * EBE_OPS_PER_ELEM, dt)
            k_ms = cuda_ms(lambda: ebe_ops.ebe_matvec_cuda(*a), 50)
            rows.append({"name": name, "route": "cuda", "source": "src/repro_torch/csrc/ebe_matvec.cu",
                         "replaces": "src/repro/kernels/ebe_matvec/ebe_matvec.py:99",
                         "launches": launches[name], "max_abs_err": float((fk - fp).abs().max()),
                         "ms": k_ms, "plain_ms": cuda_ms(lambda: plain(x, maps.conn, *a[2:]), 5),
                         "bound_ms": b_e, "bound_by": by, "library_ms": None,
                         "detail": {"E": ops.n_elem, "N": ops.n_nodes, "dtype": str(dt), "max_rel_err": rel,
                                    "tol": etol, "max_rel_err_vs_fp64": vs_fp64, "tile_e": ebe_ops.TILE_E,
                                    "bound_bytes": nbytes(*a, fk), "bound_counts": "x, conn int32, D, Jinv, "
                                    "wdet, coef, f_e (gather fused)"}})
            # one whole spmv.ebe_matvec (CUDA events) and its parts; the
            # gather runs inside the kernel
            matvec_parts[str(dt)] = {
                "matvec_ms": cuda_ms(lambda: spmv.ebe_matvec(x, Dx, maps, coef), 20),
                "gather_ms": None, "kernel_ms": k_ms,
                "scatter_ms": cuda_ms(lambda: spmv.scatter_add(fk, maps.dof_slots), 20)}
            del a, fk, fp, Dx, x
        emit({"ebe_matvec_breakdown": matvec_parts})
        # breakdown of one full-size step (CUDA events)
        copy_only = cuda_ms(lambda: [h.copy_(h.to(dev, non_blocking=True), non_blocking=True)
                                     for blk_ in ps.blocks for h in blk_], 1)
        eps_all = spmv.strain_at_points(nm.u, ops.maps[cfg.rdtype])
        bp = ops.block_params(cfg.npart)
        stream_ms = cuda_ms(lambda: methods._streamed_multispring(ops, eps_all, ps, bp), 2)
        # the multispring kernel alone over the step's blocks, each block's
        # state resident on the card
        ms_blocks_ms = 0.0
        for j, blk_h in enumerate(ps.blocks):
            blk_j = {k: h.to(dev) for k, h in zip(ms.STATE_KEYS, blk_h)}
            a_j = (eps_all[j * chunk:(j + 1) * chunk], blk_j, bp[j], ops.n_dirs, ops.w_dirs)
            ms_blocks_ms += cuda_ms(lambda: ms_ops.multispring_cuda(*a_j), 5)
            del blk_j, a_j
        diag_ms = cuda_ms(lambda: ops.ebe_diag_inverse(D, beta_e, alpha), 3)
        step_s = sorted(r["seconds"] for r in steps)[len(steps) // 2]
        emit({"breakdown": {
            "step_median_ms": step_s * 1e3,
            "theta_copy_only_h2d_d2h_ms": copy_only,
            "theta_link_GB_per_s": 2 * theta_bytes / (copy_only / 1e3) / 1e9,
            "streamed_multispring_ms": stream_ms,
            "multispring_kernel_over_blocks_ms": ms_blocks_ms,
            "ebe_diag_inverse_ms": diag_ms,
            "solve_and_rest_ms": step_s * 1e3 - stream_ms - diag_ms,
            "outer_iters": [r["iters"] for r in steps]}})
        # the CRS rungs' UpdateCRS by part, and one BCSR product held against
        # the EBE operator, on main's final tangent (CUDA events)
        bcsr, maps64 = ops.bcsr, ops.maps[cfg.rdtype]
        coef = 1.0 + (2.0 / cfg.dt) * beta_e

        def stiffness():
            return assembly.element_stiffness(D, maps64.Jinv, maps64.wdet, chunk=methods.DIAG_CHUNK)

        K_e = stiffness()
        valA = assembly.add_diag(assembly.assemble_bcsr(K_e, bcsr.entry_slots, coef), bcsr.diag_slots,
                                 ops._diag_add(alpha))
        crs_parts = {
            "element_stiffness_ms": cuda_ms(stiffness, 2),
            "assemble_valA_ms": cuda_ms(lambda: assembly.assemble_bcsr(K_e, bcsr.entry_slots, coef), 3),
            "add_diag_ms": cuda_ms(lambda: assembly.add_diag(valA, bcsr.diag_slots, ops._diag_add(alpha)), 3),
            "assemble_valCk_ms": cuda_ms(lambda: assembly.assemble_bcsr(K_e, bcsr.entry_slots, beta_e), 3),
            "block_jacobi_inverse_ms": cuda_ms(lambda: assembly.block_jacobi_inverse(valA, bcsr.diag_slots), 3),
            "crs_update_ms": cuda_ms(lambda: ops.crs_update(D, beta_e, alpha), 2)}
        del K_e
        x = nm.u.contiguous()
        xj = x[bcsr.col_idx]
        prod = (valA * xj[:, None, :]).sum(-1)
        bcsr_parts = {"gather_ms": cuda_ms(lambda: x[bcsr.col_idx], 20),
                      "products_ms": cuda_ms(lambda: (valA * xj[:, None, :]).sum(-1), 20),
                      "products_as_einsum_ms": cuda_ms(lambda: torch.einsum("nab,nb->na", valA, xj), 5),
                      "row_sum_ms": cuda_ms(lambda: torch.segment_reduce(prod, "sum", lengths=bcsr.row_lengths), 20)}
        del xj, prod
        # a library's sparse product on the same matrix, as scalar CSR (cuSPARSE): a yardstick only
        i = torch.repeat_interleave(torch.arange(mesh.n_nodes, device=dev), bcsr.row_lengths)
        i = (3 * i[:, None, None] + torch.arange(3, device=dev)[None, :, None]).expand(-1, 3, 3).reshape(-1)
        j = (3 * bcsr.col_idx[:, None, None] + torch.arange(3, device=dev)[None, None, :]).expand(-1, 3, 3).reshape(-1)
        A_csr = torch.sparse_coo_tensor(torch.stack([i, j]), valA.reshape(-1), (mesh.ndof, mesh.ndof)).coalesce()
        A_csr = A_csr.to_sparse_csr()
        del i, j
        xv = x.reshape(-1, 1)
        lib_err = rel_err((A_csr @ xv).reshape(-1, 3), spmv.bcsr_matvec(valA, bcsr, x))
        bcsr_parts["library_csr_ms"] = cuda_ms(lambda: A_csr @ xv, 20)
        bcsr_parts["library_csr_max_rel_err"] = lib_err
        del A_csr, xv
        y = spmv.bcsr_matvec(valA, bcsr, x)
        y_ebe = ops.ebe_matvec_A(D, beta_e, alpha)(x.reshape(-1)).reshape(-1, 3)
        rel = rel_err(y, y_ebe)
        require(rel <= 1e-12, f"bcsr_matvec disagrees with the EBE operator at full size: {rel}")
        # bytes the product must move: values, col_idx and row_ptr as the mesh stores them (int32), x, y
        nnzb = bcsr.nnzb
        bcsr_bytes = nbytes(valA, x, y) + (nnzb + mesh.n_nodes + 1) * 4
        b_bcsr, by = bound(bcsr_bytes, nnzb * 18, cfg.rdtype)
        emit({"crs_update_breakdown": crs_parts,
              "bcsr_matvec": {"ms": cuda_ms(lambda: spmv.bcsr_matvec(valA, bcsr, x), 20), "bound_ms": b_bcsr,
                              "bound_by": by, "bound_bytes": bcsr_bytes, "nnzb": nnzb, "dtype": str(cfg.rdtype),
                              "max_rel_err_vs_ebe_operator": rel, "tol": 1e-12, "parts": bcsr_parts,
                              "ebe_operator_ms": cuda_ms(lambda: ops.ebe_matvec_A(D, beta_e, alpha)(x.reshape(-1)),
                                                         20)}})
        del valA, y, y_ebe, x
        # flash attention at lm_main's shape: B 4, Hq 16, Hkv 8, S 4,096, dh 128, causal,
        # laid out as the layer gives it: q and k contiguous (rope's output), v
        # a transposed view of the [B,S,Hkv,dh] projection
        g = torch.Generator(device=dev).manual_seed(3)
        Bf, Hq, Hkv, S, dh = 4, qwen.n_heads, qwen.n_kv_heads, 4096, qwen.hd
        q = torch.randn((Bf, Hq, S, dh), device=dev, generator=g)
        k = torch.randn((Bf, Hkv, S, dh), device=dev, generator=g)
        v_bshd = torch.randn((Bf, S, Hkv, dh), device=dev, generator=g)
        sdpa = torch.nn.functional.scaled_dot_product_attention  # yardstick only: the port never calls it
        pairs = S * (S + 1) // 2  # (q, k) pairs the causal mask keeps
        flops = 4 * Bf * Hq * pairs * dh
        # fp32 (the CUDA-core kernel) at the reference's 2e-5: at S 4,096 most
        # rows average thousands of keys, so |o| is ~0.03 and only fp32 holds
        # those rows sharply
        args = (q, k, v_bshd.transpose(1, 2))
        out32 = fa_ops.flash_attention_cuda(*args)
        err32 = float((out32 - fa_ops.flash_attention_ref(*args)).abs().max())
        require(err32 <= FLASH_TOL["torch.float32"], f"flash_attention fp32 disagrees at the main path's shape: {err32}")
        b32, by32 = bound(nbytes(*args, out32), flops, torch.float32)
        rows.append({"name": "flash_attention_f32", "route": "cuda", "source": "src/repro_torch/csrc/flash_attention.cu",
                     "replaces": "src/repro/kernels/flash_attention/flash_attention.py:83",
                     "launches": cpu_path_launches["flash_attention_f32"], "max_abs_err": err32,
                     "ms": cuda_ms(lambda: fa_ops.flash_attention_cuda(*args), 3),
                     "plain_ms": cuda_ms(lambda: fa_ops.flash_attention_ref(*args), 1),
                     "bound_ms": b32, "bound_by": by32,
                     "library_ms": cuda_ms(lambda: sdpa(*args, is_causal=True, enable_gqa=True), 3),
                     "detail": {"B": Bf, "Hq": Hq, "Hkv": Hkv, "S": S, "dh": dh, "dtype": "torch.float32",
                                "causal": True, "v_strided": True, "tol": FLASH_TOL["torch.float32"],
                                "launches_from": "lm_cpu (fp32 prefill + forward on the card)"}})
        q, k, v = q.bfloat16(), k.bfloat16(), v_bshd.bfloat16().transpose(1, 2)
        del args, v_bshd, out32
        out_k, out_p = fa_ops.flash_attention_cuda(q, k, v), fa_ops.flash_attention_ref(q, k, v)
        err = float((out_k.float() - out_p.float()).abs().max())
        # bf16 relative to each value: 2 ulps of |o| plus 2^-5 of its row's rms
        # (p rounds to bf16 at different running maxima in the two versions,
        # an error of ~0.3% of the row's rms with no floor at o ≈ 0)
        ref32 = out_p.float()
        ulp = torch.where(ref32 == 0, 0.0, torch.ldexp(torch.ones_like(ref32), torch.frexp(ref32)[1] - 8))
        lim = 2 * ulp + 2**-5 * ref32.pow(2).mean(-1, keepdim=True).sqrt()
        ratio = float(((out_k.float() - ref32).abs() / lim).max())
        require(ratio <= 1.0, f"flash_attention bf16 disagrees at the main path's shape: {ratio} of its limit")
        lib = sdpa(q, k, v, is_causal=True, enable_gqa=True).float()
        lib_err, lib_ratio = float((lib - ref32).abs().max()), float(((lib - ref32).abs() / lim).max())
        del ref32, ulp, lim, lib
        b_fa, by = bound(nbytes(q, k, v, out_k), flops, torch.bfloat16)
        fa_ms = cuda_ms(lambda: fa_ops.flash_attention_cuda(q, k, v), 20)
        rows.append({"name": "flash_attention_bf16", "route": "cuda",
                     "source": "src/repro_torch/csrc/flash_attention_wgmma.cu",
                     "replaces": "src/repro/kernels/flash_attention/flash_attention.py:83",
                     "launches": prefill_by_kernel["flash_attention_bf16"], "max_abs_err": err,
                     "ms": fa_ms, "plain_ms": cuda_ms(lambda: fa_ops.flash_attention_ref(q, k, v), 2),
                     "bound_ms": b_fa, "bound_by": by,
                     "library_ms": cuda_ms(lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True), 20),
                     "detail": {"B": Bf, "Hq": Hq, "Hkv": Hkv, "S": S, "dh": dh, "dtype": "torch.bfloat16",
                                "causal": True, "v_strided": True, "bf16_err_over_limit": ratio,
                                "bf16_limit": "2 ulp(|o|) + 2^-5 rms(o row)", "sdpa_max_abs_err": lib_err,
                                "sdpa_err_over_limit": lib_ratio, "tflop_per_s": flops / (fa_ms / 1e3) / 1e12}})
        del q, k, v, out_k, out_p
        # breakdown of one prefill at lm_main's shape (CUDA events)
        x = torch.randn((4, S, qwen.d_model), device=dev, generator=g).to(torch.bfloat16)
        lp = T.layer(params["layers"], 0)

        def layer_matmuls():
            a = lp["attn"]
            for w in (a["wq"], a["wk"], a["wv"]):
                L.proj(x, w.to(x.dtype))
            x @ a["wo"].to(x.dtype).reshape(-1, qwen.d_model)
            h = L.proj(x, lp["mlp"]["w1"].to(x.dtype))
            h @ lp["mlp"]["w2"].to(x.dtype)
            L.proj(x, lp["mlp"]["w3"].to(x.dtype))

        prefill_ms = cuda_ms(lambda: T.prefill(params, qwen, {"tokens": prompt_main}, cache_len=4128), 1)
        mm_ms = qwen.n_layers * cuda_ms(layer_matmuls, 3)
        emit({"prefill_breakdown": {
            "prefill_ms": prefill_ms, "flash_total_ms": qwen.n_layers * fa_ms,
            "matmuls_with_weight_casts_ms": mm_ms,
            "rest_ms": prefill_ms - qwen.n_layers * fa_ms - mm_ms}})
        # one decode step at lm_main's shape (cache 4,128, pos 4,096): host
        # enqueue time, synchronised step time, and the kernels' own time from
        # the profiler, whose sum over the step time is the device's busy share
        state = T.prefill(params, qwen, {"tokens": prompt_main}, cache_len=4128)[1]
        tok, n = prompt_main[:, -1:], 8

        def steps():
            for _ in range(n):
                T.decode_step(params, qwen, tok, state)  # rewrites slot 4,096 each time

        steps()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps()
        enqueue_ms = (time.perf_counter() - t0) / n * 1e3
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / n * 1e3
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            steps()
            torch.cuda.synchronize()
        events = prof.key_averages()
        kernel_ms = sum(getattr(e, "self_device_time_total", 0) for e in events) / n / 1e3
        emit({"decode_breakdown": {
            "step_ms": step_ms, "host_enqueue_ms": enqueue_ms, "device_kernel_ms": kernel_ms,
            "device_busy_share": kernel_ms / step_ms,
            "device_ops_per_step": sum(e.count for e in events if getattr(e, "self_device_time_total", 0)) / n,
            "top_device_ops_ms_per_step": {e.key: getattr(e, "self_device_time_total", 0) / n / 1e3 for e in sorted(
                events, key=lambda e: -getattr(e, "self_device_time_total", 0))[:6]}}})
        del state
        print(smi, flush=True)
        emit({"kernel_detail": {r["name"]: r["detail"] for r in rows}})
        emit({"kernels": [{k: v for k, v in r.items() if k != "detail"} for r in rows]})

    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
