#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA device and the CUDA toolkit (``nvcc``); exits non-zero with
no result without them, or without the rest of the repository beside it.
Phases, each followed by a JSON line with its seconds:

1. device   the card's name and power limit, as ``nvidia-smi`` reports them;
2. build    the CUDA kernels from ``src/repro_torch/csrc`` (register counts);
3. kernels  each kernel against its plain PyTorch version on the card, both
            dtypes, ragged shapes, flags exact, at the default and at a
            non-default tangent floor ``g_min_frac``;
4. cpu      the port on the card against the port on the CPU (small mesh);
5. prefetch ``schedule="prefetch"`` ≡ ``"serial"`` bitwise on the card;
6. main     Proposed 2 at full size through ``methods.run``: 294,912 TET10
            elements, 150 springs per point (θ = 7.08 GB in pinned host
            memory), ``npart=8``, prefetch, fp64, 8 steps;
7. timing   each kernel of the main path at the shapes that path gives it,
            against its plain version and its bound, and a breakdown of one
            full-size step.

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
PEAK_FLOPS = {"torch.float64": 34e12, "torch.float32": 67e12}
MS_OPS_PER_SPRING = 124  # counted from csrc/multispring.cu (pow as one op)
EBE_OPS_PER_ELEM = 2448  # 4 points × (2·90 g + 2·90 H + 2·36 Dε + 2·90 Bᵀσ)


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
    from repro_torch.core import hetmem
    from repro_torch.fem import meshgen, methods, multispring as ms, spmv
    from repro_torch.kernels import _build
    from repro_torch.kernels.ebe_matvec import ops as ebe_ops
    from repro_torch.kernels.multispring import ops as ms_ops

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
        _build.library()
        regs = re.findall(r"Compiling entry function '\w*?(ms_update_kernel|ebe_kernel)I([fd])E\w*'"
                          r".*?Used (\d+) registers", _build.ptxas_log(), re.S)
        emit({"registers": {f"{name}<{'double' if t == 'd' else 'float'}>": int(n) for name, t, n in regs}})

    def rel_err(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))

    with Phase("kernels"):
        K = ms.STATE_KEYS
        for dt, tol in ((torch.float64, 1e-12), (torch.float32, 3e-5)):
            for gmf in (1e-3, 0.3):
                rng = np.random.default_rng(7)
                P, S = 29, 150  # P not a multiple of the block's points
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
            E = 1001  # not a multiple of the block's elements
            u = torch.randn((E, 10, 3), dtype=dt, device=dev, generator=g)
            Q = torch.randn((E, 4, 6, 6), dtype=torch.float64, device=dev, generator=g)
            D = (Q @ Q.transpose(-1, -2)).to(dt).contiguous()
            Jinv = torch.randn((E, 3, 3), dtype=dt, device=dev, generator=g)
            wdet = torch.rand((E, 4), dtype=dt, device=dev, generator=g)
            coef = torch.rand((E,), dtype=dt, device=dev, generator=g) + 0.5
            for c in (coef, None):
                err = rel_err(ebe_ops.ebe_element_matvec_cuda(u, D, Jinv, wdet, c),
                              ebe_ops.ebe_element_matvec_ref(u, D, Jinv, wdet, c))
                emit({"check": "ebe_matvec", "dtype": str(dt), "E": E, "coef": c is not None,
                      "max_rel_err": err, "tol": etol})
                require(err <= etol, f"ebe_matvec disagrees: {err} > {etol}")

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
        require(all(n > 0 for n in launches.values()), f"a kernel of the path never launched: {launches}")
        require(pinned, "θ blocks are not pinned host tensors")
        require(peak < theta_bytes, f"peak device memory {peak} ≥ θ bytes {theta_bytes}")
        require(bool(torch.isfinite(v).all()) and bool(torch.isfinite(res["u"]).all()), "result not finite")
        require(float(res["v"].abs().max()) > 0, "the wave moved nothing")
        require(tuple(res["u"].shape) == (mesh.n_nodes, 3), "u has the wrong shape")

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
                                "max_rel_err": rel, "tol": 1e-12}})
        del blk, out_k, out_p, args
        # EBE element product at the full mesh, fp64 (outer) and fp32 (inner)
        for dt, name in ((torch.float64, "ebe_matvec_f64"), (torch.float32, "ebe_matvec_f32")):
            maps = ops.maps[dt]
            u_e = spmv.gather_elem(nm.u.to(dt), maps.conn)
            Dx = D.to(dt).contiguous()
            coef = (1.0 + (2.0 / cfg.dt) * beta_e).to(dt)
            a = (u_e, Dx, maps.Jinv, maps.wdet, coef)
            fk, fp = ebe_ops.ebe_element_matvec_cuda(*a), ebe_ops.ebe_element_matvec_ref(*a)
            f64 = ebe_ops.ebe_element_matvec_ref(*(x.double() for x in a))  # same inputs, in fp64
            vs_fp64 = {"kernel": rel_err(fk.double(), f64), "plain": rel_err(fp.double(), f64)}
            del f64
            # fp32 on the main path's data: u is dominated by a smooth, nearly
            # rigid motion whose strain cancels, so K·u is small beside its
            # terms and two fp32 summation orders differ by more than on the
            # random inputs above (5e-6); vs_fp64 shows both orders' error.
            rel, etol = rel_err(fk, fp), (1e-13 if dt == torch.float64 else 2e-5)
            require(rel <= etol, f"{name} disagrees at full size: {rel} (vs fp64: {vs_fp64})")
            b_e, by = bound(nbytes(*a, fk), ops.n_elem * EBE_OPS_PER_ELEM, dt)
            rows.append({"name": name, "route": "cuda", "source": "src/repro_torch/csrc/ebe_matvec.cu",
                         "replaces": "src/repro/kernels/ebe_matvec/ebe_matvec.py:99",
                         "launches": launches[name], "max_abs_err": float((fk - fp).abs().max()),
                         "ms": cuda_ms(lambda: ebe_ops.ebe_element_matvec_cuda(*a), 50),
                         "plain_ms": cuda_ms(lambda: ebe_ops.ebe_element_matvec_ref(*a), 5),
                         "bound_ms": b_e, "bound_by": by, "library_ms": None,
                         "detail": {"E": ops.n_elem, "dtype": str(dt), "max_rel_err": rel, "tol": etol,
                                    "max_rel_err_vs_fp64": vs_fp64}})
            del a, fk, fp, Dx, u_e
        # breakdown of one full-size step (CUDA events)
        copy_only = cuda_ms(lambda: [h.copy_(h.to(dev, non_blocking=True), non_blocking=True)
                                     for blk_ in ps.blocks for h in blk_], 1)
        eps_all = spmv.strain_at_points(nm.u, ops.maps[cfg.rdtype])
        bp = ops.block_params(cfg.npart)
        stream_ms = cuda_ms(lambda: methods._streamed_multispring(ops, eps_all, ps, bp), 2)
        diag_ms = cuda_ms(lambda: ops.ebe_diag_inverse(D, beta_e, alpha), 3)
        step_s = sorted(r["seconds"] for r in steps)[len(steps) // 2]
        emit({"breakdown": {
            "step_median_ms": step_s * 1e3,
            "theta_copy_only_h2d_d2h_ms": copy_only,
            "theta_link_GB_per_s": 2 * theta_bytes / (copy_only / 1e3) / 1e9,
            "streamed_multispring_ms": stream_ms,
            "ebe_diag_inverse_ms": diag_ms,
            "solve_and_rest_ms": step_s * 1e3 - stream_ms - diag_ms,
            "outer_iters": [r["iters"] for r in steps]}})
        print(smi, flush=True)
        emit({"kernel_detail": {r["name"]: r["detail"] for r in rows}})
        emit({"kernels": [{k: v for k, v in r.items() if k != "detail"} for r in rows]})

    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
