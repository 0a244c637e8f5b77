#!/usr/bin/env python3
"""Time the port's flash attention kernel of one source tree on one CUDA card.

    python3 tools/flash_ab.py TREE [--mma-peak] [--flex]
    python3 tools/flash_ab.py TREE --dtype bf16 [--build-only] [--d64] [--layout64 "KEYS, STAGES, ..."]
    python3 tools/flash_ab.py --tanh-error

``TREE`` is the root of a checkout (``.`` for this one, or another commit
unpacked with ``git archive <commit> | tar -x -C build/other``); its
``src/repro_torch`` is imported and its kernels are built into its own
``build/``.  Comparing two trees: run them one after the other on one card, in
turns (other, this, this, other), one process each.  Inputs come from fixed
seeds; q and k are contiguous and v a transposed view, as the attention layer
gives them.  Prints one JSON line.

fp32 (the default): the 3×TF32 kernel's ms (CUDA events, 5 launches after a
warm-up) and its largest difference from the plain version at three causal
prefill shapes, S 4,096: qwen3-1.7b's heads (B 4, Hq 16, Hkv 8, dh 128),
gemma2-2b's (B 2, Hq 8, Hkv 4, dh 256, window 4,096, softcap 50) and
deepseek-v2's MLA heads (B 1, Hq = Hkv 16, dh 192, dv 128); each instance's
registers and spill bytes.  With ``--flex``, each softcapped shape (gemma2-2b)
also times the one PyTorch call that computes its function in fp32,
``flex_attention`` compiled with the softcap as its score_mod and the causal
window as its block mask (``chip_smoke.flex_softcap``; full fp32 products,
TF32 off), with its seconds to compile and its largest difference from the
plain version.  With ``--mma-peak`` it also measures the rate of
``mma.sync.m16n8k8`` with TF32 operands and fp32 accumulators on this card: a
loop of independent products in registers, at 4, 8 and 16 warps an SM and 4,
8 and 16 products in flight a warp.

``--dtype bf16``: the wgmma kernel (only its source is built) at the prefill
shapes of the paths that run it: qwen3-1.7b (B 4 × 4,096, dh 128),
mixtral-8x22b (B 2 × 6,144, Hq 48 over Hkv 8, window 4,096), gemma2-2b's
local and global layers (B 2 × 8,192, Hq 8 over Hkv 4, dh 256, softcap 50,
window 4,096 on the local one) and deepseek-v2's MLA (B 1 × 2,048, Hq = Hkv
128, dh 192, dv 128, scale 192^-½) and zamba2-7b's shared attention (B 2 ×
4,096, Hq = Hkv 32, dh 112 inside the (128, 128) instance), all causal;
and the (64, 64) instance's
rows: internvl2-1b (B 4 × 4,096, Hq 14 over Hkv 2, causal), whisper-small's
encoder (B 8 × 12 heads, 1,500 × 1,500), cross attention (128 × 1,500), both
non-causal, and decoder (128 × 128, causal): per shape the ms (10 launches
after a warm-up, timed as ``chip_smoke.py`` times its rows: CUDA events
behind a sleep kernel that lets the host enqueue the calls ahead), SDPA's
ms where it computes the function (no softcap), the softcapped shapes' ms
without the softcap, and the largest error over its
limit against the plain version (2 ulp(|o|) + 2^-5 of the row's rms, as
``chip_smoke.py`` holds it); per instance the registers, spill bytes, why
ptxas serialised its wgmma, if it did, its blocks an SM (where the tree's
binding reports them), and from ``cuobjdump -sass`` its instructions,
``HGMMA`` (wgmma), ``WARPGROUP`` (arrive and wait: two a group when
pipelined, two a wgmma when serialised), ``LDL``/``STL`` (spills) and
``MUFU``.  ``--build-only`` builds and reports the instances without timing;
``--d64`` times the (64, 64) rows alone.  ``--layout64 "ARGS"`` measures
a variant of the tree's (64, 64) instance: the tree's ``src`` copied into
``build/flash_ab/`` with ``ARGS`` in place of the arguments of
``Inst<64, 64>``'s ``Layout<...>`` in the kernel source (keys a tile,
stages, producer and consumer registers, slim loop, head-major).

``--tanh-error``: the relative error of ``tanh.approx.f32`` (the bf16
kernel's softcap) on this card against tanh in double, over every fp32 x in
[2^-20, 20], by band of x: the largest, its log2 and the mean, and the share
of results that are exactly 1; whether it is odd (tanh(−x) = −tanh(x)).
"""
import ctypes
import json
import os
import re
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import _sass_ops, bf16_limit, cuda_ms, flex_softcap, wgmma_serialized  # noqa: E402  (this checkout's)

BF16_SHAPES = {  # B, Hq, Hkv, Sq, Skv, dh, dv, causal, window, softcap, scale
    "qwen3-1.7b": (4, 16, 8, 4096, 4096, 128, 128, True, None, None, None),
    "mixtral-8x22b": (2, 48, 8, 6144, 6144, 128, 128, True, 4096, None, None),
    "gemma2-2b local": (2, 8, 4, 8192, 8192, 256, 256, True, 4096, 50.0, None),
    "gemma2-2b global": (2, 8, 4, 8192, 8192, 256, 256, True, None, 50.0, None),
    "deepseek-v2 MLA": (1, 128, 128, 2048, 2048, 192, 128, True, None, None, 192**-0.5),
    "zamba2-7b": (2, 32, 32, 4096, 4096, 112, 112, True, None, None, None),
    "internvl2-1b": (4, 14, 2, 4096, 4096, 64, 64, True, None, None, None),
    "whisper-small encoder": (8, 12, 12, 1500, 1500, 64, 64, False, None, None, None),
    "whisper-small cross": (8, 12, 12, 128, 1500, 64, 64, False, None, None, None),
    "whisper-small decoder": (8, 12, 12, 128, 128, 64, 64, True, None, None, None),
}
SHAPES = {  # fp32: B, Hq, Hkv, dh, dv, window, softcap
    "qwen3-1.7b": (4, 16, 8, 128, 128, None, None),
    "gemma2-2b": (2, 8, 4, 256, 256, 4096, 50.0),
    "deepseek-v2 MLA": (1, 16, 16, 192, 128, None, None),
}
S = 4096

MMA_PEAK_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
template <int N>
__global__ void mma_loop(float* out, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = 0x3f800000u + ((threadIdx.x + i) << 13);
  b[0] = a[1], b[1] = a[2];
  float c[N][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < N; ++k)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
                   "{%8,%9}, {%0,%1,%2,%3};\n"
                   : "+f"(c[k][0]), "+f"(c[k][1]), "+f"(c[k][2]), "+f"(c[k][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float s = 0.f;
  for (int k = 0; k < N; ++k) s += c[k][0] + c[k][1] + c[k][2] + c[k][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_peak(float* out, int blocks, int iters, int n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n == 4) mma_loop<4><<<blocks, 128, 0, st>>>(out, iters);
  if (n == 8) mma_loop<8><<<blocks, 128, 0, st>>>(out, iters);
  if (n == 16) mma_loop<16><<<blocks, 128, 0, st>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}
"""


TANH_SRC = r"""
#include <cuda_runtime.h>
__global__ void tanh_approx(const float* x, float* y, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) asm("tanh.approx.f32 %0, %1;\n" : "=f"(y[i]) : "f"(x[i]));
}
extern "C" int run_tanh(const float* x, float* y, int n, void* stream) {
  tanh_approx<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(x, y, n);
  return static_cast<int>(cudaGetLastError());
}
"""


def mma_peak(tree, nvcc, arch):
    """TFLOP/s of TF32 mma.sync by warps an SM and products in flight a warp."""
    out_dir = os.path.join(tree, "build", "flash_ab")
    os.makedirs(out_dir, exist_ok=True)
    src, lib_path = os.path.join(out_dir, "mma_peak.cu"), os.path.join(out_dir, "libmma_peak.so")
    with open(src, "w") as f:
        f.write(MMA_PEAK_SRC)
    subprocess.run([nvcc, *arch, "-O3", "-Xcompiler", "-fPIC", "-shared", "-o", lib_path, src], check=True)
    lib = ctypes.CDLL(lib_path)
    lib.mma_peak.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    iters, rates = 4096, {}
    for n in (4, 8, 16):
        for warps in (4, 8, 16):
            blocks = sms * warps // 4
            out = torch.empty(blocks * 128, device="cuda")
            stream = torch.cuda.current_stream().cuda_stream

            def run():
                err = lib.mma_peak(out.data_ptr(), blocks, iters, n, stream)
                if err:
                    raise RuntimeError(f"mma_peak: CUDA error {err}")

            ms = cuda_ms(run, 3)
            rates[f"{warps} warps/SM, {n} in flight"] = blocks * 4 * iters * n * 2048 / (ms / 1e3) / 1e12
    return rates


def tanh_error(nvcc, arch):
    """tanh.approx.f32 against tanh in double, by band of x."""
    import numpy as np

    out_dir = os.path.join(ROOT, "build", "flash_ab")
    os.makedirs(out_dir, exist_ok=True)
    src, lib_path = os.path.join(out_dir, "tanh_approx.cu"), os.path.join(out_dir, "libtanh_approx.so")
    with open(src, "w") as f:
        f.write(TANH_SRC)
    subprocess.run([nvcc, *arch, "-O3", "-Xcompiler", "-fPIC", "-shared", "-o", lib_path, src], check=True)
    lib = ctypes.CDLL(lib_path)
    lib.run_tanh.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]

    def run(xs):
        x = torch.tensor(xs, device="cuda")
        y = torch.empty_like(x)
        if lib.run_tanh(x.data_ptr(), y.data_ptr(), x.numel(), torch.cuda.current_stream().cuda_stream):
            raise RuntimeError("tanh_approx: launch failed")
        return y.cpu().numpy()

    bits = np.arange(np.float32(2**-20).view(np.int32), np.float32(20.0).view(np.int32) + 1, dtype=np.int32)
    xs = bits.view(np.float32)
    ya = run(xs).astype(np.float64)
    yt = np.tanh(xs.astype(np.float64))
    rel = np.abs(ya - yt) / yt
    out = {}
    for lo, hi in ((0, 0.5), (0.5, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 9.01), (9.01, 20.0001)):
        m = (xs >= lo) & (xs < hi)
        out[f"[{lo}, {hi})"] = {"max_rel": float(rel[m].max()), "log2_max_rel": float(np.log2(rel[m].max())),
                                "mean_rel": float(rel[m].mean()), "share_exactly_one": float((ya[m] == 1.0).mean())}
    out["all"] = {"max_rel": float(rel.max()), "log2_max_rel": float(np.log2(rel.max())),
                  "at_x": float(xs[rel.argmax()])}
    out["odd"] = bool(np.array_equal(run(-xs[::97]), -ya[::97].astype(np.float32)))
    return out


def wgmma_report(log):
    """Registers, spill bytes and wgmma serialisation of each bf16 instance,
    from ``-Xptxas -v``: one template argument (D) in older trees, two (DK, DV) in newer."""
    out = {}
    serialized = wgmma_serialized(log)
    for chunk in log.split("Compiling entry function '")[1:]:
        mangled = chunk.split("'", 1)[0]
        fa = re.search(r"flash_wgmma_kernelILi(\d+)E(?:Li(\d+)E)?", mangled)
        regs = re.search(r"Used (\d+) registers", chunk)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", chunk)
        if fa and regs:
            dims = ", ".join(g for g in fa.groups() if g)
            out[f"flash_wgmma_kernel<bf16, {dims}>"] = {
                "registers": int(regs.group(1)), "spill_store_bytes": int(spill.group(1)) if spill else None,
                "spill_load_bytes": int(spill.group(2)) if spill else None, "wgmma_serialized": serialized.get(mangled)}
    return out


def variant(tree, layout64):
    """A copy of ``tree``'s ``src`` under ``build/flash_ab/`` with the (64, 64)
    instance's ``Layout`` arguments rewritten to ``layout64``; returns the
    copy's root."""
    import hashlib
    import shutil

    tag = hashlib.sha256(f"{os.path.abspath(tree)} {layout64}".encode()).hexdigest()[:10]
    root = os.path.join(ROOT, "build", "flash_ab", f"variant_{tag}")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(tree, "src"), os.path.join(root, "src"), ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(root, "src", "repro_torch", "csrc", "flash_attention_wgmma.cu")
    with open(path) as f:
        text, n = re.subn(r"(struct Inst<64, 64> : Layout<)[^>]*(>)", rf"\g<1>{layout64}\g<2>", f.read())
    if n != 1:
        sys.exit(f"flash_ab: {path} has no single Inst<64, 64> to rewrite")
    with open(path, "w") as f:
        f.write(text)
    return root


def bf16_main(tree, out, build_only, only_d64=False):
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa_ops

    # only the wgmma kernel's source: the other kernels are not timed here
    _build.SOURCES = ("flash_attention_wgmma.cu",)
    _build._ENTRY_POINTS = {name: sig for name, sig in _build._ENTRY_POINTS.items()
                            if name.startswith("flash_attention_wgmma")}
    _build.library()
    out["instances"] = wgmma_report(_build.ptxas_log())
    if hasattr(fa_ops, "wgmma_blocks_per_sm"):
        for (dk, dv), n in fa_ops.wgmma_blocks_per_sm().items():
            out["instances"].setdefault(f"flash_wgmma_kernel<bf16, {dk}, {dv}>", {})["blocks_per_sm"] = n
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(_build.build())], capture_output=True, text=True, check=True).stdout
    for chunk in re.split(r"\n\s+Function : ", sass)[1:]:
        fa = re.search(r"flash_wgmma_kernelILi(\d+)E(?:Li(\d+)E)?", chunk.split("\n", 1)[0])
        if fa:
            ops = _sass_ops(chunk)
            name = f"flash_wgmma_kernel<bf16, {', '.join(g for g in fa.groups() if g)}>"
            out["instances"].setdefault(name, {})["sass"] = {
                "instructions": len(ops), **{op: ops.count(op) for op in ("HGMMA", "WARPGROUP", "LDL", "STL", "MUFU")}}
    if build_only:
        return
    dev = torch.device("cuda")
    sdpa = torch.nn.functional.scaled_dot_product_attention  # the yardstick, never the port
    for name, (B, Hq, Hkv, Sq, Skv, dh, dv, causal, window, cap, scale) in BF16_SHAPES.items():
        if only_d64 and dh != 64:
            continue
        g = torch.Generator(device=dev).manual_seed(5)
        q = torch.randn((B, Hq, Sq, dh), device=dev, generator=g).to(torch.bfloat16)
        k = torch.randn((B, Hkv, Skv, dh), device=dev, generator=g).to(torch.bfloat16)
        v = torch.randn((B, Skv, Hkv, dv), device=dev, generator=g).to(torch.bfloat16).transpose(1, 2)
        kw = dict(causal=causal, window=window, softcap=cap, scale=scale)
        ref = fa_ops.flash_attention_ref(q, k, v, **kw).float()
        ratio = float(((fa_ops.flash_attention_cuda(q, k, v, **kw).float() - ref).abs() / bf16_limit(ref)).max())
        del ref
        row = {"ms": cuda_ms(lambda: fa_ops.flash_attention_cuda(q, k, v, **kw), 10), "err_over_limit": ratio}
        if cap is None:
            if window is None:
                lib = lambda: sdpa(q, k, v, is_causal=causal, scale=scale, enable_gqa=Hq != Hkv)  # noqa: E731
            else:
                i, j = torch.arange(Skv - Sq, Skv, device=dev)[:, None], torch.arange(Skv, device=dev)[None, :]
                mask = (j <= i) & (i - j < window)
                lib = lambda: sdpa(q, k, v, attn_mask=mask, scale=scale, enable_gqa=Hq != Hkv)  # noqa: E731
            row["sdpa_ms"] = cuda_ms(lib, 10)
        if cap is not None:
            row["ms_without_softcap"] = cuda_ms(lambda: fa_ops.flash_attention_cuda(q, k, v, **dict(kw, softcap=None)),
                                                10)
        out[name] = row
        del q, k, v


def main(tree: str, peak: bool, dtype: str, build_only: bool, flex: bool = False, only_d64: bool = False,
         layout64: str | None = None) -> None:
    out = {"tree": tree, "device": torch.cuda.get_device_name(0), "dtype": dtype}
    if layout64 is not None:
        out["layout64"] = layout64
        tree = variant(tree, layout64)
    sys.path.insert(0, os.path.join(tree, "src"))
    if dtype == "bf16":
        bf16_main(tree, out, build_only, only_d64)
        print(json.dumps(out), flush=True)
        return
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa_ops

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version and flex_attention in full fp32
    _build.library()
    for name, (B, Hq, Hkv, dh, dv, window, cap) in SHAPES.items():
        g = torch.Generator(device=dev).manual_seed(3)
        q = torch.randn((B, Hq, S, dh), device=dev, generator=g)
        k = torch.randn((B, Hkv, S, dh), device=dev, generator=g)
        v = torch.randn((B, S, Hkv, dv), device=dev, generator=g).transpose(1, 2)
        kw = dict(causal=True, window=window, softcap=cap)
        ref = fa_ops.flash_attention_ref(q, k, v, **kw)
        err = float((fa_ops.flash_attention_cuda(q, k, v, **kw) - ref).abs().max())
        out[name] = {"ms": cuda_ms(lambda: fa_ops.flash_attention_cuda(q, k, v, **kw), 5), "max_abs_err": err}
        if flex and cap is not None:
            t0 = time.perf_counter()
            lib = flex_softcap(dev, S, window, cap, None)
            got = lib(q, k, v)
            torch.cuda.synchronize()
            out[name]["flex_attention"] = {"ms": cuda_ms(lambda: lib(q, k, v), 5),
                                           "max_abs_err": float((got - ref).abs().max()),
                                           "compile_and_first_call_s": time.perf_counter() - t0}
            del got, lib
        del ref
        del q, k, v
    for chunk in _build.ptxas_log().split("Compiling entry function '")[1:]:
        fa = re.search(r"flash_kernelILi(\d+)E", chunk.split("'", 1)[0])
        regs = re.search(r"Used (\d+) registers", chunk)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", chunk)
        if fa and regs:
            out[f"flash_kernel<float, {fa.group(1)}>"] = {"registers": int(regs.group(1)),
                                                         "spill_store_bytes": int(spill.group(1)) if spill else None}
    if peak:
        out["mma_sync_tf32_tflop_per_s"] = mma_peak(tree, _build._nvcc(), _build.ARCH)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    args = sys.argv[1:]
    if "--tanh-error" in args:
        sys.path.insert(0, os.path.join(ROOT, "src"))
        from repro_torch.kernels import _build

        print(json.dumps({"device": torch.cuda.get_device_name(0),
                          "tanh_approx_f32": tanh_error(_build._nvcc(), _build.ARCH)}), flush=True)
        sys.exit(0)
    dtype = args[args.index("--dtype") + 1] if "--dtype" in args else "fp32"
    if dtype not in ("fp32", "bf16"):
        sys.exit(f"flash_ab: --dtype {dtype}: fp32 or bf16")
    layout64 = args[args.index("--layout64") + 1] if "--layout64" in args else None
    tree = next(a for i, a in enumerate(args) if not a.startswith("--")
                and (i == 0 or args[i - 1] not in ("--dtype", "--layout64")))
    main(tree, "--mma-peak" in args, dtype, "--build-only" in args, "--flex" in args, "--d64" in args, layout64)
