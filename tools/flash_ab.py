#!/usr/bin/env python3
"""Time the port's fp32 flash attention kernel of one source tree on one CUDA card.

    python3 tools/flash_ab.py TREE [--mma-peak]

``TREE`` is the root of a checkout (``.`` for this one, or another commit
unpacked with ``git archive <commit> | tar -x -C build/other``); its
``src/repro_torch`` is imported and its kernels are built into its own
``build/``.  Comparing two trees: run them one after the other on one card, in
turns (other, this, this, other), one process each.  Prints one JSON line:
the fp32 kernel's ms (CUDA events, 5 launches after a warm-up) and its
largest difference from the plain version at three causal prefill shapes,
S 4,096, v a transposed view as the attention layer gives it: qwen3-1.7b's
heads (B 4, Hq 16, Hkv 8, dh 128), gemma2-2b's (B 2, Hq 8, Hkv 4, dh 256,
window 4,096, softcap 50) and deepseek-v2's MLA heads (B 1, Hq = Hkv 16,
dh 192, dv 128); each instance's registers and spill bytes.  With
``--mma-peak`` it also measures the rate of ``mma.sync.m16n8k8`` with TF32
operands and fp32 accumulators on this card: a loop of independent products
in registers, at 4, 8 and 16 warps an SM and 4, 8 and 16 products in flight
a warp.  Inputs come from fixed seeds.
"""
import ctypes
import json
import os
import re
import subprocess
import sys

import torch

SHAPES = {  # B, Hq, Hkv, dh, dv, window, softcap
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


def cuda_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


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


def main(tree: str, peak: bool) -> None:
    sys.path.insert(0, os.path.join(tree, "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa_ops

    dev = torch.device("cuda")
    _build.library()
    out = {"tree": tree, "device": torch.cuda.get_device_name(0)}
    for name, (B, Hq, Hkv, dh, dv, window, cap) in SHAPES.items():
        g = torch.Generator(device=dev).manual_seed(3)
        q = torch.randn((B, Hq, S, dh), device=dev, generator=g)
        k = torch.randn((B, Hkv, S, dh), device=dev, generator=g)
        v = torch.randn((B, S, Hkv, dv), device=dev, generator=g).transpose(1, 2)
        kw = dict(causal=True, window=window, softcap=cap)
        err = float((fa_ops.flash_attention_cuda(q, k, v, **kw) - fa_ops.flash_attention_ref(q, k, v, **kw)).abs().max())
        out[name] = {"ms": cuda_ms(lambda: fa_ops.flash_attention_cuda(q, k, v, **kw), 5), "max_abs_err": err}
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
    main(next(a for a in args if not a.startswith("--")), "--mma-peak" in args)
