"""Build and load the port's CUDA kernels (``repro_torch/csrc/*.cu``).

Every source is compiled by its own ``nvcc`` for ``sm_90a``, all started at
once, and the objects are linked into one shared library with a plain C
interface that :mod:`ctypes` loads.  The build happens at first use, into
``build/repro_torch/<hash of sources and flags>/`` at the root of the
checkout (listed in ``.gitignore``), so a fresh checkout builds its own and
a changed source never loads a stale library.  Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("multispring.cu", "ebe_matvec.cu", "flash_attention.cu", "flash_attention_wgmma.cu")
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
LIBNAME = "librepro_torch_kernels.so"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
CFLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(ARCH + CFLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile (if needed) and return the path of the shared library."""
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / LIBNAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for name in SOURCES:
            obj = Path(tmp) / (name + ".o")
            cmd = [nvcc, *ARCH, *CFLAGS, "-c", str(CSRC / name), "-o", str(obj)]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, errors = [], []
        for name, _, p in procs:
            text, _ = p.communicate()
            logs.append(f"== {name}\n{text}")
            if p.returncode:
                errors.append(f"nvcc failed on {name} (rc={p.returncode}):\n{text}")
        (out_dir / "ptxas.log").write_text("\n".join(logs))
        if errors:
            raise RuntimeError("\n".join(errors))
        tmp_lib = Path(tmp) / LIBNAME
        link = [nvcc, *ARCH, "-shared", "-o", str(tmp_lib), *(str(o) for _, o, _ in procs)]
        res = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if res.returncode:
            raise RuntimeError(f"nvcc link failed (rc={res.returncode}):\n{res.stdout}")
        os.replace(tmp_lib, lib)
    return lib


def ptxas_log() -> str:
    """ptxas' register / spill report of the last build (``-Xptxas -v``)."""
    path = BUILD_ROOT / _digest() / "ptxas.log"
    return path.read_text() if path.exists() else ""


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_D = ctypes.c_double

_FLASH_ARGS = [_P] * 4 + [_I] * 7 + [_L] * 9 + [_D, _I, _I, _D, _P]
_WGMMA_ARGS = [_P] * 4 + [_I] * 9 + [_L] * 9 + [_D, _I, _I, _D, _P]  # and the instance's (DK, DV) after dh, dv

# C entry points ``<base>_<suffix>``, one per dtype suffix, with their
# signatures: every pointer and the stream are c_void_p, sizes are c_int,
# strides c_longlong.
_ENTRY_POINTS = {
    # eps, grev, trev, gprev, gmax, dir, virg, G0, gr, beta, bulk, n, w,
    # g_min_frac, P, S, k (members), tile_p, sig, D, frac, ngrev, ntrev, ngprev, ngmax, ndir, nvirg, stream
    "ms_update": (("f32", "f64"), [_P] * 13 + [_D, _I, _I, _I, _I] + [_P] * 9 + [_P]),
    # x, conn (int32), D, Jinv, wdet, coef (nullable), gradn, E, N, k (members), tile_e, out, stream
    "ebe_matvec": (("f32", "f64"), [_P] * 7 + [_I, _I, _I, _I, _P, _P]),
    # q, k, v, out, B, Hq, Hkv, Sq, Skv, dh, dv, q/k/v strides (batch, head, row),
    # scale, causal, window (0: none), softcap (0: none), stream
    "flash_attention": (("f32",), _FLASH_ARGS),  # tensor cores, 3×TF32 mma.sync
    "flash_attention_wgmma": (("bf16",), _WGMMA_ARGS),  # tensor cores, TMA
    # the bf16 kernel's instance (DK, DV): its blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
    "flash_attention_wgmma_blocks_per_sm": (("bf16",), [_I, _I]),
}


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library, with argtypes set on every entry point."""
    lib = ctypes.CDLL(str(build()))
    for base, (suffixes, argtypes) in _ENTRY_POINTS.items():
        for suffix in suffixes:
            fn = getattr(lib, f"{base}_{suffix}")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (``cudaGetLastError``)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
