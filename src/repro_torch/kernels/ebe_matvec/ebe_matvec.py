"""Binding of ``csrc/ebe_matvec.cu`` (ctypes, plain C interface).

Launches on the current CUDA stream; the output is allocated here with
``torch.empty``; every argument is checked before its pointer is passed.
The fp64 (outer flexible CG, rhs ``C·v``) and fp32 (inner PCG) launches are
counted separately.
"""
from __future__ import annotations

import torch

from repro_torch.fem import quadrature as quad
from repro_torch.fem.assembly import gradn_ref
from repro_torch.kernels import LaunchCounter, check_arg

TILE_E = 16  # elements per tile of the persistent grid (4 threads each)
TILE_E_RANGE = (4, 64)  # and a multiple of 4: every tile's bulk copies stay 16-byte aligned
counter_f64 = LaunchCounter("ebe_matvec_f64")
counter_f32 = LaunchCounter("ebe_matvec_f32")


def check_tile_e(tile_e: int) -> None:
    lo, hi = TILE_E_RANGE
    if not (lo <= tile_e <= hi and tile_e % 4 == 0):
        raise ValueError(f"ebe_matvec: tile_e={tile_e} must be a multiple of 4 in [{lo}, {hi}]")


def _check(name, x, shape, dtype, device):
    check_arg("ebe_matvec", name, x, shape, dtype, device)


def ebe_matvec_cuda(x: torch.Tensor, conn: torch.Tensor, D: torch.Tensor, Jinv: torch.Tensor,
                    wdet: torch.Tensor, coef: torch.Tensor | None = None, *,
                    tile_e: int = TILE_E) -> torch.Tensor:
    """``f_e [E,10,3]`` = Σ_p wdet_p·coef_e·B_pᵀ D_p B_p x[conn_e] from the CUDA kernel
    (the gather fused in; ``conn`` int32)."""
    dt, dev = x.dtype, x.device
    if dt not in (torch.float32, torch.float64):
        raise ValueError(f"ebe_matvec: dtype {dt} not supported (float32, float64)")
    E = conn.shape[0]
    P = quad.NPOINT
    _check("x", x, (x.shape[0], 3), dt, dev)
    _check("conn", conn, (E, quad.NNODE), torch.int32, dev)
    _check("D", D, (E, P, 6, 6), dt, dev)
    _check("Jinv", Jinv, (E, 3, 3), dt, dev)
    _check("wdet", wdet, (E, P), dt, dev)
    if coef is not None:
        _check("coef", coef, (E,), dt, dev)
    for name, t in (("conn", conn), ("D", D), ("Jinv", Jinv), ("wdet", wdet), ("coef", coef)):
        if t is not None and t.data_ptr() % 16:  # the kernel's bulk copies start on 16-byte boundaries
            raise ValueError(f"ebe_matvec: {name} must start on a 16-byte boundary (a view into a tensor?)")
    check_tile_e(tile_e)
    if dev.type != "cuda":
        raise ValueError(f"ebe_matvec: the CUDA kernel needs CUDA tensors, got {dev}")

    from repro_torch.kernels import _build

    gradn = gradn_ref(dt, dev)
    out = torch.empty((E, quad.NNODE, 3), dtype=dt, device=dev)
    f64 = dt == torch.float64
    fn = getattr(_build.library(), "ebe_matvec_" + ("f64" if f64 else "f32"))
    err = fn(
        x.data_ptr(), conn.data_ptr(), D.data_ptr(), Jinv.data_ptr(), wdet.data_ptr(),
        None if coef is None else coef.data_ptr(), gradn.data_ptr(), E, tile_e,
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "ebe_matvec")
    (counter_f64 if f64 else counter_f32).add()
    return out
