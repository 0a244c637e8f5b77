"""Binding of ``csrc/ebe_matvec.cu`` (ctypes, plain C interface).

Launches on the tensors' device (made the thread's current one for the
launch) and on that device's current stream; the output is allocated here with
``torch.empty``; every argument is checked before its pointer is passed.
The fp64 (outer flexible CG, rhs ``C·v``) and fp32 (inner PCG) launches are
counted separately, and the k-set launches (k members in one launch) apart
from the one-member ones.
"""
from __future__ import annotations

import torch

from repro_torch.fem import quadrature as quad
from repro_torch.fem.assembly import gradn_ref
from repro_torch.kernels import LaunchCounter, check_arg, on_device

TILE_E = 16  # elements per tile of the persistent grid (4 threads each)
TILE_E_RANGE = (4, 64)  # and a multiple of 4: every tile's bulk copies stay 16-byte aligned
counter_f64 = LaunchCounter("ebe_matvec_f64")
counter_f32 = LaunchCounter("ebe_matvec_f32")
counter_kset_f64 = LaunchCounter("ebe_matvec_kset_f64")
counter_kset_f32 = LaunchCounter("ebe_matvec_kset_f32")


def check_tile_e(tile_e: int) -> None:
    lo, hi = TILE_E_RANGE
    if not (lo <= tile_e <= hi and tile_e % 4 == 0):
        raise ValueError(f"ebe_matvec: tile_e={tile_e} must be a multiple of 4 in [{lo}, {hi}]")


def _check(name, x, shape, dtype, device):
    check_arg("ebe_matvec", name, x, shape, dtype, device)


def kset_size(x: torch.Tensor, D: torch.Tensor, coef: torch.Tensor | None) -> int:
    """``k`` of a k-set call: ``x [k,N,3]``, ``D [k,E,4,6,6]`` and ``coef
    [k,E]`` must all carry the same leading member axis."""
    if x.dim() != 3:
        raise ValueError(f"ebe_matvec (k-set): x must be [k,N,3], got {tuple(x.shape)}")
    k = x.shape[0]
    if D.dim() != 5 or D.shape[0] != k:
        raise ValueError(f"ebe_matvec (k-set): D must be [k={k},E,4,6,6], got {tuple(D.shape)}")
    if coef is not None and (coef.dim() != 2 or coef.shape[0] != k):
        raise ValueError(f"ebe_matvec (k-set): coef must be [k={k},E], got {tuple(coef.shape)}")
    return k


def _launch(x, conn, D, Jinv, wdet, coef, tile_e, k):
    """Check and launch for ``k`` members (``None``: one, without the axis)."""
    dt, dev = x.dtype, x.device
    if dt not in (torch.float32, torch.float64):
        raise ValueError(f"ebe_matvec: dtype {dt} not supported (float32, float64)")
    E = conn.shape[0]
    P = quad.NPOINT
    lead = () if k is None else (k,)
    _check("x", x, (*lead, x.shape[-2], 3), dt, dev)
    _check("conn", conn, (E, quad.NNODE), torch.int32, dev)
    _check("D", D, (*lead, E, P, 6, 6), dt, dev)
    _check("Jinv", Jinv, (E, 3, 3), dt, dev)
    _check("wdet", wdet, (E, P), dt, dev)
    if coef is not None:
        _check("coef", coef, (*lead, E), dt, dev)
    for name, t in (("conn", conn), ("D", D), ("Jinv", Jinv), ("wdet", wdet), ("coef", coef)):
        if t is not None and t.data_ptr() % 16:  # the kernel's bulk copies start on 16-byte boundaries
            raise ValueError(f"ebe_matvec: {name} must start on a 16-byte boundary (a view into a tensor?)")
    check_tile_e(tile_e)
    if dev.type != "cuda":
        raise ValueError(f"ebe_matvec: the CUDA kernel needs CUDA tensors, got {dev}")

    from repro_torch.kernels import _build

    gradn = gradn_ref(dt, dev)
    out = torch.empty((*lead, E, quad.NNODE, 3), dtype=dt, device=dev)
    f64 = dt == torch.float64
    fn = getattr(_build.library(), "ebe_matvec_" + ("f64" if f64 else "f32"))
    with on_device(dev):
        err = fn(
            x.data_ptr(), conn.data_ptr(), D.data_ptr(), Jinv.data_ptr(), wdet.data_ptr(),
            None if coef is None else coef.data_ptr(), gradn.data_ptr(), E, x.shape[-2], 1 if k is None else k,
            tile_e, out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, "ebe_matvec")
    if k is None:
        (counter_f64 if f64 else counter_f32).add()
    else:
        (counter_kset_f64 if f64 else counter_kset_f32).add()
    return out


def ebe_matvec_cuda(x: torch.Tensor, conn: torch.Tensor, D: torch.Tensor, Jinv: torch.Tensor,
                    wdet: torch.Tensor, coef: torch.Tensor | None = None, *,
                    tile_e: int = TILE_E) -> torch.Tensor:
    """``f_e [E,10,3]`` = Σ_p wdet_p·coef_e·B_pᵀ D_p B_p x[conn_e] from the CUDA kernel
    (the gather fused in; ``conn`` int32)."""
    return _launch(x, conn, D, Jinv, wdet, coef, tile_e, None)


def ebe_matvec_kset_cuda(x: torch.Tensor, conn: torch.Tensor, D: torch.Tensor, Jinv: torch.Tensor,
                         wdet: torch.Tensor, coef: torch.Tensor | None = None, *,
                         tile_e: int = TILE_E) -> torch.Tensor:
    """``f_e [k,E,10,3]`` for ``k`` members in one launch: ``x [k,N,3]``,
    ``D [k,E,4,6,6]``, ``coef [k,E]``; ``conn``, ``Jinv`` and ``wdet`` shared."""
    return _launch(x, conn, D, Jinv, wdet, coef, tile_e, kset_size(x, D, coef))
