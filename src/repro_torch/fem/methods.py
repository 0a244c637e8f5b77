"""The paper's Proposed Method 2 (``EBEGPU_MSGPU_2SET``) as a step function.

  Proposed 2  matrix-free EBE operator + mixed-precision inner-PCG
              preconditioner, no CRS update; the spring state θ stays in
              pinned host memory and streams through the card in ``npart``
              blocks (Algorithm 3).

Baselines 1–2 and Proposed 1 (the CRS rungs) are not ported yet (ROADMAP,
"Modules still to port").  Every entry point runs on the card unless the
caller passes ``device="cpu"``; there is no silent fallback to the CPU.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import hetmem
from repro_torch.core.stream import StreamEngine, StreamPlan
from repro_torch.device import resolve_device
from repro_torch.fem import assembly, multispring as ms, newmark, quadrature as quad, solver, spmv

DIAG_CHUNK = 32768  # elements per chunk of ebe_diag_inverse's B-matrix einsum


@dataclasses.dataclass(frozen=True)
class SeismicConfig:
    dt: float = 0.005
    tol: float = 1e-8
    maxiter: int = 2000
    nspring: int = ms.NSPRING_DEFAULT
    npart: int = 4            # streaming blocks (Alg. 3)
    schedule: str = "serial"  # StreamEngine schedule: serial | prefetch
    prefetch: int = 1         # copy-ahead depth for schedule="prefetch"
    inner_iters: int = 8      # fp32 inner PCG sweeps (EBE-IPCG preconditioner)
    omega0: float = 2.0 * np.pi * 1.0  # Rayleigh target frequency [rad/s]
    dtype: torch.dtype = torch.float64  # the paper's 40 B per spring
    # ---- kernel backend dispatch (fem/backend.py) -------------------------
    backend: str = "auto"     # auto | cuda | torch (checked against the device)
    ebe_backend: str = ""     # per-kernel override ("" → backend)
    ms_backend: str = ""      # per-kernel override ("" → backend)
    tile_e: int = 128         # CUDA EBE kernel: elements (threads) per block
    tile_p: int = 4           # CUDA multispring kernel: points (warps) per block
    # ---- solver amortization ----------------------------------------------
    warm_start: bool = False  # carry δu as x0 for the next step's CG solve
    precond_every: int = 1    # EBE: refresh the block-Jacobi diag every N steps

    def __post_init__(self):
        if self.precond_every < 1:
            raise ValueError(f"precond_every must be ≥ 1, got {self.precond_every}")

    @property
    def rdtype(self) -> torch.dtype:
        return self.dtype


class StepAux(NamedTuple):
    iters: int
    relres: float
    converged: bool = True


class FemOperators:
    """Mesh-bound operators of Proposed 2, with everything the matvecs read
    held on the device in each dtype they use (fp64 outer, fp32 inner)."""

    _state_keys = ms.STATE_KEYS

    def __init__(self, mesh, cfg: SeismicConfig, *, device=None, element_kernel=None,
                 multispring_fn=None):
        from repro_torch.kernels.ebe_matvec import ops as ebe_ops
        from repro_torch.kernels.multispring import ops as ms_ops

        self.mesh = mesh
        self.cfg = cfg
        self.device = resolve_device(device)
        dt, dev = cfg.rdtype, self.device

        def T(a):
            return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

        self.mass = T(mesh.mass)
        self.dash = T(mesh.dashpot)
        self.force_map = T(mesh.force_map)
        self.maps = {dt: spmv.MeshMaps.from_mesh(mesh, dt, dev)}
        self.maps[torch.float32] = self.maps[dt].astype(torch.float32)
        n, w = ms.spring_directions(cfg.nspring)
        self.n_dirs, self.w_dirs = T(n), T(w)
        self.params = ms.material_params_for_mesh(mesh, dt, dev)
        self.h_max = T(np.array([m.h_max for m in mesh.materials])[mesh.mat_id])
        self.n_elem, self.n_nodes = mesh.n_elem, mesh.n_nodes
        # the wrappers pick the CUDA kernel or the plain version by device
        self.element_kernel = element_kernel or ebe_ops.element_kernel
        self.multispring_fn = multispring_fn or ms_ops.update
        # set by fem.backend.make_operators
        self.kernel_backend = None

    # ---- constitutive -----------------------------------------------------
    def multispring_all(self, eps_pts, springs):
        """(σ, D, new_state, frac) over every evaluation point."""
        return self.multispring_fn(eps_pts, springs, self.params, self.n_dirs, self.w_dirs)

    def multispring_block(self, blk, eps_blk, params_blk):
        """Per-streamed-block kernel: ``blk`` is the spring-state tensor list.

        σ, D and the damping fraction are computed on the device before θ_j
        returns to the host: Algorithm 3 keeps only θ round-tripping."""
        state = dict(zip(self._state_keys, blk))
        sigma, D, new_state, frac = self.multispring_fn(
            eps_blk, state, params_blk, self.n_dirs, self.w_dirs)
        return [new_state[k] for k in self._state_keys], (sigma, D, frac)

    def block_params(self, npart):
        """SpringParams sliced per streamed block; ``npart`` must divide the
        quadrature-point count."""
        chunk = hetmem.check_divisible(self.n_elem * quad.NPOINT, npart, "quadrature point count")
        return [self.params.slice(slice(j * chunk, (j + 1) * chunk)) for j in range(npart)]

    # ---- damping ----------------------------------------------------------
    def damping_from_frac(self, frac):
        """(α, β_e): Rayleigh from per-point damping fractions [E*P]."""
        h_pt = frac.reshape(self.n_elem, quad.NPOINT).mean(dim=1) * self.h_max
        beta_e = 2.0 * h_pt / self.cfg.omega0
        alpha = 2.0 * torch.mean(h_pt) * self.cfg.omega0
        return alpha, beta_e

    def damping_coeffs(self, springs):
        """(α, β_e) from a resident spring state."""
        return self.damping_from_frac(ms.hysteretic_damping(springs, self.params))

    # ---- operators ---------------------------------------------------------
    def _diag_add(self, alpha):
        dt = self.cfg.dt
        return (4.0 / dt**2 + 2.0 * alpha / dt) * self.mass[:, None] + (2.0 / dt) * self.dash

    def ebe_matvec_A(self, D, beta_e, alpha):
        """x ↦ A x in x's dtype: the fp64 outer solve and the fp32 inner one.

        The operands in the second dtype (D above all, 340 MB in fp64 at the
        full-size cell) are cast once per operator, i.e. once per step, not
        once per matvec."""
        coef = 1.0 + (2.0 / self.cfg.dt) * beta_e
        operands = {D.dtype: (D, coef, self._diag_add(alpha))}

        def mv(xflat):
            dt = xflat.dtype
            if dt not in operands:
                D0, c0, d0 = operands[D.dtype]
                operands[dt] = (D0.to(dt), c0.to(dt), d0.to(dt))
            Dx, cx, dx = operands[dt]
            x = xflat.reshape(-1, 3)
            y = spmv.ebe_matvec(x, Dx, self.maps[dt], cx, element_kernel=self.element_kernel)
            return (y + dx * x).reshape(-1)

        return mv

    def cv_matvec_ebe(self, D, beta_e, alpha):
        maps = self.maps[D.dtype]

        def mv(v):
            kv = spmv.ebe_matvec(v, D, maps, beta_e, element_kernel=self.element_kernel)
            return alpha * self.mass[:, None] * v + kv + self.dash * v

        return mv

    def ebe_diag_inverse(self, D, beta_e, alpha):
        """Block-Jacobi of A without assembling K (nodal diag blocks only).

        The B-matrix contraction runs over chunks of ``DIAG_CHUNK`` elements,
        so device memory stays bounded (the whole ``[E,P,6,30]`` B is 1.7 GB
        in fp64 at the full-size cell)."""
        maps = self.maps[D.dtype]
        coef = 1.0 + (2.0 / self.cfg.dt) * beta_e
        w = maps.wdet * coef[:, None]
        E = self.n_elem
        parts = []
        for s in range(0, E, DIAG_CHUNK):
            sl = slice(s, min(s + DIAG_CHUNK, E))
            B = assembly.b_matrices(maps.Jinv[sl])
            Bn = B.reshape(B.shape[0], quad.NPOINT, 6, quad.NNODE, 3)
            DB = torch.einsum("epkl,eplnb->epknb", D[sl], Bn)
            parts.append(torch.einsum("ep,epkna,epknb->enab", w[sl], Bn, DB))  # [c,10,3,3]
        Kdiag = torch.cat(parts)
        N = self.n_nodes
        nodal = spmv.segment_sum(Kdiag.reshape(E * quad.NNODE, 9), maps.node_slots).reshape(N, 3, 3)
        eye = torch.eye(3, dtype=nodal.dtype, device=nodal.device)
        nodal = nodal + self._diag_add(alpha)[:, :, None] * eye[None]
        return torch.linalg.inv(nodal)


# ---------------------------------------------------------------------------
# step factories — each returns step(carry, f_ext) -> (carry, aux)
# ---------------------------------------------------------------------------


def _resident_multispring(ops, eps_pts, springs):
    sigma, D, springs, frac = ops.multispring_all(eps_pts, springs)
    return sigma, D.reshape(ops.n_elem, quad.NPOINT, 6, 6), springs, frac


def _streamed_multispring(ops, eps_pts, springs_ps, block_params):
    """Algorithm 3 via the StreamEngine: θ blocks host↔device, σ/D on device."""
    cfg = ops.cfg
    npart = springs_ps.npart
    chunk = hetmem.check_divisible(eps_pts.shape[0], npart, "quadrature point count")
    eps_blocks = [eps_pts[j * chunk:(j + 1) * chunk] for j in range(npart)]
    plan = StreamPlan(npart=npart, schedule=cfg.schedule, prefetch=cfg.prefetch,
                      collect=True, device=ops.device)
    res = StreamEngine(plan).run(ops.multispring_block, springs_ps,
                                 per_block=(eps_blocks, block_params))
    sigma = torch.cat([e[0] for e in res.extras])
    D = torch.cat([e[1] for e in res.extras])
    frac = torch.cat([e[2] for e in res.extras])
    return sigma, D.reshape(ops.n_elem, quad.NPOINT, 6, 6), frac, res.state


def partition_springs(ops, springs, npart) -> hetmem.PartitionedState:
    """Element-point-contiguous partition of spring state (hetmem blocks)."""
    parts = hetmem.partition_arrays(springs, npart)
    return hetmem.PartitionedState(blocks=[[p[k] for k in ms.STATE_KEYS] for p in parts])


def springs_to_host(ps: hetmem.PartitionedState, device) -> hetmem.PartitionedState:
    """Pinned host copies of the blocks (the identity when ``device`` is the CPU)."""
    return hetmem.PartitionedState(blocks=[hetmem.put_host(b, device) for b in ps.blocks])


def make_step_ebe(ops: FemOperators, *, streamed: bool = True):
    """Proposed 2: EBE matrix-free solver + streamed multispring, no CRS.

    * ``cfg.warm_start`` — the carry grows a ``du_prev`` leaf used as the
      flexible-CG ``x0`` (Newmark predictor start);
    * ``cfg.precond_every = N > 1`` — the carry grows ``(Minv, step)`` and
      :meth:`FemOperators.ebe_diag_inverse` is recomputed only on steps with
      ``step % N == 0``; in between the lagged diagonal preconditions the
      solve (flexible CG tolerates an inexact preconditioner).
    """
    cfg = ops.cfg
    block_params = ops.block_params(cfg.npart) if streamed else None
    lag = cfg.precond_every > 1

    def step(carry, f_t):
        nm, springs, D, alpha, beta_e, *extra = carry
        x0 = extra[0] if cfg.warm_start else None
        mvA = ops.ebe_matvec_A(D, beta_e, alpha)
        if lag:
            Minv_prev, tstep = extra[-2], extra[-1]
            if tstep % cfg.precond_every == 0:
                Minv = ops.ebe_diag_inverse(D, beta_e, alpha)
            else:
                Minv = Minv_prev
        else:
            Minv = ops.ebe_diag_inverse(D, beta_e, alpha)
        inner = solver.make_inner_pcg_preconditioner(
            mvA,  # dtype-follows-input → fp32 inside the inner solve
            solver.block_jacobi_apply(Minv.to(torch.float32)),
            inner_iters=cfg.inner_iters,
        )
        f_ext = ops.force_map * f_t[None, :]
        b = newmark.rhs(nm, f_ext, ops.mass, cfg.dt, ops.cv_matvec_ebe(D, beta_e, alpha))
        res = solver.fcg(mvA, b.reshape(-1), inner, tol=cfg.tol, maxiter=cfg.maxiter, x0=x0)
        du = res.x.reshape(-1, 3)
        eps_pts = spmv.strain_at_points(nm.u + du, ops.maps[cfg.rdtype])
        if streamed:
            sigma, D_new, frac, springs = _streamed_multispring(ops, eps_pts, springs, block_params)
        else:
            sigma, D_new, springs, frac = _resident_multispring(ops, eps_pts, springs)
        alpha, beta_e = ops.damping_from_frac(frac)
        q_new = spmv.internal_force(sigma, ops.maps[cfg.rdtype])
        nm = newmark.advance(nm, du, q_new, cfg.dt)
        tail = (res.x,) if cfg.warm_start else ()
        if lag:
            tail += (Minv, tstep + 1)
        return (nm, springs, D_new, alpha, beta_e, *tail), StepAux(res.iters, res.relres, res.converged)

    return step


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def initial_carry(ops: FemOperators, *, streamed: bool = False, ebe: bool = False):
    """Elastic initial tangent + virgin springs (in pinned host blocks if streamed).

    Streamed, θ is made block by block directly in host memory and the
    initial tangent is computed block by block from virgin blocks made on
    the device, so the whole state is never resident on the card.  The carry
    layout follows the config: ``cfg.warm_start`` appends a zero ``du_prev``;
    ``ebe=True`` with ``cfg.precond_every > 1`` appends ``(Minv, step)``,
    whose zero ``Minv`` is replaced on step 0 before anything reads it."""
    cfg = ops.cfg
    dt, dev = cfg.rdtype, ops.device
    npts = ops.n_elem * quad.NPOINT
    if streamed:
        npart = cfg.npart
        chunk = hetmem.check_divisible(npts, npart, "quadrature point count")
        pin = hetmem.transfers_real(dev)
        blocks, sig_D_frac = [], []
        for prm in ops.block_params(npart):
            st = ms.init_state(chunk, cfg.nspring, dt, device="cpu" if pin else dev, pin_memory=pin)
            blocks.append([st[k] for k in ms.STATE_KEYS])
            virgin = ms.init_state(chunk, cfg.nspring, dt, device=dev)
            eps0 = torch.zeros((chunk, 6), dtype=dt, device=dev)
            sig_D_frac.append(ops.multispring_block([virgin[k] for k in ms.STATE_KEYS], eps0, prm)[1])
        springs = hetmem.PartitionedState(blocks=blocks)
        D0 = torch.cat([x[1] for x in sig_D_frac])
        alpha, beta_e = ops.damping_from_frac(torch.cat([x[2] for x in sig_D_frac]))
    else:
        springs = ms.init_state(npts, cfg.nspring, dt, device=dev)
        _, D0, _, _ = ops.multispring_all(torch.zeros((npts, 6), dtype=dt, device=dev), springs)
        alpha, beta_e = ops.damping_coeffs(springs)
    D0 = D0.reshape(ops.n_elem, quad.NPOINT, 6, 6)
    nm = newmark.init_state(ops.n_nodes, dt, dev)
    tail = ()
    if cfg.warm_start:
        tail += (torch.zeros(3 * ops.n_nodes, dtype=dt, device=dev),)
    if ebe and cfg.precond_every > 1:
        tail += (torch.zeros((ops.n_nodes, 3, 3), dtype=dt, device=dev), 0)
    return (nm, springs, D0, alpha, beta_e, *tail)


METHODS = ("baseline1", "baseline2", "proposed1", "proposed2")
_CRS_LATER = ("not ported yet: the CRS rungs (Baseline 1/2, Proposed 1) are the next "
              "slice (ROADMAP, 'Modules still to port')")


def make_step(name: str, ops: FemOperators):
    if name == "proposed2":
        return make_step_ebe(ops, streamed=True), True
    if name in METHODS:
        raise NotImplementedError(f"method {name!r} is {_CRS_LATER}")
    raise KeyError(name)


def run(
    mesh,
    cfg: SeismicConfig,
    wave,                      # [nt,3] bedrock input velocity
    method: str = "proposed2",
    observe: np.ndarray | None = None,  # node ids to record
    device=None,               # None → the card; "cpu" only when asked
    on_step: Callable[[int, dict], None] | None = None,
) -> dict[str, Any]:
    """Run a full nonlinear time-history analysis with the chosen method.

    ``on_step(k, info)``, when given, is called after each step with the
    step's outer iterations, relative residual, convergence flag and wall
    seconds (the step is synchronised with the device first).
    """
    from repro_torch.fem import backend as _backend

    dev = resolve_device(device)
    ops = _backend.make_operators(mesh, cfg, device=dev)
    step, streamed = make_step(method, ops)
    carry = initial_carry(ops, streamed=streamed, ebe=method == "proposed2")
    obs = torch.as_tensor(np.asarray(observe if observe is not None else mesh.surface[:1]),
                          dtype=torch.long, device=dev)
    wave = torch.as_tensor(np.asarray(wave), dtype=cfg.rdtype, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    vel, iters, relres, converged = [], [], [], []
    for k in range(wave.shape[0]):
        t0 = time.perf_counter()
        carry, aux = step(carry, wave[k])
        vel.append(carry[0].v[obs])
        iters.append(aux.iters)
        relres.append(aux.relres)
        converged.append(aux.converged)
        if on_step is not None:
            sync()
            on_step(k, {"iters": aux.iters, "relres": aux.relres, "converged": aux.converged,
                        "seconds": time.perf_counter() - t0})
    sync()  # the streamed θ blocks are written back by asynchronous copies
    nm = carry[0]
    return {
        "u": nm.u,
        "v": nm.v,
        "velocity_history": torch.stack(vel),  # [nt, n_obs, 3]
        "iters": torch.tensor(iters, dtype=torch.int32),
        "relres": torch.tensor(relres, dtype=torch.float64),
        "converged": torch.tensor(converged),
        "carry": carry,
    }
