"""The paper's four solution methods (Algorithms 1–4) as step functions.

  Baseline 1  CRSCPU_MSCPU      stored BCSR matrix + block-Jacobi PCG; θ
                                resident on the card, one multispring
                                launch over every point
  Baseline 2  CRSGPU_MSCPU      the same solve; θ lives in host memory and
                                the multispring runs on the host CPU: ε goes
                                down, σ, D and the damping fraction come up
                                (Algorithm 2)
  Proposed 1  CRSGPU_MSGPU      the same solve; θ in pinned host memory,
                                streamed through the card in ``npart``
                                blocks (Algorithm 3)
  Proposed 2  EBEGPU_MSGPU_2SET matrix-free EBE operator + mixed-precision
                                inner-PCG preconditioner, no CRS update; θ
                                streamed as in Proposed 1

Every entry point runs on the card unless the caller passes
``device="cpu"``; there is no silent fallback to the CPU.  Baseline 2's
host computation is the method itself, not a fallback: it runs on
:data:`HOST` whatever the device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import hetmem
from repro_torch.core.stream import StreamEngine, StreamPlan
from repro_torch.device import resolve_device
from repro_torch.fem import assembly, multispring as ms, newmark, quadrature as quad, solver, spmv
from repro_torch.kernels.ebe_matvec.ebe_matvec import TILE_E
from repro_torch.kernels.multispring.multispring import TILE_P

DIAG_CHUNK = 32768  # elements per chunk of the B-matrix einsums (ebe_diag_inverse, K_e)
HOST = torch.device("cpu")  # where Baseline 2 keeps θ and runs the multispring
HOST_BLOCK = 65536  # points per host multispring call (bounds the host's temporaries)


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
    tile_e: int = TILE_E      # CUDA EBE kernel: elements (4 threads each) per tile
    tile_p: int = TILE_P      # CUDA multispring kernel: points (warps) per block
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


class StepParts:
    """Milliseconds in named parts of a step: CUDA events on the card, the
    host clock on the CPU and for work the host does itself (``host=True``).
    :func:`run` reads them after each step, once the device has synchronised."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self._events: list[tuple[str, Any, Any]] = []
        self._ms: dict[str, float] = {}

    @contextlib.contextmanager
    def part(self, name: str, *, host: bool = False):
        if self.cuda and not host:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
            self._events.append((name, start, end))
        else:
            t0 = time.perf_counter()
            yield
            self._ms[name] = self._ms.get(name, 0.0) + (time.perf_counter() - t0) * 1e3

    def read(self) -> dict[str, float]:
        """The parts since the last read, summed by name (after a synchronise)."""
        ms_ = self._ms
        for name, start, end in self._events:
            ms_[name] = ms_.get(name, 0.0) + start.elapsed_time(end)
        self._events, self._ms = [], {}
        return ms_


def _part(ops, name, **kw):
    return ops.parts.part(name, **kw) if ops.parts is not None else contextlib.nullcontext()


class FemOperators:
    """Mesh-bound operators of the four methods, with everything the matvecs
    read held on the device in each dtype they use (fp64, and fp32 for
    Proposed 2's inner solve).  The BCSR maps (:attr:`bcsr`) and Baseline 2's
    host constants (:attr:`host_constants`) are made on first use."""

    _state_keys = ms.STATE_KEYS
    host = HOST

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
        # set by run when it reports each step's parts
        self.parts: StepParts | None = None

    @functools.cached_property
    def bcsr(self) -> spmv.BcsrMaps:
        return spmv.BcsrMaps.from_mesh(self.mesh, self.device)

    @functools.cached_property
    def host_constants(self) -> tuple[ms.SpringParams, torch.Tensor, torch.Tensor]:
        """Material parameters and spring directions on :data:`HOST`."""
        dt = self.cfg.rdtype
        n, w = ms.spring_directions(self.cfg.nspring)
        return (ms.material_params_for_mesh(self.mesh, dt, HOST),
                torch.as_tensor(n, dtype=dt, device=HOST), torch.as_tensor(w, dtype=dt, device=HOST))

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

    def multispring_host(self, eps_pts, springs):
        """Baseline 2's constitutive pass (Algorithm 2, lines 3–5): ε goes down
        to the host, the multispring runs on the host CPU through its plain
        version, and σ, D and the damping fraction go back up to the card.  θ
        (``springs``, on :data:`HOST`) never leaves the host.  Returns
        ``(σ, D, new θ, frac)``; the host part is timed as ``host_compute``."""
        bad = [k for k, v in springs.items() if v.device != HOST]
        if bad:
            raise ValueError(f"Baseline 2 keeps θ on {HOST}; {bad} are elsewhere")
        from repro_torch.kernels.multispring.ref import multispring_ref

        params, n, w = self.host_constants
        eps = eps_pts.to(HOST)
        P = eps.shape[0]
        with _part(self, "host_compute", host=True):
            new = {k: torch.empty_like(v) for k, v in springs.items()}
            sigma = eps.new_empty((P, 6))
            D = eps.new_empty((P, 6, 6))
            frac = eps.new_empty((P,))
            for s in range(0, P, HOST_BLOCK):
                sl = slice(s, min(s + HOST_BLOCK, P))
                sigma[sl], D[sl], blk, frac[sl] = multispring_ref(
                    eps[sl], {k: v[sl] for k, v in springs.items()}, params.slice(sl), n, w)
                for k, v in blk.items():
                    new[k][sl] = v
        dev = self.device
        return sigma.to(dev), D.to(dev), new, frac.to(dev)

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
    def crs_update(self, D, beta_e, alpha):
        """UpdateCRS: A's BCSR values (K_e weighted by 1 + 2β_e/dt, plus the
        mass and dashpot diagonal), the β_e-weighted K values of C·v, and A's
        inverted diagonal blocks (Minv).  K_e is built in chunks of
        ``DIAG_CHUNK`` elements."""
        maps, bcsr = self.maps[D.dtype], self.bcsr
        K_e = assembly.element_stiffness(D, maps.Jinv, maps.wdet, chunk=DIAG_CHUNK)
        coef = 1.0 + (2.0 / self.cfg.dt) * beta_e
        valA = assembly.add_diag(assembly.assemble_bcsr(K_e, bcsr.entry_slots, coef), bcsr.diag_slots,
                                 self._diag_add(alpha))
        valCk = assembly.assemble_bcsr(K_e, bcsr.entry_slots, beta_e)
        Minv = assembly.block_jacobi_inverse(valA, bcsr.diag_slots)
        return valA, valCk, Minv

    def crs_matvec(self, valA):
        def mv(xflat):
            return spmv.bcsr_matvec(valA, self.bcsr, xflat.reshape(-1, 3)).reshape(-1)

        return mv

    def cv_matvec_crs(self, valCk, alpha):
        def mv(v):
            kv = spmv.bcsr_matvec(valCk, self.bcsr, v)
            return alpha * self.mass[:, None] * v + kv + self.dash * v

        return mv

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


def make_step_crs(ops: FemOperators, *, transfer_boundaries: bool = False, streamed: bool = False):
    """Baseline 1 (plain), Baseline 2 (``transfer_boundaries``), Proposed 1
    (``streamed``): UpdateCRS, then block-Jacobi PCG on the stored matrix.

    * Baseline 1: θ resident on the card, one multispring launch over every
      point; damping from the new θ (:meth:`FemOperators.damping_coeffs`).
    * Baseline 2: θ on :data:`HOST`; :meth:`FemOperators.multispring_host`
      computes the multispring there (Algorithm 2).
    * Proposed 1: θ in pinned host blocks through the StreamEngine, as
      Proposed 2 streams it (Algorithm 3).

    With ``cfg.warm_start`` the carry grows a trailing ``du_prev`` leaf and
    each step's PCG starts from the previous step's solution.  The matrices
    are freed before the multispring pass, so a streamed step never holds
    them and a block of θ at once.
    """
    if transfer_boundaries and streamed:
        raise ValueError("Baseline 2 (transfer_boundaries) and Proposed 1 (streamed) are different methods")
    cfg = ops.cfg
    block_params = ops.block_params(cfg.npart) if streamed else None
    ops.bcsr  # the BCSR maps are built here, once, not inside the first step

    def solve(nm, D, alpha, beta_e, f_t, x0):
        with _part(ops, "crs_update"):
            valA, valCk, Minv = ops.crs_update(D, beta_e, alpha)
        with _part(ops, "solve"):
            f_ext = ops.force_map * f_t[None, :]
            b = newmark.rhs(nm, f_ext, ops.mass, cfg.dt, ops.cv_matvec_crs(valCk, alpha))
            return solver.pcg(ops.crs_matvec(valA), b.reshape(-1), solver.block_jacobi_apply(Minv),
                              tol=cfg.tol, maxiter=cfg.maxiter, x0=x0)

    def step(carry, f_t):
        nm, springs, D, alpha, beta_e, *extra = carry
        x0 = extra[0] if cfg.warm_start else None
        res = solve(nm, D, alpha, beta_e, f_t, x0)
        du = res.x.reshape(-1, 3)
        eps_pts = spmv.strain_at_points(nm.u + du, ops.maps[cfg.rdtype])
        with _part(ops, "multispring"):
            if streamed:
                sigma, D_new, frac, springs = _streamed_multispring(ops, eps_pts, springs, block_params)
            elif transfer_boundaries:
                sigma, D_new, springs, frac = ops.multispring_host(eps_pts, springs)
                D_new = D_new.reshape(ops.n_elem, quad.NPOINT, 6, 6)
            else:
                sigma, D_new, springs, _ = _resident_multispring(ops, eps_pts, springs)
        if streamed or transfer_boundaries:
            alpha, beta_e = ops.damping_from_frac(frac)
        else:
            alpha, beta_e = ops.damping_coeffs(springs)
        q_new = spmv.internal_force(sigma, ops.maps[cfg.rdtype])
        nm = newmark.advance(nm, du, q_new, cfg.dt)
        tail = (res.x,) if cfg.warm_start else ()
        return (nm, springs, D_new, alpha, beta_e, *tail), StepAux(res.iters, res.relres, res.converged)

    return step


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
        with _part(ops, "diag_inverse"):
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
        with _part(ops, "solve"):
            f_ext = ops.force_map * f_t[None, :]
            b = newmark.rhs(nm, f_ext, ops.mass, cfg.dt, ops.cv_matvec_ebe(D, beta_e, alpha))
            res = solver.fcg(mvA, b.reshape(-1), inner, tol=cfg.tol, maxiter=cfg.maxiter, x0=x0)
        du = res.x.reshape(-1, 3)
        eps_pts = spmv.strain_at_points(nm.u + du, ops.maps[cfg.rdtype])
        with _part(ops, "multispring"):
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


def initial_carry(ops: FemOperators, *, streamed: bool = False, host: bool = False, ebe: bool = False):
    """Elastic initial tangent + virgin springs: on the card, in pinned host
    blocks (``streamed``), or on :data:`HOST` (``host``, Baseline 2, whose
    initial tangent the host computes too).

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
    elif host:
        springs = ms.init_state(npts, cfg.nspring, dt, device=HOST)
        _, D0, _, frac = ops.multispring_host(torch.zeros((npts, 6), dtype=dt, device=dev), springs)
        alpha, beta_e = ops.damping_from_frac(frac)
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


def make_step(name: str, ops: FemOperators):
    """``(step, streamed)`` for one of :data:`METHODS`."""
    if name == "baseline1":
        return make_step_crs(ops), False
    if name == "baseline2":
        return make_step_crs(ops, transfer_boundaries=True), False
    if name == "proposed1":
        return make_step_crs(ops, streamed=True), True
    if name == "proposed2":
        return make_step_ebe(ops, streamed=True), True
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
    step's outer iterations, relative residual, convergence flag, wall
    seconds (the step is synchronised with the device first) and ``ms``, the
    milliseconds of its parts (:class:`StepParts`: ``crs_update`` or
    ``diag_inverse``, ``solve``, ``multispring``, and Baseline 2's
    ``host_compute``).
    """
    from repro_torch.fem import backend as _backend

    dev = resolve_device(device)
    ops = _backend.make_operators(mesh, cfg, device=dev)
    step, streamed = make_step(method, ops)
    carry = initial_carry(ops, streamed=streamed, host=method == "baseline2", ebe=method == "proposed2")
    if on_step is not None:
        ops.parts = StepParts(dev)
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
                        "seconds": time.perf_counter() - t0, "ms": ops.parts.read()})
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
