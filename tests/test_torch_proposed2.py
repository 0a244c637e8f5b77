"""The slice as a whole: Proposed 2 (streamed θ + EBE solver) in the port
against the reference, on (2,2,2 pad 4), nspring=12, npart=2, dt=0.01,
6 steps, with a wave that is nonzero from step 0.

Tolerances: velocity history and u within atol = 1e-6·max|·| (the
tolerance of tests/test_kernels.py:113 for a swapped kernel in Proposed 2).
Outer iteration counts are equal, or differ by one on a step whose relres
lies within a factor of 2 of ``tol``: the fp32 inner solve sums in another
order than XLA's, which can move a residual that sits at the stopping test
across it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.hetmem import PartitionedState as RefPS
from repro.fem import backend as ref_backend, meshgen as ref_meshgen, methods as ref_methods
from repro_torch import convert
from repro_torch.fem import backend, methods, multispring as ms

NT = 6
KW = dict(dt=0.01, tol=1e-8, maxiter=400, npart=2, nspring=12)


def _wave(nt=NT, dt=0.01):
    t = np.arange(nt) * dt
    wave = np.zeros((nt, 3))
    wave[:, 0] = 0.3 * np.sin(2 * np.pi * 2.0 * t + 0.5)
    wave[:, 2] = 0.1 * np.cos(2 * np.pi * 1.5 * t)
    return wave


@pytest.fixture(scope="module")
def meshes():
    ref = ref_meshgen.generate(2, 2, 2, pad_elems_to=4)
    return ref, convert.mesh_from_arrays(ref)


def _close(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6 * np.abs(ref).max())


def _iters_agree(it_port, it_ref, relres_ref, tol):
    for a, b, r in zip(np.asarray(it_port), np.asarray(it_ref), np.asarray(relres_ref)):
        assert a == b or (abs(int(a) - int(b)) == 1 and tol / 2 <= r <= 2 * tol), (it_port, it_ref)


@pytest.mark.parametrize("extra", [{}, dict(warm_start=True, precond_every=2)],
                         ids=["default", "warm_start+precond_every2"])
def test_run_matches_reference(meshes, extra):
    ref_mesh, mesh = meshes
    wave = _wave()
    obs = ref_mesh.surface[:3]
    with jax.enable_x64(True):
        ref = ref_methods.run(ref_mesh, ref_methods.SeismicConfig(**KW, **extra), wave, observe=obs)
        ref = {k: np.asarray(v) for k, v in ref.items()}
    cfg = methods.SeismicConfig(**KW, **extra)
    out = methods.run(mesh, cfg, wave, observe=obs, device="cpu")
    assert out["velocity_history"].shape == (NT, 3, 3)
    _close(out["velocity_history"], ref["velocity_history"])
    _close(out["u"], ref["u"])
    _iters_agree(out["iters"], ref["iters"], ref["relres"], cfg.tol)
    assert bool(out["converged"].all())
    blocks = out["carry"][1].blocks
    assert len(blocks) == cfg.npart and [x.dtype for x in blocks[0]] == [torch.float64] * 4 + [torch.int32] * 2


def test_streamed_bit_identical_to_resident(meshes):
    _, mesh = meshes
    cfg = methods.SeismicConfig(**KW)
    ops = backend.make_operators(mesh, cfg, device="cpu")
    wave = torch.tensor(_wave())
    outs = {}
    for streamed in (True, False):
        step = methods.make_step_ebe(ops, streamed=streamed)
        carry = methods.initial_carry(ops, streamed=streamed, ebe=True)
        iters = []
        for k in range(NT):
            carry, aux = step(carry, wave[k])
            iters.append(aux.iters)
        springs = carry[1]
        if streamed:
            springs = {k: torch.cat([blk[i] for blk in springs.blocks]) for i, k in enumerate(ms.STATE_KEYS)}
        outs[streamed] = (carry[0], springs, carry[2], iters)
    (nm_s, sp_s, D_s, it_s), (nm_r, sp_r, D_r, it_r) = outs[True], outs[False]
    assert it_s == it_r
    for a, b in zip(nm_s, nm_r):
        assert torch.equal(a, b)
    assert torch.equal(D_s, D_r)
    for k in ms.STATE_KEYS:
        assert torch.equal(sp_s[k], sp_r[k]), k


def _ref_carry_to_numpy(carry, cfg):
    nm, springs, D, alpha, beta_e, *extra = carry
    assert isinstance(springs, RefPS)
    out = {"u": nm.u, "v": nm.v, "a": nm.a, "q": nm.q, "D": D, "alpha": alpha, "beta_e": beta_e,
           "springs": {k: np.concatenate([np.asarray(blk[i]) for blk in springs.blocks])
                       for i, k in enumerate(ms.STATE_KEYS)}}
    if cfg.warm_start:
        out["du_prev"] = extra[0]
    if cfg.precond_every > 1:
        out["Minv"], out["step"] = extra[-2], extra[-1]
    return {k: (v if k == "springs" else np.asarray(v)) for k, v in out.items()}


@pytest.mark.parametrize("extra", [{}, dict(warm_start=True, precond_every=2)],
                         ids=["default", "warm_start+precond_every2"])
def test_carry_across_from_reference(meshes, extra):
    """3 reference steps, carry_from_numpy, then 3 more steps in each package."""
    ref_mesh, mesh = meshes
    wave = _wave()
    obs = ref_mesh.surface[:3]
    with jax.enable_x64(True):
        rcfg = ref_methods.SeismicConfig(**KW, **extra)
        rops = ref_backend.make_operators(ref_mesh, rcfg)
        rstep, streamed = ref_methods.make_step("proposed2", rops)
        rstep = jax.jit(rstep)
        carry = ref_methods.initial_carry(rops, streamed=streamed, ebe=True)
        for k in range(3):
            carry, _ = rstep(carry, jnp.asarray(wave[k]))
        mid = _ref_carry_to_numpy(carry, rcfg)
        ref_v, ref_it, ref_rr = [], [], []
        for k in range(3, NT):
            carry, aux = rstep(carry, jnp.asarray(wave[k]))
            ref_v.append(np.asarray(carry[0].v[obs]))
            ref_it.append(int(aux.iters))
            ref_rr.append(float(aux.relres))
        ref_u = np.asarray(carry[0].u)
    cfg = methods.SeismicConfig(**KW, **extra)
    ops = backend.make_operators(mesh, cfg, device="cpu")
    step, _ = methods.make_step("proposed2", ops)
    pcarry = convert.carry_from_numpy(mid, ops, method="proposed2")
    assert torch.equal(pcarry[0].u, torch.tensor(mid["u"]))
    v, it = [], []
    for k in range(3, NT):
        pcarry, aux = step(pcarry, torch.tensor(wave[k]))
        v.append(pcarry[0].v[torch.as_tensor(obs, dtype=torch.long)].numpy())
        it.append(aux.iters)
    _close(np.stack(v), np.stack(ref_v))
    _close(pcarry[0].u, ref_u)
    _iters_agree(it, ref_it, ref_rr, cfg.tol)


def test_config_validation():
    with pytest.raises(ValueError, match="precond_every"):
        methods.SeismicConfig(precond_every=0)
    assert dataclasses.replace(methods.SeismicConfig(), schedule="prefetch").schedule == "prefetch"
    assert methods.SeismicConfig().rdtype == torch.float64
