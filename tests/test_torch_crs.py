"""The CRS rungs (Baseline 1, Baseline 2, Proposed 1) in the port against the
reference, both packages on the same numpy inputs (the reference in x64).

Tolerances:
- BCSR assembly, ``add_diag``, ``block_jacobi_inverse``, ``bcsr_matvec`` and
  ``crs_update`` against their reference functions: 1e-13 relative to the
  largest value (fp64; the two packages sum in other orders).
- The run sum behind the assembly is a fixed order of plain additions: it
  equals a sequential fold bitwise, for every chunk size.
- Whole runs on (2,2,2 pad 4), nspring 12, npart 2, dt 0.01, 6 steps, with a
  wave nonzero from step 0: port ≡ JAX within 1e-12·max|v| for the CRS rungs
  (the tolerance of tests/test_fem.py::test_four_methods_agree) and
  1e-6·max|v| for Proposed 2 (tests/test_torch_proposed2.py); inside the
  port, Baseline 2 and Proposed 1 ≡ Baseline 1 within 1e-12·max|v| and
  Proposed 2 within 1e-5·max|v|.  PCG iteration counts are equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.hetmem import PartitionedState as RefPS
from repro.fem import (assembly as ref_assembly, backend as ref_backend, meshgen as ref_meshgen,
                       methods as ref_methods, spmv as ref_spmv)
from repro_torch import convert
from repro_torch.fem import assembly, backend, methods, multispring as ms, spmv

NT = 6
KW = dict(dt=0.01, tol=1e-8, maxiter=400, npart=2, nspring=12)
CRS = ("baseline1", "baseline2", "proposed1")


def _wave(nt=NT, dt=0.01):
    t = np.arange(nt) * dt
    wave = np.zeros((nt, 3))
    wave[:, 0] = 0.3 * np.sin(2 * np.pi * 2.0 * t + 0.5)
    wave[:, 2] = 0.1 * np.cos(2 * np.pi * 1.5 * t)
    return wave


def _close(out, ref, rel):
    out, ref = np.asarray(out), np.asarray(ref)
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(out, ref, rtol=0, atol=rel * np.abs(ref).max())


@pytest.fixture(scope="module")
def meshes():
    ref = ref_meshgen.generate(2, 2, 2, pad_elems_to=4)
    return ref, convert.mesh_from_arrays(ref)


@pytest.fixture(scope="module")
def padded():
    """A mesh with padded (ghost) elements: 24 real, 8 ghosts."""
    ref = ref_meshgen.generate(2, 2, 1, pad_elems_to=16)
    assert ref.npad == 8
    return ref, convert.mesh_from_arrays(ref)


@pytest.fixture(scope="module")
def operands(padded):
    """K_e from random SPD tangents (the reference's), β_e, α and x, as numpy."""
    ref, _ = padded
    rng = np.random.default_rng(0)
    E, N = ref.n_elem, ref.n_nodes
    Q = rng.normal(size=(E, 4, 6, 6))
    D = Q @ Q.transpose(0, 1, 3, 2) + 6 * np.eye(6)
    with jax.enable_x64(True):
        K_e = np.asarray(ref_assembly.element_stiffness(jnp.asarray(D), jnp.asarray(ref.Jinv),
                                                        jnp.asarray(ref.wdet)))
    return dict(D=D, K_e=K_e, beta_e=rng.uniform(1e-3, 1e-2, E), alpha=0.37,
                d=rng.uniform(1.0, 2.0, (N, 3)), x=rng.normal(size=(N, 3)))


# ---------------------------------------------------------------------------
# assembly, block Jacobi and the BCSR product against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fn", ["assemble_bcsr", "assemble_bcsr_coef", "add_diag", "block_jacobi_inverse",
                                "element_stiffness_chunked"])
def test_assembly_matches_reference(padded, operands, fn):
    ref, mesh = padded
    maps = spmv.BcsrMaps.from_mesh(mesh, "cpu")
    K = torch.tensor(operands["K_e"])
    coef = torch.tensor(operands["beta_e"])
    d = torch.tensor(operands["d"])
    with jax.enable_x64(True):
        vals_ref = ref_assembly.assemble_bcsr(jnp.asarray(operands["K_e"]), ref.entry_map, maps.nnzb)
        if fn == "assemble_bcsr":
            out, want = assembly.assemble_bcsr(K, maps.entry_slots), vals_ref
        elif fn == "assemble_bcsr_coef":
            out = assembly.assemble_bcsr(K, maps.entry_slots, coef)
            want = ref_assembly.assemble_bcsr(jnp.asarray(operands["K_e"] * operands["beta_e"][:, None, None]),
                                              ref.entry_map, maps.nnzb)
        elif fn == "add_diag":
            vals = torch.tensor(np.asarray(vals_ref))
            out = assembly.add_diag(vals, maps.diag_slots, d)
            want = ref_assembly.add_diag(vals_ref, ref.diag_slots, jnp.asarray(operands["d"]))
            assert torch.equal(vals, torch.tensor(np.asarray(vals_ref)))  # the input is left as it was
        elif fn == "block_jacobi_inverse":
            vals = ref_assembly.add_diag(vals_ref, ref.diag_slots, jnp.asarray(operands["d"]))
            out = assembly.block_jacobi_inverse(torch.tensor(np.asarray(vals)), maps.diag_slots)
            want = ref_assembly.block_jacobi_inverse(vals, ref.diag_slots)
        else:
            D, Jinv, wdet = (torch.tensor(a) for a in (operands["D"], mesh.Jinv, mesh.wdet))
            out = assembly.element_stiffness(D, Jinv, wdet, chunk=5)
            want = operands["K_e"]
            assert out.shape == (mesh.n_elem, 30, 30)
        want = np.asarray(want)
    assert out.shape == want.shape and out.dtype == torch.float64
    _close(out.numpy(), want, 1e-13)


@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_chunked_assembly_is_bitwise_unchunked(padded, operands, chunk):
    """Chunks of BCSR blocks change which blocks are summed together, never
    the order of any block's sum."""
    _, mesh = padded
    K = torch.tensor(operands["K_e"])
    coef = torch.tensor(operands["beta_e"])
    whole = spmv.BcsrMaps.from_mesh(mesh, "cpu")
    part = spmv.BcsrMaps.from_mesh(mesh, "cpu", chunk=chunk)
    assert whole.entry_slots.cuts.shape[0] == 2 and part.entry_slots.cuts.shape[0] - 1 == -(-whole.nnzb // chunk)
    for c in (None, coef):
        assert torch.equal(assembly.assemble_bcsr(K, part.entry_slots, c),
                           assembly.assemble_bcsr(K, whole.entry_slots, c))


@pytest.mark.parametrize("chunk", [1, 3, None])
def test_run_sum_is_a_sequential_fold(chunk):
    """Each target's sum is ((v₀ + v₁) + v₂) + … over its sources in ascending
    order, bitwise, with targets of very different degrees."""
    rng = np.random.default_rng(1)
    n = 11
    ids = np.concatenate([np.arange(n), rng.integers(0, n, 60), np.full(9, 4)])
    rng.shuffle(ids)
    vals = torch.tensor(rng.normal(size=(ids.size, 2)) * 10.0 ** rng.integers(-8, 8, (ids.size, 1)))
    slots = assembly.RunSlots.build(ids, n, "cpu", **({} if chunk is None else {"chunk": chunk}))
    out = assembly.run_sum(lambda src: vals[src], slots)
    for t in range(n):
        acc = None
        for i in np.flatnonzero(ids == t):
            acc = vals[i].clone() if acc is None else acc + vals[i]
        assert torch.equal(out[t], acc), t
    with pytest.raises(ValueError, match="every target"):
        assembly.RunSlots.build(np.array([0, 2]), 3, "cpu")


@pytest.mark.parametrize("against", ["reference", "dense"])
def test_bcsr_matvec(padded, operands, against):
    ref, mesh = padded
    maps = spmv.BcsrMaps.from_mesh(mesh, "cpu")
    K = torch.tensor(operands["K_e"])
    vals = assembly.assemble_bcsr(K, maps.entry_slots)
    x = torch.tensor(operands["x"])
    y = spmv.bcsr_matvec(vals, maps, x)
    if against == "reference":
        with jax.enable_x64(True):
            want = np.asarray(ref_spmv.bcsr_matvec(jnp.asarray(vals.numpy()), ref.rowids, ref.col_idx,
                                                   jnp.asarray(operands["x"])))
    else:
        A = assembly.dense_assemble(K, mesh.elem_dofs, mesh.ndof)
        want = (A @ x.reshape(-1)).reshape(-1, 3).numpy()
    assert y.shape == (mesh.n_nodes, 3)
    _close(y.numpy(), want, 1e-13)


@pytest.fixture(scope="module")
def crs_updates(padded, operands):
    ref, mesh = padded
    cfg = methods.SeismicConfig(**KW)
    ops = backend.make_operators(mesh, cfg, device="cpu")
    D, beta_e = torch.tensor(operands["D"]), torch.tensor(operands["beta_e"])
    port = ops.crs_update(D, beta_e, torch.tensor(operands["alpha"], dtype=torch.float64))
    with jax.enable_x64(True):
        rops = ref_backend.make_operators(ref, ref_methods.SeismicConfig(**KW))
        want = rops.crs_update(jnp.asarray(operands["D"]), jnp.asarray(operands["beta_e"]),
                               jnp.asarray(operands["alpha"]))
        want = [np.asarray(w) for w in want]
    return dict(zip(("valA", "valCk", "Minv"), zip(port, want)))


@pytest.mark.parametrize("name", ["valA", "valCk", "Minv"])
def test_crs_update_matches_reference(crs_updates, name):
    out, want = crs_updates[name]
    assert out.shape == want.shape
    _close(out.numpy(), want, 1e-13)


# ---------------------------------------------------------------------------
# steps and runs against the reference
# ---------------------------------------------------------------------------


def _ref_carry_to_numpy(carry, cfg):
    nm, springs, D, alpha, beta_e, *extra = carry
    if isinstance(springs, RefPS):
        springs = {k: np.concatenate([np.asarray(blk[i]) for blk in springs.blocks])
                   for i, k in enumerate(ms.STATE_KEYS)}
    out = {"u": nm.u, "v": nm.v, "a": nm.a, "q": nm.q, "D": D, "alpha": alpha, "beta_e": beta_e}
    if cfg.warm_start:
        out["du_prev"] = extra[0]
    out = {k: np.asarray(v) for k, v in out.items()}
    out["springs"] = {k: np.asarray(v) for k, v in springs.items()}
    return out


def _springs(carry_springs):
    if isinstance(carry_springs, dict):
        return carry_springs
    return {k: torch.cat([blk[i] for blk in carry_springs.blocks]) for i, k in enumerate(ms.STATE_KEYS)}


@pytest.mark.parametrize("method", CRS)
def test_crs_step_from_reference_carry(meshes, method):
    """3 reference steps, carry_from_numpy, then one more step in each package."""
    ref_mesh, mesh = meshes
    wave = _wave()
    with jax.enable_x64(True):
        rcfg = ref_methods.SeismicConfig(**KW)
        rops = ref_backend.make_operators(ref_mesh, rcfg)
        rstep, streamed = ref_methods.make_step(method, rops)
        rstep = jax.jit(rstep)
        carry = ref_methods.initial_carry(rops, streamed=streamed)
        for k in range(3):
            carry, _ = rstep(carry, jnp.asarray(wave[k]))
        mid = _ref_carry_to_numpy(carry, rcfg)
        carry, raux = rstep(carry, jnp.asarray(wave[3]))
        want = _ref_carry_to_numpy(carry, rcfg)
    ops = backend.make_operators(mesh, methods.SeismicConfig(**KW), device="cpu")
    step, _ = methods.make_step(method, ops)
    pcarry = convert.carry_from_numpy(mid, ops, method=method)
    assert isinstance(pcarry[1], dict) == (method != "proposed1")
    pcarry, aux = step(pcarry, torch.tensor(wave[3]))
    assert aux.iters == int(raux.iters) and aux.converged
    nm = pcarry[0]
    for k in ("u", "v", "a", "q"):
        _close(getattr(nm, k).numpy(), want[k], 1e-12)
    _close(pcarry[2].numpy(), want["D"], 1e-12)
    _close(pcarry[4].numpy(), want["beta_e"], 1e-12)
    springs = _springs(pcarry[1])
    for k in ms.STATE_KEYS:
        if k in ms.FLAG_KEYS:
            assert np.array_equal(springs[k].numpy(), want["springs"][k]), k
        else:
            _close(springs[k].numpy(), want["springs"][k], 1e-12)


@pytest.fixture(scope="module")
def runs(meshes):
    """Each method's whole run in both packages (port on the CPU)."""
    ref_mesh, mesh = meshes
    wave = _wave()
    obs = ref_mesh.surface[:3]
    out = {}
    for m in methods.METHODS:
        with jax.enable_x64(True):
            r = ref_methods.run(ref_mesh, ref_methods.SeismicConfig(**KW), wave, method=m, observe=obs)
            r = {k: np.asarray(v) for k, v in r.items()}
        out[m] = (methods.run(mesh, methods.SeismicConfig(**KW), wave, method=m, observe=obs, device="cpu"), r)
    return out


@pytest.mark.parametrize("method", methods.METHODS)
def test_run_matches_reference(runs, method):
    port, ref = runs[method]
    assert port["velocity_history"].shape == (NT, 3, 3)
    rel = 1e-12 if method in CRS else 1e-6
    _close(port["velocity_history"], ref["velocity_history"], rel)
    _close(port["u"], ref["u"], rel)
    assert port["iters"].tolist() == ref["iters"].tolist()
    assert bool(port["converged"].all())
    springs = port["carry"][1]
    if method == "baseline2":  # θ stays on the host for the whole run
        assert all(v.device == methods.HOST for v in springs.values())
    if method in ("proposed1", "proposed2"):
        assert springs.npart == KW["npart"]


def test_rungs_agree_in_the_port(runs):
    v = {m: runs[m][0]["velocity_history"].numpy() for m in methods.METHODS}
    for m in ("baseline2", "proposed1"):
        _close(v[m], v["baseline1"], 1e-12)
        assert runs[m][0]["iters"].tolist() == runs["baseline1"][0]["iters"].tolist()
    _close(v["proposed2"], v["baseline1"], 1e-5)


def test_warm_start_matches_reference(meshes):
    ref_mesh, mesh = meshes
    wave = _wave()
    obs = ref_mesh.surface[:3]
    kw = dict(KW, warm_start=True)
    with jax.enable_x64(True):
        ref = ref_methods.run(ref_mesh, ref_methods.SeismicConfig(**kw), wave, method="proposed1", observe=obs)
        ref = {k: np.asarray(v) for k, v in ref.items()}
    cfg = methods.SeismicConfig(**kw)
    port = methods.run(mesh, cfg, wave, method="proposed1", observe=obs, device="cpu")
    _close(port["velocity_history"], ref["velocity_history"], 1e-12)
    assert port["iters"].tolist() == ref["iters"].tolist()
    cold = methods.run(mesh, dataclasses.replace(cfg, warm_start=False), wave, method="proposed1",
                       observe=obs, device="cpu")
    assert int(port["iters"].sum()) < int(cold["iters"].sum())  # the warm start is really used
    assert port["carry"][-1].shape == (3 * mesh.n_nodes,)  # du_prev
