"""Port parity of the CG solvers on an SPD system built in numpy: the same
iteration counts as the reference and x within 1e-10 (relative to the
maximum), and the fp32 zero-RHS guards of tests/test_backend.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fem import solver as ref_solver
from repro_torch.fem import assembly, meshgen, multispring as ms, quadrature as quad, solver


@pytest.fixture(scope="module")
def spd():
    """Dense stiffness of the elastic (2,2,2) mesh + a mass term (numpy)."""
    m = meshgen.generate(2, 2, 2, pad_elems_to=4)
    params = ms.material_params_for_mesh(m)
    n, w = (torch.tensor(a) for a in ms.spring_directions(12))
    npts = m.n_elem * quad.NPOINT
    _, D0, _ = ms.update(torch.zeros((npts, 6), dtype=torch.float64), ms.init_state(npts, 12), params, n, w)
    K_e = assembly.element_stiffness(D0.reshape(m.n_elem, quad.NPOINT, 6, 6),
                                     torch.tensor(m.Jinv), torch.tensor(m.wdet))
    A = assembly.dense_assemble(K_e, m.elem_dofs, m.ndof).numpy()
    A = A + np.diag(np.repeat(m.mass * 1e4, 3))
    blocks = A.reshape(m.n_nodes, 3, m.n_nodes, 3)[np.arange(m.n_nodes), :, np.arange(m.n_nodes), :]
    Minv = np.linalg.inv(blocks)
    b = np.random.default_rng(1).normal(size=m.ndof)
    return A, Minv, b


def _ref(A, Minv, b, which, inner_iters=6):
    with jax.enable_x64(True):
        Aj = jnp.asarray(A)
        mv = lambda x: (Aj.astype(x.dtype) @ x)  # noqa: E731
        pre = ref_solver.block_jacobi_apply(jnp.asarray(Minv))
        if which == "fcg":
            inner = ref_solver.make_inner_pcg_preconditioner(
                mv, ref_solver.block_jacobi_apply(jnp.asarray(Minv, jnp.float32)), inner_iters=inner_iters)
            res = ref_solver.fcg(mv, jnp.asarray(b), inner, tol=1e-8, maxiter=2000)
        else:
            res = ref_solver.pcg(mv, jnp.asarray(b), pre, tol=1e-8, maxiter=2000)
        return np.asarray(res.x), int(res.iters), float(res.relres)


def _port(A, Minv, b, which, inner_iters=6):
    At = torch.tensor(A)
    mv = lambda x: At.to(x.dtype) @ x  # noqa: E731
    if which == "fcg":
        inner = solver.make_inner_pcg_preconditioner(
            mv, solver.block_jacobi_apply(torch.tensor(Minv, dtype=torch.float32)), inner_iters=inner_iters)
        res = solver.fcg(mv, torch.tensor(b), inner, tol=1e-8, maxiter=2000)
    else:
        res = solver.pcg(mv, torch.tensor(b), solver.block_jacobi_apply(torch.tensor(Minv)), tol=1e-8, maxiter=2000)
    return res


@pytest.mark.parametrize("which", ["pcg", "fcg"])
def test_solver_matches_reference(spd, which):
    A, Minv, b = spd
    x_ref, it_ref, _ = _ref(A, Minv, b, which)
    res = _port(A, Minv, b, which)
    assert res.converged and res.relres <= 1e-8
    assert res.iters == it_ref
    x = res.x.numpy()
    np.testing.assert_allclose(x, x_ref, rtol=0, atol=1e-10 * np.abs(x_ref).max())
    assert np.linalg.norm(b - A @ x) / np.linalg.norm(b) <= 1e-7


def test_inner_preconditioner_reduces_outer_iterations(spd):
    A, Minv, b = spd
    assert _port(A, Minv, b, "fcg").iters < _port(A, Minv, b, "pcg").iters


def test_unconverged_solve_reports_it(spd):
    A, Minv, b = spd
    At = torch.tensor(A)
    res = solver.pcg(lambda x: At @ x, torch.tensor(b), solver.block_jacobi_apply(torch.tensor(Minv)),
                     tol=1e-12, maxiter=2)
    assert res.iters == 2 and not res.converged


def test_pcg_fp32_zero_rhs_is_finite():
    """fp32 zero rhs: a hard-coded 1e-300 guard would flush to 0.0 → NaN."""
    b = torch.zeros(12, dtype=torch.float32)
    res = solver.pcg(lambda x: x, b, lambda r: r, tol=1e-6, maxiter=10)
    assert np.isfinite(res.relres) and res.iters == 0
    assert torch.equal(res.x, torch.zeros(12))
    res = solver.fcg(lambda x: x, b, lambda r: r, tol=1e-6, maxiter=10)
    assert np.isfinite(res.relres)


def test_inner_preconditioner_fp32_zero_residual_is_finite():
    inner = solver.make_inner_pcg_preconditioner(lambda x: x, lambda r: r, inner_iters=3)
    z = inner(torch.zeros(6, dtype=torch.float32))
    assert torch.isfinite(z).all()
