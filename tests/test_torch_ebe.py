"""Port parity of the EBE path: the element product against the reference
oracle and the reference Pallas kernel (interpret mode), the fused entry
(gather through an int32 connectivity + element product) against the
gather and the plain product and against the Pallas kernel on the gathered
input, the full matrix-free ``ebe_matvec`` against the port's dense assembly
and the reference's, and the scatter's determinism.

Tolerances: element product 1e-13 (fp64) and 5e-6 (fp32) relative to the
maximum (the tolerances of tests/test_kernels.py); full operator 1e-9
relative to the maximum (tests/test_fem.py::test_matvec_equivalence).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fem import meshgen as ref_meshgen, spmv as ref_spmv
from repro.kernels.ebe_matvec import ebe_element_matvec_pallas, ebe_element_matvec_ref
from repro_torch.fem import assembly, meshgen, multispring as ms, quadrature as quad, spmv
from repro_torch.kernels.ebe_matvec import ops as ebe_ops


@pytest.mark.parametrize("dtype,tol", [(np.float32, 5e-6), (np.float64, 1e-13)])
@pytest.mark.parametrize("with_coef", [True, False])
def test_element_product_matches_oracle_and_pallas(dtype, tol, with_coef):
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    with jax.enable_x64(dtype == np.float64):
        m = meshgen.generate(2, 2, 2, pad_elems_to=4)
        rng = np.random.default_rng(1)
        E = m.n_elem - 3  # not a multiple of the Pallas tile (16)
        u_e = rng.normal(size=(E, 10, 3)).astype(dtype)
        Q = rng.normal(size=(E, quad.NPOINT, 6, 6))
        D = (Q @ Q.transpose(0, 1, 3, 2)).astype(dtype)
        Jinv, wdet = m.Jinv[:E].astype(dtype), m.wdet[:E].astype(dtype)
        coef = rng.uniform(0.5, 1.5, size=(E,)).astype(dtype) if with_coef else None
        jargs = [jnp.asarray(a) for a in (u_e, D, Jinv, wdet)] + [None if coef is None else jnp.asarray(coef)]
        targs = [torch.tensor(a, dtype=tdt) for a in (u_e, D, Jinv, wdet)] + [None if coef is None else torch.tensor(coef)]
        out = ebe_ops.ebe_element_matvec_ref(*targs).numpy()
        for ref in (ebe_element_matvec_ref(*jargs), ebe_element_matvec_pallas(*jargs, tile_e=16)):
            ref = np.asarray(ref)
            np.testing.assert_allclose(out, ref, rtol=tol, atol=tol * float(np.abs(ref).max()))


@pytest.mark.parametrize("dtype,tol", [(np.float32, 5e-6), (np.float64, 1e-13)])
def test_fused_entry_matches_gather_and_pallas(dtype, tol):
    """The entry ``spmv.ebe_matvec`` calls, ``element_kernel(x, conn32, ...)``,
    on CPU tensors: bit-equal to ``gather_elem`` + the plain product (with
    and without coef), and within the kernel tolerance of the Pallas kernel
    on the gathered input, padded elements (conn 0, wdet 0) included."""
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    m = meshgen.generate(2, 2, 1, pad_elems_to=7)
    assert m.npad > 0 and not m.conn[-m.npad:].any()
    maps = spmv.MeshMaps.from_mesh(m, tdt, "cpu")
    rng = np.random.default_rng(5)
    E = m.n_elem
    x = rng.normal(size=(m.n_nodes, 3)).astype(dtype)
    Q = rng.normal(size=(E, quad.NPOINT, 6, 6))
    D = (Q @ Q.transpose(0, 1, 3, 2)).astype(dtype)
    coef = rng.uniform(0.5, 1.5, size=(E,)).astype(dtype)
    tD, tc = torch.tensor(D), torch.tensor(coef)
    u_e = spmv.gather_elem(torch.tensor(x), maps.conn)
    for c in (tc, None):
        out = ebe_ops.element_kernel(torch.tensor(x), maps.conn32, tD, maps.Jinv, maps.wdet, c)
        assert torch.equal(out, ebe_ops.ebe_element_matvec_ref(u_e, tD, maps.Jinv, maps.wdet, c))
        assert out[:-m.npad].abs().max() > 0 and not out[-m.npad:].any()  # ghosts contribute nothing
    with jax.enable_x64(dtype == np.float64):
        jargs = [jnp.asarray(a) for a in (u_e.numpy(), D, maps.Jinv.numpy(), maps.wdet.numpy(), coef)]
        ref = np.asarray(ebe_element_matvec_pallas(*jargs, tile_e=16))
    out = ebe_ops.element_kernel(torch.tensor(x), maps.conn32, tD, maps.Jinv, maps.wdet, tc)
    np.testing.assert_allclose(out.numpy(), ref, rtol=tol, atol=tol * float(np.abs(ref).max()))


def test_meshmaps_int32_conn_equals_int64():
    m = meshgen.generate(2, 2, 2, pad_elems_to=5)
    for dt in (torch.float64, torch.float32):
        maps = spmv.MeshMaps.from_mesh(m, dt, "cpu")
        assert maps.conn32.dtype == torch.int32 and maps.conn.dtype == torch.int64
        assert maps.conn32.is_contiguous() and tuple(maps.conn32.shape) == (m.n_elem, quad.NNODE)
        assert torch.equal(maps.conn32.long(), maps.conn)
        np.testing.assert_array_equal(maps.conn32.numpy(), m.conn)
        assert maps.astype(torch.float32).conn32 is maps.conn32  # index maps shared


@pytest.fixture(scope="module")
def elastic():
    """Mesh (3,3,3) with the elastic tangent from the port's multispring."""
    m = meshgen.generate(3, 3, 3, pad_elems_to=8)
    params = ms.material_params_for_mesh(m, device="cpu")
    n, w = (torch.tensor(a) for a in ms.spring_directions(30))
    npts = m.n_elem * quad.NPOINT
    _, D0, _ = ms.update(torch.zeros((npts, 6), dtype=torch.float64), ms.init_state(npts, 30, device="cpu"), params, n, w)
    return m, D0.reshape(m.n_elem, quad.NPOINT, 6, 6)


def test_ebe_matvec_equals_dense_assembly(elastic):
    m, D0 = elastic
    maps = spmv.MeshMaps.from_mesh(m, torch.float64, "cpu")
    K_e = assembly.element_stiffness(D0, maps.Jinv, maps.wdet)
    A = assembly.dense_assemble(K_e, m.elem_dofs, m.ndof)
    x = torch.tensor(np.random.default_rng(0).normal(size=(m.n_nodes, 3)))
    y_dense = (A @ x.reshape(-1)).reshape(-1, 3)
    scale = float(y_dense.abs().max())
    coef = torch.tensor(np.random.default_rng(1).uniform(0.5, 1.5, m.n_elem))
    y_ebe = spmv.ebe_matvec(x, D0, maps, element_kernel=ebe_ops.element_kernel)
    np.testing.assert_allclose(y_ebe.numpy(), y_dense.numpy(), rtol=0, atol=1e-9 * scale)
    # the element coefficient scales each K_e (A = Σ_e coef_e K_e)
    A_c = assembly.dense_assemble(K_e * coef[:, None, None], m.elem_dofs, m.ndof)
    y_c = (A_c @ x.reshape(-1)).reshape(-1, 3)
    np.testing.assert_allclose(spmv.ebe_matvec(x, D0, maps, coef).numpy(), y_c.numpy(),
                               rtol=0, atol=1e-9 * float(y_c.abs().max()))
    # rigid translations are in the null space
    t = torch.tensor([1.0, -2.0, 0.5], dtype=torch.float64).repeat(m.n_nodes, 1)
    assert float(spmv.ebe_matvec(t, D0, maps).abs().max()) < 1e-10 * float(K_e.abs().max())


def test_ebe_matvec_and_strain_match_reference(elastic):
    m, D0 = elastic
    maps = spmv.MeshMaps.from_mesh(m, torch.float64, "cpu")
    x = np.random.default_rng(2).normal(size=(m.n_nodes, 3))
    sig = np.random.default_rng(3).normal(size=(m.n_elem * quad.NPOINT, 6))
    with jax.enable_x64(True):
        rm = ref_meshgen.generate(3, 3, 3, pad_elems_to=8)
        y_ref = np.asarray(ref_spmv.ebe_matvec(jnp.asarray(x), jnp.asarray(D0.numpy()), rm))
        e_ref = np.asarray(ref_spmv.strain_at_points(jnp.asarray(x), rm))
        q_ref = np.asarray(ref_spmv.internal_force(jnp.asarray(sig), rm))
    for out, ref in ((spmv.ebe_matvec(torch.tensor(x), D0, maps), y_ref),
                     (spmv.strain_at_points(torch.tensor(x), maps), e_ref),
                     (spmv.internal_force(torch.tensor(sig), maps), q_ref)):
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-12 * float(np.abs(ref).max()))


def test_scatter_is_deterministic_and_matches_segment_order(elastic):
    m, _ = elastic
    maps = spmv.MeshMaps.from_mesh(m, torch.float64, "cpu")
    f_e = torch.tensor(np.random.default_rng(4).normal(size=(m.n_elem, 10, 3)))
    a, b = spmv.scatter_add(f_e, maps.dof_slots), spmv.scatter_add(f_e, maps.dof_slots)
    assert torch.equal(a, b)
    expect = np.zeros(m.ndof)
    np.add.at(expect, m.elem_dofs.ravel(), f_e.numpy().ravel())
    np.testing.assert_allclose(a.reshape(-1).numpy(), expect, rtol=0, atol=1e-12 * np.abs(expect).max())
    # each slot row lists the contributions in the reference's sorted order
    rows = maps.dof_slots.numpy()
    flat = np.concatenate([r[r < f_e.numel()] for r in rows])
    np.testing.assert_array_equal(flat, m.scatter_perm)
