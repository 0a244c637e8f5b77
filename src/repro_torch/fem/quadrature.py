"""Second-order (10-node) tetrahedra: shape functions, Gauss rule, B-matrices.

A numpy copy of the JAX package's module, kept here so the port imports
nothing of that package.

Node ordering (barycentric L1..L4 ↔ corners 0..3):
  0..3  corners
  4 (0,1)   5 (1,2)   6 (0,2)   7 (0,3)   8 (1,3)   9 (2,3)   mid-edges

Straight-edged elements with mid-edge nodes exactly at edge midpoints have an
*affine* geometry map, so the Jacobian ``J = [x1-x0, x2-x0, x3-x0]`` is
constant per element.  This is what makes the matrix-free EBE path cheap:
per element we persist only ``J^{-1}`` (9 floats) + ``detJ`` and rebuild the
6×30 B-matrices on the fly from the (static) reference gradients — the
memory-hierarchy trade at the heart of the paper's Proposed Method 2.

Deviation from the paper (documented in DESIGN.md §5): the 4-point degree-2
Gauss rule is used both for stiffness and for the 4 material evaluation
points (the paper uses a 5-point rule for Eq. 2 with 4 material points).
"""
from __future__ import annotations

import numpy as np

# 4-point Gauss rule for the reference tetrahedron, degree-2 exact.
_A = 0.5854101966249685  # (5 + 3*sqrt(5)) / 20
_B = 0.1381966011250105  # (5 - sqrt(5)) / 20
GAUSS_POINTS = np.array(
    [
        [_A, _B, _B, _B],
        [_B, _A, _B, _B],
        [_B, _B, _A, _B],
        [_B, _B, _B, _A],
    ]
)  # barycentric (L1, L2, L3, L4)
GAUSS_WEIGHTS = np.full((4,), 0.25)  # of reference volume

NPOINT = 4   # integration / material evaluation points per element
NNODE = 10   # nodes per element
NDOF = 30    # dofs per element

_EDGES = [(0, 1), (1, 2), (0, 2), (0, 3), (1, 3), (2, 3)]


def shape_functions(bary: np.ndarray) -> np.ndarray:
    """N_i at barycentric points ``bary [Q,4]`` → ``[Q,10]``."""
    L = bary
    corner = L * (2.0 * L - 1.0)  # [Q,4]
    edge = np.stack([4.0 * L[:, a] * L[:, b] for a, b in _EDGES], axis=1)
    return np.concatenate([corner, edge], axis=1)


def shape_gradients_ref(bary: np.ndarray) -> np.ndarray:
    """∂N/∂ξ at ``bary [Q,4]`` → ``[Q,10,3]`` with ξ=(L2,L3,L4), L1=1-Σξ.

    Chain rule: ∂N/∂ξ_k = ∂N/∂L_{k+1} − ∂N/∂L_1.
    """
    L = bary
    Q = L.shape[0]
    dN_dL = np.zeros((Q, NNODE, 4))
    for i in range(4):
        dN_dL[:, i, i] = 4.0 * L[:, i] - 1.0
    for e, (a, b) in enumerate(_EDGES):
        dN_dL[:, 4 + e, a] = 4.0 * L[:, b]
        dN_dL[:, 4 + e, b] = 4.0 * L[:, a]
    return dN_dL[:, :, 1:] - dN_dL[:, :, :1]  # [Q,10,3]


# Static reference gradients at the 4 Gauss points: [4, 10, 3]
GRADN_REF = shape_gradients_ref(GAUSS_POINTS)


def element_geometry(coords: np.ndarray, conn: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-element ``(Jinv [E,3,3], detJ [E])`` from corner coordinates.

    ``coords [N,3]``, ``conn [E,10]`` — only the 4 corners define J (affine).
    """
    x0 = coords[conn[:, 0]]
    J = np.stack(
        [coords[conn[:, 1]] - x0, coords[conn[:, 2]] - x0, coords[conn[:, 3]] - x0],
        axis=1,
    )  # [E,3,3], rows = dx/dξ_k
    detJ = np.linalg.det(J)
    Jinv = np.linalg.inv(J)
    return Jinv, detJ


def physical_gradients(Jinv: np.ndarray) -> np.ndarray:
    """∇_x N at all Gauss points: ``[E, P, 10, 3]`` = GRADN_REF @ J^{-1}.

    ∂N/∂x_j = Σ_k ∂N/∂ξ_k ∂ξ_k/∂x_j and ∂ξ/∂x = J^{-1} (J rows are dx/dξ).
    """
    return np.einsum("pnk,ekj->epnj", GRADN_REF, Jinv)


def b_matrix(gradN: np.ndarray) -> np.ndarray:
    """Voigt B ``[..., 6, NDOF]`` from ∇_x N ``[..., 10, 3]``.

    Strain Voigt order (engineering shear): xx, yy, zz, xy, yz, zx.
    DOF order: node-major (n0x n0y n0z n1x ...).
    """
    lead = gradN.shape[:-2]
    B = np.zeros(lead + (6, NNODE, 3))
    gx, gy, gz = gradN[..., 0], gradN[..., 1], gradN[..., 2]
    B[..., 0, :, 0] = gx
    B[..., 1, :, 1] = gy
    B[..., 2, :, 2] = gz
    B[..., 3, :, 0] = gy
    B[..., 3, :, 1] = gx
    B[..., 4, :, 1] = gz
    B[..., 4, :, 2] = gy
    B[..., 5, :, 0] = gz
    B[..., 5, :, 2] = gx
    return B.reshape(lead + (6, NDOF))


def integration_weights(detJ: np.ndarray) -> np.ndarray:
    """``wdet [E, P]``: quadrature weight × |J| per point (ref volume 1/6)."""
    return np.outer(detJ / 6.0, GAUSS_WEIGHTS)


def lumped_mass(coords: np.ndarray, conn: np.ndarray, rho: np.ndarray) -> np.ndarray:
    """HRZ (diagonal-scaling) lumped mass ``[N]`` — positive for TET10.

    Row-sum lumping gives zero/negative corner masses for quadratic tets;
    HRZ scales the consistent-mass diagonal so the element mass is exact.
    """
    bary = GAUSS_POINTS
    N = shape_functions(bary)  # [P,10]
    _, detJ = element_geometry(coords, conn)
    wdet = integration_weights(detJ)  # [E,P]
    diag_e = np.einsum("ep,pn,pn->en", wdet, N, N)  # consistent diagonal
    mass_e = wdet.sum(axis=1)  # element volume
    scale = (rho * mass_e / diag_e.sum(axis=1))[:, None]
    m_e = diag_e * scale  # [E,10]
    m = np.zeros(coords.shape[0])
    np.add.at(m, conn, m_e)
    return m
