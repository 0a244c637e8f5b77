"""Synthetic layered-basin mesh generator (second-order tets).

The paper's ground model (ADEP, Tokyo site — 7.8M elements, 32.5M DOF) is
proprietary; this generator reproduces its *structure*: a soft sedimentary
layer with a dipping interface over stiffer bedrock (the Fig. 4(a) wedge
where waves focus), discretized with 10-node tetrahedra from a structured
Kuhn subdivision.  All arrays are numpy; consumers move them to torch.

Produces everything the four solution methods need:
  * geometry (``Jinv``, ``detJ``, ``wdet``) for EBE on-the-fly B-matrices,
  * BCSR 3×3 sparsity + element→nnz scatter map for the CRS path,
  * sorted scatter permutation for TPU-deterministic segment-sum assembly,
  * HRZ lumped mass, Lysmer dashpot coefficients, bedrock input-force map.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.fem import quadrature as quad

# Kuhn subdivision: 6 tets per hex, all sharing the v000→v111 diagonal.
_HEX_TO_TETS = [
    (0, 1, 3, 7),
    (0, 3, 2, 7),
    (0, 2, 6, 7),
    (0, 6, 4, 7),
    (0, 4, 5, 7),
    (0, 5, 1, 7),
]
# hex corner offsets (x fastest): bit0→x, bit1→y, bit2→z
_HEX_OFFSETS = np.array([[b & 1, (b >> 1) & 1, (b >> 2) & 1] for b in range(8)])


@dataclasses.dataclass(frozen=True)
class Material:
    """Layer material: elasticity + multi-spring backbone parameters."""

    rho: float      # density [kg/m^3]
    vs: float       # shear wave velocity [m/s]
    vp: float       # P wave velocity [m/s]
    gamma_r: float  # reference shear strain of the R-O backbone
    beta: float     # backbone exponent (1 → hyperbolic Hardin-Drnevich)
    h_max: float    # maximum hysteretic damping ratio

    @property
    def G0(self) -> float:
        return self.rho * self.vs**2

    @property
    def lam(self) -> float:  # Lamé λ
        return self.rho * (self.vp**2 - 2.0 * self.vs**2)

    @property
    def bulk(self) -> float:
        return self.lam + 2.0 * self.G0 / 3.0


# Fig. 1(c)-inspired defaults: soft dipping layer over engineering bedrock.
SOFT = Material(rho=1500.0, vs=130.0, vp=1380.0, gamma_r=8e-4, beta=1.0, h_max=0.20)
MEDIUM = Material(rho=1800.0, vs=220.0, vp=1550.0, gamma_r=1.2e-3, beta=1.0, h_max=0.17)
BEDROCK = Material(rho=2100.0, vs=420.0, vp=1800.0, gamma_r=5e-3, beta=1.0, h_max=0.10)


@dataclasses.dataclass
class Mesh:
    coords: np.ndarray        # [N,3] float64
    conn: np.ndarray          # [E,10] int32 (padded elements point at node 0)
    mat_id: np.ndarray        # [E] int32
    materials: list[Material]
    # geometry for EBE (constant-J elements)
    Jinv: np.ndarray          # [E,3,3]
    detJ: np.ndarray          # [E]
    wdet: np.ndarray          # [E,P]
    # scatter maps
    elem_dofs: np.ndarray     # [E,30] int32
    scatter_perm: np.ndarray  # [E*30] int32 argsort of elem_dofs.ravel()
    scatter_segids: np.ndarray  # [E*30] int32 sorted dof ids
    # BCSR 3x3 (node blocks)
    row_ptr: np.ndarray       # [N+1] int32
    col_idx: np.ndarray       # [nnzb] int32
    rowids: np.ndarray        # [nnzb] int32 expanded row index
    entry_map: np.ndarray     # [E,10,10] int32 → nnzb slot
    diag_slots: np.ndarray    # [N] int32 → nnzb slot of diagonal block
    # physics
    mass: np.ndarray          # [N] HRZ-lumped
    dashpot: np.ndarray       # [N,3] Lysmer dashpot coefficients
    force_map: np.ndarray     # [N,3] bedrock input-force weights (×2ρV·A)
    # node sets
    bottom: np.ndarray
    surface: np.ndarray
    npad: int                 # trailing padded (ghost) elements

    @property
    def n_nodes(self) -> int:
        return self.coords.shape[0]

    @property
    def n_elem(self) -> int:
        return self.conn.shape[0]

    @property
    def ndof(self) -> int:
        return 3 * self.n_nodes


def _interface_depth(x: np.ndarray, y: np.ndarray, lx: float, depth: float) -> np.ndarray:
    """Dipping interface: deep basin on the left rising to a shallow shelf —
    the Fig. 4(a) wedge where the paper observes focusing."""
    t = np.clip(x / lx, 0.0, 1.0)
    return -depth * (0.35 + 0.65 * 0.5 * (1.0 + np.cos(np.pi * t)))  # z of interface


def generate(
    nx: int = 4,
    ny: int = 4,
    nz: int = 4,
    lx: float = 400.0,
    ly: float = 400.0,
    lz: float = 100.0,
    materials: list[Material] | None = None,
    pad_elems_to: int = 1,
) -> Mesh:
    """Structured layered-basin TET10 mesh over [0,lx]×[0,ly]×[-lz,0]."""
    materials = materials or [SOFT, BEDROCK]

    # --- linear grid nodes
    xs = np.linspace(0, lx, nx + 1)
    ys = np.linspace(0, ly, ny + 1)
    zs = np.linspace(-lz, 0.0, nz + 1)
    gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
    corner_coords = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)

    def nid(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k

    # --- hexes → 6 tets
    tets = []
    for i in range(nx):
        for j in range(ny):
            for k in range(nz):
                corners = [nid(i + o[0], j + o[1], k + o[2]) for o in _HEX_OFFSETS]
                for t in _HEX_TO_TETS:
                    tets.append([corners[t[0]], corners[t[1]], corners[t[2]], corners[t[3]]])
    tet4 = np.asarray(tets, dtype=np.int64)

    # positive orientation
    p = corner_coords
    v = np.einsum(
        "ei,ei->e",
        np.cross(p[tet4[:, 1]] - p[tet4[:, 0]], p[tet4[:, 2]] - p[tet4[:, 0]]),
        p[tet4[:, 3]] - p[tet4[:, 0]],
    )
    flip = v < 0
    tet4[flip, 1], tet4[flip, 2] = tet4[flip, 2].copy(), tet4[flip, 1].copy()

    # --- promote to TET10: one mid node per unique edge
    edges = []
    for a, b in [(0, 1), (1, 2), (0, 2), (0, 3), (1, 3), (2, 3)]:
        e = np.sort(tet4[:, [a, b]], axis=1)
        edges.append(e)
    all_edges = np.concatenate(edges, axis=0)
    uniq, inverse = np.unique(all_edges, axis=0, return_inverse=True)
    mid_coords = 0.5 * (corner_coords[uniq[:, 0]] + corner_coords[uniq[:, 1]])
    coords = np.concatenate([corner_coords, mid_coords], axis=0)
    nE = tet4.shape[0]
    mid_ids = inverse.reshape(6, nE).T + corner_coords.shape[0]  # [E,6]
    conn = np.concatenate([tet4, mid_ids], axis=1).astype(np.int32)  # [E,10]

    # --- materials from centroid vs dipping interface
    cent = p[tet4].mean(axis=1)
    z_int = _interface_depth(cent[:, 0], cent[:, 1], lx, lz)
    if len(materials) == 2:
        mat_id = np.where(cent[:, 2] >= z_int, 0, 1).astype(np.int32)
    else:
        z_int2 = z_int * 0.5
        mat_id = np.where(
            cent[:, 2] >= z_int2, 0, np.where(cent[:, 2] >= z_int, 1, 2)
        ).astype(np.int32)

    # --- geometry
    Jinv, detJ = quad.element_geometry(coords, conn)
    assert (detJ > 0).all(), "negative element volume"
    wdet = quad.integration_weights(detJ)

    # --- mass / boundary physics
    rho_e = np.array([materials[m].rho for m in mat_id])
    mass = quad.lumped_mass(coords, conn, rho_e)

    eps = 1e-9
    bottom = np.where(coords[:, 2] < -lz + eps)[0].astype(np.int32)
    surface = np.where(coords[:, 2] > -eps)[0].astype(np.int32)
    side = np.where(
        (coords[:, 0] < eps) | (coords[:, 0] > lx - eps) | (coords[:, 1] < eps) | (coords[:, 1] > ly - eps)
    )[0].astype(np.int32)

    rho_b, vs_b, vp_b = materials[-1].rho, materials[-1].vs, materials[-1].vp
    dashpot = np.zeros((coords.shape[0], 3))
    a_bot = lx * ly / max(1, len(bottom))
    # bottom: normal (z) uses Vp, tangentials Vs
    dashpot[bottom] += a_bot * rho_b * np.array([vs_b, vs_b, vp_b])
    a_side = (2 * (lx + ly) * lz) / max(1, len(side))
    dashpot[side] += a_side * rho_b * np.array([vs_b, vs_b, vs_b])

    force_map = np.zeros((coords.shape[0], 3))
    force_map[bottom] = 2.0 * a_bot * rho_b * np.array([vs_b, vs_b, vp_b])

    # --- pad elements (ghosts contribute nothing: wdet = 0)
    E0 = conn.shape[0]
    E = -(-E0 // pad_elems_to) * pad_elems_to
    npad = E - E0
    if npad:
        conn = np.concatenate([conn, np.zeros((npad, 10), np.int32)])
        mat_id = np.concatenate([mat_id, np.zeros((npad,), np.int32)])
        Jinv = np.concatenate([Jinv, np.tile(np.eye(3)[None], (npad, 1, 1))])
        detJ = np.concatenate([detJ, np.ones((npad,))])
        wdet = np.concatenate([wdet, np.zeros((npad, quad.NPOINT))])

    # --- scatter maps
    elem_dofs = (3 * conn[:, :, None] + np.arange(3)[None, None]).reshape(E, 30).astype(np.int32)
    flat = elem_dofs.ravel()
    scatter_perm = np.argsort(flat, kind="stable").astype(np.int32)
    scatter_segids = flat[scatter_perm].astype(np.int32)

    # --- BCSR (node-block) sparsity from real (unpadded) elements
    ii = np.repeat(conn[:E0], 10, axis=1).ravel()
    jj = np.tile(conn[:E0], (1, 10)).ravel()
    keys = ii.astype(np.int64) * coords.shape[0] + jj
    uniq_keys = np.unique(keys)
    rows = (uniq_keys // coords.shape[0]).astype(np.int32)
    cols = (uniq_keys % coords.shape[0]).astype(np.int32)
    row_ptr = np.zeros(coords.shape[0] + 1, np.int32)
    np.add.at(row_ptr, rows + 1, 1)
    row_ptr = np.cumsum(row_ptr).astype(np.int32)
    slot_all = np.searchsorted(uniq_keys, keys).astype(np.int32)
    entry_map = slot_all.reshape(E0, 10, 10)
    if npad:  # ghosts all map to slot of (0,0) with zero contribution
        entry_map = np.concatenate([entry_map, np.zeros((npad, 10, 10), np.int32)])
    diag_keys = np.arange(coords.shape[0], dtype=np.int64) * (coords.shape[0] + 1)
    diag_slots = np.searchsorted(uniq_keys, diag_keys).astype(np.int32)

    return Mesh(
        coords=coords,
        conn=conn,
        mat_id=mat_id,
        materials=list(materials),
        Jinv=Jinv,
        detJ=detJ,
        wdet=wdet,
        elem_dofs=elem_dofs,
        scatter_perm=scatter_perm,
        scatter_segids=scatter_segids,
        row_ptr=row_ptr,
        col_idx=cols,
        rowids=rows,
        entry_map=entry_map,
        diag_slots=diag_slots,
        mass=mass,
        dashpot=dashpot,
        force_map=force_map,
        bottom=bottom,
        surface=surface,
        npad=npad,
    )
