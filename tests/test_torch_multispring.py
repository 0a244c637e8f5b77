"""Port parity of the multi-spring constitutive update: the port's plain
torch ``update`` against the reference oracle (``repro.fem.multispring``)
and the reference Pallas kernel in interpret mode, on the 6-step random
strain path of ``tests/test_kernels.py``.

Tolerances (relative to the maximum): σ and D 1e-12 in fp64 and 3e-5 in
fp32 (sums over springs in another order); flags exactly equal and int32;
damping fraction rtol 1e-4, atol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fem import multispring as ref_ms
from repro.kernels.multispring import multispring_pallas
from repro_torch.fem import multispring as ms
from repro_torch.kernels.multispring import ops as ms_ops

DTYPES = [(np.float32, 3e-5), (np.float64, 1e-12)]


def _params(rng, P):
    return {k: rng.uniform(lo, hi, P) for k, (lo, hi) in
            dict(G0=(5e7, 5e8), gamma_r=(5e-4, 5e-3), beta=(0.7, 1.0), bulk=(1e8, 1e9)).items()}


def _close(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol * float(np.abs(b).max()))


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("nspring", [30, 150])
def test_update_path_matches_oracle_and_pallas(dtype, tol, nspring):
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    with jax.enable_x64(dtype == np.float64):
        rng = np.random.default_rng(7)
        P = 29
        raw = _params(rng, P)
        p_ref = ref_ms.SpringParams(**{k: jnp.asarray(v, dtype) for k, v in raw.items()})
        p_port = ms.SpringParams(**{k: torch.tensor(v, dtype=tdt) for k, v in raw.items()})
        n, w = ref_ms.spring_directions(nspring)
        n_port, w_port = ms.spring_directions(nspring)
        np.testing.assert_array_equal(n, n_port)
        np.testing.assert_array_equal(w, w_port)
        n_j, w_j = jnp.asarray(n, dtype), jnp.asarray(w, dtype)
        n_t, w_t = torch.tensor(n, dtype=tdt), torch.tensor(w, dtype=tdt)
        st_ref = ref_ms.init_state(P, nspring, dtype)
        st_pal = dict(st_ref)
        st_port = ms.init_state(P, nspring, tdt, device="cpu")
        eps = np.zeros((P, 6), dtype)
        for _ in range(6):
            eps = eps + rng.normal(scale=8e-4, size=(P, 6)).astype(dtype)
            sr, Dr, st_ref = ref_ms.update(jnp.asarray(eps), st_ref, p_ref, n_j, w_j)
            sp, Dp, st_pal, fp = multispring_pallas(jnp.asarray(eps), st_pal, p_ref, n_j, w_j, tile_p=16)
            st_, Dt, st_port, ft = ms_ops.update(torch.tensor(eps), st_port, p_port, n_t, w_t)
            for ref in ((sr, Dr), (sp, Dp)):
                _close(st_.numpy(), ref[0], tol)
                _close(Dt.numpy(), ref[1], tol)
            for key in ms.FLAG_KEYS:
                assert st_port[key].dtype == torch.int32
                np.testing.assert_array_equal(st_port[key].numpy(), np.asarray(st_ref[key]))
                np.testing.assert_array_equal(st_port[key].numpy(), np.asarray(st_pal[key]))
            for key in ms.STATE_KEYS[:4]:
                assert st_port[key].dtype == tdt
                _close(st_port[key].numpy(), np.asarray(st_ref[key]), tol)
        fr = ref_ms.hysteretic_damping(st_ref, p_ref)
        np.testing.assert_allclose(ft.numpy(), np.asarray(fr), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(ft.numpy(), np.asarray(fp), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("g_min_frac", [0.05, 0.3])
def test_tangent_floor_follows_g_min_frac(g_min_frac):
    """The port takes the floor from ``params.g_min_frac`` like the oracle
    (the Pallas kernel hard-codes 1e-3·G0): pinned to the oracle at a
    non-default value, where the floor is active."""
    with jax.enable_x64(True):
        rng = np.random.default_rng(3)
        P, S = 17, 30
        raw = _params(rng, P)
        p_ref = ref_ms.SpringParams(**{k: jnp.asarray(v) for k, v in raw.items()}, g_min_frac=g_min_frac)
        p_port = ms.SpringParams(**{k: torch.tensor(v) for k, v in raw.items()}, g_min_frac=g_min_frac)
        p_default = ms.SpringParams(**{k: torch.tensor(v) for k, v in raw.items()})
        n, w = ms.spring_directions(S)
        st_ref = ref_ms.init_state(P, S)
        st_port, st_def = ms.init_state(P, S, device="cpu"), ms.init_state(P, S, device="cpu")
        eps = np.zeros((P, 6))
        for _ in range(4):
            eps = eps + rng.normal(scale=3e-3, size=(P, 6))
            _, Dr, st_ref = ref_ms.update(jnp.asarray(eps), st_ref, p_ref, jnp.asarray(n), jnp.asarray(w))
            _, Dt, st_port = ms.update(torch.tensor(eps), st_port, p_port, torch.tensor(n), torch.tensor(w))
            _, Dd, st_def = ms.update(torch.tensor(eps), st_def, p_default, torch.tensor(n), torch.tensor(w))
            _close(Dt.numpy(), np.asarray(Dr), 1e-12)
        assert float((Dt - Dd).abs().max()) > 1e-3 * float(Dd.abs().max())  # the floor bites


def test_state_is_40_bytes_per_spring():
    st = ms.init_state(5, 12, torch.float64, device="cpu")
    assert ms.state_bytes_per_spring(st) == 40
    assert [st[k].dtype for k in ms.STATE_KEYS] == [torch.float64] * 4 + [torch.int32] * 2
    assert ms.state_bytes_per_spring(st) == ref_ms.state_bytes_per_spring(
        {k: np.asarray(v) for k, v in st.items()})


@pytest.mark.parametrize("seed,beta", [(0, 0.7), (1, 0.85), (2, 1.0)])
def test_tangent_matches_finite_difference_and_is_psd(seed, beta):
    """Invariants of tests/test_multispring.py on the port: the returned
    tangent is the derivative of σ along the continuing strain path (Masing
    tangents are direction-dependent), and it is symmetric PSD."""
    p = ms.SpringParams(*(torch.full((1,), v, dtype=torch.float64) for v in (1e8, 1e-3, beta, 2e8)))
    n, w = (torch.tensor(a) for a in ms.spring_directions(12))
    rng = np.random.default_rng(seed)
    st = ms.init_state(1, 12, device="cpu")
    eps = torch.zeros((1, 6), dtype=torch.float64)
    for _ in range(5):
        step = rng.normal(scale=4e-4, size=(1, 6))
        eps = eps + torch.tensor(step)
        _, _, st = ms.update(eps, st, p, n, w)
    direction = torch.tensor(step[0] / np.linalg.norm(step))
    h = 1e-9
    sig0, D, _ = ms.update(eps, st, p, n, w)
    sig1, _, _ = ms.update(eps + h * direction[None], st, p, n, w)
    fd = ((sig1 - sig0)[0] / h).numpy()
    an = (D[0] @ direction).numpy()
    np.testing.assert_allclose(fd, an, rtol=5e-4, atol=1e-3 * np.abs(an).max())
    Dm = D[0].numpy()
    np.testing.assert_allclose(Dm, Dm.T, rtol=1e-10)
    assert np.linalg.eigvalsh(Dm).min() > 0
