"""k-set ensembles (the paper's 2SET) in the port against the reference, both
packages on the same numpy inputs (the reference in x64), on the config of
tests/test_campaign.py: (2,2,2 pad 4), nspring 12, npart 2, dt 0.01.

Tolerances:
- The stream helpers and ``StreamEngine(kset=k)`` are data movement: bitwise
  (a loop over the members, ``donate`` ≡ ``serial``); against the JAX
  engine, whose XLA arithmetic may fuse differently, 1e-13 relative.
- The k-set kernel entries (plain versions on the CPU) against the
  reference's oracles under ``jax.vmap``: 1e-13 (EBE, fp64) and 1e-12
  (multispring σ and D, fp64) relative to the maximum, flags exact (the
  kernels' tolerances of tests/test_torch_ebe.py and
  tests/test_torch_multispring.py).
- ``run_ensemble``, 2 waves, 4 steps: the CRS rungs within 1e-12·max|v| of
  the reference's ``run_ensemble`` at equal PCG iterations, Proposed 2
  within 1e-6·max|v| with outer iterations equal or one apart on a step
  whose relres lies within a factor of 2 of tol (tests/test_torch_proposed2.py);
  each lane within 1e-9·max|v| of the port's own ``run`` of that case
  (tests/test_campaign.py::test_run_ensemble_matches_run_all_methods).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import stream as ref_stream
from repro.core.hetmem import PartitionedState as RefPS
from repro.fem import meshgen as ref_meshgen, methods as ref_methods, multispring as ref_ms, spmv as ref_spmv
from repro_torch import convert
from repro_torch.core import hetmem
from repro_torch.core.hetmem import PartitionedState
from repro_torch.core.stream import (StreamEngine, StreamPlan, broadcast_kset, pad_kset, stack_kset,
                                     stack_kset_states, unstack_kset, unstack_kset_state)
from repro_torch.fem import backend, methods, multispring as ms, quadrature as quad
from repro_torch.kernels.ebe_matvec import ops as ebe_ops
from repro_torch.kernels.multispring import ops as ms_ops

KW = dict(dt=0.01, tol=1e-8, maxiter=600, npart=2, nspring=12)
CRS = ("baseline1", "baseline2", "proposed1")


def _waves(M, nt, seed=0):
    rng = np.random.default_rng(seed)
    w = np.zeros((M, nt, 3))
    w[:, :, 0] = 0.3 * rng.normal(size=(M, nt))
    return w


def _state(npart=3, chunk=4, width=5, seed=0, k=None):
    rng = np.random.default_rng(seed)
    lead = () if k is None else (k,)
    return PartitionedState(blocks=[
        [torch.tensor(rng.normal(size=(*lead, chunk, width))), torch.tensor(rng.normal(size=(*lead, chunk)))]
        for _ in range(npart)])


def _kernel(blk, scale):
    a, b = blk
    return [torch.tanh(a * scale) + 0.25 * a, b * scale + 1.0]


def _flat(state):
    return torch.cat([x.reshape(-1) for blk in state.blocks for x in blk])


# ---------------------------------------------------------------------------
# the stream engine and the k-set helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2, 3])
def test_kset_run_is_a_loop_over_members(k):
    """One pass of a k-set plan ≡ each member streamed alone, bitwise, with
    per-block inputs, collected extras and a k-set carry."""
    ps = _state(k=k)
    offs = [torch.tensor(float(j)) for j in range(3)]

    def fn(blk, h, off, scale):
        a, b = blk
        h = torch.tanh(h * scale + a.sum(-2)) + off
        return [a * scale + h[..., None, :1], b - off], h, b.sum(-1)

    h0 = torch.linspace(-1, 1, 5).expand(k, 5).clone()
    plan = StreamPlan(npart=3, kset=k, collect=True)
    res = StreamEngine(plan).run(fn, ps, per_block=(offs,), broadcast=(torch.tensor(0.5),), carry=h0)
    members = [StreamEngine(StreamPlan(npart=3, collect=True)).run(
        fn, m, per_block=(offs,), broadcast=(torch.tensor(0.5),), carry=h0[i])
        for i, m in enumerate(unstack_kset_state(_state(k=k), k))]
    assert torch.equal(_flat(res.state), _flat(stack_kset_states([m.state for m in members])))
    assert torch.equal(res.carry, torch.stack([m.carry for m in members]))
    for j in range(3):
        assert torch.equal(res.extras[j], torch.stack([m.extras[j] for m in members]))


@pytest.mark.parametrize("k", [2, 3])
def test_kset_engine_matches_jax_engine(k):
    """The port's k-set engine (the kernel sees the whole k-set block) and the
    JAX one (``vmap`` of a one-member kernel) on the same blocks."""
    blocks = [[np.asarray(x) for x in blk] for blk in _state(k=k).blocks]
    with jax.enable_x64(True):
        ref = ref_stream.StreamEngine(ref_stream.StreamPlan(npart=3, kset=k)).run(
            lambda blk, s: [jnp.tanh(blk[0] * s) + 0.25 * blk[0], blk[1] * s + 1.0],
            RefPS(blocks=[[jnp.asarray(x) for x in blk] for blk in blocks], spec=None),
            broadcast=(jnp.float64(0.7),))
        ref_flat = np.concatenate([np.asarray(x).reshape(-1) for blk in ref.state.blocks for x in blk])
    out = StreamEngine(StreamPlan(npart=3, kset=k)).run(
        _kernel, PartitionedState(blocks=[[torch.tensor(x) for x in blk] for blk in blocks]),
        broadcast=(torch.tensor(0.7, dtype=torch.float64),))
    np.testing.assert_allclose(_flat(out.state).numpy(), ref_flat, rtol=1e-13, atol=0)


@pytest.mark.parametrize("k", [None, 2])
def test_donate_bitwise_serial(k):
    scale = torch.tensor(0.7, dtype=torch.float64)
    kset = {} if k is None else {"kset": k}
    serial = StreamEngine(StreamPlan(npart=4, **kset)).run(_kernel, _state(npart=4, k=k), broadcast=(scale,))
    donate = StreamEngine(StreamPlan(npart=4, schedule="donate", **kset)).run(
        _kernel, _state(npart=4, k=k), broadcast=(scale,))
    assert torch.equal(_flat(serial.state), _flat(donate.state))


def test_device_buffer_accounting():
    assert StreamPlan(npart=8).device_buffers == 2
    assert StreamPlan(npart=8, schedule="donate").device_buffers == 2
    assert StreamPlan(npart=8, schedule="prefetch", prefetch=3).device_buffers == 4
    assert StreamPlan(npart=8, offload=False).device_buffers == 8


def test_kset_plan_refuses_blocks_without_the_axis():
    with pytest.raises(ValueError, match="stack_kset_states"):
        StreamEngine(StreamPlan(npart=3, kset=2)).run(_kernel, _state(k=3), broadcast=(torch.tensor(1.0),))
    with pytest.raises(ValueError, match="kset must be"):
        StreamPlan(npart=3, kset=0)
    with pytest.raises(ValueError, match="share the block partition"):
        stack_kset_states([_state(npart=3), _state(npart=2)])


def test_kmap_maps_a_one_member_function():
    x = torch.arange(12.0).reshape(3, 4)
    tree = {"a": torch.arange(3.0), "b": [torch.ones(3, 2)]}
    eng = StreamEngine(StreamPlan(npart=1, offload=False, kset=3))
    out = eng.kmap(lambda xi, t, s: {"y": xi * s + t["a"], "z": t["b"][0].sum()}, x, tree,
                   broadcast=(torch.tensor(2.0),))
    assert torch.equal(out["y"], x * 2.0 + torch.arange(3.0)[:, None])
    assert torch.equal(out["z"], torch.full((3,), 2.0))
    with pytest.raises(ValueError, match="leading axis"):
        eng.kmap(lambda xi: xi, torch.zeros(2, 4))
    with pytest.raises(ValueError, match="leading axis"):
        eng.kmap(lambda xi: xi, torch.tensor(1.0))


def test_kset_helpers_match_reference():
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    for mult in (4, 3, 2):
        ref_p, ref_v = ref_stream.pad_kset(a, mult)
        for arr in (a, torch.tensor(a)):
            p, v = pad_kset(arr, mult)
            assert type(p) is type(arr) and isinstance(v, np.ndarray)
            np.testing.assert_array_equal(np.asarray(p), ref_p)
            np.testing.assert_array_equal(v, ref_v)
    ref_p, _ = ref_stream.pad_kset(a, 3, axis=1)
    np.testing.assert_array_equal(pad_kset(torch.tensor(a), 3, axis=1)[0].numpy(), ref_p)
    with pytest.raises(ValueError):
        pad_kset(a[:0], 2)

    tree = {"x": np.arange(6.0).reshape(2, 3), "y": [np.ones(2, np.int32)]}
    ref_b = ref_stream.broadcast_kset(jax.tree_util.tree_map(jnp.asarray, tree), 3)
    b = broadcast_kset({"x": torch.tensor(tree["x"]), "y": [torch.tensor(tree["y"][0])]}, 3)
    np.testing.assert_array_equal(b["x"].numpy(), np.asarray(ref_b["x"]))
    np.testing.assert_array_equal(b["y"][0].numpy(), np.asarray(ref_b["y"][0]))
    b["x"][0] += 1.0  # materialised: one lane's in-place update stays in that lane
    assert torch.equal(b["x"][1], torch.tensor(tree["x"])) and b["x"].stride()[0] == 6

    members = [{"x": torch.tensor(tree["x"]) * i} for i in range(3)]
    stacked = stack_kset(members)
    ref_s = ref_stream.stack_kset([{"x": jnp.asarray(tree["x"]) * i} for i in range(3)])
    np.testing.assert_array_equal(stacked["x"].numpy(), np.asarray(ref_s["x"]))
    assert all(torch.equal(m["x"], u["x"]) for m, u in zip(members, unstack_kset(stacked, 3)))

    states = [_state(seed=i) for i in range(2)]
    with jax.enable_x64(True):
        ref_states = [RefPS(blocks=[[jnp.asarray(x.numpy()) for x in blk] for blk in s.blocks], spec=None)
                      for s in states]
        ref_ks = ref_stream.stack_kset_states(ref_states)
        ks = stack_kset_states(states)
        for blk, rblk in zip(ks.blocks, ref_ks.blocks):
            for x, rx in zip(blk, rblk):
                np.testing.assert_array_equal(x.numpy(), np.asarray(rx))
    for s, u in zip(states, unstack_kset_state(ks, 2)):
        assert torch.equal(_flat(s), _flat(u))


# ---------------------------------------------------------------------------
# the k-set kernel entries (plain versions on the CPU)
# ---------------------------------------------------------------------------


def test_ebe_kset_entry_matches_reference_oracle():
    m = ref_meshgen.generate(2, 2, 2, pad_elems_to=4)
    rng = np.random.default_rng(3)
    k, E, N = 3, m.n_elem, m.n_nodes
    x = rng.normal(size=(k, N, 3))
    Q = rng.normal(size=(k, E, quad.NPOINT, 6, 6))
    D = Q @ Q.swapaxes(-1, -2)
    coef = rng.uniform(0.5, 1.5, size=(k, E))
    with jax.enable_x64(True):
        ref = jax.vmap(lambda xi, Di, ci: ref_spmv.ebe_element_matvec(
            xi[jnp.asarray(m.conn)], Di, jnp.asarray(m.Jinv), jnp.asarray(m.wdet), ci))(
            jnp.asarray(x), jnp.asarray(D), jnp.asarray(coef))
        ref = np.asarray(ref)
    T = torch.tensor
    out = ebe_ops.element_kernel_kset(T(x), T(m.conn, dtype=torch.int32), T(D), T(m.Jinv), T(m.wdet), T(coef))
    assert out.shape == (k, E, 10, 3)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-13, atol=1e-13 * np.abs(ref).max())
    for i in range(k):  # the plain k-set version is the one-member plain version per member
        one = ebe_ops.element_kernel(T(x[i]), T(m.conn, dtype=torch.int32), T(D[i]), T(m.Jinv), T(m.wdet),
                                     T(coef[i]))
        assert torch.equal(out[i], one)


def test_multispring_kset_entry_matches_reference_oracle():
    rng = np.random.default_rng(7)
    k, P, S = 2, 29, 30
    raw = {key: rng.uniform(lo, hi, P) for key, (lo, hi) in
           dict(G0=(5e7, 5e8), gamma_r=(5e-4, 5e-3), beta=(0.7, 1.0), bulk=(1e8, 1e9)).items()}
    n, w = ms.spring_directions(S)
    with jax.enable_x64(True):
        p_ref = ref_ms.SpringParams(**{key: jnp.asarray(v) for key, v in raw.items()})
        st_ref = ref_stream.broadcast_kset(ref_ms.init_state(P, S, jnp.float64), k)
        upd = jax.vmap(lambda e, st: ref_ms.update(e, st, p_ref, jnp.asarray(n), jnp.asarray(w)))
        p_port = ms.SpringParams(**{key: torch.tensor(v) for key, v in raw.items()})
        st = broadcast_kset(ms.init_state(P, S, torch.float64, device="cpu"), k)
        eps = np.zeros((k, P, 6))
        for _ in range(4):
            eps = eps + rng.normal(scale=8e-4, size=(k, P, 6))
            sr, Dr, st_ref = upd(jnp.asarray(eps), st_ref)
            sp, Dp, st, frac = ms_ops.update_kset(torch.tensor(eps), st, p_port, torch.tensor(n), torch.tensor(w))
            for a, b in ((sp, sr), (Dp, Dr)):
                b = np.asarray(b)
                np.testing.assert_allclose(a.numpy(), b, rtol=1e-12, atol=1e-12 * np.abs(b).max())
            for key in ms.FLAG_KEYS:
                assert st[key].dtype == torch.int32
                np.testing.assert_array_equal(st[key].numpy(), np.asarray(st_ref[key]))
        assert frac.shape == (k, P)


# ---------------------------------------------------------------------------
# run_ensemble against the reference and against the port's own run
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def meshes():
    ref = ref_meshgen.generate(2, 2, 2, pad_elems_to=4)
    return ref, convert.mesh_from_arrays(ref)


@pytest.fixture(scope="module")
def ensembles(meshes):
    ref_mesh, mesh = meshes
    waves = _waves(2, 4)
    out = {}
    with jax.enable_x64(True):
        for m in methods.METHODS:
            ref = ref_methods.run_ensemble(ref_mesh, ref_methods.SeismicConfig(**KW), waves, method=m)
            out[m] = ({k: np.asarray(v) for k, v in ref.items()},
                      methods.run_ensemble(mesh, methods.SeismicConfig(**KW), waves, method=m, device="cpu"))
    return waves, out


def _close(out, ref, rel):
    out, ref = np.asarray(out), np.asarray(ref)
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(out, ref, rtol=0, atol=rel * np.abs(ref).max())


@pytest.mark.parametrize("method", methods.METHODS)
def test_run_ensemble_matches_reference(ensembles, method):
    _, runs = ensembles
    ref, out = runs[method]
    assert out["velocity_history"].shape == ref["velocity_history"].shape == (2, 4, 1, 3)
    assert out["iters"].shape == (2, 4) and bool(out["converged"].all())
    if method in CRS:
        _close(out["velocity_history"], ref["velocity_history"], 1e-12)
        np.testing.assert_array_equal(out["iters"].numpy(), ref["iters"])
    else:
        _close(out["velocity_history"], ref["velocity_history"], 1e-6)
        rel = out["relres"].numpy()
        for a, b, r in zip(out["iters"].numpy().ravel(), ref["iters"].ravel(), rel.ravel()):
            assert a == b or (abs(int(a) - int(b)) == 1 and KW["tol"] / 2 <= r <= 2 * KW["tol"])


@pytest.mark.parametrize("method", methods.METHODS)
def test_each_lane_matches_its_own_run(ensembles, meshes, method):
    waves, runs = ensembles
    _, mesh = meshes
    ens = runs[method][1]
    for i in range(waves.shape[0]):
        one = methods.run(mesh, methods.SeismicConfig(**KW), waves[i], method=method, device="cpu")
        _close(ens["velocity_history"][i], one["velocity_history"], 1e-9)
        assert ens["iters"][i].tolist() == one["iters"].tolist()


def test_ensemble_step_carry_types(meshes):
    """make_ensemble_step pairs each method's step with a k-set carry: θ in
    ``[k,chunk,S]`` blocks for Proposed 1, ``[k,P,S]`` resident otherwise
    (on the host for Baseline 2); every tensor leaf leads with k."""
    _, mesh = meshes
    cfg = methods.SeismicConfig(**KW)
    ops = backend.make_operators(mesh, cfg, device="cpu")
    k, P = 3, mesh.n_elem * quad.NPOINT
    for method in methods.METHODS:
        step, carry0 = methods.make_ensemble_step(ops, method, kset=k)
        springs = carry0[1]
        if method == "proposed1":
            assert isinstance(springs, hetmem.PartitionedState) and len(springs.blocks) == cfg.npart
            assert all(x.shape[:2] == (k, P // cfg.npart) for blk in springs.blocks for x in blk)
        else:
            assert isinstance(springs, dict) and all(v.shape == (k, P, cfg.nspring) for v in springs.values())
        assert all(x.shape[0] == k for x in (*carry0[0], carry0[2], carry0[3], carry0[4]))
        assert not step.theta_in_place
        carry, aux = step(carry0, torch.tensor(_waves(k, 1)[:, 0]))
        assert aux.iters.shape == aux.relres.shape == aux.converged.shape == (k,)
    with pytest.raises(KeyError):
        methods.make_ensemble_step(ops, "nonesuch", kset=2)


def test_ensemble_converged_flag_per_lane(meshes):
    """CGResult.converged per lane: a satisfied solve reports True, an
    iteration-starved one False (maxiter 1, tol 1e-14)."""
    _, mesh = meshes
    f = torch.tensor(_waves(2, 1)[:, 0])
    for kw, expect in ((KW, True), (dict(KW, maxiter=1, tol=1e-14), False)):
        ops = backend.make_operators(mesh, methods.SeismicConfig(**kw), device="cpu")
        step, carry = methods.make_ensemble_step(ops, "proposed2", kset=2)
        _, aux = step(carry, f)
        assert aux.converged.tolist() == [expect, expect]
        if expect:
            assert bool((aux.relres <= kw["tol"]).all())
        else:
            assert aux.iters.tolist() == [1, 1]
