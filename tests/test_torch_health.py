"""Per-case numerical health of the port's k-sets and its fault injection,
against the reference (both packages on the same numpy inputs, the
reference in x64), on the config of tests/test_health.py: (2,2,2 pad 4),
nspring 12, npart 2, dt 0.01, 8 steps, Proposed 2.

The reference side composes the campaign's guarded k-set from public
functions only, as ``repro/campaign/runner.py`` does: ``jax.vmap`` of
``health.guard_step(step)`` over ``broadcast_kset(initial_guard_carry(
carry0), 3)`` in a ``lax.scan``.  A NaN in case 1's forcing at step 3
(``faults.nan_at_step``) must give the reference's health words and
nonconverged counts exactly; the siblings must be bitwise the port's clean
guarded run, and the clean guarded run bitwise the unguarded one.  The
same holds for Proposed 1 with θ offloaded (``offload=True``), whose guard
keeps θ in two host sets, and its tripped lane's θ stays as it was before
the trip.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import faults as ref_faults, health as ref_health
from repro.core.stream import broadcast_kset as ref_broadcast_kset
from repro.fem import backend as ref_backend, meshgen as ref_meshgen, methods as ref_methods
from repro_torch import convert
from repro_torch.core import faults, health
from repro_torch.fem import backend, methods

NT = 8
KW = dict(dt=0.01, tol=1e-8, maxiter=600, npart=2, nspring=12)


def _waves(M, nt=NT, seed=0):
    rng = np.random.default_rng(seed)
    w = np.zeros((M, nt, 3))
    w[:, :, 0] = 0.3 * rng.normal(size=(M, nt))
    return w


@pytest.fixture(scope="module")
def guarded():
    ref_mesh = ref_meshgen.generate(2, 2, 2, pad_elems_to=4)
    mesh = convert.mesh_from_arrays(ref_mesh)
    waves = _waves(3)
    poisoned = faults.nan_at_step(waves, 3, case=1)
    np.testing.assert_array_equal(poisoned, ref_faults.nan_at_step(waves, 3, case=1), strict=True)
    obs = ref_mesh.surface[:1]
    with jax.enable_x64(True):
        ops = ref_backend.make_operators(ref_mesh, ref_methods.SeismicConfig(**KW))
        step, carry0 = ref_methods.make_ensemble_step(ops, "proposed2")
        gstep = ref_health.guard_step(step)

        def body(c, f_t):
            c, aux = jax.vmap(gstep)(c, f_t)
            return c, (c[0][0].v[:, obs], aux.iters)

        hc = ref_broadcast_kset(ref_health.initial_guard_carry(carry0), 3)
        hc, (vel, iters) = jax.lax.scan(body, hc, jnp.swapaxes(jnp.asarray(poisoned), 0, 1))
        ref = {"health": np.asarray(hc[1]), "nonconverged": np.asarray(hc[2]),
               "iters": np.asarray(iters).T, "velocity_history": np.swapaxes(np.asarray(vel), 0, 1)}
    cfg = methods.SeismicConfig(**KW)
    cfg_g = dataclasses.replace(cfg, health=True)
    runs = {"bad": methods.run_ensemble(mesh, cfg_g, poisoned, observe=obs, device="cpu"),
            "clean": methods.run_ensemble(mesh, cfg_g, waves, observe=obs, device="cpu"),
            "plain": methods.run_ensemble(mesh, cfg, waves, observe=obs, device="cpu")}
    return ref, runs


def test_words_and_counts_match_reference(guarded):
    ref, runs = guarded
    bad = runs["bad"]
    assert bad["health"].dtype == torch.int32 and bad["health"].shape == (3,)
    np.testing.assert_array_equal(bad["health"].numpy(), ref["health"])
    np.testing.assert_array_equal(bad["nonconverged"].numpy(), ref["nonconverged"])
    np.testing.assert_array_equal(bad["iters"].numpy(), ref["iters"])
    assert health.diverged(bad["health"]).tolist() == [False, True, False]
    assert "solver_nonfinite" in health.describe(bad["health"][1])
    assert runs["clean"]["health"].tolist() == [0, 0, 0]


def test_siblings_are_bitwise_the_clean_run(guarded):
    _, runs = guarded
    for sib in (0, 2):
        assert torch.equal(runs["bad"]["velocity_history"][sib], runs["clean"]["velocity_history"][sib])
    # the frozen case's recorded output stays finite: NaN never enters the carry
    assert bool(torch.isfinite(runs["bad"]["velocity_history"]).all())
    assert torch.equal(runs["bad"]["velocity_history"][1, 3:], runs["bad"]["velocity_history"][1, 2:3].expand(5, -1, -1))


def test_guarded_equals_unguarded_when_healthy(guarded):
    ref, runs = guarded
    assert torch.equal(runs["clean"]["velocity_history"], runs["plain"]["velocity_history"])
    v = ref["velocity_history"][[0, 2]]
    np.testing.assert_allclose(runs["bad"]["velocity_history"][[0, 2]].numpy(), v, rtol=0,
                               atol=1e-6 * np.abs(v).max())


@pytest.fixture(scope="module")
def guarded_offloaded():
    """Proposed 1 with θ offloaded (``offload=True``), guarded: the reference's
    ``jax.vmap(guard_step(step))`` in a ``lax.scan`` against the port's
    guarded k-set on the CPU, whose θ alternates between two block sets.

    The reference's step is its ``offload=False`` form, whose arithmetic its
    ``offload=True`` form shares (the flag only places θ): on a JAX whose CPU
    runtime has a ``pinned_host`` memory, the reference's ``finite_all``
    refuses to combine a host-memory θ's checks with device ones."""
    ref_mesh = ref_meshgen.generate(2, 2, 2, pad_elems_to=4)
    mesh = convert.mesh_from_arrays(ref_mesh)
    waves = _waves(3)
    poisoned = faults.nan_at_step(waves, 3, case=1)
    obs = ref_mesh.surface[:1]
    with jax.enable_x64(True):
        ops = ref_backend.make_operators(ref_mesh, ref_methods.SeismicConfig(**KW))
        step, carry0 = ref_methods.make_ensemble_step(ops, "proposed1", offload=False)
        gstep = ref_health.guard_step(step)

        def body(c, f_t):
            c, aux = jax.vmap(gstep)(c, f_t)
            return c, (c[0][0].v[:, obs], aux.iters)

        hc = ref_broadcast_kset(ref_health.initial_guard_carry(carry0), 3)
        hc, (vel, iters) = jax.lax.scan(body, hc, jnp.swapaxes(jnp.asarray(poisoned), 0, 1))
        ref = {"health": np.asarray(hc[1]), "nonconverged": np.asarray(hc[2]),
               "iters": np.asarray(iters).T, "velocity_history": np.swapaxes(np.asarray(vel), 0, 1)}

    ops = backend.make_operators(mesh, methods.SeismicConfig(**KW), device="cpu")
    obs_t = torch.as_tensor(obs)

    def run(w, guarded):
        step, carry = methods.make_ensemble_step(ops, "proposed1", kset=3, offload=True)
        if guarded:
            step, carry = health.guard_step(step), health.initial_guard_carry(carry)
        vel, iters, theta_before_trip = [], [], None
        for t, f_t in enumerate(torch.tensor(w).unbind(1)):
            if t == 3 and guarded:  # lane 1's θ before the step its forcing is NaN
                theta_before_trip = [x[1].clone() for blk in carry[0][1].blocks for x in blk]
            carry, aux = step(carry, f_t)
            vel.append((carry[0][0] if guarded else carry[0]).v[:, obs_t])
            iters.append(aux.iters)
        return {"velocity_history": torch.stack(vel, dim=1), "iters": torch.stack(iters, dim=1), "carry": carry,
                "theta_before_trip": theta_before_trip}

    n = torch.get_num_threads()
    torch.set_num_threads(1)  # small tensors: intra-op threads would only wait on the other test workers
    try:
        return ref, {"bad": run(poisoned, True), "clean": run(waves, True), "plain": run(waves, False)}
    finally:
        torch.set_num_threads(n)


def test_guarded_offloaded_kset_matches_reference(guarded_offloaded):
    """guard_step over Proposed 1 with θ offloaded gives the reference's
    health words and counts; the siblings are bitwise the clean guarded
    run, and that run bitwise the unguarded offloaded one."""
    ref, runs = guarded_offloaded
    (_, word, ncg), clean = runs["bad"]["carry"], runs["clean"]["carry"]
    np.testing.assert_array_equal(word.numpy(), ref["health"])
    np.testing.assert_array_equal(ncg.numpy(), ref["nonconverged"])
    np.testing.assert_array_equal(runs["bad"]["iters"].numpy(), ref["iters"])
    assert health.diverged(word).tolist() == [False, True, False] and clean[1].tolist() == [0, 0, 0]
    bad_v = runs["bad"]["velocity_history"]
    for sib in (0, 2):
        assert torch.equal(bad_v[sib], runs["clean"]["velocity_history"][sib])
    assert bool(torch.isfinite(bad_v).all())
    assert torch.equal(runs["clean"]["velocity_history"], runs["plain"]["velocity_history"])
    v = ref["velocity_history"][[0, 2]]
    np.testing.assert_allclose(bad_v[[0, 2]].numpy(), v, rtol=0, atol=1e-6 * np.abs(v).max())


def test_guarded_offloaded_kset_freezes_theta(guarded_offloaded):
    """The tripped lane's θ is the θ it had before the trip, in both host
    sets; the siblings' θ is bitwise the clean run's."""
    _, runs = guarded_offloaded
    theta = runs["bad"]["carry"][0][1]
    assert theta.spare is not None and theta.frozen == (1,)
    for blocks in (theta.blocks, theta.spare):
        lane1 = [x[1] for blk in blocks for x in blk]
        assert all(torch.equal(x, y) for x, y in zip(lane1, runs["bad"]["theta_before_trip"]))
    clean = runs["clean"]["carry"][0][1]
    assert clean.frozen == () and all(
        torch.equal(x[i], y[i]) for b1, b2 in zip(theta.blocks, clean.blocks) for x, y in zip(b1, b2) for i in (0, 2))
    plain = runs["plain"]["carry"][1]
    assert plain.spare is None and all(
        torch.equal(x, y) for b1, b2 in zip(clean.blocks, plain.blocks) for x, y in zip(b1, b2))


# ---------------------------------------------------------------------------
# health word primitives over a k-set
# ---------------------------------------------------------------------------


def test_health_word_bits_and_describe():
    w = health.init_word(2)
    assert w.tolist() == [0, 0] and bool(health.is_live(w).all()) and not bool(health.diverged(w).any())
    w = w | torch.tensor([health.BIT_SOLVER_NONFINITE | health.BIT_NONCONVERGED, health.BIT_NONCONVERGED],
                         dtype=torch.int32)
    assert health.diverged(w).tolist() == [True, False] and health.is_live(w).tolist() == [False, True]
    assert health.describe(w[0]) == "solver_nonfinite+nonconverged"
    assert health.describe(0) == "healthy"
    for bit, name in ((health.BIT_CARRY_NONFINITE, "carry_nonfinite"),
                      (health.BIT_SPRINGS_NONFINITE, "springs_nonfinite")):
        assert health.describe(bit) == name == ref_health.describe(bit)
    assert health.FATAL == ref_health.FATAL


def test_finite_all_and_freeze_per_lane():
    old = {"a": torch.ones(3, 4), "i": torch.zeros(3, 2, dtype=torch.int32)}
    new = {"a": torch.full((3, 4), 2.0), "i": torch.ones(3, 2, dtype=torch.int32)}
    new["a"][1, 2] = float("nan")
    assert health.finite_all(new).tolist() == [True, False, True]  # int leaves skipped
    out = health.freeze(health.finite_all(new), new, old)
    assert out is new  # in place: only the tripped lane is written
    assert torch.equal(new["a"][1], old["a"][1]) and torch.equal(new["i"][1], old["i"][1])
    assert torch.equal(new["a"][0], torch.full((4,), 2.0)) and torch.equal(new["i"][2], torch.ones(2, dtype=torch.int32))


def test_update_word_folds_the_step():
    aux = methods.StepAux(iters=torch.tensor([3, 3, 600]), relres=torch.tensor([1e-9, float("nan"), 1e-3]),
                          converged=torch.tensor([True, False, False]))
    carry = (torch.ones(3, 2), {"s": torch.ones(3, 5)})
    carry[1]["s"][0, 0] = float("inf")
    word = health.update_word(health.init_word(3), carry, carry[1], aux)
    assert word.tolist() == [health.BIT_CARRY_NONFINITE | health.BIT_SPRINGS_NONFINITE,
                             health.BIT_SOLVER_NONFINITE | health.BIT_NONCONVERGED, health.BIT_NONCONVERGED]


def test_guard_step_counts_nonconverged_steps():
    ref_mesh = ref_meshgen.generate(1, 1, 1, pad_elems_to=2)
    mesh = convert.mesh_from_arrays(ref_mesh)
    ops = backend.make_operators(mesh, methods.SeismicConfig(**dict(KW, maxiter=1, tol=1e-14)), device="cpu")
    step, carry = methods.make_ensemble_step(ops, "baseline1", kset=2)
    gstep = health.guard_step(step)
    hc = health.initial_guard_carry(carry)
    for f in torch.tensor(_waves(2, 3)).unbind(1):
        hc, aux = gstep(hc, f)
    assert hc[1].tolist() == [health.BIT_NONCONVERGED] * 2 and hc[2].tolist() == [3, 3]


# ---------------------------------------------------------------------------
# fault-spec grammar + injectors (tests/test_health.py, against the port's copy)
# ---------------------------------------------------------------------------


def test_faults_parse_grammar():
    s = faults.parse("nan_at_step=5,case=1")
    assert s.kind == "nan_at_step" and s.value == 5 and s.get("case") == 1
    assert s == faults.FaultSpec(**dataclasses.asdict(ref_faults.parse("nan_at_step=5,case=1")))
    assert faults.parse(None) is None and faults.parse("") is None
    assert faults.parse("fail_infer_every_n=2,limit=3").get("limit") == 3
    with pytest.raises(ValueError, match="unknown fault kind"):
        faults.parse("meteor_strike=1")
    with pytest.raises(ValueError):
        faults.parse("nan_at_step")  # missing =value


def test_nan_at_step_bounds_and_purity():
    w = _waves(3)
    out = faults.nan_at_step(w, 2, case=1)
    assert np.isfinite(w).all()                     # input untouched
    assert np.isnan(out[1, 2]).all() and np.isfinite(out[0]).all()
    with pytest.raises(ValueError):
        faults.nan_at_step(w, NT + 7)
    with pytest.raises(ValueError):
        faults.nan_at_step(w, 0, case=99)


def test_corrupt_shard_byte_roundtrip(tmp_path):
    p = str(tmp_path / "blob.bin")
    with open(p, "wb") as f:
        f.write(bytes(range(16)))
    pos = faults.corrupt_shard_byte(p, offset=3, xor=0xFF)
    data = open(p, "rb").read()
    assert pos == 3 and data[3] == 3 ^ 0xFF and data[0] == 0
    faults.corrupt_shard_byte(p, offset=3, xor=0xFF)  # XOR is its own inverse
    assert open(p, "rb").read() == bytes(range(16))
    assert faults.corrupt_shard_byte(p, offset=-1) == 15
    with pytest.raises(ValueError):
        faults.corrupt_shard_byte(p, offset=0, xor=0)


def test_faulty_engine_schedule_and_signature():
    class Ok:
        def warmup(self):
            pass

        def signature(self):
            return "ok-v1"

        def infer(self, x):
            return x

    eng = faults.wrap_engine(faults.parse("fail_infer_every_n=2,limit=1"), Ok())
    assert "+fault:fail_infer_every_n=2,limit=1" in eng.signature()
    assert eng.infer(1) == 1                        # call 1: passes
    with pytest.raises(RuntimeError, match="injected engine failure"):
        eng.infer(2)                                # call 2: fails
    assert eng.infer(3) == 3 and eng.infer(4) == 4  # limit=1 exhausted
    with pytest.raises(ValueError):
        faults.wrap_engine(faults.parse("nan_at_step=1"), Ok())
    with pytest.raises(ValueError):
        faults.apply_wave_fault(faults.parse("fail_infer_every_n=1"), _waves(1))
    assert np.isnan(faults.apply_wave_fault(faults.parse("nan_at_step=1,case=0"), _waves(1))[0, 1]).all()
