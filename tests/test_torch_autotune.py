"""The port's autotuner (``repro_torch.scenario.autotune``) against the JAX
package's, on the reference tests' sizes (mesh (2, 2, 2), nspring 12) and
a few others: ``spring_state_bytes``, ``candidate_nparts``, the model's
scored list, the probe shortlist and ``choose(probe=False)`` are pure
arithmetic and are held *exactly* equal (tolerance 0) — over budgets
(one that forces streaming, one that fits nothing), ``n_cases`` values,
and with and without a kernel calibration table.  The probe is
wall-clock, so ``choose(probe=True)`` on the CPU is held to its
structure: a shortlisted candidate, ``source == "probe"``, a positive
measured time."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.scenario import autotune as ref_at
from repro.scenario.catalog import Scenario as RefScenario
from repro_torch.scenario import autotune as at
from repro_torch.scenario.catalog import Scenario

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CALIBRATION = os.path.join(REPO, "BENCH_kernels.json")
SHAPES = [dict(mesh_n=(2, 2, 2), nspring=12), dict(mesh_n=(3, 2, 2), nspring=30), dict(mesh_n=(2, 2, 1), nspring=150)]


def _pair(shape, dtype="float64"):
    """(port mesh, port cfg, reference mesh, reference cfg) of one scenario."""
    scn, rscn = Scenario(**shape), RefScenario(**shape)
    cfg = dataclasses.replace(scn.sim_config(), dtype=getattr(torch, dtype))
    rcfg = dataclasses.replace(rscn.sim_config(), dtype=getattr(jnp, dtype))
    return scn.build_mesh(), cfg, rscn.build_mesh(), rcfg


def test_tune_choice_fields_are_the_reference_fields():
    assert [f.name for f in dataclasses.fields(at.TuneChoice)] == \
        [f.name for f in dataclasses.fields(ref_at.TuneChoice)]
    assert at.TuneChoice("proposed2", 1, 2) == at.TuneChoice(**dataclasses.asdict(ref_at.TuneChoice("proposed2", 1, 2)))
    for name in ("MODEL_FLOPS", "MS_FLOPS_PER_SPRING", "MATVEC_FLOPS_PER_ELEM", "SOLVER_ITERS",
                 "CRS_ASSEMBLY_FACTOR", "EBE_MATVEC_FACTOR", "EBE_PRECOND_ITERS", "KSET_COMPUTE_MARGINAL",
                 "DEFAULT_LINK_GBPS", "DEFAULT_DEVICE_GB"):
        assert getattr(at, name) == getattr(ref_at, name), name


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("shape", SHAPES)
def test_state_bytes_and_nparts_equal_reference(shape, dtype):
    with jax.enable_x64(True):
        mesh, cfg, rmesh, rcfg = _pair(shape, dtype)
        assert at.spring_state_bytes(mesh, cfg) == ref_at.spring_state_bytes(rmesh, rcfg)
    npts = mesh.n_elem * 4
    for cap in (1, 4, 8, 12):
        assert at.candidate_nparts(npts, cap) == ref_at.candidate_nparts(npts, cap)
    assert at.candidate_nparts(192, cap=8) == [1, 2, 3, 4, 6, 8]


def test_state_bytes_at_full_size():
    """The paper's site size: (64, 64, 12) → 294,912 elements, 150 springs,
    fp64: θ is 7,077,888,000 B a case (counted, no mesh built)."""
    mesh = type("M", (), {"n_elem": 294_912})()
    cfg = Scenario(nspring=150).sim_config()
    assert at.spring_state_bytes(mesh, cfg) == 7_077_888_000


@pytest.mark.parametrize("calibrated", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_model_scores_shortlist_and_choice_equal_reference(shape, calibrated):
    cal = CALIBRATION if calibrated else None
    with jax.enable_x64(True):
        mesh, cfg, rmesh, rcfg = _pair(shape)
        state = at.spring_state_bytes(mesh, cfg)
        budgets = [ref_at.DEFAULT_DEVICE_GB, 0.9 * state / 1e9, 1e-9, 70.0]
        for n_cases in (1, 2, 5, 8):
            for gb in budgets:
                kw = dict(n_cases=n_cases, n_devices=1, methods=("proposed2", "proposed1", "baseline1", "baseline2"),
                          kset_cap=4, npart_cap=8, link_gbps=900.0, device_budget_bytes=gb * 1e9)
                got = list(at._model_scores(mesh, cfg, **kw, calibration=at.pipeline.load_kernel_calibration(cal)))
                want = list(ref_at._model_scores(rmesh, rcfg, **kw,
                                                 calibration=ref_at.pipeline.load_kernel_calibration(cal)))
                assert got == want
                ranked = sorted(got, key=lambda c: (c[0], c[1], c[2], c[3]))
                for top in (1, 2, 3):
                    assert at._probe_shortlist(ranked, top) == ref_at._probe_shortlist(ranked, top)
                if gb == 1e-9:
                    with pytest.raises(ValueError, match="no .* candidate fits"):
                        at.choose(mesh, cfg, n_cases=n_cases, device_gb=gb, calibration=cal)
                    continue
                a = at.choose(mesh, cfg, n_cases=n_cases, device_gb=gb, calibration=cal)
                b = ref_at.choose(rmesh, rcfg, n_cases=n_cases, device_gb=gb, calibration=cal)
                assert dataclasses.asdict(a) == dataclasses.asdict(b)
                assert a.source == "model" and a.calibration == ("jnp" if calibrated else None)


def test_memory_pressure_switches_to_streaming():
    """tests/test_scenario.py's budget below one resident member: both
    packages stream (Proposed 1, npart > 1)."""
    with jax.enable_x64(True):
        mesh, cfg, rmesh, rcfg = _pair(SHAPES[0])
        gb = 0.9 * at.spring_state_bytes(mesh, cfg) / 1e9
        a = at.choose(mesh, cfg, n_cases=8, device_gb=gb)
        assert a == at.TuneChoice(**dataclasses.asdict(ref_at.choose(rmesh, rcfg, n_cases=8, device_gb=gb)))
    assert a.method == "proposed1" and a.npart > 1
    assert at.choose(mesh, cfg, n_cases=8).method == "proposed2"


def test_probe_on_the_cpu_returns_a_shortlisted_candidate():
    scn = Scenario(mesh_n=(2, 2, 2), n_cases=2, nt=4)
    mesh, cfg = scn.build_mesh(), scn.sim_config()
    kw = dict(n_cases=2, probe_steps=2, waves=scn.waves(), obs=scn.obs.indices(mesh))
    ch = at.choose(mesh, cfg, probe=True, device="cpu", **kw)
    scored = sorted(at._model_scores(mesh, cfg, n_cases=2, n_devices=1, methods=("proposed2", "proposed1"),
                                     kset_cap=4, npart_cap=8, link_gbps=at.DEFAULT_LINK_GBPS,
                                     device_budget_bytes=at.DEFAULT_DEVICE_GB * 1e9),
                    key=lambda c: (c[0], c[1], c[2], c[3]))
    short = at._probe_shortlist(scored, 2)
    assert {c[1] for c in short} == {"proposed2", "proposed1"}
    assert (ch.modeled_case_s, ch.method, ch.npart, ch.kset) in short
    assert ch.source == "probe" and ch.probed_case_s > 0 and ch.considered == len(scored)
    with pytest.raises(ValueError, match="probe"):
        at.choose(mesh, cfg, n_cases=2, probe=True, device="cpu")
