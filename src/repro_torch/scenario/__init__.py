"""Scenario subsystem of the port: the catalog (wave families, soil
profiles and observation grids as data, :mod:`repro_torch.scenario.catalog`)
and the planner's declarative half (sweep expansion, compile-key grouping,
plan manifests, :mod:`repro_torch.scenario.planner`).  The planner's
campaign execution, the autotuner and the scheduler of the JAX package are
not ported yet."""
from repro_torch.scenario.catalog import (  # noqa: F401
    CATALOG,
    WAVE_FAMILIES,
    ObsSpec,
    Scenario,
    SoilSpec,
    WaveSpec,
    cosine_taper,
    get,
)
from repro_torch.scenario.planner import (  # noqa: F401
    Plan,
    PlanGroup,
    SweepSpec,
    expand,
    make_plan,
    manifest,
    scenario_from_dict,
    sweep_from_json,
)
