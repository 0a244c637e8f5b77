"""Scenario catalog of the port: wave families, soil profiles and
observation grids as data (:mod:`repro_torch.scenario.catalog`).  The
planner, autotuner and scheduler of the JAX package are not ported yet."""
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
