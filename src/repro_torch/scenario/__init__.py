"""Scenario subsystem of the port: declarative catalog → sweep planner →
autotuner → elastic scheduler, on one device.

``catalog``   hashable :class:`Scenario` dataclasses (wave families, soil
              perturbations, observation grids) with stable signatures.
``planner``   sweep expansion, compile-signature grouping, plan manifest,
              group-by-group campaign execution.
``autotune``  per-group ``(method, npart, kset)`` via the pipeline cost
              model + optional on-device probe.
``scheduler`` elastic on-disk work queue over plan groups: leased jobs,
              expired-lease takeover, bounded retry, heartbeat watchdog.

Each is the port's copy of the JAX package's module of the same name:
manifests, queue files and tuned choices cross between the packages.
"""
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
    PlanRunResult,
    ScenarioResult,
    SweepSpec,
    expand,
    make_plan,
    manifest,
    run_group,
    run_plan,
    scenario_from_dict,
    sweep_from_json,
    write_manifest,
)
from repro_torch.scenario.autotune import TuneChoice, choose  # noqa: F401
from repro_torch.scenario.scheduler import (  # noqa: F401
    JobQueue,
    LeaseLost,
    QueueWatch,
    SchedulerConfig,
    WorkerSummary,
    queue_dir_for,
    run_worker,
)
