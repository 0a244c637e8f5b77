"""Sweep planner: expand a declarative sweep into compile-grouped campaigns.

The port's copy of the JAX package's ``scenario/planner.py``, so both
packages give the same scenario names, signatures, group keys, tuned
choices and manifests.

A :class:`SweepSpec` names a base :class:`~repro_torch.scenario.catalog.
Scenario` plus sweep *axes* — dotted field paths into the scenario with the
values to try (``"wave.family"``, ``"soil.vs"``, ``"obs.grid"``,
``"seed"``, …).  The planner expands the axes (full grid, or a seeded
random sample of it) into concrete scenarios and groups them by
:meth:`Scenario.compile_key`: scenarios that share a mesh + physics +
output shape differ only in *data*, so one campaign (one set of
operators) serves the whole group.

:func:`run_plan` executes a plan group-by-group through
:func:`repro_torch.campaign.run_campaign` on one device: each group
concatenates its scenarios' waves along the case axis, runs them as one
campaign (optionally autotuned — :mod:`repro_torch.scenario.autotune`
picks ``method``/``npart``/``kset`` per group), checkpoints under
``ckpt_dir/group_<key>/`` with the group's scenario signature threaded
into the campaign signature (resume under a *changed* scenario is
refused), and splits the results back per scenario.  :func:`write_manifest`
records the whole plan — scenarios, signatures, case ranges, tuned
choices, throughput — as JSON next to the checkpoint dir.
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
import os
import re
import time
import uuid
from typing import Any, Optional

import numpy as np

from repro_torch.kernels.ebe_matvec.ebe_matvec import TILE_E
from repro_torch.kernels.multispring.multispring import TILE_P
from repro_torch.scenario.catalog import ObsSpec, Scenario, SoilSpec, WaveSpec

_SUBSPECS = {"wave": WaveSpec, "soil": SoilSpec, "obs": ObsSpec}


# ---------------------------------------------------------------------------
# sweep specification
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """``base`` scenario + ``axes`` of (dotted path, values to sweep).

    ``samples = 0`` expands the full grid; ``samples > 0`` draws that many
    distinct grid points with the seeded RNG (deterministic subsample for
    very large grids).
    """

    base: Scenario = Scenario()
    axes: tuple = ()  # ((path, (v0, v1, ...)), ...)
    samples: int = 0
    seed: int = 0

    def __post_init__(self):
        axes = tuple((str(p), tuple(vs)) for p, vs in self.axes)
        object.__setattr__(self, "axes", axes)
        for p, vs in axes:
            if not vs:
                raise ValueError(f"sweep axis {p!r} has no values")
        if self.samples < 0:
            raise ValueError(f"samples must be ≥ 0, got {self.samples}")


def scenario_from_dict(d: dict[str, Any], base: Scenario = Scenario()) -> Scenario:
    """Overlay a (possibly nested) dict onto ``base`` — the JSON spec form."""
    kw: dict[str, Any] = {}
    for k, v in d.items():
        if k in _SUBSPECS:
            sub = dataclasses.replace(getattr(base, k), **v) if isinstance(v, dict) else v
            kw[k] = sub
        else:
            kw[k] = tuple(v) if isinstance(v, list) else v
    try:
        return dataclasses.replace(base, **kw)
    except TypeError as e:
        raise ValueError(f"bad scenario field in sweep spec: {e}") from None


def sweep_from_json(spec: str) -> SweepSpec:
    """Parse a sweep spec from a JSON file path or an inline JSON string::

        {"base": {"n_cases": 4, "nt": 16, "mesh_n": [2, 2, 2]},
         "axes": {"wave.family": ["band_noise", "ricker"],
                  "soil.vs": [[1.0, 1.0], [0.8, 1.0]]},
         "samples": 0, "seed": 0}
    """
    if os.path.exists(spec):
        with open(spec) as f:
            d = json.load(f)
    else:
        try:
            d = json.loads(spec)
        except json.JSONDecodeError as e:
            raise ValueError(
                f"--sweep is neither an existing file nor valid inline JSON: {e}"
            ) from None
    base = scenario_from_dict(d.get("base", {}))
    axes = tuple(sorted(d.get("axes", {}).items()))
    return SweepSpec(
        base=base, axes=axes,
        samples=int(d.get("samples", 0)), seed=int(d.get("seed", 0)),
    )


def _replace_path(scn: Scenario, path: str, value: Any) -> Scenario:
    parts = path.split(".")
    if isinstance(value, list):
        value = tuple(value)
    try:
        if len(parts) == 1:
            return dataclasses.replace(scn, **{parts[0]: value})
        if len(parts) == 2:
            sub = dataclasses.replace(getattr(scn, parts[0]), **{parts[1]: value})
            return dataclasses.replace(scn, **{parts[0]: sub})
    except (TypeError, AttributeError) as e:
        raise ValueError(f"unknown sweep axis {path!r}: {e}") from None
    raise ValueError(f"sweep axis path {path!r} nests too deep (max spec.field)")


def _slug(path: str, value: Any) -> str:
    leaf = path.split(".")[-1]
    if isinstance(value, (tuple, list)):
        v = "x".join(str(x) for x in value)
    else:
        v = str(value)
    return re.sub(r"[^A-Za-z0-9.x_-]+", "-", f"{leaf}-{v}")


def expand(spec: SweepSpec) -> list[Scenario]:
    """Expanded scenario list — full grid or the seeded ``samples`` subset.

    Names are derived from the base name + per-axis slugs and are unique
    within the sweep (they become dataset-shard directory names)."""
    if not spec.axes:
        return [spec.base]
    paths = [p for p, _ in spec.axes]
    grids = [vs for _, vs in spec.axes]
    combos = list(itertools.product(*grids))
    if spec.samples and spec.samples < len(combos):
        rng = np.random.default_rng(spec.seed)
        pick = sorted(rng.permutation(len(combos))[: spec.samples].tolist())
        combos = [combos[i] for i in pick]
    out, seen = [], set()
    for combo in combos:
        scn = spec.base
        for path, value in zip(paths, combo):
            scn = _replace_path(scn, path, value)
        name = "_".join([spec.base.name] + [_slug(p, v) for p, v in zip(paths, combo)])
        while name in seen:  # duplicate combos get an explicit suffix
            name += "+"
        seen.add(name)
        out.append(dataclasses.replace(scn, name=name))
    return out


# ---------------------------------------------------------------------------
# plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PlanGroup:
    """Scenarios sharing one compile key → one campaign."""

    key: str                       # Scenario.compile_key() of every member
    scenarios: list[Scenario]
    choice: Any = None             # autotune.TuneChoice once tuned

    @property
    def n_cases(self) -> int:
        return sum(s.n_cases for s in self.scenarios)

    def case_slices(self) -> list[tuple[int, int]]:
        """[lo, hi) rows of the group's concatenated wave array, per scenario."""
        out, lo = [], 0
        for s in self.scenarios:
            out.append((lo, lo + s.n_cases))
            lo += s.n_cases
        return out

    def signature(self) -> str:
        """Group identity threaded into the campaign checkpoint signature:
        covers every member scenario (order + full physics hash), so a
        checkpoint resumes only under the exact same scenario group."""
        blob = json.dumps([self.key] + [s.signature() for s in self.scenarios])
        return hashlib.sha256(blob.encode()).hexdigest()[:16]


@dataclasses.dataclass
class Plan:
    groups: list[PlanGroup]
    spec: Optional[SweepSpec] = None

    @property
    def n_scenarios(self) -> int:
        return sum(len(g.scenarios) for g in self.groups)

    @property
    def n_cases(self) -> int:
        return sum(g.n_cases for g in self.groups)


def make_plan(spec_or_scenarios) -> Plan:
    """Group scenarios by compile key, preserving first-appearance order."""
    if isinstance(spec_or_scenarios, SweepSpec):
        spec, scenarios = spec_or_scenarios, expand(spec_or_scenarios)
    else:
        spec, scenarios = None, list(spec_or_scenarios)
    groups: dict[str, PlanGroup] = {}
    for s in scenarios:
        key = s.compile_key()
        if key not in groups:
            groups[key] = PlanGroup(key=key, scenarios=[])
        groups[key].scenarios.append(s)
    return Plan(groups=list(groups.values()), spec=spec)


def manifest(plan: Plan, results: Optional[dict] = None) -> dict:
    """JSON-able record of the plan (+ per-group run stats when available)."""
    results = results or {}
    out: dict[str, Any] = {
        "plan": "scenario-sweep",
        "n_scenarios": plan.n_scenarios,
        "n_cases": plan.n_cases,
        "groups": [],
    }
    if plan.spec is not None:
        out["sweep"] = {
            "axes": {p: list(vs) for p, vs in plan.spec.axes},
            "samples": plan.spec.samples,
            "seed": plan.spec.seed,
        }
    for g in plan.groups:
        entry: dict[str, Any] = {
            "key": g.key,
            "signature": g.signature(),
            "n_cases": g.n_cases,
            "scenarios": [
                {
                    "name": s.name,
                    "signature": s.signature(),
                    "wave_family": s.wave.family,
                    "cases": list(sl),
                }
                for s, sl in zip(g.scenarios, g.case_slices())
            ],
        }
        if g.choice is not None:
            entry["choice"] = dataclasses.asdict(g.choice)
        if g.key in results:
            entry.update(results[g.key])
        out["groups"].append(entry)
    return out


def _prior_choices(manifest_path: Optional[str]) -> dict:
    """``{group signature → TuneChoice}`` recorded by a previous run of the
    same plan (by either package), keyed by signature so a *changed* group
    never inherits."""
    if not manifest_path or not os.path.exists(manifest_path):
        return {}
    from repro_torch.scenario.autotune import TuneChoice

    with open(manifest_path) as f:
        m = json.load(f)
    out = {}
    for g in m.get("groups", []):
        if "choice" in g and "signature" in g:
            out[g["signature"]] = TuneChoice(**g["choice"])
    return out


def write_manifest(plan: Plan, path: str, results: Optional[dict] = None) -> str:
    """Write the plan manifest atomically.  Queue workers of one plan each
    write it as groups settle, so every writer stages into a file of its own
    (the reference's one shared ``.tmp`` name lets one worker's replace move
    another's staged file away, which then fails)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{uuid.uuid4().hex[:8]}.tmp"
    with open(tmp, "w") as f:
        json.dump(manifest(plan, results), f, indent=2)
    os.replace(tmp, path)
    return path


# ---------------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ScenarioResult:
    scenario: Scenario
    waves: np.ndarray        # [n, nt, 3]
    responses: np.ndarray    # [n, nt, n_obs, 3]
    shard_dir: Optional[str] = None


@dataclasses.dataclass
class PlanRunResult:
    plan: Plan
    scenarios: dict[str, ScenarioResult]
    group_stats: dict[str, dict]
    manifest_path: Optional[str] = None


def run_group(
    group: PlanGroup,
    *,
    autotune: bool = False,
    probe: bool = False,
    method: str = "proposed2",
    npart: int = 2,
    kset: int = 2,
    tol: float = 1e-6,
    maxiter: int = 400,
    backend: str = "auto",
    ebe_backend: str = "",
    ms_backend: str = "",
    tile_e: int = TILE_E,
    tile_p: int = TILE_P,
    warm_start: bool = False,
    precond_every: int = 1,
    health: bool = True,
    calibration=None,
    device=None,
    device_mesh=None,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 0,
    out_dir: Optional[str] = None,
    shard_size: int = 16,
    stop_after_steps: Optional[int] = None,
    prior: Optional[dict] = None,
    log=None,
    label: str = "",
) -> tuple[dict[str, ScenarioResult], dict]:
    """Execute ONE plan group as a campaign on ``device`` (``None``: the
    card) → (results, stats).

    The unit of work both :func:`run_plan` (serial) and the elastic queue
    (:func:`repro_torch.scenario.scheduler.run_worker`) execute — any
    process holding the group's lease produces the identical campaign: the
    tuned choice comes from ``prior`` (keyed by group signature) when
    recorded, checkpoints land under ``ckpt_dir/group_<key>/`` carrying the
    group signature (kill-and-resume is bitwise; a changed sweep is
    refused), and shards land in ``out_dir/<scenario>/`` committed
    atomically by ``save_shards``.  ``stats["completed"]`` is False when
    ``stop_after_steps`` checkpoint-stopped the campaign mid-group.

    ``health=True`` (default) runs the campaign with the per-case health
    word (:mod:`repro_torch.core.health`): diverged cases are frozen
    in-flight, **excluded from shard output**, and recorded in
    ``stats["health"]["diverged"]`` — the planner manifest's quarantine
    record, which the elastic scheduler's quarantine round consumes.
    ``device_mesh`` is ``None`` (one device) or a case mesh
    (``launch.mesh.make_case_mesh()``): rounds of ``kset × entries``, each
    entry of this process in a host thread of its own, and under several
    processes each process runs its slice of the group's cases.  Shards are
    refused over several processes: every process would write the same
    ``out_dir/<scenario>/``.
    """
    from repro_torch.campaign import CampaignConfig, case_topology, run_campaign
    from repro_torch.scenario import autotune as _autotune

    topo = case_topology(device_mesh, 1)
    if out_dir and topo.process_count > 1:
        raise ValueError(f"run_group over {topo.process_count} processes with out_dir: every process would "
                         f"write the same {out_dir}/<scenario>/ shards; run one process, or pass no out_dir")
    n_devices = topo.n_dev
    log = log or (lambda msg: None)
    prior = prior or {}
    knobs = dict(backend=backend, ebe_backend=ebe_backend, ms_backend=ms_backend,
                 tile_e=tile_e, tile_p=tile_p, warm_start=warm_start, precond_every=precond_every)
    ref = group.scenarios[0]
    mesh = ref.build_mesh()
    waves = np.concatenate([s.waves() for s in group.scenarios], axis=0)
    obs = ref.obs.indices(mesh)
    if autotune and group.signature() in prior:
        group.choice = prior[group.signature()]
    elif autotune:
        group.choice = _autotune.choose(
            mesh, ref.sim_config(npart=npart, tol=tol, maxiter=maxiter, **knobs),
            n_cases=group.n_cases, n_devices=n_devices, probe=probe,
            obs=obs, waves=waves, calibration=calibration, device=device,
        )
    elif group.choice is None:
        group.choice = _autotune.TuneChoice(method=method, npart=npart, kset=kset)
    ch = group.choice
    sim = ref.sim_config(npart=ch.npart, tol=tol, maxiter=maxiter, **knobs)
    if health:
        sim = dataclasses.replace(sim, health=True)
    log(f"{label or 'group'} [{group.key[:8]}]: "
        f"{len(group.scenarios)} scenario(s), {group.n_cases} case(s), "
        f"method={ch.method} npart={ch.npart} kset={ch.kset} ({ch.source})")
    cc = CampaignConfig(
        kset=ch.kset, method=ch.method, seed=ref.seed,
        checkpoint_dir=os.path.join(ckpt_dir, f"group_{group.key}") if ckpt_dir else None,
        checkpoint_every=ckpt_every,
        scenario_sig=group.signature(),
    )
    t0 = time.perf_counter()
    res = run_campaign(mesh, sim, waves, observe=obs, campaign=cc, device=device, device_mesh=device_mesh,
                       stop_after_steps=stop_after_steps)
    wall_s = time.perf_counter() - t0
    stats = {
        "completed": bool(res.completed),
        "wall_s": wall_s,
        "cases_per_s": len(res.case_indices) / wall_s if wall_s > 0 else 0.0,
        "mean_iters": float(res.iters.mean()) if res.iters.size else 0.0,
    }
    if not res.completed:
        log(f"{label or 'group'} [{group.key[:8]}]: stopped after "
            f"{res.steps_done} steps — relaunch to resume")
        return {}, stats
    diverged = np.asarray(res.diverged_cases() if health else [], np.int64)
    if health:
        stats["health"] = {
            "guarded": True,
            "diverged": [int(c) for c in diverged],
            "nonconverged_steps": int(res.nonconverged.sum()) if res.nonconverged.size else 0,
        }
        if diverged.size:
            log(f"{label or 'group'} [{group.key[:8]}] [quarantine]: "
                f"{diverged.size} diverged case(s) "
                f"{[int(c) for c in diverged]} — excluded from shard output")
    results: dict[str, ScenarioResult] = {}
    for s, (lo, hi) in zip(group.scenarios, group.case_slices()):
        local = (res.case_indices >= lo) & (res.case_indices < hi)
        if diverged.size:  # diverged cases never reach shards
            local &= ~np.isin(res.case_indices, diverged)
        sr = ScenarioResult(
            scenario=s,
            waves=waves[res.case_indices[local]],
            responses=np.asarray(res.velocity_history[local]),
        )
        if out_dir:
            from repro_torch.surrogate.dataset import save_shards

            sr.shard_dir = os.path.join(out_dir, s.name)
            save_shards(
                sr.shard_dir,
                sr.waves.astype(np.float32),
                sr.responses[:, :, 0, :].astype(np.float32),
                shard_size=shard_size,
            )
        results[s.name] = sr
    return results, stats


def run_plan(
    plan: Plan,
    *,
    device=None,
    device_mesh=None,
    ckpt_dir: Optional[str] = None,
    out_dir: Optional[str] = None,
    log=None,
    **group_kw,
) -> PlanRunResult:
    """Execute every plan group serially, one campaign each, on ``device``
    (``None``: the card).

    A thin loop over :func:`run_group` (see there for the knobs — autotune,
    kernel backends, solver amortization, checkpointing, shard output; all
    keywords forward).  A group whose campaign *raises* does not abort the
    whole plan: its manifest entry records ``failed: true`` with the error
    and the remaining groups still run — the elastic scheduler's retry
    (:mod:`repro_torch.scenario.scheduler`) consumes that record as a spent
    attempt; a caller that needs every group checks ``group_stats``.  A
    group that checkpoint-*stops* (``stop_after_steps``) ends the run early
    for later resume.  The plan manifest is written next to the checkpoints
    (or shards) after every group settles.
    """
    log = log or (lambda msg: None)
    manifest_path = None
    if ckpt_dir:
        manifest_path = os.path.join(ckpt_dir, "plan.json")
    elif out_dir:
        manifest_path = os.path.join(out_dir, "plan.json")
    # Tuned choices from a previous (killed) run of this same plan: the
    # knobs are part of the campaign signature, so a resumed group MUST
    # re-use them — a probe re-run is wall-clock-nondeterministic and a
    # flipped winner would refuse its own checkpoint.
    prior = _prior_choices(manifest_path) if group_kw.get("autotune") else {}

    results: dict[str, ScenarioResult] = {}
    stats: dict[str, dict] = {}
    for gi, group in enumerate(plan.groups):
        label = f"group {gi + 1}/{len(plan.groups)}"
        try:
            group_results, st = run_group(
                group, device=device, device_mesh=device_mesh, ckpt_dir=ckpt_dir,
                out_dir=out_dir, prior=prior, log=log, label=label, **group_kw,
            )
        except Exception as e:  # noqa: BLE001 — one bad scenario ≠ dead plan
            stats[group.key] = {
                "completed": False, "failed": True,
                "error": f"{type(e).__name__}: {e}",
            }
            log(f"{label} [{group.key[:8]}] FAILED ({type(e).__name__}: {e}) "
                f"— continuing with remaining groups")
            if manifest_path:
                write_manifest(plan, manifest_path, stats)
            continue
        stats[group.key] = st
        if not st["completed"]:
            if manifest_path:
                write_manifest(plan, manifest_path, stats)
            return PlanRunResult(plan, results, stats, manifest_path)
        results.update(group_results)
        if manifest_path:
            write_manifest(plan, manifest_path, stats)
    return PlanRunResult(plan, results, stats, manifest_path)
