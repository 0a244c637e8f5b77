"""Sweep planner, its declarative half: expand a declarative sweep into
compile-grouped scenario groups (numpy only; the port's own copy of that
half of the JAX package's ``scenario/planner.py``, so both packages give
the same scenario names, signatures, group keys and manifests).

A :class:`SweepSpec` names a base :class:`~repro_torch.scenario.catalog.
Scenario` plus sweep *axes* — dotted field paths into the scenario with the
values to try (``"wave.family"``, ``"soil.vs"``, ``"obs.grid"``,
``"seed"``, …).  The planner expands the axes (full grid, or a seeded
random sample of it) into concrete scenarios and groups them by
:meth:`Scenario.compile_key`: scenarios that share a mesh + physics +
output shape differ only in *data*, so one campaign can serve the whole
group.  :func:`manifest` records a plan — scenarios, signatures, case
ranges — as JSON-able data.

The serving feedback loop (:mod:`repro_torch.serving.feedback`) and the
serve CLI's ``--sweep`` use this half.  The reference's ``run_group``,
``run_plan`` and ``write_manifest`` (which reads the autotuner's prior
choices) are not ported yet.
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
import os
import re
from typing import Any, Optional

import numpy as np

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


def manifest(plan: Plan) -> dict:
    """JSON-able record of the plan."""
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
        out["groups"].append(entry)
    return out
