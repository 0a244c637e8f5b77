"""Active learning: high-uncertainty serving traffic → new campaign jobs
(no torch: the port's own copy of the JAX package's ``serving/feedback.py``,
over the port's scenario catalog and planner; each package reads the
other's logs).

Every computed request carries an uncertainty score (the
:class:`~repro_torch.serving.engine.SurrogateEngine` ensemble
disagreement); requests whose score exceeds a threshold are appended to a
JSONL *feedback log* as scenario records.  :func:`load_feedback` reads them
back through :func:`repro_torch.scenario.planner.scenario_from_dict` and
:func:`feedback_plan` hands them to :func:`repro_torch.scenario.planner.
make_plan` — the places the surrogate is *least sure about* become a
compile-grouped sweep of new data-generation jobs, whose shards retrain the
surrogate.  (The JAX package's campaign launcher runs such a plan with
``--scenarios``; the port's launcher does not have that mode yet.)

Record format (one JSON object per line)::

    {"signature": "<scenario sig>", "score": 0.31,
     "scenario": {<Scenario fields, JSON form>}, "key": "<request key>"}

Appends are line-atomic on POSIX; duplicate scenarios (by signature) are
written once per log instance and deduplicated again on load, so a hot
scenario hammered by traffic becomes *one* campaign job, not thousands.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Any, Optional

from repro_torch.scenario.catalog import Scenario


def scenario_to_dict(s: Scenario) -> dict:
    """JSON form accepted back by :func:`repro_torch.scenario.planner.
    scenario_from_dict` (tuples become lists; the overlay restores them)."""
    return dataclasses.asdict(s)


class FeedbackLog:
    """Threshold gate + JSONL writer for the active-learning loop.

    ``observe(meta, score)`` is called by the batcher for every *computed*
    (non-cached) request; only metas that are :class:`Scenario` instances
    can be routed back to the planner — others are counted and skipped.
    """

    def __init__(self, path: str, *, threshold: float = 0.05):
        if threshold < 0:
            raise ValueError(f"threshold must be ≥ 0, got {threshold}")
        self.path = path
        self.threshold = float(threshold)
        self._seen: set[str] = set()
        self._lock = threading.Lock()
        self.observed = 0
        self.routed = 0
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)

    def observe(self, meta: Any, score: float, key: Optional[str] = None) -> bool:
        """Route ``meta`` to the log iff it is a scenario scoring above the
        threshold; returns True when a record was written."""
        with self._lock:
            self.observed += 1
            if not isinstance(meta, Scenario) or score <= self.threshold:
                return False
            sig = meta.signature()
            if sig in self._seen:
                return False
            self._seen.add(sig)
            rec = {
                "signature": sig,
                "score": float(score),
                "key": key,
                "scenario": scenario_to_dict(meta),
            }
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
            self.routed += 1
            return True

    def stats(self) -> dict:
        with self._lock:
            return {"observed": self.observed, "routed": self.routed,
                    "threshold": self.threshold, "path": self.path}


def load_feedback(path: str, base: Scenario = Scenario()) -> list[Scenario]:
    """Scenarios from a feedback log, deduplicated by signature, in
    first-appearance order.  Each record's ``scenario`` dict overlays
    ``base`` via :func:`~repro_torch.scenario.planner.scenario_from_dict` — the
    same JSON-spec form the sweep CLI accepts, so a feedback file is just
    another scenario source.  Torn trailing lines (a serve process killed
    mid-append) are skipped; malformed *interior* records raise."""
    from repro_torch.scenario.planner import scenario_from_dict

    out: list[Scenario] = []
    seen: set[str] = set()
    with open(path) as f:
        lines = f.readlines()
    for i, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            if i == len(lines) - 1:
                break  # torn final append — everything before it is intact
            raise ValueError(f"{path}:{i + 1}: malformed feedback record")
        scn = scenario_from_dict(rec["scenario"], base)
        sig = scn.signature()
        if rec.get("signature") not in (None, sig):
            raise ValueError(
                f"{path}:{i + 1}: scenario hashes to {sig} but the record "
                f"claims {rec['signature']} — file edited or schema drifted"
            )
        if sig not in seen:
            seen.add(sig)
            out.append(scn)
    # scenario names become shard-directory names downstream (run_group) —
    # physics-distinct records sharing a label get a signature suffix.
    # name is excluded from signature(), so relabeling is identity-safe.
    names: set[str] = set()
    for i, scn in enumerate(out):
        if scn.name in names:
            out[i] = scn = dataclasses.replace(
                scn, name=f"{scn.name}-{scn.signature()[:6]}"
            )
        names.add(scn.name)
    return out


def feedback_plan(path: str, base: Scenario = Scenario()):
    """Feedback log → compile-grouped :class:`~repro_torch.scenario.planner.
    Plan` (the JAX package runs it with ``launch/campaign.py --scenarios
    <log>``)."""
    from repro_torch.scenario.planner import make_plan

    scenarios = load_feedback(path, base)
    if not scenarios:
        raise ValueError(f"feedback log {path} holds no scenario records")
    return make_plan(scenarios)
