"""Elastic work-queue scheduler: plan groups as leased jobs on disk.

The port's copy of the JAX package's ``scenario/scheduler.py``, with its
on-disk protocol (file names and JSON keys), so a queue made by one
package reads alike in the other.
:func:`repro_torch.scenario.planner.run_plan` executes compile groups one
at a time in one process.  At sweep scale (throughput comes from keeping
every device busy on many independent time-evolution cases) that serial
loop is the bottleneck, so this module turns the same plan into a
**persistent on-disk job queue** living next to ``plan.json``:

* one ``job_<key>.json`` per compile group, written once (``O_EXCL``);
* a worker *claims* a job by creating ``job_<key>.lease.json`` with
  ``O_CREAT | O_EXCL`` — the filesystem arbitrates, exactly one winner;
* the lease carries a random token and an expiry; a heartbeat thread
  renews it while the group's campaign runs — the renew's
  read-check-write runs under a per-job ``flock`` mutex (released by the
  OS if its holder dies), so a holder that stalls past expiry can never
  clobber a usurper's fresh lease with its stale token.  A worker that
  dies stops renewing; any survivor *takes over* the expired lease by
  ``os.rename`` onto a tombstone — again exactly one winner — records
  the expiry as a spent attempt, and re-claims;
* a failing group is released with a ``job_<key>.fail_NNN.json`` record:
  retried with bounded exponential backoff until
  :attr:`SchedulerConfig.max_attempts` *counted* attempts (errors and
  expiries; ``preempted`` checkpoint-stops advanced a valid checkpoint
  and never count), then declared dead — one bad scenario cannot sink a
  ten-thousand-scenario plan;
* completion writes ``job_<key>.done.json`` (atomic replace), and shard
  output is staged under ``queue/stage/<worker>/`` then published into
  ``out_dir/<scenario>/`` with one ``os.rename`` per scenario — so even a
  duplicated execution (a stalled-but-alive worker racing its usurper)
  publishes exactly once: a staged copy is discarded only when the
  destination was already published, a cross-filesystem stage falls back
  to copy-then-rename, and any other rename failure propagates instead
  of destroying the generated shards.  Every execution of a group
  produces the *identical* campaign (same signature, same checkpoints
  under ``ckpt_dir/group_<key>/``, kill-and-resume bitwise).

Workers join and leave at any time: :func:`run_worker` simply scans the
queue in plan order, runs whatever it can claim through
:func:`~repro_torch.scenario.planner.run_group`, and exits when every job
is settled (done or dead).  :class:`QueueWatch` revives
:class:`repro_torch.training.elastic.StepWatchdog` for the parent monitor: each
worker's heartbeat age is fed in as that host's step duration, so a
silent-but-not-dead worker is flagged before its lease even expires.
"""
from __future__ import annotations

import contextlib
import dataclasses
import errno
import fcntl
import glob
import json
import os
import shutil
import threading
import time
import uuid
from typing import Callable, Optional

from repro_torch.scenario.planner import Plan, _prior_choices, run_group, write_manifest


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Queue-side knobs (the campaign knobs ride through ``run_worker``)."""

    lease_s: float = 30.0      # lease lifetime; heartbeat renews at /3
    poll_s: float = 0.5        # idle worker re-scan period
    max_attempts: int = 3      # attempts (errors + expiries; preemptions
                               # never count) before a job is dead
    backoff_s: float = 2.0     # error retry n waits backoff_s · 2^(n-1)


class LeaseLost(RuntimeError):
    """The lease was taken over (or expired) out from under its holder."""


@dataclasses.dataclass(frozen=True)
class Claim:
    key: str
    token: str
    attempt: int  # 1-based: prior fail records + 1


class JobQueue:
    """The on-disk queue: all state is files, all arbitration is atomic
    filesystem operations — no server, any number of processes."""

    def __init__(self, queue_dir: str, cfg: SchedulerConfig = SchedulerConfig()):
        self.dir = queue_dir
        self.cfg = cfg
        os.makedirs(os.path.join(queue_dir, "tombs"), exist_ok=True)

    # -- paths ---------------------------------------------------------------

    def _p(self, name: str) -> str:
        return os.path.join(self.dir, name)

    def job_path(self, key: str) -> str:
        return self._p(f"job_{key}.json")

    def lease_path(self, key: str) -> str:
        return self._p(f"job_{key}.lease.json")

    def done_path(self, key: str) -> str:
        return self._p(f"job_{key}.done.json")

    def fail_paths(self, key: str) -> list[str]:
        return sorted(glob.glob(self._p(f"job_{key}.fail_*.json")))

    # -- low-level file ops --------------------------------------------------

    @staticmethod
    def _write_once(path: str, obj: dict) -> bool:
        """Create-exclusive JSON write; False if ``path`` already exists."""
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return False
        with os.fdopen(fd, "w") as f:
            json.dump(obj, f)
        return True

    @staticmethod
    def _write_atomic(path: str, obj: dict) -> None:
        tmp = f"{path}.{uuid.uuid4().hex[:8]}.tmp"
        with open(tmp, "w") as f:
            json.dump(obj, f)
        os.replace(tmp, path)

    @staticmethod
    def _read(path: str) -> Optional[dict]:
        try:
            with open(path) as f:
                return json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return None  # missing, or torn mid-replace — caller re-polls

    @contextlib.contextmanager
    def _lease_mutex(self, key: str, block: bool = True):
        """Advisory per-job mutex (``flock`` on ``job_<key>.lock``)
        serializing every lease read-check-write section — renew vs
        takeover vs release.  The OS drops the lock if its holder dies,
        so a crashed worker never wedges the job.  Yields True with the
        lock held; with ``block=False`` yields False (lock NOT held)
        when another process is mid-section."""
        fd = os.open(self._p(f"job_{key}.lock"), os.O_CREAT | os.O_RDWR, 0o644)
        try:
            try:
                fcntl.flock(fd, fcntl.LOCK_EX | (0 if block else fcntl.LOCK_NB))
            except OSError:
                yield False
                return
            yield True
        finally:
            os.close(fd)  # close releases the flock

    def _spent(self, fail_paths: list[str]) -> int:
        """Fail records that count toward :attr:`SchedulerConfig.
        max_attempts`: errors, lease expiries, and quarantine requeues.
        ``preempted`` checkpoint-stops are excluded — each one advanced a
        valid checkpoint, so a ``--stop-after-steps`` run (or a repeatedly
        preempted worker pool) may need arbitrarily many resume cycles
        and must never be declared dead for it."""
        return sum(1 for p in fail_paths
                   if (self._read(p) or {}).get("kind") != "preempted")

    def quarantine_record(self, key: str) -> Optional[dict]:
        """The quarantine fail record for ``key``, if a prior attempt
        requeued it over diverged cases — its presence is what bounds the
        quarantine machinery to ONE fallback round: a retry that still
        diverges commits its healthy cases and records the survivors
        instead of requeuing again."""
        for p in self.fail_paths(key):
            rec = self._read(p) or {}
            if rec.get("kind") == "quarantine":
                return rec
        return None

    # -- queue construction --------------------------------------------------

    @classmethod
    def create(
        cls,
        queue_dir: str,
        plan: Plan,
        cfg: SchedulerConfig = SchedulerConfig(),
        manifest_path: Optional[str] = None,
    ) -> "JobQueue":
        """Idempotent (and claim-race-safe): every worker calls this on
        startup; ``O_EXCL`` makes the first writer win per file.

        A prior serial :func:`~repro_torch.scenario.planner.run_plan` manifest is
        consumed: groups it completed are pre-marked done, and a group it
        recorded as ``failed`` starts life with one spent attempt — the
        scheduler *retry* of the satellite contract."""
        q = cls(queue_dir, cfg)
        prior: dict[str, dict] = {}
        if manifest_path and os.path.exists(manifest_path):
            m = cls._read(manifest_path) or {}
            prior = {g["key"]: g for g in m.get("groups", []) if "key" in g}
        for gi, g in enumerate(plan.groups):
            q._write_once(q.job_path(g.key), {"key": g.key, "gi": gi})
            rec = prior.get(g.key, {})
            if rec.get("completed"):
                q._write_once(q.done_path(g.key), {
                    "key": g.key, "worker": "run_plan", "attempt": 0,
                    "from_manifest": True,
                    **{k: rec[k] for k in
                       ("completed", "wall_s", "cases_per_s", "mean_iters")
                       if k in rec},
                    **({"choice": rec["choice"]} if "choice" in rec else {}),
                })
            elif rec.get("failed"):
                # Pinned to the fail_000 slot: racing workers that both
                # observe the manifest's `failed` record at startup must
                # spend ONE attempt total, not one per observer — only
                # the O_EXCL winner records it, losers accept False.
                q._write_once(q._p(f"job_{g.key}.fail_000.json"), {
                    "t": time.time(), "kind": "error", "worker": "run_plan",
                    "from_manifest": True,
                    "error": rec.get("error", "failed in run_plan"),
                })
        return q

    # -- job lifecycle -------------------------------------------------------

    def state(self, key: str, now: Optional[float] = None) -> str:
        """``done | dead | leased | expired | backoff | ready``."""
        now = time.time() if now is None else now
        if os.path.exists(self.done_path(key)):
            return "done"
        fails = self.fail_paths(key)
        spent = self._spent(fails)
        if spent >= self.cfg.max_attempts:
            return "dead"
        lease = self._read(self.lease_path(key))
        if lease is not None:
            return "leased" if lease.get("expires", 0) >= now else "expired"
        if fails:
            rec = self._read(fails[-1]) or {}
            if rec.get("kind") == "error":
                wait = self.cfg.backoff_s * (2 ** max(0, spent - 1))
                try:
                    if os.path.getmtime(fails[-1]) + wait > now:
                        return "backoff"
                except OSError:
                    pass
        return "ready"

    def try_claim(self, key: str, worker: str) -> Optional[Claim]:
        """Claim ``key`` for ``worker``; None if it isn't claimable."""
        st = self.state(key)
        if st == "expired":
            self._expire(key)
            st = self.state(key)
        if st != "ready":
            return None
        token = uuid.uuid4().hex
        attempt = len(self.fail_paths(key)) + 1
        ok = self._write_once(self.lease_path(key), {
            "worker": worker, "token": token, "attempt": attempt,
            "expires": time.time() + self.cfg.lease_s,
        })
        return Claim(key=key, token=token, attempt=attempt) if ok else None

    def _expire(self, key: str) -> None:
        """Tombstone an expired lease — ``os.rename`` picks exactly one
        winner among racing survivors; the expiry is a spent attempt.

        Runs under the per-job mutex, non-blocking: if the holder is
        mid-renewal right now it is stalled-but-alive — skip the
        takeover this scan and let its renew land."""
        with self._lease_mutex(key, block=False) as held:
            if not held:
                return
            lease = self._read(self.lease_path(key))
            if lease is None or lease.get("expires", 0) >= time.time():
                return
            tomb = os.path.join(self.dir, "tombs",
                                f"{key}.{lease.get('token', 'x')}")
            try:
                os.rename(self.lease_path(key), tomb)
            except FileNotFoundError:
                return  # another survivor won the takeover
        self._record_fail(
            key, kind="expired", worker=lease.get("worker", "?"),
            error=f"lease expired (worker {lease.get('worker')} went silent)",
            **({"choice": lease["choice"]} if "choice" in lease else {}),
        )

    def _record_fail(self, key: str, **rec) -> Optional[str]:
        for n in range(self.cfg.max_attempts + 16):
            p = self._p(f"job_{key}.fail_{n:03d}.json")
            if self._write_once(p, {"t": time.time(), **rec}):
                return p
        return None

    def renew(self, key: str, token: str, extra: Optional[dict] = None) -> None:
        """Heartbeat: push the expiry out — but only while the lease is
        still ours and still alive.  ``extra`` (e.g. the tuned choice)
        rides on the lease so a takeover can inherit it.

        The whole read-check-write runs under the per-job mutex: a
        holder that read a still-valid lease can no longer stall past
        expiry and then clobber a usurper's fresh lease with its stale
        token — either its renew lands before any takeover (mutex held
        throughout), or the takeover already tombstoned/replaced the
        lease and the re-read here raises :class:`LeaseLost`."""
        with self._lease_mutex(key):
            lease = self._read(self.lease_path(key))
            now = time.time()
            if (lease is None or lease.get("token") != token
                    or lease.get("expires", 0) < now):
                raise LeaseLost(f"lease on {key} expired or was taken over")
            lease["expires"] = now + self.cfg.lease_s
            if extra:
                lease.update(extra)
            self._write_atomic(self.lease_path(key), lease)

    def release(self, key: str, token: str, fail: Optional[dict] = None) -> None:
        """Give the job back (optionally recording a fail/requeue reason)."""
        if fail:
            self._record_fail(key, **fail)
        with self._lease_mutex(key):
            lease = self._read(self.lease_path(key))
            if lease and lease.get("token") == token:
                try:
                    os.remove(self.lease_path(key))
                except FileNotFoundError:
                    pass

    def mark_done(self, key: str, token: str, record: dict) -> None:
        self._write_atomic(self.done_path(key), record)
        self.release(key, token)

    # -- aggregate views -----------------------------------------------------

    def settled(self, plan: Plan) -> bool:
        """Every job done or dead — nothing left for any worker."""
        return all(self.state(g.key) in ("done", "dead") for g in plan.groups)

    def recorded_choice(self, key: str) -> Optional[dict]:
        """Tuned choice persisted by a previous attempt (done/fail/lease
        record, newest first) — a retry MUST reuse it: the knobs are
        signature-bearing and a re-probe could flip the winner, which
        would then refuse the first attempt's checkpoint."""
        for p in ([self.done_path(key)] + self.fail_paths(key)[::-1]
                  + [self.lease_path(key)]):
            rec = self._read(p)
            if rec and rec.get("choice"):
                return rec["choice"]
        return None

    def stats(self, plan: Plan) -> dict[str, dict]:
        """Merge done/fail records into :func:`write_manifest`-shaped stats
        (convergent: built purely from disk, any worker can write it)."""
        out: dict[str, dict] = {}
        for g in plan.groups:
            rec = self._read(self.done_path(g.key))
            if rec:
                out[g.key] = {k: rec[k] for k in
                              ("completed", "wall_s", "cases_per_s",
                               "mean_iters", "worker", "attempt",
                               "health", "quarantine") if k in rec}
                if rec.get("choice") and g.choice is None:
                    from repro_torch.scenario.autotune import TuneChoice

                    g.choice = TuneChoice(**rec["choice"])
                continue
            fails = self.fail_paths(g.key)
            spent = self._spent(fails)
            if spent >= self.cfg.max_attempts:
                last = self._read(fails[-1]) or {}
                out[g.key] = {
                    "completed": False, "failed": True,
                    "attempts": spent,
                    "error": last.get("error", "exhausted retries"),
                }
        return out


# ---------------------------------------------------------------------------
# worker
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class WorkerSummary:
    worker: str
    done: list[str]                # group keys this worker completed
    failed: list[str]              # group keys whose attempt here errored
    preempted: list[str]           # group keys checkpoint-stopped + requeued
    settled: bool                  # whole queue settled when this worker left
    dead: list[str]                # group keys exhausted (queue-wide)
    quarantined: list[str] = dataclasses.field(default_factory=list)
    # group keys this worker requeued for a fallback-config quarantine round


def queue_dir_for(ckpt_dir: Optional[str], out_dir: Optional[str]) -> str:
    """The queue lives next to ``plan.json`` — under the checkpoint dir
    when there is one, else under the shard output dir."""
    root = ckpt_dir or out_dir
    if not root:
        raise ValueError("the scheduler needs --ckpt-dir or --out to host "
                         "its on-disk queue (and kill-resume needs "
                         "checkpoints anyway)")
    return os.path.join(root, "queue")


def _publish_dir(src: str, dst: str) -> None:
    """Move a staged scenario directory into place, exactly-once.

    The first publisher wins via one ``os.rename``.  The staged copy is
    discarded ONLY when ``dst`` was already published (a duplicated
    execution — the stalled-but-alive worker racing its usurper — lost
    the race); a cross-filesystem stage (``EXDEV``: ``ckpt_dir`` hosting
    ``queue/stage/`` on a different mount than ``out_dir``) falls back
    to copying onto ``dst``'s filesystem and renaming from there; every
    other rename failure (``EACCES``, ``ENOSPC``, …) propagates so the
    generated shards are never silently destroyed."""
    try:
        os.rename(src, dst)
        return
    except OSError as e:
        if os.path.isdir(dst):
            shutil.rmtree(src, ignore_errors=True)  # duplicate: theirs won
            return
        if e.errno != errno.EXDEV:
            raise
    # EXDEV: stage a sibling copy on dst's filesystem (the .tmp suffix
    # keeps shard_paths from walking it), then the same atomic rename.
    tmp = f"{dst}.{uuid.uuid4().hex[:8]}.pub.tmp"
    try:
        shutil.copytree(src, tmp)
        try:
            os.rename(tmp, dst)
        except OSError:
            if not os.path.isdir(dst):
                raise
            # a duplicate published dst while we copied: theirs won
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    shutil.rmtree(tmp, ignore_errors=True)
    shutil.rmtree(src, ignore_errors=True)


def _heartbeat_file(queue_dir: str, worker: str) -> str:
    return os.path.join(queue_dir, f"worker_{worker}.json")


def _beat(q: JobQueue, worker: str, job: Optional[str], n_done: int) -> None:
    JobQueue._write_atomic(_heartbeat_file(q.dir, worker), {
        "worker": worker, "job": job, "t": time.time(), "done": n_done,
    })


def run_worker(
    plan: Plan,
    *,
    worker: Optional[str] = None,
    scheduler: SchedulerConfig = SchedulerConfig(),
    device=None,
    device_mesh=None,
    ckpt_dir: Optional[str] = None,
    out_dir: Optional[str] = None,
    shard_size: int = 16,
    max_jobs: int = 0,
    stop_after_steps: Optional[int] = None,
    log=None,
    _group_runner: Optional[Callable[..., tuple[dict, dict]]] = None,
    **group_kw,
) -> WorkerSummary:
    """Join the queue for ``plan`` and work it until settled (or told off),
    running each claimed group on ``device`` (``None``: the card).

    Elastic by construction: run this from as many processes as you like,
    whenever you like — each scans the queue in plan order, claims what it
    can, and executes claimed groups through
    :func:`~repro_torch.scenario.planner.run_group` with exactly the knobs
    ``run_plan`` would use (``**group_kw`` forwards).  Campaign values are
    therefore identical to the serial run's, and shard *placement* is made
    race-proof by staging: the group writes into
    ``queue/stage/<worker>/<scenario>/`` and publishes with one
    ``os.rename`` per scenario (a duplicated execution loses the rename
    and discards its copy).

    ``stop_after_steps`` is the deterministic stand-in for SIGKILL used by
    tests: the claimed group checkpoints mid-campaign, the worker
    records a ``preempted`` requeue and **exits** — a surviving worker
    re-claims and resumes from the checkpoint bit-identically.

    ``max_jobs > 0`` caps how many groups this worker completes (scale-in).
    ``_group_runner`` swaps the execution body out for tests.
    """
    log = log or (lambda msg: None)
    worker = worker or f"w{os.getpid()}"
    qdir = queue_dir_for(ckpt_dir, out_dir)
    manifest_path = os.path.join(ckpt_dir or out_dir, "plan.json")
    q = JobQueue.create(qdir, plan, scheduler, manifest_path=manifest_path)
    prior = _prior_choices(manifest_path) if group_kw.get("autotune") else {}
    runner = _group_runner or run_group
    stage_root = os.path.join(qdir, "stage", worker)
    by_key = {g.key: (gi, g) for gi, g in enumerate(plan.groups)}

    summary = WorkerSummary(worker=worker, done=[], failed=[], preempted=[],
                            settled=False, dead=[])

    def publish(group_results: dict) -> None:
        if not out_dir:
            return
        os.makedirs(out_dir, exist_ok=True)
        for name, sr in group_results.items():
            src, dst = os.path.join(stage_root, name), os.path.join(out_dir, name)
            _publish_dir(src, dst)
            sr.shard_dir = dst

    def flush_manifest() -> None:
        write_manifest(plan, manifest_path, q.stats(plan))

    while True:
        if max_jobs and len(summary.done) >= max_jobs:
            log(f"worker {worker}: reached max_jobs={max_jobs}, leaving")
            break
        claim = None
        for key in by_key:
            claim = q.try_claim(key, worker)
            if claim:
                break
        if claim is None:
            if q.settled(plan):
                break
            _beat(q, worker, None, len(summary.done))
            time.sleep(scheduler.poll_s)
            continue

        gi, group = by_key[claim.key]
        if group_kw.get("autotune"):
            rec = q.recorded_choice(claim.key)
            if rec:
                from repro_torch.scenario.autotune import TuneChoice

                prior[group.signature()] = TuneChoice(**rec)

        lost = threading.Event()
        stop = threading.Event()

        def heartbeat(key=claim.key, token=claim.token, group=group):
            while not stop.wait(max(0.05, scheduler.lease_s / 3.0)):
                extra = ({"choice": dataclasses.asdict(group.choice)}
                         if group.choice is not None else None)
                try:
                    q.renew(key, token, extra)
                except LeaseLost:
                    lost.set()
                    return
                _beat(q, worker, key, len(summary.done))

        hb = threading.Thread(target=heartbeat, daemon=True)
        hb.start()
        _beat(q, worker, claim.key, len(summary.done))
        label = f"worker {worker} group {gi + 1}/{len(plan.groups)} " \
                f"(attempt {claim.attempt})"
        # quarantine round: a prior attempt completed but left diverged
        # cases — this retry runs the fallback config it recorded
        run_kw = dict(group_kw)
        qrec = q.quarantine_record(claim.key)
        if qrec is not None and run_kw.get("health", True):
            fb_tol = float(qrec.get("fallback_tol") or 0.0)
            if fb_tol > 0:
                run_kw["tol"] = fb_tol
            log(f"{label}: quarantine round for diverged case(s) "
                f"{qrec.get('diverged', [])} — fallback tol="
                f"{run_kw.get('tol', 1e-6):g}")
        try:
            group_results, st = runner(
                group, device=device, device_mesh=device_mesh, ckpt_dir=ckpt_dir,
                out_dir=os.path.join(stage_root) if out_dir else None,
                shard_size=shard_size, stop_after_steps=stop_after_steps,
                prior=prior, log=log, label=label, **run_kw,
            )
        except Exception as e:  # noqa: BLE001 — record, requeue, move on
            stop.set()
            hb.join()
            q.release(claim.key, claim.token, fail={
                "kind": "error", "worker": worker,
                "error": f"{type(e).__name__}: {e}",
                **({"choice": dataclasses.asdict(group.choice)}
                   if group.choice is not None else {}),
            })
            summary.failed.append(claim.key)
            log(f"{label} FAILED ({type(e).__name__}: {e}) — requeued with "
                f"backoff")
            flush_manifest()
            continue
        finally:
            stop.set()
            hb.join()

        if not st["completed"]:
            # checkpoint-stopped (fault injection / preemption): requeue
            # without backoff and LEAVE — the kill stand-in.
            q.release(claim.key, claim.token, fail={
                "kind": "preempted", "worker": worker,
                "error": "checkpoint-stopped mid-group (worker left)",
                **({"choice": dataclasses.asdict(group.choice)}
                   if group.choice is not None else {}),
            })
            summary.preempted.append(claim.key)
            log(f"{label}: preempted mid-group — checkpointed and requeued")
            flush_manifest()
            break

        diverged = list((st.get("health") or {}).get("diverged") or [])
        if diverged and qrec is None:
            # first completion with diverged cases: discard this attempt's
            # staged output and checkpoints (the fallback config changes the
            # campaign signature, which would refuse the stale checkpoints)
            # and requeue exactly ONE quarantine round with a tighter tol.
            # The quarantine record both carries the fallback config and —
            # by its presence — bounds the machinery to a single round.
            fb_tol = float(run_kw.get("tol", 1e-6)) * 0.1
            for name in group_results:
                shutil.rmtree(os.path.join(stage_root, name),
                              ignore_errors=True)
            if ckpt_dir:
                shutil.rmtree(os.path.join(ckpt_dir, f"group_{claim.key}"),
                              ignore_errors=True)
            q.release(claim.key, claim.token, fail={
                "kind": "quarantine", "worker": worker,
                "error": f"{len(diverged)} diverged case(s): {diverged}",
                "diverged": diverged, "fallback_tol": fb_tol,
                **({"choice": dataclasses.asdict(group.choice)}
                   if group.choice is not None else {}),
            })
            summary.quarantined.append(claim.key)
            log(f"{label} [quarantine]: {len(diverged)} diverged case(s) "
                f"{diverged} — requeued once with fallback tol={fb_tol:g}")
            flush_manifest()
            continue
        if diverged:
            # the fallback round still diverged: commit the healthy cases
            # (run_group already excluded the diverged ones from shards) and
            # record the survivors — no further retries.
            st = dict(st)
            st["quarantine"] = {
                "round": "fallback", "diverged": diverged,
                "fallback_tol": run_kw.get("tol", 1e-6),
            }
            log(f"{label} [quarantine]: fallback round still has "
                f"{len(diverged)} diverged case(s) {diverged} — committing "
                f"healthy cases only")
        if lost.is_set():
            log(f"{label}: lease was taken over mid-run — publishing anyway "
                f"(first rename wins) ")
        publish(group_results)
        q.mark_done(claim.key, claim.token, {
            "key": claim.key, "worker": worker, "attempt": claim.attempt,
            **st,
            **({"choice": dataclasses.asdict(group.choice)}
               if group.choice is not None else {}),
            "scenarios": [s.name for s in group.scenarios],
        })
        summary.done.append(claim.key)
        _beat(q, worker, None, len(summary.done))
        flush_manifest()

    summary.settled = q.settled(plan)
    summary.dead = [g.key for g in plan.groups if q.state(g.key) == "dead"]
    _beat(q, worker, None, len(summary.done))
    return summary


# ---------------------------------------------------------------------------
# queue monitor: StepWatchdog over worker heartbeats
# ---------------------------------------------------------------------------


class QueueWatch:
    """Straggler detection for queue workers, via
    :class:`repro_torch.training.elastic.StepWatchdog`.

    Each :meth:`poll` is one watchdog "step": every worker's heartbeat age
    (seconds since its ``worker_<name>.json`` was last touched) is fed in
    as that host's step duration.  A worker that stops beating — wedged in
    a kernel, swapping, half-dead — shows a monotonically growing age and
    gets flagged after ``patience`` consecutive polls, typically *before*
    its lease expires; the launcher surfaces the flag so an operator (or a
    supervisor) can kill it and let lease takeover do the requeue.
    """

    def __init__(self, queue_dir: str, workers: list[str], *,
                 slack: float = 3.0, patience: int = 2, window: int = 16):
        from repro_torch.training.elastic import StepWatchdog

        self.dir = queue_dir
        self.workers = list(workers)
        self.wd = StepWatchdog(n_hosts=len(self.workers), slack=slack,
                               patience=patience, window=window)
        self.step = 0
        self.t0 = time.time()

    def ages(self) -> list[float]:
        now = time.time()
        out = []
        for w in self.workers:
            try:
                out.append(now - os.path.getmtime(_heartbeat_file(self.dir, w)))
            except OSError:
                out.append(now - self.t0)  # never beat: age since launch
        return out

    def poll(self):
        """→ ``StragglerReport`` for this poll (``slow_hosts`` indexes into
        ``self.workers``)."""
        for i, age in enumerate(self.ages()):
            self.wd.report(i, self.step, max(age, 1e-3))
        rep = self.wd.snapshot(self.step)
        self.step += 1
        return rep
