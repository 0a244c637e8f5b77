"""Fault-tolerant checkpoints: atomic, asynchronous, CRC-checked, in the JAX
package's on-disk format, so each package reads the other's checkpoints of
plain trees.

* **atomic**: writes go to ``…tmp`` then a single ``os.replace``; a crash
  mid-write can never corrupt the latest checkpoint.
* **asynchronous**: :meth:`CheckpointManager.save` copies every leaf to host
  numpy on the caller's thread (a CUDA tensor is copied off the card, a CPU
  tensor is cloned), and only then writes in a background thread; ``wait()``
  joins it.  The copy is what makes the background write safe: the caller
  may change its tensors in place as soon as ``save`` returns (the health
  guard freezes a tripped lane by writing into the carry).
* **checked**: the manifest records a CRC32 of every leaf file as written;
  :meth:`~CheckpointManager.restore` refuses a leaf whose bytes no longer
  match (:class:`CheckpointCorruptError`) and
  :meth:`~CheckpointManager.restore_latest` falls back to the previous step.
* **sharded layout**: with ``process_count > 1`` each process writes only its
  own shard ``step_<n>.p<k>/`` and process 0 commits ``step_<n>.commit.json``
  after a barrier (by default the process group's,
  :func:`repro_torch.parallel.distributed.barrier`; tests drive two managers
  from one process with a no-op).
* **whole leaves** (``whole_leaves=True``, a mesh's trainer): the state is
  logically unsharded.  The processes share out the writing leaf by leaf
  (leaf ``i`` of a tree, in name order, in shard ``i mod process_count``),
  in the sharded layout above, and each ``DTensor`` leaf is assembled
  whole on its writer alone from the shards the others send it (every
  process saves).  Any number of processes restores such a step, one
  process included: each reads the manifests of all the shards, and
  ``restore_latest(like, shardings=…)`` lays the arrays out on its own
  mesh (the elastic restore), each process reading its own block of each
  leaf's file.

On-disk layout::

    dir/step_000000042/            single-process checkpoint
        manifest.json              {"step", "meta", "leaves", "checksums"}
        <name>/00000.npy …
    dir/step_000000042.p00/        process 0's shard of a sharded checkpoint
        manifest.json              {"step", "process_index", "process_count",
                                    "meta", "leaves", "checksums"}
        <name>/00000.npy …
    dir/step_000000042.commit.json the global manifest: the step is durable
                                   iff this file exists (``whole_leaves``:
                                   true for a whole-leaf step)

A campaign over several case-mesh entries in one process keeps a k-set
carry on each entry's device.  :func:`spread` joins them into one tree of
:class:`Spread` leaves, each saved as one global array (the entries' blocks
concatenated along the member axis, in entry order, as the reference's
carry over a local mesh is one array) and restored in place block by block
into each entry's tensors on its device; :func:`unspread` takes entry
``d``'s tree back out.

Leaves are named as ``jax.tree_util.keystr`` names them: ``['key']`` for a
dict key, ``[i]`` for a list or tuple index, ``.field`` for a NamedTuple
field (and ``.blocks[j][i]`` for a :class:`~repro_torch.core.hetmem.
PartitionedState`).  A leaf is a torch tensor, a numpy array or a python
number; a restored leaf takes the kind of its counterpart in ``like``: a
tensor on the device of ``like``'s tensor (pinned if that one is), a numpy
array, or a python int, float or bool.  ``restore(..., in_place=True)``
fills ``like``'s tensors instead of allocating new ones.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import sys
import threading
import time
import zlib
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core.hetmem import PartitionedState
from repro_torch.parallel.distributed import make_barrier
from repro_torch.utils.tree import leaves_with_paths, tree_flatten, tree_map

_CRC_CHUNK = 1 << 26  # bytes per read while checksumming (bounds host memory)


class CheckpointCorruptError(RuntimeError):
    """A checkpoint leaf file fails its manifest checksum.

    Raised by :meth:`CheckpointManager.restore`; :meth:`CheckpointManager.
    restore_latest` catches it and falls back to the previous committed
    step instead — bit rot costs one checkpoint interval, never a resume
    from garbage."""


def _crc(path: str) -> int:
    """CRC32 of a file's bytes (read in chunks; the same value as one read)."""
    crc = 0
    with open(path, "rb") as f:
        while chunk := f.read(_CRC_CHUNK):
            crc = zlib.crc32(chunk, crc)
    return crc & 0xFFFFFFFF


def _crc_saved(path: str, arr: np.ndarray) -> int:
    """:func:`_crc` of the ``.npy`` file ``np.save`` just wrote for ``arr``:
    its header read back, then ``arr``'s bytes from host memory."""
    if not arr.flags.c_contiguous or arr.dtype.hasobject:
        return _crc(path)
    with open(path, "rb") as f:
        crc = zlib.crc32(f.read(os.path.getsize(path) - arr.nbytes))
    return zlib.crc32(memoryview(arr.reshape(-1).view(np.uint8)), crc) & 0xFFFFFFFF


_STEP_DIR = re.compile(r"^step_(\d+)$")
_SHARD_DIR = re.compile(r"^step_(\d+)\.p(\d+)$")
_COMMIT = re.compile(r"^step_(\d+)\.commit\.json$")


def _paths(tree: Any) -> list[tuple[str, Any]]:
    """``(name, leaf)`` of every leaf, named as ``jax.tree_util.keystr`` names
    them, in flattening order (``utils.tree.leaves_with_paths``)."""
    return leaves_with_paths(tree)


@dataclasses.dataclass(frozen=True)
class Spread:
    """One leaf over the entries of a case mesh: ``parts[d]`` is entry
    ``d``'s block of the member axis, a tensor on that entry's device."""

    parts: tuple


def spread(trees: list) -> Any:
    """One tree of the entries' trees (of one structure): each tensor leaf a
    :class:`Spread` of the entries' tensors; any other leaf (the lagged
    preconditioner's step counter, a python int) the same in every tree,
    and taken once."""
    flat = [tree_flatten(t) for t in trees]
    leaves = []
    for group in zip(*(f for f, _ in flat)):
        if isinstance(group[0], torch.Tensor):
            leaves.append(Spread(tuple(group)))
        elif any(g != group[0] for g in group[1:]):
            raise ValueError(f"a leaf that is not a tensor differs between entries: {group}")
        else:
            leaves.append(group[0])
    return flat[0][1].unflatten(leaves)


def unspread(tree: Any, d: int) -> Any:
    """Entry ``d``'s tree of a :func:`spread` tree."""
    return tree_map(lambda x: x.parts[d] if isinstance(x, Spread) else x, tree)


def _to_host(leaf: Any) -> np.ndarray:
    """A host numpy copy of ``leaf`` that nothing else shares."""
    if isinstance(leaf, Spread):
        return np.concatenate([_to_host(p) for p in leaf.parts])
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        return (leaf.cpu() if leaf.device.type != "cpu" else leaf.clone()).numpy()
    return np.array(leaf, copy=True)


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    return {name: _to_host(leaf) for name, leaf in _paths(tree)}


def _whole_on(leaf: Any, owner: int, rank: int) -> Optional[np.ndarray]:
    """``leaf`` whole, as a host numpy array, on process ``owner`` alone
    (``None`` on the others).  A ``DTensor`` leaf is assembled there from
    its blocks: each distinct block goes to ``owner`` once, from the first
    process that holds it (a collective: every process calls this)."""
    if not hasattr(leaf, "full_tensor"):
        return _to_host(leaf) if rank == owner else None
    import torch.distributed as dist

    from repro_torch.parallel.sharding import local_block

    mine = local_block(leaf.shape, leaf.device_mesh, leaf.placements)
    blocks: list = [None] * dist.get_world_size()
    dist.all_gather_object(blocks, [(s.start, s.stop) for s in mine])
    sender: dict = {}  # block → the process that sends it (the owner's own first)
    for r in (owner, *(r for r in range(len(blocks)) if r != owner)):
        if all(a < b for a, b in blocks[r]):
            sender.setdefault(tuple(blocks[r]), r)
    local = leaf.to_local().detach().cpu()
    if rank != owner:
        if sender.get(tuple(blocks[rank])) == rank:
            dist.send(local.contiguous(), dst=owner)
        return None
    whole = torch.empty(tuple(leaf.shape), dtype=local.dtype)
    for block, r in sorted(sender.items(), key=lambda kv: kv[1]):
        part = local if r == rank else torch.empty([b - a for a, b in block], dtype=local.dtype)
        if r != rank:
            dist.recv(part, src=r)
        whole[tuple(slice(a, b) for a, b in block)] = part
    return whole.numpy()


def _flatten_whole(tree: Any, rank: int, count: int) -> dict[str, Optional[np.ndarray]]:
    """:func:`_flatten` of a whole-leaf save: leaf ``i`` in name order whole
    on process ``i mod count``, which writes it, and ``None`` elsewhere."""
    named = sorted(_paths(tree), key=lambda kv: kv[0])
    return {name: _whole_on(leaf, i % count, rank) for i, (name, leaf) in enumerate(named)}


def _like_leaf(arr: np.ndarray, like: Any, in_place: bool, name: str, sharding=None) -> Any:
    """``arr`` as the kind of leaf ``like`` is (``like`` itself, filled, for a
    tensor restored ``in_place``); laid out over a mesh by ``sharding`` (a
    ``ShardSpec`` over a ``DeviceMesh``) or, for a ``DTensor`` ``like``, as
    ``like`` is: each process copies its block of the (mapped) array."""
    if sharding is not None or hasattr(like, "full_tensor"):
        from repro_torch.parallel.sharding import from_global

        mesh, pl = (sharding.mesh, sharding.placements) if sharding is not None else (like.device_mesh,
                                                                                     like.placements)
        dev = like.to_local().device if hasattr(like, "to_local") else like.device
        return from_global(arr, mesh, pl, dev)
    if isinstance(like, Spread):
        bounds = np.cumsum([0] + [p.shape[0] for p in like.parts])
        if arr.shape[:1] != (bounds[-1],):
            raise ValueError(f"checkpoint leaf {name}: {arr.shape} on disk, {bounds[-1]} members over "
                             f"{len(like.parts)} entries to restore into")
        return Spread(tuple(_like_leaf(np.ascontiguousarray(arr[a:b]), p, in_place, name)
                            for a, b, p in zip(bounds[:-1], bounds[1:], like.parts)))
    if isinstance(like, torch.Tensor):
        t = torch.from_numpy(arr)
        if in_place:
            if t.shape != like.shape or t.dtype != like.dtype:
                raise ValueError(f"checkpoint leaf {name}: {tuple(t.shape)} {t.dtype} on disk, "
                                 f"{tuple(like.shape)} {like.dtype} to restore into")
            return like.copy_(t)
        if like.device.type != "cpu":
            return t.to(like.device)
        return t.pin_memory() if like.is_pinned() else t
    if isinstance(like, (bool, int, float)) and not isinstance(like, np.generic):
        return type(like)(arr.item())
    return arr


def _unflatten(tree: Any, leaves: dict[str, Any], prefix: str = "") -> Any:
    """``tree``'s structure with each leaf replaced by ``leaves[name]``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves, f"{prefix}[{k!r}]") for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_unflatten(v, leaves, f"{prefix}.{f}") for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves, f"{prefix}[{i}]") for i, v in enumerate(tree))
    if isinstance(tree, PartitionedState):
        return PartitionedState(blocks=_unflatten(tree.blocks, leaves, f"{prefix}.blocks"))
    return leaves[prefix]


class CheckpointManager:
    def __init__(
        self,
        directory: str,
        keep: int = 3,
        *,
        process_index: int = 0,
        process_count: int = 1,
        barrier: Optional[Callable[[], None]] = None,
        whole_leaves: bool = False,
    ):
        """``barrier`` syncs all processes (a zero-argument callable); with
        ``process_count > 1`` it defaults to the process group's barrier
        (``make_barrier("ckpt")``).  Unit tests pass a no-op to emulate N
        processes from one.  ``whole_leaves``: the whole-leaf layout (see
        the module docstring)."""
        if not 0 <= process_index < process_count:
            raise ValueError(f"process_index {process_index} outside [0, {process_count})")
        if barrier is None and process_count > 1:
            barrier = make_barrier("ckpt")
        self.directory = directory
        self.keep = keep
        self.process_index = process_index
        self.process_count = process_count
        self._barrier = barrier or (lambda: None)
        self.whole_leaves = whole_leaves and process_count > 1
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        #: one record per save and restore: bytes and seconds of each part
        self.log: list[dict[str, Any]] = []

    @property
    def sharded(self) -> bool:
        return self.process_count > 1

    # ---- save -------------------------------------------------------------
    def save(
        self,
        step: int,
        state: dict[str, Any],
        blocking: bool = False,
        meta: Optional[dict[str, Any]] = None,
    ) -> None:
        """``state`` is a dict of named trees (e.g. params, opt_state).

        Every leaf is copied to host numpy before this returns; the files
        are written in the background (``blocking`` waits for them).
        ``meta`` is a small JSON-serializable dict recorded in the (shard)
        manifest; on sharded restore it is the agreement key all shards must
        match on (the campaign passes ``{"round": r, "t": t}``).
        """
        self.wait()  # one in-flight save at a time
        t0 = time.perf_counter()
        if self.whole_leaves:
            arrays = {name: _flatten_whole(tree, self.process_index, self.process_count)
                      for name, tree in state.items()}
        else:
            arrays = {name: _flatten(tree) for name, tree in state.items()}
        record = {"op": "save", "step": step, "host_copy_s": time.perf_counter() - t0,
                  "bytes": sum(a.nbytes for leaves in arrays.values() for a in leaves.values() if a is not None)}
        if self.sharded:
            # synchronous: the shard barrier + process-0 commit happen on the
            # caller thread, in program order with the caller's coordination
            self._write(step, arrays, meta, record)
            return
        self._thread = threading.Thread(target=self._write_bg, args=(step, arrays, meta, record), daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def _shard_path(self, step: int, proc: int) -> str:
        return os.path.join(self.directory, f"step_{step:09d}.p{proc:02d}")

    def _commit_path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:09d}.commit.json")

    def _write_bg(self, *args) -> None:
        try:
            self._write(*args)
        except BaseException as e:  # re-raised on the caller's thread by wait()
            self._error = e

    def _write(self, step: int, arrays: dict[str, dict[str, np.ndarray]], meta: Optional[dict[str, Any]],
               record: dict[str, Any]) -> None:
        if self.sharded:
            final = self._shard_path(step, self.process_index)
        else:
            final = os.path.join(self.directory, f"step_{step:09d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest: dict[str, Any] = {"step": step, "meta": meta, "leaves": {}, "checksums": {}}
        if self.sharded:
            manifest["process_index"] = self.process_index
            manifest["process_count"] = self.process_count
        if self.whole_leaves:
            manifest["whole_leaves"] = True
            manifest["index"] = {}
        write_s = crc_s = 0.0
        for name, leaves in arrays.items():
            sub = os.path.join(tmp, name)
            os.makedirs(sub)
            manifest["leaves"][name] = []
            for i, (key, arr) in enumerate(sorted(leaves.items())):
                if self.whole_leaves:
                    if arr is None:
                        continue  # another process writes this leaf
                    manifest["index"].setdefault(name, []).append(i)
                fn = f"{i:05d}.npy"
                t0 = time.perf_counter()
                np.save(os.path.join(sub, fn), arr)
                t1 = time.perf_counter()
                manifest["leaves"][name].append(key)
                # the written bytes' checksum: restore refuses a leaf whose
                # bytes on disk no longer hash to what was saved
                manifest["checksums"][f"{name}/{fn}"] = _crc_saved(os.path.join(sub, fn), arr)
                write_s += t1 - t0
                crc_s += time.perf_counter() - t1
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        if self.sharded:
            # every shard durable before the manifest makes the step visible
            self._barrier()
            if self.process_index == 0:
                ctmp = self._commit_path(step) + ".tmp"
                with open(ctmp, "w") as f:
                    json.dump({"step": step, "process_count": self.process_count,
                               **({"whole_leaves": True} if self.whole_leaves else {})}, f)
                os.replace(ctmp, self._commit_path(step))
            # nobody GCs (or returns to overwrite state) until the commit is visible to all
            self._barrier()
        self._gc()
        self.log.append({**record, "write_s": write_s, "crc_s": crc_s})

    def _gc(self) -> None:
        keep = set(sorted(self.all_steps())[-self.keep:])
        entries = os.listdir(self.directory)
        if self.process_index == 0:
            # commits first: a half-deleted step must never look committed
            for d in entries:
                m = _COMMIT.match(d)
                if m and int(m.group(1)) not in keep:
                    try:
                        os.remove(os.path.join(self.directory, d))
                    except FileNotFoundError:
                        pass
            for d in entries:
                m = _STEP_DIR.match(d)
                if m and int(m.group(1)) not in keep:
                    shutil.rmtree(os.path.join(self.directory, d), ignore_errors=True)
        newest = max(keep, default=-1)
        for d in entries:
            m = _SHARD_DIR.match(d)
            if not m or int(m.group(2)) != self.process_index:
                continue  # own shards only
            s = int(m.group(1))
            # a shard newer than the newest committed step is mid-protocol
            # (written, commit pending) — never its own GC's victim; a kill's
            # orphan at that step is collected once a newer step commits
            if s not in keep and s <= newest:
                shutil.rmtree(os.path.join(self.directory, d), ignore_errors=True)

    def wait(self) -> None:
        """Join the background write; re-raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # ---- restore ----------------------------------------------------------
    def _committed_steps(self) -> set[int]:
        return {int(m.group(1)) for d in os.listdir(self.directory) if (m := _COMMIT.match(d))}

    def _legacy_steps(self) -> set[int]:
        return {int(m.group(1)) for d in os.listdir(self.directory) if (m := _STEP_DIR.match(d))}

    def all_steps(self) -> list[int]:
        """Steps restorable from this directory (single-process dirs +
        committed sharded steps; orphan shards and ``.tmp`` debris are
        invisible)."""
        return sorted(self._legacy_steps() | self._committed_steps())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _read_manifest(self, path: str) -> Optional[dict]:
        try:
            with open(os.path.join(path, "manifest.json")) as f:
                return json.load(f)
        except (FileNotFoundError, NotADirectoryError, json.JSONDecodeError):
            return None

    def _commit(self, step: int) -> dict:
        with open(self._commit_path(step)) as f:
            return json.load(f)

    def _validate_sharded(self, step: int) -> None:
        """World size + shard agreement for a committed sharded step (a
        whole-leaf step restores on any world size)."""
        commit = self._commit(step)
        pc = int(commit["process_count"])
        if pc != self.process_count and not commit.get("whole_leaves"):
            raise ValueError(
                f"checkpoint step {step} in {self.directory} was written by "
                f"{pc} process(es) but this run has {self.process_count} — "
                f"refusing to resume on a mismatched world size"
            )
        metas = []
        for k in range(pc):
            man = self._read_manifest(self._shard_path(step, k))
            if man is None:
                raise ValueError(
                    f"checkpoint step {step} is committed but shard p{k:02d} "
                    f"is missing/unreadable — checkpoint directory corrupt"
                )
            metas.append(man.get("meta"))
        if any(m != metas[0] for m in metas[1:]):
            raise ValueError(
                f"checkpoint step {step} shards disagree on meta "
                f"({metas}) — refusing to splice inconsistent shards"
            )

    def restore_latest(self, like: dict[str, Any], skip: Optional[set] = None, shardings: Optional[dict] = None
                       ) -> Optional[tuple[int, dict[str, Any]]]:
        """``(step, state)`` from the newest *valid* checkpoint, or ``None``
        if the directory holds none — the resume-or-start-fresh idiom of the
        campaign runner.

        A torn single-process step (a directory without a readable manifest)
        and a step whose leaf files fail their checksums
        (:class:`CheckpointCorruptError`) are skipped in favor of the next
        older step.  A world-size mismatch, a committed step with a missing
        shard, or shards disagreeing on ``meta`` raise: those are operator
        errors a silent fresh start would hide.

        ``skip`` excludes steps a caller already found corrupt when
        restoring a *different* subset of the state than ``like`` covers
        (the campaign runner restores the meta head first, then the carry).
        ``shardings`` (trees of ``ShardSpec`` by name) lays the leaves out
        over a mesh (see :meth:`restore`).  A whole-leaf manager also reads
        single-process steps.
        """
        committed = self._committed_steps()
        legacy = self._legacy_steps()
        if self.sharded and legacy and not committed and not self.whole_leaves:
            raise ValueError(
                f"{self.directory} holds single-process checkpoints but this "
                f"run has {self.process_count} processes — refusing to resume "
                f"on a mismatched world size"
            )
        for step in sorted(committed | legacy, reverse=True):
            if skip and step in skip:
                continue
            try:
                if step in committed:
                    self._validate_sharded(step)
                    return step, self.restore(step, like, shardings=shardings)
                if self.sharded and not self.whole_leaves:
                    continue  # orphan single-process dir below a committed step
                if self._read_manifest(os.path.join(self.directory, f"step_{step:09d}")) is None:
                    continue  # torn step: fall back to the previous one
                return step, self.restore(step, like, shardings=shardings)
            except CheckpointCorruptError as e:
                print(
                    f"[checkpoint] step {step} failed checksum verification "
                    f"({e}) — falling back to the previous committed step",
                    file=sys.stderr,
                )
                continue
        return None

    def _sources(self, step: int) -> list[str]:
        """The directories that hold ``step``'s leaves: this process's shard,
        every shard of a whole-leaf step, or the single-process directory."""
        if step in self._committed_steps():
            commit = self._commit(step)
            if commit.get("whole_leaves"):
                return [self._shard_path(step, k) for k in range(int(commit["process_count"]))]
            if not self.sharded:
                raise ValueError(
                    f"step {step} is a sharded checkpoint; restore it with a "
                    f"CheckpointManager(process_count=N) matching its writers"
                )
            return [self._shard_path(step, self.process_index)]
        if self.sharded and not self.whole_leaves:
            return [self._shard_path(step, self.process_index)]
        return [os.path.join(self.directory, f"step_{step:09d}")]

    def restore(self, step: int, like: dict[str, Any], *, in_place: bool = False,
                shardings: Optional[dict] = None) -> dict[str, Any]:
        """Rebuild the named trees of ``like`` (its structure, and each
        leaf's kind and device; see the module docstring) from ``step``.
        With ``in_place`` each tensor leaf of ``like`` is filled with its
        saved value straight from host memory and returned, so a restore
        into device tensors allocates nothing on the device; its shape and
        dtype must be the saved leaf's.  Sharded managers read only their
        own process's shard; a whole-leaf step is read from all of its
        shards, by any manager.  A leaf whose ``shardings`` entry is given
        (a ``ShardSpec`` over a ``DeviceMesh``), or whose ``like`` is a
        ``DTensor``, comes back as a ``DTensor``: each process maps the
        leaf's file and copies its own block, to ``like``'s device."""
        manifests = []
        for path in self._sources(step):
            with open(os.path.join(path, "manifest.json")) as f:
                manifests.append((path, json.load(f)))
        out = {}
        read_s = crc_s = 0.0
        nbytes = 0
        for name, tree in like.items():
            # leaf key → (file, checksum); a whole-leaf step's files keep their
            # index in the full sorted list of the tree's leaves
            files = {}
            for path, manifest in manifests:
                keys = manifest["leaves"][name]
                checksums = manifest.get("checksums") or {}  # none before checksum support
                idx = manifest["index"].get(name, []) if manifest.get("whole_leaves") else range(len(keys))
                for i, key in zip(idx, sorted(keys)):
                    fn = f"{name}/{i:05d}.npy"
                    files[key] = (os.path.join(path, name, f"{i:05d}.npy"), fn, checksums.get(fn))
            paths = _paths(tree)
            layout = dict(_paths(shardings[name])) if shardings and name in shardings else {}
            if sorted(p for p, _ in paths) != sorted(files):
                raise ValueError(f"checkpoint step {step}, {name}: leaf mismatch "
                                 f"({sorted(files)} on disk, {sorted(p for p, _ in paths)} asked)")
            loaded = {}
            # a leaf laid out over a mesh is mapped: its process copies only its block
            mapped = {p for p, leaf in paths if layout.get(p) is not None or hasattr(leaf, "full_tensor")}
            for key, (fpath, fn, want) in files.items():
                t0 = time.perf_counter()
                if want is not None and _crc(fpath) != want:
                    raise CheckpointCorruptError(
                        f"checkpoint leaf {fn} of step {step} in "
                        f"{self.directory} does not match its manifest "
                        f"checksum — refusing to deserialize corrupt data"
                    )
                t1 = time.perf_counter()
                loaded[key] = np.load(fpath, mmap_mode="r" if key in mapped else None)
                nbytes += loaded[key].nbytes
                crc_s += t1 - t0
                read_s += time.perf_counter() - t1
            t0 = time.perf_counter()
            out[name] = _unflatten(tree, {p: _like_leaf(loaded[p], leaf, in_place, f"{name}{p}", layout.get(p))
                                          for p, leaf in paths})
            read_s += time.perf_counter() - t0
        self.log.append({"op": "restore", "step": step, "bytes": nbytes, "crc_s": crc_s, "read_s": read_s})
        return out
