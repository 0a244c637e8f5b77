"""Synthetic data pipeline: deterministic token streams with learnable
structure, and a background prefetch onto the device.

The JAX package's ``training/data.py`` in PyTorch.  The batches are numpy
and bitwise the reference's (the same generators drawn in the same order).
The bigram-chain generator gives the convergence tests something a model
can learn (the loss must drop below the unigram entropy); the uniform
stream is for throughput.  :class:`Prefetcher` overlaps host batch
synthesis with device compute, the data-pipeline half of straggler
mitigation (``training/elastic.py`` watches its wait).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    kind: str = "bigram"      # bigram | uniform
    seed: int = 0
    n_frontend_tokens: int = 0
    frontend: Optional[str] = None
    d_model: int = 0


def _bigram_table(vocab: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    # each token prefers a handful of successors → learnable structure
    table = rng.dirichlet(np.full(min(vocab, 32), 0.2), size=vocab)
    succ = rng.integers(0, vocab, size=(vocab, min(vocab, 32)))
    return table, succ


def batches(cfg: DataConfig) -> Iterator[dict[str, np.ndarray]]:
    """Endless batches ``{"tokens" [B,S], "labels" [B,S]}`` (int32), with
    ``frames`` (audio) or ``patches`` (vision) ``[B,n,d_model]`` fp32 for a
    frontend; a VLM's labels gain ``-100`` over its patch positions."""
    rng = np.random.default_rng(cfg.seed)
    if cfg.kind == "bigram":
        probs, succ = _bigram_table(cfg.vocab_size, cfg.seed + 1)
    while True:
        B, S = cfg.global_batch, cfg.seq_len
        if cfg.kind == "uniform":
            toks = rng.integers(0, cfg.vocab_size, size=(B, S + 1))
        else:
            toks = np.empty((B, S + 1), np.int64)
            toks[:, 0] = rng.integers(0, cfg.vocab_size, size=B)
            for t in range(S):
                p = probs[toks[:, t]]
                choice = (p.cumsum(1) > rng.random((B, 1))).argmax(1)
                toks[:, t + 1] = succ[toks[:, t], choice]
        batch = {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }
        if cfg.frontend:
            batch["frames" if cfg.frontend == "audio_frames" else "patches"] = rng.normal(
                size=(B, cfg.n_frontend_tokens, cfg.d_model)
            ).astype(np.float32)
            if cfg.frontend == "vision_patches":
                # patch positions carry no next-token loss
                pad = np.full((B, cfg.n_frontend_tokens), -100, np.int32)
                batch["labels"] = np.concatenate([pad, batch["labels"]], axis=1)
        yield batch


class Prefetcher:
    """A background thread that draws batches from ``it`` and puts each on
    ``device`` (``None`` → the card) ahead of use, at most ``depth`` ahead.
    On the card each array goes through pinned memory with an asynchronous
    copy; on the CPU it becomes a tensor sharing the array's memory."""

    def __init__(self, it: Iterator, depth: int = 2, device=None):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self._device = resolve_device(device)
        self._stop = threading.Event()
        self._last_wait_s = 0.0
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _place(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        if self._device.type == "cpu":
            return t
        return t.pin_memory().to(self._device, non_blocking=True)

    def _offer(self, item) -> bool:
        """Put ``item`` on the queue, waiting while it is full, unless closed meanwhile."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                pass
        return False

    def _run(self):
        for item in self._it:
            if self._stop.is_set() or not self._offer({k: self._place(v) for k, v in item.items()}):
                return
        self._offer(None)

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        item = self._q.get()
        self._last_wait_s = time.perf_counter() - t0
        if item is None:
            raise StopIteration
        return item

    @property
    def last_wait_s(self) -> float:
        """Input-bound stall of the last ``next``, for the straggler watchdog."""
        return self._last_wait_s

    def close(self):
        """Stop drawing: the thread ends after the batch it is drawing or
        placing, even with the queue full (a ``next`` after this may still
        return the batches already queued)."""
        self._stop.set()
