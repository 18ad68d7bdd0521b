"""Synthetic deterministic data pipeline.

The port of :mod:`repro.data.pipeline`. There is no corpus on disk, so the
pipeline draws token streams from a fixed-seed order-1 Markov chain over the
vocabulary, in numpy, with the reference's generator calls: the same seed
and step give the same tokens in both packages. Each token has ``branch``
successors, so the chain has learnable structure and a trained model's loss
falls well below ``ln(V)`` (towards ``ln(branch)``).

Batches are made on the host per step index (deterministic and restart-safe:
step N always yields the same batch) and moved to the caller's device as
int64 tensors, torch's index dtype. :class:`Prefetcher` keeps ``depth``
batches ready on a background thread.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.models.api import resolve_device

__all__ = ["MarkovLMDataset", "Prefetcher", "make_batch_fn"]


@dataclasses.dataclass
class MarkovLMDataset:
    """Order-1 Markov token stream with ``branch`` successors per token."""

    vocab: int
    seq_len: int
    batch: int
    seed: int = 0
    branch: int = 4  # successors per state -> target CE ~ ln(branch)

    def __post_init__(self) -> None:
        rng = np.random.default_rng(self.seed)
        self._succ = rng.integers(
            0, self.vocab, size=(self.vocab, self.branch), dtype=np.int64
        )

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Deterministic int32 ``tokens`` and ``labels`` [batch, seq_len] for
        a global step (restart-safe)."""
        rng = np.random.default_rng((self.seed, step))
        b, s = self.batch, self.seq_len
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, size=b)
        choices = rng.integers(0, self.branch, size=(b, s))
        for t in range(s):
            toks[:, t + 1] = self._succ[toks[:, t], choices[:, t]]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def make_batch_fn(dataset: MarkovLMDataset, device=None):
    """``step -> {"tokens", "labels"}``: int64 tensors on ``device``
    (default ``cuda``; without a card that raises, as every entry point)."""
    device = resolve_device(device)

    def fn(step: int) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v.astype(np.int64)).to(device)
                for k, v in dataset.batch_at(step).items()}

    return fn


class Prefetcher:
    """Background thread that keeps ``depth`` batches ready; :meth:`get`
    returns ``(step, batch)`` in step order from ``start_step``."""

    def __init__(self, batch_fn, start_step: int = 0, depth: int = 2):
        self._fn = batch_fn
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._next = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self) -> None:
        step = self._next
        while not self._stop.is_set():
            try:
                self._q.put((step, self._fn(step)), timeout=0.2)
                step += 1
            except queue.Full:
                continue

    def get(self):
        return self._q.get()

    def close(self) -> None:
        self._stop.set()
        while not self._q.empty():
            self._q.get_nowait()
        self._thread.join(timeout=2)
