"""Slot-pooled KV cache for continuous batching.

The port of the full-precision part of :mod:`repro.serve.cache`. The pool
owns one KV buffer per layer sized ``[n_slots, max_len]`` for the engine's
lifetime; a request leases one slot (one batch lane) while it is live.

* join: a prefilled request's caches (sized to its prompt bucket) are copied
  into its slot's rows, in place (:func:`scatter_slots`);
* decode: every slot appends at its own position (``api.decode_at``);
* release: host bookkeeping only; the lane's stale K/V stays masked by its
  length until the next join overwrites it.

Quantized K/V lanes and the prefix cache are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import api as model_api
from repro_torch.models.attention import KVCache

__all__ = ["SlotPool", "init_slot_caches", "scatter_slots"]


def init_slot_caches(
    cfg: ArchConfig, n_slots: int, max_len: int, dtype, device
) -> List[KVCache]:
    """Pool-shaped caches, each with an int64 ``[n_slots]`` fill vector."""
    caches = model_api.init_state(cfg, n_slots, max_len, dtype, device)
    lengths = torch.zeros((n_slots,), dtype=torch.int64, device=caches[0].k.device)
    return [KVCache(c.k, c.v, lengths) for c in caches]


def scatter_slots(
    pool_caches: List[KVCache], prefill_caches: List[KVCache], slots: Sequence[int]
) -> List[KVCache]:
    """Copy prefilled rows into pool slots, in place: row ``i`` of the
    prefill caches goes to slot ``slots[i]``, positions ``[:Lb]``. Slot
    indices past the pool (filler rows) are dropped."""
    n_slots = pool_caches[0].k.shape[0]
    rows = [i for i, s in enumerate(slots) if 0 <= s < n_slots]
    if not rows:
        return pool_caches
    device = pool_caches[0].k.device
    src = torch.tensor(rows, dtype=torch.int64, device=device)
    dst = torch.tensor([slots[i] for i in rows], dtype=torch.int64, device=device)
    for pc, fc in zip(pool_caches, prefill_caches):
        lb = fc.k.shape[1]
        pc.k[dst, :lb] = fc.k[src].to(pc.k.dtype)
        pc.v[dst, :lb] = fc.v[src].to(pc.v.dtype)
    return pool_caches


@dataclasses.dataclass
class SlotPool:
    """Device caches + host-side slot lease bookkeeping."""

    cfg: ArchConfig
    n_slots: int
    max_len: int
    caches: Any
    _free: List[int]
    _owner: Dict[int, Any]  # slot -> request id
    leased_hwm: int = 0  # peak concurrently leased slots

    @classmethod
    def create(
        cls, cfg: ArchConfig, n_slots: int, max_len: int, dtype=torch.bfloat16,
        device=None,
    ) -> "SlotPool":
        return cls(
            cfg=cfg,
            n_slots=n_slots,
            max_len=max_len,
            caches=init_slot_caches(cfg, n_slots, max_len, dtype, device),
            _free=list(range(n_slots)),
            _owner={},
        )

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_active(self) -> int:
        return self.n_slots - len(self._free)

    @property
    def occupancy(self) -> float:
        return self.n_active / self.n_slots

    def owner_of(self, slot: int):
        return self._owner.get(slot)

    def active_slots(self) -> List[int]:
        return sorted(self._owner)

    def allocate(self, request_ids) -> List[int]:
        """Lease one slot per request id (lowest-numbered slots first)."""
        if len(request_ids) > len(self._free):
            raise RuntimeError(
                f"requested {len(request_ids)} slots, {len(self._free)} free"
            )
        self._free.sort()
        slots = [self._free.pop(0) for _ in request_ids]
        for s, rid in zip(slots, request_ids):
            self._owner[s] = rid
        self.leased_hwm = max(self.leased_hwm, len(self._owner))
        return slots

    def release(self, slot: int) -> bool:
        """Return ``slot`` to the free list. Idempotent: releasing a free
        in-range slot is a no-op returning ``False``; an out-of-range slot
        id raises."""
        if not (0 <= slot < self.n_slots):
            raise KeyError(f"slot {slot} out of range [0, {self.n_slots})")
        rid = self._owner.pop(slot, None)
        if rid is None:
            return False
        self._free.append(slot)
        return True

    def join(self, prefill_caches: List[KVCache], slots: List[int]) -> None:
        """Copy a prefilled bucket into the leased ``slots``; prefill rows
        beyond ``len(slots)`` (row-count padding) are dropped."""
        n_rows = prefill_caches[0].k.shape[0]
        idx = list(slots) + [self.n_slots] * (n_rows - len(slots))
        self.caches = scatter_slots(self.caches, prefill_caches, idx)
