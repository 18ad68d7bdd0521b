"""Slot-pooled KV cache for continuous batching, and the radix prefix cache.

The port of :mod:`repro.serve.cache`. The pool owns one cache per layer for
the engine's lifetime: a KV buffer sized ``[n_slots, max_len]`` for an
attention layer, a recurrent state ``[n_slots, ...]`` for a mamba or xLSTM
one. A request leases one slot (one batch lane) while it is live.

* join: a prefilled request's caches (sized to its prompt bucket) are copied
  into its slot's rows, in place (:func:`scatter_slots`): a KV cache's
  prompt span, a recurrent state's whole row;
* decode: every slot appends at its own position (``api.decode_at``);
* release: host bookkeeping only; the lane's stale K/V stays masked by its
  length until the next join overwrites it.

**Quantized K/V lanes** (``kv_format`` "int8", "fp8_e4m3" or "fp8_e5m2"):
the pool's caches are :class:`~repro_torch.quant.kvcache.QuantKVCache` —
one-byte values with fp32 per-slot, per-head scales, calibrated at join
time from each request's prefilled K/V and fixed for its lifetime.

**Prefix cache** (:class:`PrefixCache`): a trie over token-id blocks that
keeps finished prompts' K/V, so a request sharing a cached prefix attaches
it and prefills only its suffix.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import api as model_api
from repro_torch.models.attention import KVCache
from repro_torch.quant.kvcache import (
    DEFAULT_KV_MARGIN,
    QuantKVCache,
    _dequant,
    kv_bytes_per_slot,
    quantize_kv_rows,
)
from repro_torch.quant.quantize import format_of

__all__ = [
    "SlotPool",
    "PrefixCache",
    "PrefixNode",
    "init_slot_caches",
    "scatter_slots",
]


def init_slot_caches(
    cfg: ArchConfig, n_slots: int, max_len: int, dtype, device,
    kv_format: Optional[str] = None,
) -> List[Any]:
    """Pool-shaped caches, one entry per layer: each KV cache with an int64
    ``[n_slots]`` fill vector, each recurrent state (mamba, mLSTM, sLSTM)
    zeroed at full width. ``kv_format`` (a :data:`repro_torch.quant.FORMATS`
    name) narrows the K/V lanes to that format with per-slot, per-head
    scales; recurrent states stay full width, as the reference's do (they
    are rewritten whole every step, not appended to and read again)."""
    caches = model_api.init_state(cfg, n_slots, max_len, dtype, device)
    lengths = torch.zeros((n_slots,), dtype=torch.int64, device=model_api.resolve_device(device))
    out = []
    for c in caches:
        if not isinstance(c, KVCache):
            out.append(c)
        elif kv_format is None:
            out.append(KVCache(c.k, c.v, lengths))
        else:
            out.append(dataclasses.replace(
                QuantKVCache.zeros(n_slots, max_len, cfg.n_kv, cfg.head_dim_,
                                   fmt=kv_format, device=lengths.device),
                length=lengths))
    return out


def _first(cache) -> torch.Tensor:
    """One layer's cache's first field (``k`` or a state's first tensor),
    whose leading dim is the batch rows."""
    return getattr(cache, dataclasses.fields(cache)[0].name)


def scatter_slots(
    pool_caches: List[Any], prefill_caches: List[Any], slots: Sequence[int],
    scale_floors=None,
) -> List[Any]:
    """Copy prefilled rows into pool slots, in place: row ``i`` of the
    prefill caches goes to slot ``slots[i]``, a KV cache's positions
    ``[:Lb]`` and a recurrent state's whole row. Slot indices past the pool
    (filler rows) are dropped.

    A quantized pool calibrates per-(row, head) scales from each row's
    prefilled span (amax over the whole bucket, with the margin), quantizes,
    and stores the scales in the slot's sidecar. ``scale_floors`` (one
    ``None`` or ``(k_floor, v_floor)`` ``[rows, n_kv]`` per layer) carries
    the scales of a quantized cached prefix that a row attached (zeros for
    the other rows): see :func:`~repro_torch.quant.kvcache.quantize_kv_rows`.
    """
    n_slots = _first(pool_caches[0]).shape[0]
    rows = [i for i, s in enumerate(slots) if 0 <= s < n_slots]
    if not rows:
        return pool_caches
    device = _first(pool_caches[0]).device
    src = torch.tensor(rows, dtype=torch.int64, device=device)
    dst = torch.tensor([slots[i] for i in rows], dtype=torch.int64, device=device)
    floors = scale_floors or (None,) * len(pool_caches)
    for pc, fc, fl in zip(pool_caches, prefill_caches, floors):
        if isinstance(pc, QuantKVCache):
            lb = fc.k.shape[1]
            k_q, v_q, k_s, v_s = quantize_kv_rows(
                fc.k[src], fc.v[src], pc.n_kv, fmt=pc.k.dtype, margin=DEFAULT_KV_MARGIN,
                k_scale_floor=None if fl is None else fl[0][src],
                v_scale_floor=None if fl is None else fl[1][src],
            )
            pc.k[dst, :lb] = k_q
            pc.v[dst, :lb] = v_q
            pc.k_scale[dst] = k_s
            pc.v_scale[dst] = v_s
        elif isinstance(pc, KVCache):
            lb = fc.k.shape[1]
            pc.k[dst, :lb] = fc.k[src].to(pc.k.dtype)
            pc.v[dst, :lb] = fc.v[src].to(pc.v.dtype)
        else:
            for f in dataclasses.fields(pc):
                p, x = getattr(pc, f.name), getattr(fc, f.name)
                p[dst] = x[src].to(p.dtype)
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
        device=None, kv_format: Optional[str] = None,
    ) -> "SlotPool":
        return cls(
            cfg=cfg,
            n_slots=n_slots,
            max_len=max_len,
            caches=init_slot_caches(cfg, n_slots, max_len, dtype, device, kv_format),
            _free=list(range(n_slots)),
            _owner={},
        )

    def kv_bytes_per_slot(self) -> float:
        """K/V cache bytes held per slot (values + scale sidecars)."""
        return kv_bytes_per_slot(self.caches)

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

    def join(self, prefill_caches: List[KVCache], slots: List[int], scale_floors=None) -> None:
        """Copy a prefilled bucket into the leased ``slots``; prefill rows
        beyond ``len(slots)`` (row-count padding) are dropped.
        ``scale_floors`` passes through to :func:`scatter_slots`."""
        n_rows = _first(prefill_caches[0]).shape[0]
        idx = list(slots) + [self.n_slots] * (n_rows - len(slots))
        self.caches = scatter_slots(self.caches, prefill_caches, idx, scale_floors)


# ---------------------------------------------------------------------------
# Radix prefix cache
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PrefixNode:
    """One block of cached prompt K/V: an edge of the trie.

    ``payload`` has one entry per layer: ``None`` for a layer without K/V,
    else the block's full-precision ``(k, v)`` ``[block, fused]`` or, in a
    quantized trie, ``(k_q, v_q, k_scale, v_scale)`` with fp32 per-head
    scales ``[n_kv]``. Payloads are copies, never views of a prefill's
    buffers (a view would keep a join's whole buffer alive).
    """

    block: tuple  # the token-id block keying this edge
    parent: Optional["PrefixNode"]
    children: Dict[tuple, "PrefixNode"] = dataclasses.field(default_factory=dict)
    payload: tuple = ()
    refcount: int = 0
    last_used: int = 0
    # Memoized ``gather`` of the root-to-here path. Payloads never change
    # (first writer wins) and ancestors outlive this node (eviction takes
    # childless leaves only), so the memo holds while the node does.
    gathered: Optional[tuple] = None


class PrefixCache:
    """Radix prompt-prefix cache over blocks of ``block_size`` token ids.

    Each edge holds its block's per-layer K/V (quantized to ``kv_format``
    when set). The engine matches a new prompt, attaches the longest cached
    prefix into the request's prefill caches and chunk-prefills the suffix.
    Matched nodes are ref-counted (``acquire``/``release``) while a join
    uses them, so eviction, LRU over refcount-0 leaves whenever
    ``cached_tokens`` exceeds ``capacity_tokens``, never takes them.
    Host-side bookkeeping; the payloads are device tensors.
    """

    def __init__(
        self,
        *,
        block_size: int = 16,
        capacity_tokens: int = 1 << 16,
        kv_format: Optional[str] = None,
        n_kv: Optional[int] = None,
        margin: float = DEFAULT_KV_MARGIN,
    ):
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        if kv_format is not None and n_kv is None:
            raise ValueError("quantized prefix trie needs n_kv for its scales")
        self.block_size = int(block_size)
        self.capacity_tokens = int(capacity_tokens)
        self.kv_format = kv_format
        self.n_kv = n_kv
        self.margin = margin
        self._root = PrefixNode(block=(), parent=None)
        self._clock = 0
        self._n_nodes = 0
        self.evictions = 0
        self.hits = 0
        self.misses = 0

    @property
    def cached_tokens(self) -> int:
        return self._n_nodes * self.block_size

    @property
    def n_nodes(self) -> int:
        return self._n_nodes

    def match(self, tokens) -> Tuple[List[PrefixNode], int]:
        """Longest cached prefix of ``tokens`` in whole blocks, leaving at
        least one prompt token to prefill (the join needs real last-token
        logits). Returns ``(path nodes, matched token count)`` and refreshes
        the LRU clock of every node on the path."""
        toks = [int(t) for t in tokens]
        node, path, matched = self._root, [], 0
        while matched + self.block_size <= len(toks) - 1:
            child = node.children.get(tuple(toks[matched : matched + self.block_size]))
            if child is None:
                break
            path.append(child)
            matched += self.block_size
            node = child
        self._clock += 1
        for n in path:
            n.last_used = self._clock
        return path, matched

    def acquire(self, nodes: List[PrefixNode]) -> None:
        for n in nodes:
            n.refcount += 1

    def release(self, nodes: List[PrefixNode]) -> None:
        for n in nodes:
            if n.refcount <= 0:
                raise AssertionError("prefix node released more times than acquired")
            n.refcount -= 1

    def insert(self, tokens, plen: int, prefill_caches, row: int) -> int:
        """Insert the whole blocks of ``tokens[:plen]`` from one finished
        prefill (``prefill_caches``: the request's full-precision per-layer
        caches, ``row`` its lane). A block already present keeps its payload
        (first writer wins). Returns the number of new blocks, then evicts
        down to capacity."""
        toks = [int(t) for t in tokens[:plen]]
        n_blocks = len(toks) // self.block_size
        if not n_blocks:
            return 0
        scales = _span_scales(
            prefill_caches, row, n_blocks * self.block_size,
            fmt=self.kv_format, n_kv=self.n_kv, margin=self.margin,
        ) if self.kv_format is not None else None
        node, created = self._root, 0
        self._clock += 1
        for j in range(n_blocks):
            lo, hi = j * self.block_size, (j + 1) * self.block_size
            blk = tuple(toks[lo:hi])
            child = node.children.get(blk)
            if child is None:
                payload = _slice_payload(prefill_caches, row, lo, hi,
                                         fmt=self.kv_format, span_scales=scales)
                child = PrefixNode(block=blk, parent=node, payload=payload)
                node.children[blk] = child
                self._n_nodes += 1
                created += 1
            child.last_used = self._clock
            node = child
        self._evict_to_capacity()
        return created

    def gather(self, nodes: List[PrefixNode]):
        """Concatenate a matched path into attachable per-layer spans.

        Returns ``(spans, floors)``: ``spans`` has ``None`` or a
        full-precision ``(k, v)`` ``[L, fused]`` per layer (quantized
        payloads dequantize to fp32 here: chunks prefill full-precision
        caches); ``floors`` is ``None`` for a full-precision trie, else per
        layer ``None`` or the ``(k_scale, v_scale)`` ``[n_kv]`` floors
        (elementwise max over the path's blocks) for the join's scale
        adoption."""
        if not nodes:
            raise ValueError("gather of an empty prefix path")
        if nodes[-1].gathered is not None:
            return nodes[-1].gathered
        spans, floors = [], []
        for e in range(len(nodes[0].payload)):
            parts = [n.payload[e] for n in nodes]
            if parts[0] is None:
                spans.append(None)
                floors.append(None)
            elif self.kv_format is None:
                spans.append((torch.cat([p[0] for p in parts]),
                              torch.cat([p[1] for p in parts])))
                floors.append(None)
            else:
                spans.append((
                    torch.cat([_dequant(p[0], p[2], torch.float32) for p in parts]),
                    torch.cat([_dequant(p[1], p[3], torch.float32) for p in parts]),
                ))
                floors.append((functools.reduce(torch.maximum, [p[2] for p in parts]),
                               functools.reduce(torch.maximum, [p[3] for p in parts])))
        out = tuple(spans), (None if self.kv_format is None else tuple(floors))
        nodes[-1].gathered = out
        return out

    def _evict_to_capacity(self) -> None:
        while self.cached_tokens > self.capacity_tokens:
            victim = None
            stack = [self._root]
            while stack:
                n = stack.pop()
                stack.extend(n.children.values())
                if (
                    n is not self._root
                    and not n.children
                    and n.refcount == 0
                    and (victim is None or n.last_used < victim.last_used)
                ):
                    victim = n
            if victim is None:
                return  # everything resident is referenced: over capacity
            del victim.parent.children[victim.block]
            self._n_nodes -= 1
            self.evictions += 1


def _kv_entries(prefill_caches):
    """``(layer, KVCache)`` for the attention caches of a request's
    standalone prefill caches ``[rows, Lb, fused]``."""
    for i, c in enumerate(prefill_caches):
        if isinstance(c, QuantKVCache):
            raise TypeError(
                "prefix insertion reads full-precision standalone caches; "
                "quantization happens inside the trie"
            )
        if isinstance(c, KVCache):
            yield i, c


def _span_scales(prefill_caches, row: int, span: int, *, fmt, n_kv: int, margin: float):
    """Per-layer per-head scales calibrated over the whole inserted span:
    the blocks of one insertion share one scale."""
    f = format_of(fmt)
    scales = {}
    for i, c in _kv_entries(prefill_caches):
        out = []
        for x in (c.k, c.v):
            xh = x[row, :span].float()
            xh = xh.reshape(span, n_kv, xh.shape[-1] // n_kv)
            amax = xh.abs().amax(dim=(0, 2))  # [n_kv]
            out.append(torch.clamp_min(amax * margin, 1e-12) / f.qmax)
        scales[i] = tuple(out)
    return scales


def _slice_payload(prefill_caches, row: int, lo: int, hi: int, *, fmt, span_scales):
    """One block's payload (one entry per layer), copied out of the
    prefill caches."""
    kv_at = dict(_kv_entries(prefill_caches))
    payload = []
    for i in range(len(prefill_caches)):
        c = kv_at.get(i)
        if c is None:
            payload.append(None)
            continue
        k, v = c.k[row, lo:hi], c.v[row, lo:hi]
        if fmt is None:
            payload.append((k.clone(), v.clone()))
            continue
        f = format_of(fmt)
        k_s, v_s = span_scales[i]
        n_kv = k_s.shape[-1]

        def q(x, s):
            sp, fused = x.shape
            xh = x.float().reshape(sp, n_kv, fused // n_kv)
            return f.cast(xh / s[None, :, None]).reshape(sp, fused)

        payload.append((q(k, k_s), q(v, v_s), k_s, v_s))
    return tuple(payload)
