"""Continuous-batching serving engine: keep every decode lane busy.

The port of the monolithic-prefill path of :mod:`repro.serve.continuous`.
One masked decode step runs over a fixed pool of ``n_slots`` lanes; a
finished request frees its slot mid-flight and the next queued requests are
prefilled (one prompt-length bucket, rows rounded up to a power of two) and
copied in.

Step loop (one tick = one decode step over the pool):

1. join — while slots are free and arrived requests queue, prefill one
   bucket (``api.prefill_bucketed``), sample each request's first token from
   its last-prompt-token logits, copy the caches into leased slots.
2. decode — one ``api.decode_at`` + sample over all lanes; inactive lanes
   hold their token and position.
3. evict — count each active lane's token; requests at EOS or at their
   token budget retire and free their slot.

Without EOS or a streaming callback, retirement depends only on token
counts, so token values are fetched once at the end of the run.

Chunked prefill, the prefix cache, quantized K/V lanes, SLO goodput and
tracing are not ported yet; setting them raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import math
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import api as model_api
from repro_torch.models.transformer import check_supported

from .cache import SlotPool
from .engine import sample_token
from .scheduler import Request, Scheduler

__all__ = ["ContinuousEngine", "ServingReport", "percentile"]


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """Linear-interpolated percentile (q in [0, 100]); ``None`` when there
    are no samples — no data is not zero latency."""
    if not values:
        return None
    xs = sorted(values)
    if len(xs) == 1:
        return float(xs[0])
    rank = (q / 100.0) * (len(xs) - 1)
    lo = int(math.floor(rank))
    hi = min(lo + 1, len(xs) - 1)
    frac = rank - lo
    return float(xs[lo] * (1.0 - frac) + xs[hi] * frac)


@dataclasses.dataclass
class ServingReport:
    """Outcome of one ``serve`` run and its utilization counters."""

    outputs: Dict[int, List[int]]  # rid -> generated tokens
    generated_tokens: int
    decode_steps: int
    prefill_batches: int
    mean_occupancy: float  # mean active-slot fraction per decode step
    wall_time_s: float
    # Host-clock latency percentiles in seconds (None without samples).
    # TTFT: from the request's arrival tick to its first token (sampled from
    # the prefill logits at join). ITL: between a lane's consecutive tokens;
    # on the deferred-fetch path this is the host's dispatch cadence.
    ttft_p50: Optional[float] = None
    ttft_p99: Optional[float] = None
    itl_p50: Optional[float] = None
    itl_p99: Optional[float] = None

    @property
    def tokens_per_sec(self) -> float:
        return self.generated_tokens / self.wall_time_s if self.wall_time_s else 0.0

    @property
    def tokens_per_step(self) -> float:
        return self.generated_tokens / self.decode_steps if self.decode_steps else 0.0


@dataclasses.dataclass
class ContinuousEngine:
    """Continuous-batching engine over ``n_slots`` pooled decode lanes, on
    the device that holds ``params``."""

    cfg: ArchConfig
    params: Any
    n_slots: int
    max_len: int
    cache_dtype: torch.dtype = torch.bfloat16
    temperature: float = 0.0
    eos_id: Optional[int] = None
    exact_buckets: Optional[bool] = None  # None = exact iff recurrent mixers
    # Not ported yet: must stay unset.
    kv_format: Optional[str] = None
    prefill_chunk: Optional[int] = None
    prefix_cache: Optional[bool] = None
    slo_ttft_ms: Optional[float] = None
    slo_itl_ms: Optional[float] = None

    def __post_init__(self) -> None:
        check_supported(self.cfg)
        if self.cfg.moe is not None and not self.cfg.moe.dropless:
            # Token-choice capacity dropping routes by whole-batch content:
            # one request's load would change another's outputs. Dropless
            # routing is per-token, keeping slots independent.
            warnings.warn(
                "continuous batching with capacity-dropping MoE couples "
                "requests through the router; set moe.dropless for "
                "request-isolated serving",
                RuntimeWarning,
                stacklevel=2,
            )
        for name in ("kv_format", "prefill_chunk", "prefix_cache", "slo_ttft_ms", "slo_itl_ms"):
            if getattr(self, name):
                raise NotImplementedError(f"ContinuousEngine.{name} is not ported yet")
        self.device = self.params["embed"]["table"].device

    # -- serving -----------------------------------------------------------

    @torch.inference_mode()
    def serve(
        self,
        requests: List[Request],
        *,
        generator: Optional[torch.Generator] = None,
        on_token: Optional[Callable[[int, int], None]] = None,
        max_steps: Optional[int] = None,
    ) -> ServingReport:
        """Run ``requests`` to completion; returns outputs + counters.
        ``on_token(rid, token)`` streams each sampled token as the host sees
        it (and makes every step wait for its tokens)."""
        for r in requests:
            if len(r.prompt) + r.max_new_tokens > self.max_len:
                raise ValueError(
                    f"request {r.rid}: prompt {len(r.prompt)} + "
                    f"max_new {r.max_new_tokens} exceeds max_len {self.max_len}"
                )
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        sched = Scheduler(
            self.cfg, eos_id=self.eos_id, exact_buckets=self.exact_buckets,
            max_bucket=self.max_len,
        )
        for r in requests:
            sched.submit(r)
        pool = SlotPool.create(
            self.cfg, self.n_slots, self.max_len, self.cache_dtype, self.device
        )

        b = self.n_slots
        tok = torch.zeros((b, 1), dtype=torch.int64, device=self.device)
        pos = torch.zeros((b,), dtype=torch.int64, device=self.device)
        active = [False] * b  # host truth; the device mask follows on change
        active_dev = torch.tensor(active, device=self.device)
        sync = on_token is not None or self.eos_id is not None
        pending = []  # (device tokens [*, 1], [(row, rid), ...]) per step

        wall = time.perf_counter
        by_arrival = sorted(requests, key=lambda r: r.arrival)
        n_arrival_stamped = 0
        arrive: Dict[int, float] = {}
        last_tok: Dict[int, float] = {}
        ttfts: List[float] = []
        itls: List[float] = []

        step = 0
        decode_steps = 0
        prefill_batches = 0
        generated = 0
        occupancy_acc = 0.0
        limit = max_steps if max_steps is not None else (
            sum(r.arrival + r.max_new_tokens for r in requests) + 10 * self.max_len
        )

        while not (sched.drained and pool.n_active == 0):
            if step > limit:
                raise RuntimeError(f"serving did not drain within {limit} steps")
            while (
                n_arrival_stamped < len(by_arrival)
                and by_arrival[n_arrival_stamped].arrival <= step
            ):
                arrive[by_arrival[n_arrival_stamped].rid] = wall()
                n_arrival_stamped += 1

            # -- join: refill free slots from the queue ---------------------
            joined = False
            while pool.n_free:
                batch = sched.next_batch(pool.n_free, now=step)
                if not batch:
                    break
                tok, pos, n_gen = self._join(
                    sched, pool, batch, tok, pos, active, generator, step,
                    on_token, sync, pending,
                )
                prefill_batches += 1
                generated += n_gen  # one token per request, prefill logits
                joined = True
                # TTFT closes when the first token's work is issued, as in
                # the JAX engine; without ``sync`` the card may not have
                # run it yet, so TTFT and ITL are host-issue times.
                ts = wall()
                for r in batch:
                    ttfts.append(ts - arrive.get(r.rid, ts))
                    last_tok[r.rid] = ts
            if joined:
                active_dev = torch.tensor(active, device=self.device)

            if not any(active):
                if sched.drained:
                    break
                step += 1  # idle tick: wait for the next arrival
                continue

            # -- decode: one masked step over the whole pool ----------------
            n_live = sum(active)
            tok, pool.caches, pos = self._decode(
                pool.caches, tok, pos, active_dev, generator
            )
            decode_steps += 1
            occupancy_acc += n_live / self.n_slots
            step += 1

            # -- evict: count tokens, retire finished requests --------------
            live = [
                s for s in pool.active_slots()
                if active[s] and pool.owner_of(s) is not None
            ]
            live_rids = [pool.owner_of(s) for s in live]
            changed = False
            if sync:
                emitted = tok[:, 0].cpu().numpy()
                for slot, rid in zip(live, live_rids):
                    t = int(emitted[slot])
                    if on_token is not None:
                        on_token(rid, t)
                    generated += 1
                    if sched.record_token(rid, t, now=step):
                        pool.release(slot)
                        active[slot] = False
                        changed = True
            else:
                pending.append((tok, list(zip(live, live_rids))))
                for slot, rid in zip(live, live_rids):
                    generated += 1
                    if sched.record_emitted(rid, now=step):
                        pool.release(slot)
                        active[slot] = False
                        changed = True
            if changed:
                active_dev = torch.tensor(active, device=self.device)
            now = wall()
            for rid in live_rids:
                prev = last_tok.get(rid)
                if prev is not None:
                    itls.append(now - prev)
                last_tok[rid] = now

        # Deferred fetch: token values come to the host once, at the end.
        for arr, pairs in pending:
            vals = arr[:, 0].cpu().numpy()
            for row, rid in pairs:
                sched.states[rid].tokens.append(int(vals[row]))
        return ServingReport(
            outputs={rid: st.tokens for rid, st in sched.states.items()},
            generated_tokens=generated,
            decode_steps=decode_steps,
            prefill_batches=prefill_batches,
            mean_occupancy=(occupancy_acc / decode_steps) if decode_steps else 0.0,
            wall_time_s=0.0,  # stamped by timed_serve
            ttft_p50=percentile(ttfts, 50),
            ttft_p99=percentile(ttfts, 99),
            itl_p50=percentile(itls, 50),
            itl_p99=percentile(itls, 99),
        )

    def timed_serve(self, requests: List[Request], **kw) -> ServingReport:
        """``serve`` with its wall time stamped (the run ends on a host
        fetch of the tokens, so the device has finished)."""
        t0 = time.perf_counter()
        report = self.serve(requests, **kw)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        report.wall_time_s = time.perf_counter() - t0
        return report

    # -- internals ---------------------------------------------------------

    def _decode(self, caches, tok, pos, active, generator):
        logits, caches = model_api.decode_at(self.cfg, self.params, tok, caches, pos)
        nxt = sample_token(logits, generator, self.temperature)
        # Masked lanes hold token and position: the step never changes shape.
        nxt = torch.where(active[:, None], nxt, tok)
        return nxt, caches, pos + active.to(torch.int64)

    def _join(
        self, sched: Scheduler, pool: SlotPool, batch: List[Request], tok, pos,
        active: List[bool], generator, step: int, on_token, sync: bool, pending,
    ):
        """Prefill one bucket, copy it into leased slots, seed the lanes."""
        lb = sched.bucket(max(len(r.prompt) for r in batch))
        # Rows round up to a power of two, as the reference bounds its
        # compiled prefill shapes (filler rows repeat row 0 and are dropped).
        rows = 1
        while rows < len(batch):
            rows *= 2
        tokens = np.zeros((rows, lb), np.int64)
        lengths = np.ones((rows,), np.int64)
        for i, r in enumerate(batch):
            tokens[i, : len(r.prompt)] = np.asarray(r.prompt, np.int64)
            lengths[i] = len(r.prompt)
        if rows > len(batch):
            tokens[len(batch):] = tokens[0]
            lengths[len(batch):] = lengths[0]
        logits, caches = model_api.prefill_bucketed(
            self.cfg, self.params,
            torch.from_numpy(tokens).to(self.device),
            torch.from_numpy(lengths).to(self.device),
            self.cache_dtype,
        )
        first = sample_token(logits, generator, self.temperature)

        slots = pool.allocate([r.rid for r in batch])
        sched.admit(batch, slots, now=step)
        pool.join(caches, slots)

        n = len(batch)
        slot_idx = torch.tensor(slots, dtype=torch.int64, device=self.device)
        # Out of place: earlier `tok` tensors wait in `pending` for the fetch.
        tok = tok.index_put((slot_idx,), first[:n])
        pos = pos.index_put(
            (slot_idx,), torch.from_numpy(lengths[:n]).to(self.device)
        )
        if sync:
            first_host = first[:, 0].cpu().numpy()
            for i, r in enumerate(batch):
                t = int(first_host[i])
                if on_token is not None:
                    on_token(r.rid, t)
                if sched.record_token(r.rid, t, now=step):
                    pool.release(slots[i])  # one-token request: retire at join
                else:
                    active[slots[i]] = True
        else:
            pending.append((first, [(i, r.rid) for i, r in enumerate(batch)]))
            for i, r in enumerate(batch):
                if sched.record_emitted(r.rid, now=step):
                    pool.release(slots[i])
                else:
                    active[slots[i]] = True
        return tok, pos, n
