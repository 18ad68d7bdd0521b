"""Continuous-batching serving engine: keep every decode lane busy.

The port of :mod:`repro.serve.continuous`. One masked decode step runs over
a fixed pool of ``n_slots`` lanes; a finished request frees its slot
mid-flight and the next queued requests are prefilled (one prompt-length
bucket, rows rounded up to a power of two) and copied in.

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

Prompt-side features (attention-only patterns, off by default: the
``prefill_chunk`` / ``prefix_cache`` fields or the ``REPRO_PREFILL_CHUNK`` /
``REPRO_PREFIX_CACHE`` knobs):

* **Chunked prefill** — a join becomes a pending pipeline: its standalone
  caches advance by one power-of-two chunk (``api.prefill_chunk``) per tick,
  between the pool's decode steps, and the batch joins the pool when every
  row's prompt is consumed.
* **Prefix cache** — a trie over token-id blocks
  (:class:`~repro_torch.serve.cache.PrefixCache`) keeps finished prompts'
  K/V. A request attaches its longest cached prefix (snapped down to a chunk
  boundary) into its standalone caches and chunk-prefills the suffix; a
  quantized pool quantizes the attached span again at the prefix's own
  scales (scale adoption, :mod:`repro_torch.quant.kvcache`).

``kv_format`` narrows the pool's K/V lanes (int8 or fp8).

Telemetry (:mod:`repro_torch.obs`, host-side only; the step's device
kernels are the same with it on or off). Every request's lifecycle —
arrival, admission (with the fall-through bucket), prefix attach, chunk
ticks, first token, each ITL, retirement — is stamped into
:mod:`repro_torch.obs.tracing` keyed by ``Request.uid``. The ``queue`` /
``prefix_attach`` / ``chunk_prefill`` phases are contiguous and share the
TTFT stamps, so per request they sum to its ``serve.ttft_seconds`` sample.
``slo_ttft_ms`` / ``slo_itl_ms`` (or ``REPRO_SLO_TTFT_MS`` /
``REPRO_SLO_ITL_MS``) turn those stamps into ``ServingReport.goodput``.
Each tick records the ``serve.*`` histograms, counters and gauges, and the
prefix trie its ``serve.prefix_cache.*`` counters. Every step — a decode
step, a prefill per (rows, bucket), a chunk step per (rows, bucket, width,
first chunk of its join or not) — is dispatched through the engine's
:class:`repro_torch.obs.attr.StepKeys`: its key's first dispatch captures its GEMM workload (and counts ``gemm.calls``, as the
reference's trace does), later dispatches charge their host wall time to
that workload (``gemm.roofline_fraction``) and pay no per-GEMM telemetry.
The lifecycle stamps read host counts only: no telemetry reads a token
value or synchronizes the card.
"""

from __future__ import annotations

import dataclasses
import os
import time
import warnings
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import obs as _obs
from repro_torch.configs.base import ArchConfig
from repro_torch.core.roofline import HardwareSpec, spec_for_device
from repro_torch.obs import attr as _attr
from repro_torch.obs import tracing as _tracing
from repro_torch.obs.metrics import percentile
from repro_torch.models import api as model_api
from repro_torch.models.transformer import check_supported

from .cache import PrefixCache, SlotPool
from .engine import sample_token
from .scheduler import Request, Scheduler

__all__ = ["ContinuousEngine", "ServingReport", "percentile"]

# Chunk-prefill pipelines in flight at once. One removes head-of-line
# blocking (decode never waits on a whole prefill) and keeps the slots
# leased but not yet decoding bounded.
_MAX_PENDING = 1


@dataclasses.dataclass
class _PendingJoin:
    """A join mid-chunk: standalone caches filling one chunk per tick."""

    batch: List[Request]
    slots: List[int]
    caches: Any  # standalone full-precision caches, per layer [rows, lb, fused]
    rows: int
    lb: int
    offsets: np.ndarray  # [len(batch)] next fill position per row
    plens: np.ndarray  # [len(batch)] prompt lengths
    nodes: List[list]  # per-row acquired trie nodes (released at completion)
    floors: Any  # scale floors for a quantized pool's join, or None
    first_logits: Optional[torch.Tensor] = None  # [rows, V]; valid where done
    done: Optional[np.ndarray] = None  # [len(batch)] row consumed its prompt

    def __post_init__(self) -> None:
        if self.done is None:
            self.done = np.zeros(len(self.batch), bool)

    @property
    def all_done(self) -> bool:
        return bool(self.done.all())


class _Lifecycle:
    """Per-``serve()`` request-lifecycle bookkeeping.

    Owns the wall stamps the report's TTFT, ITL and phase percentiles and
    its goodput are computed from, emits the phase histograms, and mirrors
    every lifecycle edge into :mod:`repro_torch.obs.tracing`. The phase
    chain — queue → prefix_attach → chunk_prefill → decode (chunked) or
    queue → prefill → decode (monolithic) — is contiguous and shares these
    exact stamps, so each request's pre-decode phases sum to its
    ``serve.ttft_seconds`` sample.
    """

    def __init__(self) -> None:
        self.arrive: Dict[int, float] = {}  # rid -> clock-start stamp
        self.admit: Dict[int, float] = {}  # rid -> queue-exit stamp
        self.attach: Dict[int, float] = {}  # rid -> attach-done stamp
        self.last_tok: Dict[int, float] = {}
        self.ttfts: List[float] = []
        self.itls: List[float] = []
        self.queue_s: List[float] = []
        self.attach_s: List[float] = []
        self.chunk_s: List[float] = []
        self.ttft_by_rid: Dict[int, float] = {}
        self.itl_max: Dict[int, float] = {}

    def arrival(self, r: Request, ts: float) -> None:
        """Queue enter: the loop reached the request's arrival tick."""
        self.arrive[r.rid] = ts
        _tracing.begin_request(r.uid, r.rid, ts)

    def admitted(self, batch: List[Request], ts: float, bucket, fallthrough: bool,
                 phase: str) -> None:
        """Queue exit: the scheduler popped ``batch`` for one join."""
        for r in batch:
            q = ts - self.arrive.get(r.rid, ts)
            self.admit[r.rid] = ts
            self.queue_s.append(q)
            _obs.histogram("serve.queue_seconds").observe(q)
            _tracing.annotate(r.uid, bucket=bucket, fallthrough=fallthrough)
            _tracing.instant(r.uid, "admitted", ts, bucket=bucket, fallthrough=fallthrough,
                             queue_s=q)
            _tracing.begin_phase(r.uid, phase, ts)

    def attached(self, batch: List[Request], ts: float) -> None:
        """Chunked path: slots leased and cached prefixes attached; the
        chunk pipeline owns the request from here to its first token."""
        for r in batch:
            a = ts - self.admit.get(r.rid, ts)
            self.attach[r.rid] = ts
            self.attach_s.append(a)
            _obs.histogram("serve.prefill_attach_seconds").observe(a)
            _tracing.begin_phase(r.uid, "chunk_prefill", ts)

    def first_token(self, batch: List[Request], sched: Scheduler, eos_id, ts: float,
                    chunked: bool) -> None:
        """First token sampled (from prefill logits, at join): closes the
        TTFT window and the last pre-decode phase with the same stamp."""
        _obs.counter("serve.requests", event="admitted").inc(len(batch))
        for r in batch:
            ttft = ts - self.arrive.get(r.rid, ts)
            self.ttfts.append(ttft)
            self.ttft_by_rid[r.rid] = ttft
            self.last_tok[r.rid] = ts
            _obs.histogram("serve.ttft_seconds").observe(ttft)
            if chunked:
                c = ts - self.attach.get(r.rid, ts)
                self.chunk_s.append(c)
                _obs.histogram("serve.chunk_prefill_seconds").observe(c)
            _tracing.instant(r.uid, "first_token", ts, ttft_s=ttft)
            _tracing.begin_phase(r.uid, "decode", ts)
            st = sched.states[r.rid]
            if st.done:  # one-token request: retires at its own join tick
                _obs.counter("serve.requests", event="retired").inc()
                reason = ("eos" if eos_id is not None and st.tokens and st.tokens[-1] == eos_id
                          else "budget")
                self.retired(r, st, reason, ts)

    def token(self, r: Request, ts: float) -> None:
        prev = self.last_tok.get(r.rid)
        if prev is not None:
            itl = ts - prev
            self.itls.append(itl)
            self.itl_max[r.rid] = max(self.itl_max.get(r.rid, 0.0), itl)
            _obs.histogram("serve.itl_seconds").observe(itl)
            _tracing.instant(r.uid, "token", ts, itl_s=itl)
        self.last_tok[r.rid] = ts

    def retired(self, r: Request, st, reason: str, ts: float) -> None:
        _obs.event("request_retired", uid=r.uid, rid=r.rid, reason=reason,
                   tokens=st.n_emitted, slot=st.slot)
        _tracing.end_request(r.uid, reason, ts)

    def goodput(self, requests: List[Request], slo_ttft_s, slo_itl_s) -> Optional[float]:
        """Fraction of requests meeting every configured SLO; None when no
        SLO is set (no objective must not read as 100 %)."""
        if (slo_ttft_s is None and slo_itl_s is None) or not requests:
            return None
        good = 0
        for r in requests:
            ok = True
            if slo_ttft_s is not None:
                ttft = self.ttft_by_rid.get(r.rid)
                ok = ok and ttft is not None and ttft <= slo_ttft_s
            if slo_itl_s is not None:
                ok = ok and self.itl_max.get(r.rid, 0.0) <= slo_itl_s
            good += bool(ok)
        return good / len(requests)


@dataclasses.dataclass
class ServingReport:
    """Outcome of one ``serve`` run and its utilization counters."""

    outputs: Dict[int, List[int]]  # rid -> generated tokens
    generated_tokens: int
    decode_steps: int
    prefill_batches: int
    mean_occupancy: float  # mean active-slot fraction per decode step
    wall_time_s: float
    kv_bytes_per_slot: float = 0.0  # K/V pool bytes per slot (+ quant scales)
    # Host-clock latency percentiles in seconds (None without samples).
    # TTFT: from the request's arrival tick to its first token (sampled from
    # the prefill logits at join). ITL: between a lane's consecutive tokens;
    # on the deferred-fetch path this is the host's dispatch cadence.
    ttft_p50: Optional[float] = None
    ttft_p99: Optional[float] = None
    itl_p50: Optional[float] = None
    itl_p99: Optional[float] = None
    # SLO and phase decomposition. ``goodput``: share of requests whose TTFT
    # (and worst ITL) met every configured objective; None without one.
    # ``queue_*``: arrival to admission. ``attach_*`` / ``chunk_prefill_*``:
    # the chunked path's prefix-attach and chunk-prefill phases (None on the
    # monolithic path). The three phases are contiguous and share the TTFT
    # stamps. ``slot_hwm``: peak concurrently leased slots.
    goodput: Optional[float] = None
    queue_p50: Optional[float] = None
    queue_p99: Optional[float] = None
    attach_p50: Optional[float] = None
    attach_p99: Optional[float] = None
    chunk_prefill_p50: Optional[float] = None
    chunk_prefill_p99: Optional[float] = None
    slot_hwm: int = 0

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
    # Narrow K/V lanes for the pool ("int8", "fp8_e4m3", "fp8_e5m2"). Prefill
    # stays full-precision; the join calibrates per-slot scales.
    kv_format: Optional[str] = None
    # Chunked prefill width, a power of two (None = REPRO_PREFILL_CHUNK,
    # unset = off).
    prefill_chunk: Optional[int] = None
    # Prefix cache (None = REPRO_PREFIX_CACHE, unset = off). It implies
    # chunked prefill; the trie lives as long as the engine.
    prefix_cache: Optional[bool] = None
    prefix_block: int = 16  # trie block size, tokens
    prefix_capacity: int = 1 << 16  # trie capacity, tokens
    # TTFT and worst-ITL objectives in ms (None = REPRO_SLO_TTFT_MS /
    # REPRO_SLO_ITL_MS, unset = none). With one set, ServingReport.goodput
    # is the share of requests meeting every configured objective.
    slo_ttft_ms: Optional[float] = None
    slo_itl_ms: Optional[float] = None

    def __post_init__(self) -> None:
        if not model_api.takes_token_prompt(self.cfg):
            # Serving audio or vlm here would drop their non-token inputs.
            raise NotImplementedError(
                f"ContinuousEngine serves token-prompt LM families; use "
                f"ServeEngine for {self.cfg.family}"
            )
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
        # The SLO and prompt-side knobs: fields beat the environment.
        if self.slo_ttft_ms is None:
            env = os.environ.get("REPRO_SLO_TTFT_MS", "")
            self.slo_ttft_ms = float(env) if env else None
        if self.slo_itl_ms is None:
            env = os.environ.get("REPRO_SLO_ITL_MS", "")
            self.slo_itl_ms = float(env) if env else None
        if self.prefill_chunk is None:
            env = os.environ.get("REPRO_PREFILL_CHUNK", "")
            self.prefill_chunk = int(env) if env else None
        if self.prefix_cache is None:
            env = os.environ.get("REPRO_PREFIX_CACHE", "")
            self.prefix_cache = env.lower() not in ("", "0", "false", "no")
        if self.prefix_cache and self.prefill_chunk is None:
            self.prefill_chunk = 32  # the suffix prefill rides the chunk entry
        if self.prefill_chunk is not None:
            w = self.prefill_chunk
            if w < 1 or (w & (w - 1)):
                raise ValueError(f"prefill_chunk must be a power of two, got {w}")
            if not all(bd.mixer in ("attn", "attn_local", "none") for bd in self.cfg.pattern):
                # Recurrent state cannot resume mid-prompt from a scatter:
                # fall back to whole-bucket prefill.
                warnings.warn(
                    "chunked prefill / prefix cache need attention-only "
                    f"patterns; disabled for {self.cfg.name}",
                    RuntimeWarning,
                    stacklevel=2,
                )
                self.prefill_chunk = None
                self.prefix_cache = False
        self._trie: Optional[PrefixCache] = (
            PrefixCache(block_size=self.prefix_block, capacity_tokens=self.prefix_capacity,
                        kv_format=self.kv_format, n_kv=self.cfg.n_kv)
            if self.prefix_cache else None
        )
        self._pending: List[_PendingJoin] = []
        self.device = self.params["embed"]["table"].device
        # Prefix-trie residency high-watermark (tokens); the trie outlives
        # serve() calls, so the peak does too.
        self._prefix_hwm = 0
        # Utilization attribution: the step keys dispatched so far and the
        # GEMM workload each key's capturing dispatch recorded. Keys: one
        # decode step; prefills per (rows, bucket); chunk steps per
        # (rows, bucket, width, whether the join already ran a chunk).
        self._hw: Optional[HardwareSpec] = None
        self._steps = _attr.StepKeys(hardware=self._hardware)

    def _hardware(self) -> HardwareSpec:
        """The roofline spec steps are costed against (resolved at first
        use: the H100 SXM; any other card raises)."""
        if self._hw is None:
            self._hw = spec_for_device(self.device)
        return self._hw

    def prefix_cache_stats(self) -> Optional[Dict[str, int]]:
        """Hit, miss, eviction and residency counts of the prefix trie
        (None when the cache is off)."""
        if self._trie is None:
            return None
        return {
            "hits": self._trie.hits,
            "misses": self._trie.misses,
            "evictions": self._trie.evictions,
            "cached_tokens": self._trie.cached_tokens,
        }

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
            self.cfg, self.n_slots, self.max_len, self.cache_dtype, self.device,
            kv_format=self.kv_format,
        )
        # Abandoned pipelines end with their serve() call (slot leases are
        # per pool); the prefix trie stays, so a warm-up run fills it for
        # the runs that follow.
        self._pending = []

        b = self.n_slots
        tok = torch.zeros((b, 1), dtype=torch.int64, device=self.device)
        pos = torch.zeros((b,), dtype=torch.int64, device=self.device)
        active = [False] * b  # host truth; the device mask follows on change
        active_dev = torch.tensor(active, device=self.device)
        sync = on_token is not None or self.eos_id is not None
        pending = []  # (device tokens [*, 1], [(row, rid), ...]) per step

        # Lifecycle wall stamps (always kept: the report's percentiles are
        # product, not telemetry; only the obs emission is gated). A
        # request's clock starts when the loop reaches its arrival tick.
        wall = time.perf_counter
        by_arrival = sorted(requests, key=lambda r: r.arrival)
        n_arrival_stamped = 0
        lc = _Lifecycle()

        step = 0
        decode_steps = 0
        prefill_batches = 0
        generated = 0
        occupancy_acc = 0.0
        limit = max_steps if max_steps is not None else (
            sum(r.arrival + r.max_new_tokens for r in requests) + 10 * self.max_len
            # a chunked join spends up to ceil(plen / W) more ticks
            + (sum(len(r.prompt) for r in requests) if self.prefill_chunk else 0)
        )

        while not (sched.drained and pool.n_active == 0):
            if step > limit:
                raise RuntimeError(f"serving did not drain within {limit} steps")
            while (
                n_arrival_stamped < len(by_arrival)
                and by_arrival[n_arrival_stamped].arrival <= step
            ):
                lc.arrival(by_arrival[n_arrival_stamped], wall())
                n_arrival_stamped += 1

            # -- join: refill free slots from the queue ---------------------
            joined = False
            chunked = self.prefill_chunk is not None
            while pool.n_free:
                admissible = None
                if chunked and len(self._pending) >= _MAX_PENDING:
                    # Pipeline full: only prompts whose remaining prefill
                    # fits one chunk may join (they complete inline); the
                    # scheduler falls through to them past a blocked head.
                    admissible = lambda r: self._suffix_len(r) <= self.prefill_chunk  # noqa: E731
                batch = sched.next_batch(pool.n_free, now=step, admissible=admissible)
                if not batch:
                    break
                adm = sched.last_admission or {}
                if chunked:
                    lc.admitted(batch, wall(), adm.get("bucket"), bool(adm.get("fallthrough")),
                                phase="prefix_attach")
                    pj = self._begin_join(sched, pool, batch, step)
                    lc.attached(batch, wall())
                    if len(self._pending) < _MAX_PENDING:
                        self._pending.append(pj)  # advances below, this tick
                        continue
                    # One chunk finishes every prompt of this batch (a loop:
                    # an eviction after the admissibility check can
                    # lengthen a suffix).
                    while not pj.all_done:
                        self._advance_chunk(pj)
                    tok, pos = self._complete_join(
                        pj, sched, pool, tok, pos, active, generator, step,
                        on_token, sync, pending,
                    )
                else:
                    lc.admitted(batch, wall(), adm.get("bucket"), bool(adm.get("fallthrough")),
                                phase="prefill")
                    tok, pos = self._join(
                        sched, pool, batch, tok, pos, active, generator, step,
                        on_token, sync, pending,
                    )
                prefill_batches += 1
                generated += len(batch)  # one token per request, prefill logits
                joined = True
                # The first tokens exist now: one stamp closes each request's
                # TTFT window and its last pre-decode phase.
                lc.first_token(batch, sched, self.eos_id, wall(), chunked)

            # -- advance the pending chunk pipeline by one chunk ------------
            if self._pending:
                pj = self._pending[0]
                self._advance_chunk(pj)
                if pj.all_done:
                    tok, pos = self._complete_join(
                        pj, sched, pool, tok, pos, active, generator, step,
                        on_token, sync, pending,
                    )
                    prefill_batches += 1
                    generated += len(pj.batch)
                    joined = True
                    lc.first_token(pj.batch, sched, self.eos_id, wall(), chunked)
                    self._pending.pop(0)
            if joined:
                active_dev = torch.tensor(active, device=self.device)

            if not any(active):
                if sched.drained and not self._pending:
                    break
                step += 1  # idle tick: the next arrival or pending chunk
                continue

            # -- decode: one masked step over the whole pool ----------------
            t_step = wall()
            n_live = sum(active)
            with self._steps.dispatch(("decode",), "decode") as st:
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
            n_retired = 0
            retired_now: List[tuple] = []  # (Request, reason)
            changed = False
            if sync:
                emitted = tok[:, 0].cpu().numpy()
                for slot, rid in zip(live, live_rids):
                    t = int(emitted[slot])
                    if on_token is not None:
                        on_token(rid, t)
                    generated += 1
                    if sched.record_token(rid, t, now=step):
                        reason = ("eos" if self.eos_id is not None and t == self.eos_id
                                  else "budget")
                        retired_now.append((sched.states[rid].request, reason))
                        n_retired += pool.release(slot)
                        active[slot] = False
                        changed = True
            else:
                pending.append((tok, list(zip(live, live_rids))))
                for slot, rid in zip(live, live_rids):
                    generated += 1
                    if sched.record_emitted(rid, now=step):
                        retired_now.append((sched.states[rid].request, "budget"))
                        n_retired += pool.release(slot)
                        active[slot] = False
                        changed = True
            if changed:
                active_dev = torch.tensor(active, device=self.device)

            # Per-tick telemetry: the step's wall time, each live lane's
            # inter-token gap, queue and occupancy gauges. Retirement stamps
            # come after the token stamps, so a request's last ITL instant
            # lies inside its span.
            now = wall()
            _obs.histogram("serve.step_seconds").observe(now - t_step)
            if st.workload:
                # Host wall, as ITL: on the deferred path the host's issue
                # cadence, on the sync path token-to-token time.
                _attr.observe_step(st.workload, now - t_step)
            for rid in live_rids:
                lc.token(sched.states[rid].request, now)
            for r, reason in retired_now:
                lc.retired(r, sched.states[r.rid], reason, now)
            _obs.counter("serve.tokens").inc(len(live_rids))
            if n_retired:
                _obs.counter("serve.requests", event="retired").inc(n_retired)
            _obs.gauge("serve.queue_depth").set(sched.n_arrived(step))
            _obs.gauge("serve.occupancy").set(n_live / self.n_slots)
            _obs.gauge("serve.slot_pool_hwm").set(pool.leased_hwm)

        # Deferred fetch: token values come to the host once, at the end.
        for arr, pairs in pending:
            vals = arr[:, 0].cpu().numpy()
            for row, rid in pairs:
                sched.states[rid].tokens.append(int(vals[row]))
        _obs.gauge("serve.slot_pool_hwm").set(pool.leased_hwm)
        goodput = lc.goodput(
            requests,
            None if self.slo_ttft_ms is None else self.slo_ttft_ms / 1e3,
            None if self.slo_itl_ms is None else self.slo_itl_ms / 1e3,
        )
        report = ServingReport(
            outputs={rid: st.tokens for rid, st in sched.states.items()},
            generated_tokens=generated,
            decode_steps=decode_steps,
            prefill_batches=prefill_batches,
            mean_occupancy=(occupancy_acc / decode_steps) if decode_steps else 0.0,
            wall_time_s=0.0,  # stamped by timed_serve
            kv_bytes_per_slot=pool.kv_bytes_per_slot(),
            ttft_p50=percentile(lc.ttfts, 50),
            ttft_p99=percentile(lc.ttfts, 99),
            itl_p50=percentile(lc.itls, 50),
            itl_p99=percentile(lc.itls, 99),
            goodput=goodput,
            queue_p50=percentile(lc.queue_s, 50),
            queue_p99=percentile(lc.queue_s, 99),
            attach_p50=percentile(lc.attach_s, 50),
            attach_p99=percentile(lc.attach_s, 99),
            chunk_prefill_p50=percentile(lc.chunk_s, 50),
            chunk_prefill_p99=percentile(lc.chunk_s, 99),
            slot_hwm=pool.leased_hwm,
        )
        _obs.event(
            "serving_report",
            requests=len(requests),
            generated_tokens=report.generated_tokens,
            decode_steps=report.decode_steps,
            mean_occupancy=report.mean_occupancy,
            ttft_p50=report.ttft_p50,
            ttft_p99=report.ttft_p99,
            itl_p50=report.itl_p50,
            itl_p99=report.itl_p99,
            goodput=report.goodput,
            queue_p50=report.queue_p50,
            queue_p99=report.queue_p99,
            slot_hwm=report.slot_hwm,
        )
        return report

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
        rows = _pow2_rows(len(batch))
        tokens = np.zeros((rows, lb), np.int64)
        lengths = np.ones((rows,), np.int64)
        for i, r in enumerate(batch):
            tokens[i, : len(r.prompt)] = np.asarray(r.prompt, np.int64)
            lengths[i] = len(r.prompt)
        if rows > len(batch):
            tokens[len(batch):] = tokens[0]
            lengths[len(batch):] = lengths[0]
        tokens_dev = torch.from_numpy(tokens).to(self.device)
        lengths_dev = torch.from_numpy(lengths).to(self.device)
        t_pf = time.perf_counter()
        with self._steps.dispatch((rows, lb), "prefill") as st:
            logits, caches = model_api.prefill_bucketed(
                self.cfg, self.params, tokens_dev, lengths_dev, self.cache_dtype,
            )
        if st.workload:
            _attr.observe_step(st.workload, time.perf_counter() - t_pf)
        first = sample_token(logits, generator, self.temperature)
        slots = pool.allocate([r.rid for r in batch])
        sched.admit(batch, slots, now=step)
        for r, s in zip(batch, slots):
            _tracing.set_slot(r.uid, s)
        pool.join(caches, slots)
        return self._seed_lanes(sched, pool, batch, slots, first, lengths[: len(batch)],
                                tok, pos, active, step, on_token, sync, pending)

    def _seed_lanes(self, sched, pool, batch, slots, first, plens, tok, pos, active,
                    step, on_token, sync, pending):
        """Point the joined lanes at their first tokens and positions, and
        retire any request whose first token ends it."""
        n = len(batch)
        slot_idx = torch.tensor(slots, dtype=torch.int64, device=self.device)
        # Out of place: earlier `tok` tensors wait in `pending` for the fetch.
        tok = tok.index_put((slot_idx,), first[:n])
        plens = torch.from_numpy(np.asarray(plens, np.int64)).to(self.device)
        pos = pos.index_put((slot_idx,), plens)
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
        return tok, pos

    def _attach_len(self, matched: int, plen: int) -> int:
        """The usable cached span: the trie match snapped down to a chunk
        boundary (resume offsets stay chunk-aligned), leaving at least one
        token to prefill."""
        w = self.prefill_chunk
        return max((min(matched, plen - 1) // w) * w, 0)

    def _suffix_len(self, r: Request) -> int:
        """Prompt tokens left to prefill after a prefix attach: what a full
        chunk pipeline admits by."""
        if self._trie is None:
            return len(r.prompt)
        _, matched = self._trie.match(r.prompt)
        return len(r.prompt) - self._attach_len(matched, len(r.prompt))

    def _begin_join(
        self, sched: Scheduler, pool: SlotPool, batch: List[Request], step: int
    ) -> _PendingJoin:
        """Lease slots, build standalone caches, attach cached prefixes. The
        pipeline then advances one chunk per tick; the batch joins the pool
        (and its lanes activate) when it completes."""
        lb = sched.bucket(max(len(r.prompt) for r in batch))
        rows = _pow2_rows(len(batch))
        plens = np.array([len(r.prompt) for r in batch], np.int64)
        caches = model_api.init_state(self.cfg, rows, lb, self.cache_dtype, self.device)
        offsets = np.zeros(len(batch), np.int64)
        nodes: List[list] = [[] for _ in batch]
        floors = None
        if self._trie is not None:
            for i, r in enumerate(batch):
                path, matched = self._trie.match(r.prompt)
                attach = self._attach_len(matched, int(plens[i]))
                if attach <= 0:
                    self._trie.misses += 1
                    _obs.counter("serve.prefix_cache.misses").inc()
                    _tracing.instant(r.uid, "prefix_miss", time.perf_counter(),
                                     matched=int(matched))
                    continue
                self._trie.hits += 1
                _obs.counter("serve.prefix_cache.hits").inc()
                # Keep resident only the nodes the attach covers.
                n_nodes = -(-attach // self._trie.block_size)
                nodes[i] = path[:n_nodes]
                self._trie.acquire(nodes[i])
                spans, fls = self._trie.gather(nodes[i])
                _attach_prefix(caches, spans, i, attach)
                _tracing.instant(r.uid, "prefix_attach", time.perf_counter(),
                                 tokens=int(attach), matched=int(matched), spans=int(n_nodes))
                _tracing.annotate(r.uid, prefix_tokens=int(attach), prefix_spans=int(n_nodes))
                if fls is not None:
                    if floors is None:
                        floors = _zero_floors(rows, fls, self.device)
                    for f, fl in zip(floors, fls):
                        if fl is not None:
                            f[0][i] = fl[0]
                            f[1][i] = fl[1]
                offsets[i] = attach
        slots = pool.allocate([r.rid for r in batch])
        sched.admit(batch, slots, now=step)
        for r, s in zip(batch, slots):
            _tracing.set_slot(r.uid, s)
        return _PendingJoin(batch=batch, slots=slots, caches=caches, rows=rows, lb=lb,
                            offsets=offsets, plens=plens, nodes=nodes, floors=floors)

    def _advance_chunk(self, pj: _PendingJoin) -> None:
        """Advance every unfinished row of ``pj`` by one prompt chunk."""
        w = self.prefill_chunk
        ctoks = np.zeros((pj.rows, w), np.int64)
        # Sentinel offset = bucket length: every write of that row drops
        # and its logits row is never selected.
        offs = np.full((pj.rows,), pj.lb, np.int64)
        last_idx = np.zeros((pj.rows,), np.int64)
        fin = np.zeros((pj.rows,), bool)
        advanced = []  # (uid, off, end): trace slices stamped after the dispatch
        for i, r in enumerate(pj.batch):
            if pj.done[i]:
                continue
            off = int(pj.offsets[i])
            end = min(off + w, int(pj.plens[i]))
            offs[i] = off
            ctoks[i, : end - off] = np.asarray(r.prompt[off:end], np.int64)
            if end >= pj.plens[i]:
                fin[i] = True
                last_idx[i] = int(pj.plens[i]) - 1 - off
            pj.offsets[i] = end
            advanced.append((r.uid, off, end))
        args = (torch.from_numpy(ctoks).to(self.device), pj.caches,
                torch.from_numpy(offs).to(self.device),
                torch.from_numpy(last_idx).to(self.device))
        # A join's first chunk and its continuations are two step keys, as
        # they are two compiled programs in the reference (its fresh caches
        # carry a per-row length, a chunk's output a per-period one).
        key = (pj.rows, pj.lb, w, pj.first_logits is not None)
        t_ck = time.perf_counter()
        with self._steps.dispatch(key, "chunk") as st:
            logits, pj.caches = model_api.prefill_chunk(self.cfg, self.params, *args)
        t_done = time.perf_counter()
        if st.workload:
            _attr.observe_step(st.workload, t_done - t_ck)
        # One slice per row advanced this tick (the host's dispatch bracket:
        # the chunk step runs asynchronously, as every step does).
        for uid, off, end in advanced:
            _tracing.slice_event(uid, "chunk", t_ck, t_done, offset=off, end=end)
        if pj.first_logits is None:
            pj.first_logits = logits
        else:
            fin_dev = torch.from_numpy(fin).to(self.device)
            pj.first_logits = torch.where(fin_dev[:, None], logits, pj.first_logits)
        pj.done |= fin[: len(pj.batch)]

    def _complete_join(
        self, pj: _PendingJoin, sched: Scheduler, pool: SlotPool, tok, pos, active,
        generator, step, on_token, sync, pending,
    ):
        """Every prompt consumed: join the pool, seed the lanes with their
        first tokens, insert the prompts into the prefix trie."""
        first = sample_token(pj.first_logits, generator, self.temperature)
        pool.join(pj.caches, pj.slots, pj.floors)
        tok, pos = self._seed_lanes(sched, pool, pj.batch, pj.slots, first, pj.plens,
                                    tok, pos, active, step, on_token, sync, pending)
        if self._trie is not None:
            ev0 = self._trie.evictions
            for i, r in enumerate(pj.batch):
                self._trie.insert(r.prompt, int(pj.plens[i]), pj.caches, i)
                if pj.nodes[i]:
                    self._trie.release(pj.nodes[i])
            if self._trie.evictions > ev0:
                _obs.counter("serve.prefix_cache.evictions").inc(self._trie.evictions - ev0)
            _obs.gauge("serve.prefix_cache.cached_tokens").set(self._trie.cached_tokens)
            self._prefix_hwm = max(self._prefix_hwm, self._trie.cached_tokens)
            _obs.gauge("serve.prefix_cache.hwm_tokens").set(self._prefix_hwm)
        return tok, pos


def _pow2_rows(n: int) -> int:
    """Rows of a join: ``n`` rounded up to a power of two, as the reference
    bounds its compiled prefill shapes (filler rows are dropped at the join)."""
    rows = 1
    while rows < n:
        rows *= 2
    return rows


def _attach_prefix(caches, spans, row: int, attach: int) -> None:
    """Write a gathered prefix span into positions ``[0, attach)`` of one row
    of the standalone caches, in place (the span may run past ``attach``)."""
    for c, sp in zip(caches, spans):
        if sp is not None:
            c.k[row, :attach] = sp[0][:attach].to(c.k.dtype)
            c.v[row, :attach] = sp[1][:attach].to(c.v.dtype)


def _zero_floors(rows: int, fls, device):
    """Zero scale floors per layer, ``[rows, n_kv]``; rows that attach a
    quantized prefix overwrite theirs."""
    return [
        None if f is None else tuple(
            torch.zeros((rows, f[0].shape[-1]), dtype=torch.float32, device=device)
            for _ in range(2))
        for f in fls
    ]
