"""Request-scoped lifecycle tracing for the serving engine.

The port of :mod:`repro.obs.tracing`, whole: the same recorder calls give
the same snapshot and the same Chrome trace document (its process is
named ``repro.serve`` in both packages).

``obs.metrics`` answers "how is the engine doing in aggregate"; this module
answers "why was *this* request's TTFT 40 ms". A global
:class:`TraceRecorder` stamps every lifecycle edge of a serving request —
arrival (queue enter), admission (queue exit, incl. the fall-through bucket
chosen), prefix-cache match/attach, each chunk-prefill tick, first token,
every decode ITL, retirement (EOS / budget-evict) — keyed by the stable
``Request.uid`` the scheduler assigns at construction.

Same zero-device-cost discipline as the registry: every stamp is host-side
Python at dispatch time from the engine's own host counts; nothing here
launches a kernel, reads a device value or synchronizes, so a step's
sequence of device kernels is the same with tracing on or off (pinned by
``tests/test_torch_tracing.py`` on the CPU and by ``chip_smoke.py`` 4(h) on
the card).

A request's record is a chain of **contiguous phases** sharing the engine's
exact wall stamps — ``queue`` → ``prefix_attach`` → ``chunk_prefill`` →
``decode`` (chunked path) or ``queue`` → ``prefill`` → ``decode``
(monolithic path) — so the pre-decode phase durations sum *exactly* to the
``serve.ttft_seconds`` sample recorded for the same request. Nested slices
(one per chunk-prefill tick) and instants (admission, prefix attach, first
token, every token) hang off the phases for fine detail.

Export: :func:`chrome_trace` converts a snapshot to Chrome trace-event JSON
(loads in Perfetto / ``chrome://tracing``): one track per slot plus a queue
track, one async span per request (``ph: b/e`` keyed by uid) with the phase
chain as nested ``X`` complete events. ``python -m
repro_torch.launch.stats trace`` is the CLI wrapper; ``obs.http``'s ``/trace`` endpoint serves it live.

Env knobs:

* ``REPRO_TRACE=0`` — disable tracing alone (metrics stay on). Tracing is
  also off whenever the registry is hard-off (``REPRO_METRICS=0``).
* ``REPRO_TRACE_DUMP=<path>`` — write the raw recorder snapshot (JSON) at
  interpreter exit, the tracing sibling of ``REPRO_METRICS_DUMP``;
  ``launch.stats trace --file`` converts it offline.
* ``REPRO_TRACE_CAP=<n>`` — retired-request ring size (default 4096).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from . import metrics as _m

__all__ = [
    "TraceRecorder",
    "active_requests",
    "annotate",
    "begin_phase",
    "begin_request",
    "chrome_trace",
    "enabled",
    "end_request",
    "instant",
    "recorder",
    "reset",
    "set_enabled",
    "set_slot",
    "slice_event",
    "snapshot",
    "validate_chrome_trace",
]

_ENV_VAR = "REPRO_TRACE"
_DUMP_ENV_VAR = "REPRO_TRACE_DUMP"
_CAP_ENV_VAR = "REPRO_TRACE_CAP"

# Per-request instant cap: decode emits one instant per token, and a
# pathological request could otherwise grow without bound. Drops count in
# the request's meta (``instants_dropped``) — silent truncation would read
# as "request emitted fewer tokens".
_MAX_INSTANTS = 4096

_forced: Optional[bool] = None  # set_enabled override (None = env default)


def enabled() -> bool:
    """Tracing is on iff the metrics registry is on AND tracing itself is
    not disabled (``set_enabled(False)`` or ``REPRO_TRACE=0``)."""
    if not _m.enabled():
        return False
    if _forced is not None:
        return _forced
    return os.environ.get(_ENV_VAR, "1").lower() not in ("0", "false", "off")


def set_enabled(flag: Optional[bool]) -> Optional[bool]:
    """Force tracing on/off for this process; ``None`` restores the env
    default. Returns the previous override."""
    global _forced
    prev = _forced
    _forced = flag
    return prev


class TraceRecorder:
    """Thread-safe recorder of per-request lifecycle events.

    Active requests live in a uid-keyed dict; retired ones move to a
    bounded ring (oldest dropped first). All timestamps are
    ``time.perf_counter()`` floats; the snapshot carries the
    ``(epoch, perf_counter)`` pair captured at construction so exporters
    can place the trace on the wall clock.
    """

    def __init__(self, cap: Optional[int] = None) -> None:
        if cap is None:
            cap = int(os.environ.get(_CAP_ENV_VAR, "4096") or "4096")
        self._lock = threading.Lock()
        self._active: Dict[int, Dict[str, Any]] = {}
        self._retired: deque = deque(maxlen=cap)
        self._epoch = time.time()
        self._perf0 = time.perf_counter()

    # -- recording ---------------------------------------------------------

    def begin_request(self, uid: int, rid: Any, ts: float) -> None:
        """Open a request's record with its ``queue`` phase (queue enter)."""
        if not enabled():
            return
        rec = {
            "uid": uid,
            "rid": rid,
            "slot": None,
            "phases": [{"name": "queue", "t0": ts, "t1": None}],
            "slices": [],
            "instants": [],
            "retired_ts": None,
            "retire_reason": None,
            "meta": {},
        }
        with self._lock:
            self._active[uid] = rec

    def set_slot(self, uid: int, slot: int) -> None:
        if not enabled():
            return
        with self._lock:
            rec = self._active.get(uid)
            if rec is not None:
                rec["slot"] = slot

    def annotate(self, uid: int, **fields: Any) -> None:
        if not enabled():
            return
        with self._lock:
            rec = self._active.get(uid)
            if rec is not None:
                rec["meta"].update(fields)

    def begin_phase(self, uid: int, name: str, ts: float) -> None:
        """Close the open phase at ``ts`` and open ``name`` — phases are
        contiguous by construction, so they tile the request's lifetime."""
        if not enabled():
            return
        with self._lock:
            rec = self._active.get(uid)
            if rec is None:
                return
            if rec["phases"] and rec["phases"][-1]["t1"] is None:
                rec["phases"][-1]["t1"] = ts
            rec["phases"].append({"name": name, "t0": ts, "t1": None})

    def slice_event(
        self, uid: int, name: str, t0: float, t1: float, **fields: Any
    ) -> None:
        """A nested timed slice inside the current phase (chunk ticks)."""
        if not enabled():
            return
        with self._lock:
            rec = self._active.get(uid)
            if rec is not None:
                rec["slices"].append(
                    {"name": name, "t0": t0, "t1": t1, **fields}
                )

    def instant(self, uid: int, name: str, ts: float, **fields: Any) -> None:
        if not enabled():
            return
        with self._lock:
            rec = self._active.get(uid)
            if rec is None:
                return
            if len(rec["instants"]) >= _MAX_INSTANTS:
                rec["meta"]["instants_dropped"] = (
                    rec["meta"].get("instants_dropped", 0) + 1
                )
                return
            rec["instants"].append({"name": name, "ts": ts, **fields})

    def end_request(self, uid: int, reason: str, ts: float) -> None:
        """Retire the request: close the open phase and move the record to
        the bounded ring."""
        if not enabled():
            return
        with self._lock:
            rec = self._active.pop(uid, None)
            if rec is None:
                return
            if rec["phases"] and rec["phases"][-1]["t1"] is None:
                rec["phases"][-1]["t1"] = ts
            rec["retired_ts"] = ts
            rec["retire_reason"] = reason
            self._retired.append(rec)

    # -- reading -----------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """Deep-copied view: retired requests first (oldest first), then
        still-active ones, plus the clock anchor for exporters."""
        import copy

        with self._lock:
            reqs = list(self._retired) + [
                self._active[k] for k in sorted(self._active)
            ]
            return {
                "clock": {"epoch": self._epoch, "perf": self._perf0},
                "requests": copy.deepcopy(reqs),
            }

    def active_requests(self, now: Optional[float] = None) -> List[Dict]:
        """In-flight request states for the ``/requests`` endpoint: current
        phase, phase age, and total age (seconds)."""
        if now is None:
            now = time.perf_counter()
        out = []
        with self._lock:
            for uid in sorted(self._active):
                rec = self._active[uid]
                open_phase = next(
                    (p for p in reversed(rec["phases"]) if p["t1"] is None),
                    None,
                )
                phase = open_phase["name"] if open_phase else "unknown"
                t_start = rec["phases"][0]["t0"] if rec["phases"] else now
                out.append(
                    {
                        "uid": uid,
                        "rid": rec["rid"],
                        "slot": rec["slot"],
                        "phase": phase,
                        "phase_age_s": (
                            now - open_phase["t0"] if open_phase else 0.0
                        ),
                        "age_s": now - t_start,
                        "tokens": sum(
                            1 for i in rec["instants"]
                            if i["name"] in ("first_token", "token")
                        ),
                        "meta": dict(rec["meta"]),
                    }
                )
        return out

    def reset(self) -> None:
        with self._lock:
            self._active.clear()
            self._retired.clear()
            self._epoch = time.time()
            self._perf0 = time.perf_counter()


_RECORDER = TraceRecorder()


def recorder() -> TraceRecorder:
    return _RECORDER


def begin_request(uid: int, rid: Any, ts: float) -> None:
    _RECORDER.begin_request(uid, rid, ts)


def set_slot(uid: int, slot: int) -> None:
    _RECORDER.set_slot(uid, slot)


def annotate(uid: int, **fields: Any) -> None:
    _RECORDER.annotate(uid, **fields)


def begin_phase(uid: int, name: str, ts: float) -> None:
    _RECORDER.begin_phase(uid, name, ts)


def slice_event(uid: int, name: str, t0: float, t1: float, **fields) -> None:
    _RECORDER.slice_event(uid, name, t0, t1, **fields)


def instant(uid: int, name: str, ts: float, **fields: Any) -> None:
    _RECORDER.instant(uid, name, ts, **fields)


def end_request(uid: int, reason: str, ts: float) -> None:
    _RECORDER.end_request(uid, reason, ts)


def snapshot() -> Dict[str, Any]:
    return _RECORDER.snapshot()


def active_requests(now: Optional[float] = None) -> List[Dict]:
    return _RECORDER.active_requests(now)


def reset() -> None:
    _RECORDER.reset()


# -- Chrome trace-event export ----------------------------------------------

_PID = 1
_QUEUE_TID = 0


def _slot_tid(slot: Optional[int]) -> int:
    return _QUEUE_TID if slot is None else int(slot) + 1


def chrome_trace(snap: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Convert a recorder snapshot to Chrome trace-event JSON (Perfetto /
    ``chrome://tracing`` loadable).

    Layout: one process ("repro.serve"), thread 0 is the queue track,
    thread ``slot + 1`` is that slot's track. Each request is one async
    nestable span (``ph: b``/``e``, ``id`` = uid) opened at arrival and
    closed at retirement; its contiguous phases are ``X`` complete events
    (the ``queue`` phase on the queue track, everything after admission on
    the slot track), chunk ticks are nested ``X`` slices, and admission /
    prefix-attach / token edges are ``i`` instants. Timestamps are
    microseconds relative to the recorder's clock anchor.
    """
    if snap is None:
        snap = snapshot()
    perf0 = float(snap["clock"]["perf"])

    def us(t: float) -> float:
        return (t - perf0) * 1e6

    events: List[Dict[str, Any]] = [
        {
            "ph": "M", "pid": _PID, "name": "process_name",
            "args": {"name": "repro.serve"},
        },
        {
            "ph": "M", "pid": _PID, "tid": _QUEUE_TID, "name": "thread_name",
            "args": {"name": "queue"},
        },
    ]
    named_tids = {_QUEUE_TID}
    for req in snap["requests"]:
        tid = _slot_tid(req.get("slot"))
        if tid not in named_tids:
            named_tids.add(tid)
            events.append(
                {
                    "ph": "M", "pid": _PID, "tid": tid, "name": "thread_name",
                    "args": {"name": f"slot {req['slot']}"},
                }
            )
        phases = req.get("phases") or []
        if not phases:
            continue
        uid = req["uid"]
        start = phases[0]["t0"]
        end_ts = req.get("retired_ts")
        events.append(
            {
                "ph": "b", "cat": "request", "id": uid,
                "name": f"req {req['rid']}", "pid": _PID, "tid": tid,
                "ts": us(start),
                "args": {"uid": uid, "rid": req["rid"], **req.get("meta", {})},
            }
        )
        for p in phases:
            t1 = p["t1"] if p["t1"] is not None else (end_ts or p["t0"])
            events.append(
                {
                    "ph": "X", "cat": "phase", "name": p["name"],
                    "pid": _PID,
                    "tid": _QUEUE_TID if p["name"] == "queue" else tid,
                    "ts": us(p["t0"]),
                    "dur": max(0.0, (t1 - p["t0"]) * 1e6),
                    "args": {"uid": uid},
                }
            )
        for s in req.get("slices", []):
            extra = {
                k: v for k, v in s.items() if k not in ("name", "t0", "t1")
            }
            events.append(
                {
                    "ph": "X", "cat": "slice", "name": s["name"],
                    "pid": _PID, "tid": tid, "ts": us(s["t0"]),
                    "dur": max(0.0, (s["t1"] - s["t0"]) * 1e6),
                    "args": {"uid": uid, **extra},
                }
            )
        for i in req.get("instants", []):
            extra = {k: v for k, v in i.items() if k not in ("name", "ts")}
            events.append(
                {
                    "ph": "i", "s": "t", "name": i["name"],
                    "pid": _PID, "tid": tid, "ts": us(i["ts"]),
                    "args": {"uid": uid, **extra},
                }
            )
        if end_ts is not None:
            events.append(
                {
                    "ph": "e", "cat": "request", "id": uid,
                    "name": f"req {req['rid']}", "pid": _PID, "tid": tid,
                    "ts": us(end_ts),
                    "args": {"reason": req.get("retire_reason")},
                }
            )
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def validate_chrome_trace(doc: Dict[str, Any]) -> int:
    """Structural validation of a Chrome trace document; returns the number
    of request spans. Raises ``ValueError`` on: missing/empty
    ``traceEvents``, an async ``e`` without a matching open ``b`` (or vice
    versa), a negative ``X`` duration, or a closed request span with no
    nested phase slice. Used by the serving bench and the CI smoke."""
    events = doc.get("traceEvents")
    if not isinstance(events, list) or not events:
        raise ValueError("traceEvents missing or empty")
    open_spans: Dict[Any, float] = {}
    closed: Dict[Any, tuple] = {}
    phases_by_uid: Dict[Any, int] = {}
    for ev in events:
        ph = ev.get("ph")
        if ph == "b" and ev.get("cat") == "request":
            key = ev.get("id")
            if key in open_spans:
                raise ValueError(f"request span {key!r} opened twice")
            open_spans[key] = float(ev["ts"])
        elif ph == "e" and ev.get("cat") == "request":
            key = ev.get("id")
            if key not in open_spans:
                raise ValueError(f"request span {key!r} closed without open")
            t0 = open_spans.pop(key)
            t1 = float(ev["ts"])
            if t1 < t0:
                raise ValueError(f"request span {key!r} ends before it begins")
            closed[key] = (t0, t1)
        elif ph == "X":
            dur = ev.get("dur")
            if dur is None or float(dur) < 0:
                raise ValueError(
                    f"X event {ev.get('name')!r} has invalid dur {dur!r}"
                )
            if ev.get("cat") == "phase":
                uid = (ev.get("args") or {}).get("uid")
                phases_by_uid[uid] = phases_by_uid.get(uid, 0) + 1
    for key in closed:
        if not phases_by_uid.get(key):
            raise ValueError(f"request span {key!r} has no phase slices")
    return len(closed) + len(open_spans)


# ---------------------------------------------------------------------------
# REPRO_TRACE_DUMP: write the raw snapshot at interpreter exit (sibling of
# REPRO_METRICS_DUMP), only when the port's recorder holds a request, so a
# process that traced only through the reference keeps the reference's dump.
# `launch.stats trace --file <path>` converts offline.
# ---------------------------------------------------------------------------
_dump_path = os.environ.get(_DUMP_ENV_VAR)
if _dump_path:
    import atexit

    def _dump_at_exit(path: str = _dump_path) -> None:
        snap = snapshot()
        if not snap["requests"]:
            return  # nothing recorded here: leave the path to the other package
        try:
            with open(path, "w") as f:
                json.dump(snap, f)
        except Exception:
            pass  # never let telemetry break interpreter shutdown

    atexit.register(_dump_at_exit)
