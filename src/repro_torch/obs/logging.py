"""Structured logging + JSONL event log for scripted runs.

The port of :mod:`repro.obs.logging`, whole.

**Logger** (the satellite that retires the launch scripts' ad-hoc
``print()``\\ s): ``get_logger("serve").info("generated", tokens=128,
wall_s=1.2)`` writes either

* ``REPRO_LOG=text`` (default) — ``[serve] generated tokens=128 wall_s=1.2``
  (the human-facing shape the old prints had), or
* ``REPRO_LOG=json`` — one JSON object per line
  (``{"ts": ..., "component": "serve", "event": "generated", ...}``) so
  scripted runs produce machine-parseable output.

**Event log**: ``event(kind, **fields)`` appends a structured record to an
in-memory ring buffer (``recent_events``) and — when a sink is configured
via ``set_event_log(path)`` or ``REPRO_EVENTS=<path>`` — to a JSONL file.
The serving engine emits ``request_retired`` and ``serving_report`` events
through this, the auditor ``numerics_drift``;
``python -m repro_torch.launch.stats tail`` reads the file back. Event emission respects the
``REPRO_METRICS`` hard-off switch (the logger does not: turning telemetry
off must not silence a launch script's output).
"""

from __future__ import annotations

import collections
import json
import os
import sys
import threading
import time
from typing import Dict, List, Optional, TextIO

from . import metrics as _m

__all__ = [
    "Logger",
    "get_logger",
    "log_mode",
    "event",
    "clear_events",
    "set_event_log",
    "event_log_path",
    "recent_events",
    "read_events",
    "follow_events",
]

_LOG_ENV_VAR = "REPRO_LOG"
_EVENTS_ENV_VAR = "REPRO_EVENTS"


def log_mode() -> str:
    """``"text"`` or ``"json"`` (``REPRO_LOG``; unknown values mean text)."""
    mode = os.environ.get(_LOG_ENV_VAR, "text").lower()
    return "json" if mode == "json" else "text"


def _render_value(v) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    if isinstance(v, str) and (" " in v or not v):
        return repr(v)
    return str(v)


class Logger:
    """One named component's structured logger (stdout by default —
    launch-script output is the program's product, not a diagnostic)."""

    def __init__(self, component: str, stream: Optional[TextIO] = None):
        self.component = component
        self._stream = stream

    @property
    def stream(self) -> TextIO:
        return self._stream if self._stream is not None else sys.stdout

    def info(self, event_name: str, **fields) -> None:
        if log_mode() == "json":
            rec = {
                "ts": time.time(),
                "component": self.component,
                "event": event_name,
                **fields,
            }
            print(json.dumps(rec, default=str), file=self.stream, flush=True)
        else:
            parts = [f"[{self.component}] {event_name}"]
            parts += [f"{k}={_render_value(v)}" for k, v in fields.items()]
            print(" ".join(parts), file=self.stream, flush=True)

    def raw(self, msg: str) -> None:
        """A preformatted line (e.g. a driver's own progress line):
        passed through in text mode, wrapped as a ``message`` event in json
        mode so the stream stays machine-parseable."""
        if log_mode() == "json":
            self.info("message", msg=msg)
        else:
            print(msg, file=self.stream, flush=True)


_loggers: Dict[str, Logger] = {}
_loggers_lock = threading.Lock()


def get_logger(component: str) -> Logger:
    with _loggers_lock:
        lg = _loggers.get(component)
        if lg is None:
            lg = _loggers[component] = Logger(component)
        return lg


# ---------------------------------------------------------------------------
# JSONL event log
# ---------------------------------------------------------------------------

_RING_CAP = 1024
_events: collections.deque = collections.deque(maxlen=_RING_CAP)
_events_lock = threading.Lock()
_sink_path: Optional[str] = os.environ.get(_EVENTS_ENV_VAR) or None


def set_event_log(path: Optional[str]) -> Optional[str]:
    """Point the JSONL sink at ``path`` (None = ring buffer only); returns
    the previous sink path."""
    global _sink_path
    prev = _sink_path
    _sink_path = path
    return prev


def event_log_path() -> Optional[str]:
    return _sink_path


def event(kind: str, **fields) -> None:
    """Record a structured event (no-op when telemetry is hard-off)."""
    if not _m.enabled():
        return
    rec = {"ts": time.time(), "kind": kind, **fields}
    with _events_lock:
        _events.append(rec)
        if _sink_path:
            try:
                with open(_sink_path, "a") as f:
                    f.write(json.dumps(rec, default=str) + "\n")
            except OSError:
                pass  # a full disk must not take the serving loop down


def clear_events() -> None:
    """Drop the in-memory ring buffer (any JSONL sink file is untouched).
    Tests call this between cases; long-lived processes normally never do."""
    with _events_lock:
        _events.clear()


def recent_events(n: int = 50, *, kind: Optional[str] = None) -> List[dict]:
    """Most recent ``n`` ring-buffer events (newest last)."""
    with _events_lock:
        evts = list(_events)
    if kind is not None:
        evts = [e for e in evts if e.get("kind") == kind]
    return evts[-n:]


def read_events(path: str, n: Optional[int] = None) -> List[dict]:
    """Read (the last ``n`` lines of) a JSONL event file; bad lines skipped."""
    out = []
    with open(path) as f:
        lines = f.readlines()
    if n is not None:
        lines = lines[-n:]
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            out.append(json.loads(line))
        except json.JSONDecodeError:
            continue
    return out


def follow_events(
    path: str,
    *,
    poll_interval: float = 0.5,
    start_at_end: bool = False,
    stop=None,
):
    """Generator over events appended to a JSONL sink — the engine behind
    ``launch.stats tail --follow``. Polls (portable: no inotify); waits for
    the file to appear; yields each complete line as a parsed dict (a line
    mid-write — no trailing newline yet — is buffered until its newline
    lands; undecodable lines are skipped). ``start_at_end`` skips history
    and yields only events appended after the call. ``stop`` is an optional
    zero-arg callable polled between reads — return True to end the
    generator (tests and embedders; the CLI just Ctrl-C's)."""
    while not os.path.exists(path):
        if stop is not None and stop():
            return
        time.sleep(poll_interval)
    buf = ""
    with open(path) as f:
        if start_at_end:
            f.seek(0, os.SEEK_END)
        while True:
            chunk = f.readline()
            if not chunk:
                if stop is not None and stop():
                    return
                time.sleep(poll_interval)
                continue
            buf += chunk
            if not buf.endswith("\n"):
                continue  # partial line: writer mid-append
            line, buf = buf.strip(), ""
            if not line:
                continue
            try:
                yield json.loads(line)
            except json.JSONDecodeError:
                continue
