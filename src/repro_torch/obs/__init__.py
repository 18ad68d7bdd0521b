"""``repro_torch.obs`` — telemetry of the PyTorch/CUDA port.

The port of :mod:`repro.obs`, with the same public names and its own
registry, event ring and trace recorder:

* :mod:`~repro_torch.obs.metrics` — thread-safe Counter/Gauge/Histogram
  registry, ``snapshot()`` (nested dict), JSON + Prometheus-text exporters,
  and the ``REPRO_METRICS=0`` hard-off switch. All instrumentation is
  host-side Python that reads host counts only, so telemetry on or off
  leaves a step's sequence of device kernels unchanged (asserted on the
  CPU by ``tests/test_torch_tracing.py`` and on the card by
  ``chip_smoke.py`` 4(h)).
* :mod:`~repro_torch.obs.spans` — ``span(name)``:
  ``torch.profiler.record_function`` on the profiler's timeline, a
  wall-clock histogram on the host side.
* :mod:`~repro_torch.obs.logging` — structured launch-script logging
  (``REPRO_LOG=text|json``) and the JSONL event log (``REPRO_EVENTS``,
  ``launch.stats tail``).
* :mod:`~repro_torch.obs.attr` — live utilization attribution: captured
  GEMM workloads costed with :mod:`repro_torch.core.roofline` (H100 SXM),
  measured step time attributed per shape bucket
  (``gemm.achieved_gflops`` / ``gemm.roofline_fraction``;
  ``launch.stats top``), and the engine step scopes that keep per-call
  telemetry to a step key's first dispatch.
* :mod:`~repro_torch.obs.tracing` — request-scoped lifecycle tracing for
  the serving engine (``Request.uid``-keyed phase chains: queue →
  prefix-attach → chunk-prefill → decode, chunk-tick slices, token
  instants), exported as Chrome trace-event JSON (``launch.stats trace`` →
  Perfetto).
* :mod:`~repro_torch.obs.http` — live scrape surface
  (``REPRO_METRICS_PORT``): ``/metrics``, ``/requests``, ``/trace`` on a
  stdlib ``http.server`` thread bound to 127.0.0.1.
* :mod:`~repro_torch.obs.audit` — shadow numerics auditor:
  ``REPRO_AUDIT=N`` samples direct quantized-family GEMMs for fp
  re-execution on the ``grad_backend``.

Instrumented layers: ``kernels.ops`` (``gemm.calls`` by
backend/family/shape/tile/fusion, records, the audit hook) and
``serve.continuous`` (per-request lifecycle -> TTFT/ITL/phase histograms,
queue/occupancy gauges, prefix-cache counters, step attribution).
``python -m repro_torch.launch.stats`` surfaces all of it.
"""

from . import attr, audit, http, tracing
from .logging import (
    Logger,
    clear_events,
    event,
    event_log_path,
    follow_events,
    get_logger,
    log_mode,
    read_events,
    recent_events,
    set_event_log,
)
from .metrics import (
    DEFAULT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    Registry,
    counter,
    enabled,
    gauge,
    histogram,
    percentile,
    prometheus_text,
    reset,
    set_enabled,
    snapshot,
    to_json,
)
from .spans import span

__all__ = [
    "attr",
    "audit",
    "http",
    "tracing",
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "DEFAULT_BUCKETS",
    "counter",
    "gauge",
    "histogram",
    "snapshot",
    "reset",
    "to_json",
    "prometheus_text",
    "percentile",
    "enabled",
    "set_enabled",
    "span",
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
