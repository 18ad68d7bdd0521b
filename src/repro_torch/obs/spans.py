"""Trace spans: named brackets that show up on the profiler's timeline *and*
in the host histograms.

The port of :mod:`repro.obs.spans`. ``span(name)`` is one context manager
serving both:

* **profiler** — the body runs under ``torch.profiler.record_function``, so
  the bracket appears on the Chrome trace of a ``torch.profiler`` capture
  (``python -m repro_torch.launch.stats serve --profile``). That is the
  trace that works on the card's machine; ``nsys`` does not run there, so
  an NVTX range would show nowhere;
* **host** — a wall-clock timer records the bracket duration into the
  ``span.seconds`` histogram, labelled by span name.

With telemetry off (``REPRO_METRICS=0``) the whole thing is a bare
``yield`` — no profiler op, no timer — so a disabled process runs the
un-instrumented code.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator

from . import metrics as _m

__all__ = ["span"]


@contextlib.contextmanager
def span(name: str, **labels) -> Iterator[None]:
    """Bracket a region: profiler annotation + host wall timer."""
    if not _m.enabled():
        yield
        return
    import torch

    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        _m.histogram("span.seconds", name=name, **labels).observe(
            time.perf_counter() - t0
        )
