"""The auto-retune seam: what the registry's drift detectors trigger.

The port of :mod:`repro.tune.retune`. Two sibling hooks in
:mod:`repro_torch.kernels.ops` route here by default:

* ``on_miss_streak`` — a long-lived process keeps resolving plans the memo
  (and, usually, the tuning table) has never seen: a workload the last
  ``python -m repro_torch.launch.tune`` run did not cover (``reason:
  "miss_streak"``).
* ``on_util_gap`` — a shape the table *does* cover keeps scoring a live
  roofline fraction (:mod:`repro_torch.obs.attr`) well below its own best:
  a tuned entry gone stale (``reason: "util_gap"``).

The default hook does **not** retune: a search in the process would take
card time from the serving loop it means to help. It records the candidate
— a ``tune.retune_candidates`` counter labelled by shape family, backend and
reason, and a ``retune_candidate`` event carrying the full shape key — so an
operator can tune exactly those shapes offline. A process that wants an
active policy registers its own callback with ``ops.on_miss_streak`` /
``ops.on_util_gap``.
"""

from __future__ import annotations

from typing import Optional, Tuple

from repro_torch import obs as _obs

__all__ = ["retune_candidate"]

# (backend, shape_family, m, k, n, groups, itemsize) — ops.TileKey.
Key = Tuple[Optional[str], str, int, int, int, int, int]


def retune_candidate(key: Key, streak: int, *, reason: str = "miss_streak") -> None:
    """Record one retune candidate (never retunes implicitly)."""
    if not _obs.enabled():
        return
    backend, family, m, k, n, groups, itemsize = key
    _obs.counter(
        "tune.retune_candidates", backend=str(backend), family=family, reason=reason,
    ).inc()
    _obs.event(
        "retune_candidate", backend=str(backend), family=family, m=m, k=k, n=n,
        groups=groups, itemsize=itemsize, streak=streak, reason=reason,
    )
