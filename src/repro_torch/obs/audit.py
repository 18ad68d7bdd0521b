"""Shadow numerics auditor: sampled fp re-execution of quantized GEMMs.

The port of :mod:`repro.obs.audit`. A sampling gate (``REPRO_AUDIT=N`` →
audit one in N eligible calls; unset/0 → off) re-executes a
quantized-family GEMM's exact composition — epilogue included — on the
backend's registered full-precision ``grad_backend`` (``cuda`` for
``cuda_q8``, ``torch`` for ``torch_q8``) and records:

* ``numerics.abs_err`` / ``numerics.rel_err`` histograms (labelled by
  backend / family / shape family),
* ``numerics.nonfinite`` sentinel counters (NaN / Inf in the quantized
  output — a quantizer overflow never gets to hide in a latency histogram),
* a ``numerics_drift`` structured event + ``numerics.drift`` counter when
  the relative error exceeds the family's policy threshold
  (:func:`set_policy`; ``repro_torch.quant`` registers the q8 policy).

Reach: ``kernels.ops`` audits direct entry-point calls only. Inside an
engine step (:func:`repro_torch.obs.attr.step_scope`, the port's analogue
of a ``jit`` trace, where the reference's outputs are tracers) nothing is
audited, so a served step's kernels are the same with sampling on or off.
The shadow GEMM of a sampled direct call is an eager re-execution and its
error summary a read of the output: it costs the card one more GEMM and the
host one synchronization on the 1-in-N sampled call, never a served step.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Callable, Dict, Optional, Tuple

from . import metrics as _metrics
from .logging import event as _event

__all__ = [
    "AUDIT_ENV",
    "AuditPolicy",
    "audit_every",
    "set_audit_every",
    "set_policy",
    "get_policy",
    "maybe_audit_gemm",
    "ERR_BUCKETS",
]

AUDIT_ENV = "REPRO_AUDIT"

# Error-magnitude bucket edges (shared by abs and rel error histograms):
# fp32-roundoff (~1e-7) through catastrophically-wrong (>1).
ERR_BUCKETS: Tuple[float, ...] = (
    1e-8, 1e-7, 1e-6, 1e-5, 1e-4, 1e-3, 3e-3, 0.01, 0.03, 0.1, 0.3,
    1.0, 3.0, 10.0,
)


@dataclasses.dataclass(frozen=True)
class AuditPolicy:
    """Per-numerics-family drift threshold. ``rel_err`` is max absolute
    error over the reference's max magnitude — scale-free, so one policy
    covers every layer size."""

    rel_err: float
    abs_err: Optional[float] = None  # optional absolute floor, same units


_LOCK = threading.Lock()
_POLICIES: Dict[str, AuditPolicy] = {}
# Runtime override for the env knob (tests; a serving process could flip it
# live). None → read the environment.
_EVERY_OVERRIDE: Optional[int] = None
_CALLS = 0  # eligible-call counter driving the 1-in-N gate


def audit_every() -> int:
    """Current sampling period: audit one in N eligible calls; 0 = off."""
    if _EVERY_OVERRIDE is not None:
        return _EVERY_OVERRIDE
    raw = os.environ.get(AUDIT_ENV, "")
    try:
        n = int(raw)
    except ValueError:
        return 0
    return max(n, 0)


def set_audit_every(n: Optional[int]) -> None:
    """Override the ``REPRO_AUDIT`` period at runtime (``None`` restores the
    environment's value). Resets the sampling phase."""
    global _EVERY_OVERRIDE, _CALLS
    with _LOCK:
        _EVERY_OVERRIDE = None if n is None else max(int(n), 0)
        _CALLS = 0


def set_policy(family: str, *, rel_err: float,
               abs_err: Optional[float] = None) -> None:
    """Register/replace the drift policy for a numerics family."""
    _POLICIES[family] = AuditPolicy(rel_err=float(rel_err), abs_err=abs_err)


def get_policy(family: str) -> Optional[AuditPolicy]:
    return _POLICIES.get(family)


def _should_sample() -> bool:
    every = audit_every()
    if every <= 0:
        return False
    global _CALLS
    with _LOCK:
        _CALLS += 1
        return _CALLS % every == 0


def maybe_audit_gemm(
    *,
    kind: str,
    backend: str,
    family: str,
    out,
    ref_fn: Callable[[], object],
    m: int,
    k: int,
    n: int,
    g: int = 0,
) -> Optional[Dict[str, float]]:
    """Audit one eligible (quantized-family, concrete-output) GEMM call.

    ``ref_fn`` recomputes the identical composition on the fp
    ``grad_backend`` — the caller (``kernels.ops``) builds the closure so
    this module never imports the registry. Returns the error summary when
    an audit ran (tests use it), else ``None``. Never raises: a diagnostics
    path must not take down the model that it is diagnosing.
    """
    if not _metrics.enabled() or not _should_sample():
        return None
    try:
        import torch

        got = out.detach().to(torch.float64)
        labels = dict(backend=backend, family=family, shape=kind)
        n_nan = int(torch.isnan(got).sum().item())
        n_inf = int(torch.isinf(got).sum().item())
        if n_nan:
            _metrics.counter("numerics.nonfinite", sentinel="nan",
                             **labels).inc(n_nan)
        if n_inf:
            _metrics.counter("numerics.nonfinite", sentinel="inf",
                             **labels).inc(n_inf)
        ref = ref_fn().detach().to(torch.float64)
        finite = torch.isfinite(got)
        abs_err = float(
            (torch.where(finite, got, torch.zeros_like(got)) - ref).abs().max()
        ) if ref.numel() else 0.0
        ref_scale = float(ref.abs().max()) if ref.numel() else 0.0
        rel_err = abs_err / (ref_scale + 1e-30)
        _metrics.counter("numerics.audits", **labels).inc()
        _metrics.histogram("numerics.abs_err", buckets=ERR_BUCKETS,
                           **labels).observe(abs_err)
        _metrics.histogram("numerics.rel_err", buckets=ERR_BUCKETS,
                           **labels).observe(rel_err)
        policy = _POLICIES.get(family)
        drifted = policy is not None and (
            rel_err > policy.rel_err
            or (policy.abs_err is not None and abs_err > policy.abs_err)
            or n_nan > 0
            or n_inf > 0
        )
        if drifted:
            _metrics.counter("numerics.drift", **labels).inc()
            _event(
                "numerics_drift",
                backend=backend,
                family=family,
                shape_family=kind,
                m=m, k=k, n=n, g=g,
                abs_err=abs_err,
                rel_err=rel_err,
                nan=n_nan,
                inf=n_inf,
                threshold=policy.rel_err,
            )
        return {
            "abs_err": abs_err, "rel_err": rel_err,
            "nan": float(n_nan), "inf": float(n_inf),
            "drifted": float(drifted),
        }
    except Exception:
        return None
