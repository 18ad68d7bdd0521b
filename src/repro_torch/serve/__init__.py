"""Serving layer of the port: scheduler, slot pool, lockstep and
continuous-batching engines."""

from .cache import SlotPool, init_slot_caches, scatter_slots
from .continuous import ContinuousEngine, ServingReport
from .engine import ServeEngine, sample_token
from .scheduler import (
    Request,
    RequestState,
    Scheduler,
    bucket_length,
    gen_len_spread,
    poisson_trace,
    shared_prefix_trace,
)

__all__ = [
    "ContinuousEngine",
    "Request",
    "RequestState",
    "Scheduler",
    "ServeEngine",
    "ServingReport",
    "SlotPool",
    "bucket_length",
    "gen_len_spread",
    "init_slot_caches",
    "poisson_trace",
    "sample_token",
    "scatter_slots",
    "shared_prefix_trace",
]
