"""Autotuning subsystem of the port: measured plan selection on the H100.

The port of :mod:`repro.tune`. The kernels' heuristics (each kernel
module's ``_plan``) give one plan per shape; this package replaces the
guess with a measurement, in three parts:

* :mod:`~repro_torch.tune.search` — every legal plan of the GEMM kernels
  (K1, K4 on ``"cuda"``; K2, K5 on ``"cuda_q8"``: a compiled tile and, for
  K1 and K2, a K split count), each timed on the card by device time
  through the kernels' ``plan=`` parameter, the heuristic among them;
* :mod:`~repro_torch.tune.table` — the persistent JSON tuning table (keyed
  by backend, shape family, (M, K, N, G), dtype, device kind; the
  reference's file format, with an optional ``splits``) that
  ``kernels.ops._tile_for`` consults before the heuristic, with env override
  ``REPRO_TUNE_TABLE`` and hard-constraint validation at lookup;
* :mod:`~repro_torch.tune.capture` — workload harvesting: one training
  forward of a ``configs/`` model on the meta device under
  ``ops.capture_shapes`` yields its whole GEMM shape set, which
  ``python -m repro_torch.launch.tune`` tunes offline.

``ops.tile_source(backend, m, k, n)`` reports whether a shape resolves
``"tuned"`` or ``"heuristic"``; the tuner's fused-vs-post-hoc epilogue probe
(``search.probe_epilogue_fusion``) records its verdict in
``TuneEntry.fuse_epilogue``, and ``ops.fusion_source`` reports whether a
shape's fusion decision is ``"tuned"`` or ``"default"``.
"""

from .capture import capture_gemm_shapes, harvest_model_shapes
from .search import (
    PROBE_EPILOGUE,
    TUNABLE_BACKENDS,
    CandidateResult,
    EpilogueProbe,
    candidate_blocks,
    median_time_us,
    probe_epilogue_fusion,
    tune_shape,
    tune_workload,
)
from .table import (
    DEFAULT_TABLE_PATH,
    ENV_VAR,
    GemmShape,
    SCHEMA_VERSION,
    TableFormatError,
    TuneEntry,
    TuneKey,
    TuningTable,
    active_table_path,
    device_kind,
    load_active_table,
)

__all__ = [
    "PROBE_EPILOGUE",
    "TUNABLE_BACKENDS",
    "CandidateResult",
    "EpilogueProbe",
    "candidate_blocks",
    "median_time_us",
    "probe_epilogue_fusion",
    "tune_shape",
    "tune_workload",
    "capture_gemm_shapes",
    "harvest_model_shapes",
    "DEFAULT_TABLE_PATH",
    "ENV_VAR",
    "GemmShape",
    "SCHEMA_VERSION",
    "TableFormatError",
    "TuneEntry",
    "TuneKey",
    "TuningTable",
    "active_table_path",
    "device_kind",
    "load_active_table",
]
