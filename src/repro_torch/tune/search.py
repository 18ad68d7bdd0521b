"""Measured plan search on the card: every legal plan, timed by device time.

The port of :mod:`repro.tune.search`. The reference tunes a free ``(bm, bn,
bk)``; the H100 kernels compile a few tile configurations, so the port's
knob is the kernel's **plan**: the sm90 route, a compiled tile (which fixes
bm, bn, bk and the stage count) and, for K1 and K2, the K split count. The
search space of one workload cell is every legal plan the kernel module
lists (:func:`candidate_blocks`, the kernels' ``candidate_plans``: two
compiled tiles a kernel, each with its legal split counts), and every one
of them is timed on the card (warmup, then the median of ``iters`` samples
of device time), the winner persisted to a
:class:`~repro_torch.tune.table.TuningTable`. The reference prunes its free
tile space with its TPU cycle model (``rank_plans``, copied into
:mod:`repro_torch.core.tiling`); that model describes neither ``wgmma``,
TMA nor split-K, and a list this short needs no pruning, so the port times
every plan and records no ``modeled_cycles``.

The backend's own heuristic plan is **always** in the measured set, so a
tuned entry is never slower than the heuristic under the same measurement:
the tuner can only confirm or improve the default.

Device time, not host time: each sample is CUDA events around calls that the
host queues behind a sleeping kernel (``torch.cuda._sleep``), so the events
time the device's back-to-back work and not the host's issue rate. The calls
rotate over enough copies of the weight operand that the weights exceed
the 50 MB L2 three times over: a decode GEMM reads its weights from device
memory, as in service, and a split that only wins on warm L2 does not win
here. There is no CPU kernel lane to time: on the CPU the search raises.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.roofline import dtype_width
from repro_torch.kernels import epilogue as _epi
from repro_torch.kernels import ops
from repro_torch.kernels.opope_gemm import Plan, opope_gemm
from repro_torch.kernels.opope_gemm import candidate_plans as _k1_candidates
from repro_torch.kernels.opope_grouped import candidate_plans as _k4_candidates
from repro_torch.kernels.opope_grouped import opope_gemm_grouped
from repro_torch.quant.backends import quantize_grouped_operands, quantize_operands
from repro_torch.quant.opope_q8 import candidate_plans as _q8_candidates
from repro_torch.quant.opope_q8 import opope_gemm_q8, opope_gemm_q8_grouped

from .table import GemmShape, TuneEntry, TuneKey, TuningTable, device_kind

__all__ = [
    "TUNABLE_BACKENDS",
    "PROBE_EPILOGUE",
    "CandidateResult",
    "EpilogueProbe",
    "candidate_blocks",
    "median_time_us",
    "probe_epilogue_fusion",
    "tune_shape",
    "tune_workload",
]

# The backends whose kernel entry points the tuner drives with an explicit
# plan= (K1/K4 for "cuda", K2/K5 for "cuda_q8"). Tunability itself comes
# from the registry (tile_fn); a registered fn hides its kernel, so timing
# a specific plan needs the kernel entry point: a new backend with a
# tile_fn must add its dispatch here and to _make_runner to be tunable.
TUNABLE_BACKENDS = frozenset({"cuda", "cuda_q8"})

L2_BYTES = 50 * 2**20  # H100 SXM


def _torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def candidate_blocks(backend: str, shape: GemmShape) -> List[Plan]:
    """Every legal sm90 plan of ``backend``'s kernel for this cell (its
    ``candidate_plans``): K1 or K4 for ``"cuda"``, K2 or K5 for
    ``"cuda_q8"``. Empty where the sm90 route does not take the cell."""
    grouped = shape.family == "grouped"
    if backend == "cuda":
        cands = _k4_candidates if grouped else _k1_candidates
        return cands(shape.m, shape.n, shape.k, dtype=_torch_dtype(shape.dtype))
    if backend == "cuda_q8":
        return _q8_candidates(shape.m, shape.n, shape.k, grouped=grouped)
    raise ValueError(f"backend {backend!r} is not tunable; tunable: {sorted(TUNABLE_BACKENDS)}")


@dataclasses.dataclass(frozen=True)
class CandidateResult:
    block: Tuple[int, int, int]
    us: float
    gflops: float
    modeled_cycles: Optional[int]
    is_heuristic: bool
    splits: int = 1


# The epilogue pipeline the fusion probe times: one streamed row operand plus
# one activation, the canonical MLP-hidden writeback (bias + silu).
PROBE_EPILOGUE: Tuple[str, ...] = ("bias", "silu")


@dataclasses.dataclass(frozen=True)
class EpilogueProbe:
    """Fused-vs-post-hoc device time of :data:`PROBE_EPILOGUE` at one plan.

    ``fused_us`` times the kernel with the pipeline fused into the
    accumulator writeback; ``posthoc_us`` the same kernel's fp32 product
    followed by the pipeline as PyTorch passes over the output. Ties go to
    fused: at equal time it still saves a round trip through memory.
    """

    block: Tuple[int, int, int]
    steps: Tuple[str, ...]
    fused_us: float
    posthoc_us: float
    splits: int = 1

    @property
    def fuse(self) -> bool:
        return self.fused_us <= self.posthoc_us

    @property
    def decided_us(self) -> float:
        return min(self.fused_us, self.posthoc_us)


def _queued_ms(run: Callable[[int], object], calls: int) -> float:
    """Mean device time in ms of ``run(i)`` over ``calls`` calls that the
    host queues behind a sleeping kernel: the device runs them back to back
    once it wakes, so the events time the device's work, not the host's
    issue rate. The start event must still be pending when the last call is
    queued; else the sleep was too short and it is taken again, four times
    longer."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    cycles = 10_000_000  # ~5 ms at the H100's clock
    for _ in range(5):
        torch.cuda._sleep(cycles)
        start.record()
        for i in range(calls):
            run(i)
        end.record()
        if not start.query():
            end.synchronize()
            return start.elapsed_time(end) / calls
        torch.cuda.synchronize()
        cycles *= 4
    raise RuntimeError("the host did not queue the timed calls within the device's sleep")


def median_time_us(run: Callable[[int], object], *, iters: int = 3, warmup: int = 1,
                   calls: int = 20) -> float:
    """Median device time of one ``run(i)`` in microseconds: ``warmup``
    calls, then ``iters`` samples, each the mean over ``calls`` queued calls
    (``i`` counts the calls, so ``run`` can rotate operand copies)."""
    for i in range(max(1, warmup)):
        run(i)
    torch.cuda.synchronize()
    samples = sorted(1e3 * _queued_ms(run, max(1, calls)) for _ in range(max(1, iters)))
    return max(samples[len(samples) // 2], 1e-3)


def _tuning_device() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "the tuner times plans by device time on a CUDA device; the port has no CPU "
            "kernel lane to time and no CUDA device is available")
    return torch.device("cuda")


def _operands(backend: str, shape: GemmShape, device: torch.device, seed: int):
    """(A, weight copies, the kernel, a zero-arg tuple maker for one call's
    operands): A once and enough weight copies that they exceed the L2
    three times over (at most 64), quantized here for the q8 kernels, all
    outside every timed region."""
    grouped = shape.family == "grouped"
    q8 = backend == "cuda_q8"
    lead = (shape.g,) if grouped else ()
    gen = torch.Generator(device=device).manual_seed(seed)
    dtype = torch.bfloat16 if q8 else _torch_dtype(shape.dtype)
    b_bytes = max(1, shape.g if grouped else 1) * shape.k * shape.n * (1 if q8 else
                                                                         dtype_width(dtype))
    n_bufs = max(1, min(64, math.ceil(3 * L2_BYTES / b_bytes)))
    a = torch.randn(lead + (shape.m, shape.k), generator=gen, device=device).to(dtype)
    bs = [(torch.randn(lead + (shape.k, shape.n), generator=gen, device=device)
           * shape.k ** -0.5).to(dtype) for _ in range(n_bufs)]
    if not q8:
        kern = opope_gemm_grouped if grouped else opope_gemm
        return kern, [(a, b) for b in bs]
    quant = quantize_grouped_operands if grouped else quantize_operands
    args = []
    for b in bs:
        aq, bq = quant(a, b)
        args.append((aq.q, aq.scale, bq.q, bq.scale))
    return (opope_gemm_q8_grouped if grouped else opope_gemm_q8), args


def _make_runner(backend: str, shape: GemmShape, seed: int = 0):
    """``(plan -> run(i), calls)``: ``run(i)`` is one kernel call on the
    ``i``-th weight copy (mod their count) under ``plan``; ``calls`` the
    queued calls a sample takes (every copy at least once)."""
    kern, args = _operands(backend, shape, _tuning_device(), seed)

    def runner(plan: Plan) -> Callable[[int], object]:
        return lambda i: kern(*args[i % len(args)], plan=plan)

    return runner, max(20, len(args))


def _make_epilogue_runners(backend: str, shape: GemmShape, plan: Plan, seed: int = 0):
    """``(fused(i), posthoc(i), calls)`` for :data:`PROBE_EPILOGUE` at one
    plan: the same fp32 result either with the pipeline at the kernel's
    writeback or as PyTorch passes over the kernel's fp32 product."""
    device = _tuning_device()
    kern, args = _operands(backend, shape, device, seed)
    grouped = shape.family == "grouped"
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    bias = torch.randn((shape.g, 1, shape.n) if grouped else (1, shape.n), generator=gen,
                       device=device)

    def fused(i):
        return kern(*args[i % len(args)], out_dtype=torch.float32, epilogue=PROBE_EPILOGUE,
                    epilogue_operands=(bias,), plan=plan)

    def posthoc(i):
        acc = kern(*args[i % len(args)], out_dtype=torch.float32, plan=plan)
        return _epi.apply_epilogue(acc, PROBE_EPILOGUE, (bias,))

    return fused, posthoc, max(20, len(args))


def probe_epilogue_fusion(backend: str, shape: GemmShape, plan: Plan, *, iters: int = 3,
                          warmup: int = 1, seed: int = 0) -> EpilogueProbe:
    """Time :data:`PROBE_EPILOGUE` fused at the writeback against post-hoc
    for one cell at one plan; the verdict feeds ``TuneEntry.fuse_epilogue``
    (and from there ``ops._fusion_for`` on every later run)."""
    if backend not in TUNABLE_BACKENDS:
        raise ValueError(f"backend {backend!r} is not tunable; tunable: "
                         f"{sorted(TUNABLE_BACKENDS)}")
    if not ops.epilogue_capable(backend):
        raise ValueError(f"backend {backend!r} has no fused-epilogue lane")
    fused, posthoc, calls = _make_epilogue_runners(backend, shape, plan, seed=seed)
    return EpilogueProbe(
        block=(plan.bm, plan.bn, plan.bk), steps=PROBE_EPILOGUE,
        fused_us=median_time_us(fused, iters=iters, warmup=warmup, calls=calls),
        posthoc_us=median_time_us(posthoc, iters=iters, warmup=warmup, calls=calls),
        splits=plan.splits,
    )


def tune_shape(
    backend: str,
    shape: GemmShape,
    *,
    iters: int = 3,
    warmup: int = 1,
    seed: int = 0,
    probe_epilogue: bool = True,
) -> Tuple[TuneEntry, List[CandidateResult]]:
    """Tune one workload cell on one backend; returns the winning entry plus
    every measured candidate: every legal plan, the heuristic's among them.
    With ``probe_epilogue`` (the default) the winning plan also gets the
    fused-vs-post-hoc probe, whose verdict the entry records in
    ``fuse_epilogue``.
    """
    if backend not in TUNABLE_BACKENDS:
        if backend in ops.tunable_backends():
            raise ValueError(
                f"backend {backend!r} registers a tile_fn but the tuner has "
                f"no kernel dispatch for it — add it to "
                f"search.TUNABLE_BACKENDS/_make_runner to make it tunable"
            )
        raise ValueError(
            f"backend {backend!r} has no tile knob to tune; tunable: "
            f"{sorted(TUNABLE_BACKENDS)}"
        )
    q8 = ops.family_of(backend) == "q8"
    grouped = shape.family == "grouped"
    heuristic = ops.heuristic_tile(backend, shape.m, shape.k, shape.n,
                                   groups=shape.g if grouped else 0,
                                   dtype=_torch_dtype(shape.dtype))
    plans = candidate_blocks(backend, shape)
    if heuristic not in plans:
        plans.append(heuristic)

    runner, calls = _make_runner(backend, shape, seed=seed)
    flops = 2.0 * shape.m * shape.k * shape.n * max(1, shape.g)
    results: List[CandidateResult] = []
    for plan in plans:
        us = median_time_us(runner(plan), iters=iters, warmup=warmup, calls=calls)
        results.append(CandidateResult(
            block=(plan.bm, plan.bn, plan.bk), us=us, gflops=flops / us / 1e3,
            modeled_cycles=None, is_heuristic=plan == heuristic, splits=plan.splits,
        ))
    best_i = min(range(len(results)), key=lambda i: results[i].us)
    best, best_plan = results[best_i], plans[best_i]
    fuse: Optional[bool] = None
    if probe_epilogue and ops.epilogue_capable(backend):
        fuse = probe_epilogue_fusion(backend, shape, best_plan, iters=iters, warmup=warmup,
                                     seed=seed).fuse
    entry = TuneEntry(
        key=TuneKey(
            backend=backend, shape_family=shape.family,
            m=shape.m, k=shape.k, n=shape.n, g=shape.g,
            dtype="int8" if q8 else shape.dtype,
            device_kind=device_kind(),
        ),
        block=best.block, us=best.us, gflops=best.gflops,
        fuse_epilogue=fuse, splits=best.splits,
    )
    return entry, results


def tune_workload(
    shapes: Sequence[GemmShape],
    *,
    backends: Iterable[str],
    table: Optional[TuningTable] = None,
    iters: int = 3,
    warmup: int = 1,
    log: Optional[Callable[[str], None]] = None,
) -> TuningTable:
    """Tune every (shape x backend) cell into ``table`` (new one if None)."""
    table = table if table is not None else TuningTable()
    for backend in backends:
        for shape in shapes:
            entry, results = tune_shape(backend, shape, iters=iters, warmup=warmup)
            table.put(entry)
            if log is not None:
                heur = next(r for r in results if r.is_heuristic)
                gain = heur.us / entry.us if entry.us else 1.0
                log(
                    f"{backend:>8s} {shape.family:>7s} "
                    f"g={shape.g:<3d} {shape.m}x{shape.k}x{shape.n} "
                    f"{shape.dtype}: best {entry.block} x{entry.splits} {entry.us:.2f}us "
                    f"({entry.gflops:.1f} GFLOP/s), heuristic {heur.block} x{heur.splits} "
                    f"{heur.us:.2f}us -> {gain:.3f}x, "
                    f"{len(results)} candidates timed, "
                    f"fuse_epilogue={entry.fuse_epilogue}"
                )
    return table
