"""Offline plan tuning for the port's GEMM kernels on the card.

The port of :mod:`repro.launch.tune`, with its flags but its top-k pruning
one (the port times every legal plan; no model prunes them):
``python -m repro_torch.launch.tune``. Tunes a workload's GEMM shape set —
explicit shapes, and/or every shape a ``configs/`` model runs (harvested on
the meta device, zero FLOPs) — on each requested backend (``cuda``: K1, K4;
``cuda_q8``: K2, K5), timing every legal plan by device time, and writes
the winners to a tuning table that ``repro_torch.kernels.ops`` consults on
every later run (``$REPRO_TUNE_TABLE``, or ``repro_torch/tune/tables/default.json``).
It runs on a CUDA device and refuses without one.

Examples::

    # two decode shapes of chatglm3-6b on K1, into a throwaway table
    python -m repro_torch.launch.tune --shapes 4x4096x4096 4x13696x4096 \
        --backends cuda --table build/tune.json

    # every GEMM shape deepseek-moe-16b's training step runs at batch 8,
    # seq 2048, on both backends
    python -m repro_torch.launch.tune --arch deepseek-moe-16b --batch 8 --seq 2048
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

import torch

from repro_torch import obs
from repro_torch.kernels import ops
from repro_torch.tune import (
    ENV_VAR,
    TUNABLE_BACKENDS,
    GemmShape,
    TableFormatError,
    TuningTable,
    active_table_path,
    device_kind,
    harvest_model_shapes,
    tune_workload,
)

__all__ = ["main"]


def _parse_dense(spec: str, dtype: str) -> GemmShape:
    try:
        m, k, n = (int(x) for x in spec.lower().split("x"))
    except ValueError:
        raise SystemExit(f"bad --shapes entry {spec!r}; want MxKxN") from None
    return GemmShape("dense", m, k, n, 0, dtype)


def _parse_grouped(spec: str, dtype: str) -> GemmShape:
    try:
        g, m, k, n = (int(x) for x in spec.lower().split("x"))
    except ValueError:
        raise SystemExit(f"bad --grouped entry {spec!r}; want GxMxKxN") from None
    return GemmShape("grouped", m, k, n, g, dtype)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.tune",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--shapes", nargs="*", default=[], metavar="MxKxN",
                    help="dense GEMM shapes to tune")
    ap.add_argument("--grouped", nargs="*", default=[], metavar="GxMxKxN",
                    help="grouped GEMM shapes to tune (per-group MxKxN)")
    ap.add_argument("--arch", action="append", default=[],
                    help="configs/ model whose GEMM shapes to harvest and tune (repeatable)")
    ap.add_argument("--batch", type=int, default=1, help="harvest batch size (with --arch)")
    ap.add_argument("--seq", type=int, default=128, help="harvest sequence length (with --arch)")
    ap.add_argument("--dtype", default="bfloat16",
                    help="operand dtype for explicit --shapes/--grouped (the sm90 plans "
                         "take bfloat16; the q8 backend quantizes it)")
    ap.add_argument("--backends", nargs="*", default=None,
                    help="backends to tune (default: every tunable backend)")
    ap.add_argument("--table", default=None,
                    help=f"table path (default: {active_table_path()})")
    ap.add_argument("--fresh", action="store_true",
                    help="start from an empty table instead of merging into the existing one")
    ap.add_argument("--iters", type=int, default=3,
                    help="timing samples per candidate (each a mean over queued calls)")
    ap.add_argument("--warmup", type=int, default=1, help="warmup calls per candidate")
    ap.add_argument("--list-backends", action="store_true",
                    help="print the tunable backends and exit")
    return ap


def main(argv: Optional[List[str]] = None) -> None:
    args = _parser().parse_args(argv)
    log = obs.get_logger("tune")

    tunable = [b for b in ops.tunable_backends() if b in TUNABLE_BACKENDS]
    if args.list_backends:
        log.raw(f"tunable backends on {device_kind()}: {tunable}")
        return
    if not torch.cuda.is_available():
        raise SystemExit("repro_torch.launch.tune times plans on a CUDA device; none is "
                         "available (the port has no CPU kernel lane to tune)")

    if args.backends is None:
        backends = tunable
    else:
        unknown = [b for b in args.backends if b not in TUNABLE_BACKENDS]
        if unknown:
            raise SystemExit(f"not tunable: {unknown} (no plan= knob); "
                             f"tunable: {sorted(TUNABLE_BACKENDS)}")
        backends = list(args.backends)
    if not backends:
        raise SystemExit("no tunable backend registered")

    shapes: List[GemmShape] = []
    shapes += [_parse_dense(s, args.dtype) for s in args.shapes]
    shapes += [_parse_grouped(s, args.dtype) for s in args.grouped]
    for arch in args.arch:
        harvested = harvest_model_shapes(arch, batch=args.batch, seq=args.seq)
        log.raw(f"harvested {len(harvested)} GEMM shapes from {arch} "
                f"(batch={args.batch}, seq={args.seq})")
        shapes += harvested
    shapes = list(dict.fromkeys(shapes))  # dedupe, keep order
    if not shapes:
        raise SystemExit("nothing to tune: pass --shapes/--grouped/--arch")

    path = args.table or active_table_path()
    table = TuningTable()
    if not args.fresh:
        try:
            table.merge(TuningTable.load(path))
            log.raw(f"merging into {len(table)} existing entries from {path}")
        except FileNotFoundError:
            pass
        except TableFormatError as e:
            log.raw(f"ignoring unusable existing table at {path}: {e}")

    log.raw(f"tuning {len(shapes)} shapes x {len(backends)} backends on {device_kind()} "
            f"(every legal plan, {args.iters} samples each, device time)")
    tune_workload(
        shapes, backends=backends, table=table, iters=args.iters, warmup=args.warmup,
        log=lambda line: log.raw("  " + line),
    )
    table.save(path)
    ops.clear_tile_cache()  # this process re-reads the table it just wrote
    log.raw(f"wrote {len(table)} entries -> {path}")
    if path == active_table_path():
        if os.environ.get(ENV_VAR):
            log.raw(f"active while REPRO_TUNE_TABLE={path} is set")
        else:
            log.raw("written to the default location; active automatically")
    else:
        log.raw(f"activate with: REPRO_TUNE_TABLE={path}")


if __name__ == "__main__":
    main(sys.argv[1:])
