"""L1 tiling and DMA double-buffering model (paper §II-C, §III-D).

When GEMM operands exceed the 128 kB TCDM, the PULP cluster splits the
scratchpad in half: 64 kB holds the tiles the engine is computing on while the
DMA fills the other 64 kB with the next tiles (Fig. 7 setup). Core 0 reprograms
the DMA and the accelerator for every tile. The paper's exemplary tiling is
``64 x 128 x 128`` (FP16: 16 kB A + 32 kB B + 16 kB C = 64 kB).

This module provides

* :func:`choose_tile` — pick an (tm, tk, tn) tile satisfying the paper's
  utilization constraints (tm, tn multiples of the engine's C-tile side,
  tk >= 2p) under an L1 byte budget, and
* :func:`tiled_gemm_cycles` — the cluster-level runtime model: engine cycles
  per tile (via the cycle-accurate engine model, with C preload/writeback at
  k-tile boundaries) overlapped with DMA transfers, plus per-tile reprogramming.

A copy of :mod:`repro.core.tiling` (the port imports nothing of the JAX
package), held equal to it by the port's tests. It models the paper's TPU
cluster, not the H100: the port's tuner (:mod:`repro_torch.tune.search`)
does not rank with :func:`rank_plans`, because the model knows neither
``wgmma``, TMA nor split-K, and it times every legal plan instead.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Iterable, List, Tuple

from .engine import EngineConfig, simulate_gemm

__all__ = [
    "TilingPlan",
    "choose_tile",
    "tiled_gemm_cycles",
    "ClusterConfig",
    "rank_plans",
]


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    """PULP cluster parameters around the engine (paper §II-C)."""

    tcdm_bytes: int = 128 * 1024
    double_buffer: bool = True  # half TCDM for DMA, half for compute
    dma_bytes_per_cycle: float = 16.0  # 128-bit AXI to L2
    reprogram_cycles: int = 50  # core 0 re-programs DMA + accelerator per tile

    @property
    def compute_bytes(self) -> int:
        return self.tcdm_bytes // 2 if self.double_buffer else self.tcdm_bytes


@dataclasses.dataclass(frozen=True)
class TilingPlan:
    tm: int
    tk: int
    tn: int
    elem_bytes: int

    @property
    def a_bytes(self) -> int:
        return self.tm * self.tk * self.elem_bytes

    @property
    def b_bytes(self) -> int:
        return self.tk * self.tn * self.elem_bytes

    @property
    def c_bytes(self) -> int:
        return self.tm * self.tn * self.elem_bytes

    @property
    def total_bytes(self) -> int:
        return self.a_bytes + self.b_bytes + self.c_bytes


def choose_tile(
    engine: EngineConfig,
    m: int,
    k: int,
    n: int,
    *,
    l1_budget_bytes: int = 64 * 1024,
    elem_bytes: int = 2,
) -> TilingPlan:
    """Pick an L1 tile per the paper's constraints.

    Preference order mirrors §III-C: (1) tm, tn multiples of the engine's
    output tile side (2p) to avoid pipeline quantization, (2) tk as large as
    possible and at least 2p so the C-tile swap hides under compute, (3) fit
    A+B+C in the budget. Falls back to the full dimension when it already fits.
    """
    side = engine.tile_m  # 2p
    tm = min(m, 2 * side)  # 64 for p=16 — the paper's exemplary tile height
    tm = max(side, (tm // side) * side) if m >= side else m

    def fits(tm: int, tk: int, tn: int) -> bool:
        return TilingPlan(tm, tk, tn, elem_bytes).total_bytes <= l1_budget_bytes

    # Grow tn in units of the tile side, then give the rest of the budget to tk.
    best: TilingPlan | None = None
    tn_cap = min(n, 16 * side)
    tn = side if n >= side else n
    while True:
        # Largest tk fitting the budget for this (tm, tn).
        tk_budget = (l1_budget_bytes - tm * tn * elem_bytes) // (
            (tm + tn) * elem_bytes
        )
        tk = min(k, tk_budget)
        if tk >= min(k, 2 * engine.p) and fits(tm, tk, tn):
            best = TilingPlan(tm, tk, tn, elem_bytes)
        next_tn = tn + side
        if next_tn > tn_cap or not fits(tm, min(k, 2 * engine.p), next_tn):
            break
        tn = next_tn
    if best is None:  # degenerate small-budget fallback
        best = TilingPlan(min(m, side), min(k, 2 * engine.p), min(n, side), elem_bytes)
    return best


def tiled_gemm_cycles(
    engine: EngineConfig,
    m: int,
    k: int,
    n: int,
    *,
    cluster: ClusterConfig = ClusterConfig(),
    plan: TilingPlan | None = None,
    elem_bytes: int = 2,
) -> dict:
    """Cluster-level runtime of a large GEMM with L1 double buffering.

    Per (m, n) macro-tile the K dimension is consumed in tk-chunks; the engine
    preloads the partial C tile as accumulator initial values (the paper's
    C-preload path) and writes it back per chunk. The DMA moves the next
    chunk's A/B (and C at macro-tile boundaries) concurrently; with double
    buffering each tile step costs ``max(engine, dma)`` cycles plus the
    reprogramming overhead.

    Returns a dict with total cycles, utilization, and the bound ("compute" or
    "dma") for reporting in `benchmarks/fig7_runtime.py`.
    """
    if plan is None:
        plan = choose_tile(
            engine, m, k, n,
            l1_budget_bytes=cluster.compute_bytes, elem_bytes=elem_bytes,
        )
    mt = math.ceil(m / plan.tm)
    nt = math.ceil(n / plan.tn)
    kt = math.ceil(k / plan.tk)

    total = 0
    compute_bound_steps = 0
    dma_bound_steps = 0
    # Prologue: DMA in the first tile set (not overlapped).
    first_bytes = plan.total_bytes
    total += math.ceil(first_bytes / cluster.dma_bytes_per_cycle)
    for i in range(mt):
        tm = min(plan.tm, m - i * plan.tm)
        for j in range(nt):
            tn = min(plan.tn, n - j * plan.tn)
            for kk in range(kt):
                tk = min(plan.tk, k - kk * plan.tk)
                eng = _engine_cycles(engine, tm, tk, tn)
                dma_bytes = (tm * tk + tk * tn) * elem_bytes
                if kk == kt - 1:  # C tile in/out at macro-tile boundary
                    dma_bytes += 2 * tm * tn * elem_bytes
                dma = math.ceil(dma_bytes / cluster.dma_bytes_per_cycle)
                step = max(eng, dma) if cluster.double_buffer else eng + dma
                total += step + cluster.reprogram_cycles
                if eng >= dma:
                    compute_bound_steps += 1
                else:
                    dma_bound_steps += 1
    useful = m * k * n
    return {
        "plan": plan,
        "total_cycles": total,
        "utilization": useful / (engine.n_macs * total),
        "runtime_us": total / (engine.freq_ghz * 1e3),
        "compute_bound_steps": compute_bound_steps,
        "dma_bound_steps": dma_bound_steps,
        "bound": "compute" if compute_bound_steps >= dma_bound_steps else "dma",
    }


@functools.lru_cache(maxsize=4096)
def _engine_cycles(engine: EngineConfig, tm: int, tk: int, tn: int) -> int:
    """Memoized per-tile engine cycles. A tiled GEMM sweep sees at most four
    distinct tile shapes (interior plus the three ragged edges), and the
    autotuner's candidate ranking replays the sweep for tens of candidate
    plans — without the memo the closed-form model dominates search time."""
    return simulate_gemm(engine, tm, tk, tn).total_cycles


def rank_plans(
    engine: EngineConfig,
    m: int,
    k: int,
    n: int,
    candidates: Iterable[Tuple[int, int, int]],
    *,
    elem_bytes: int = 2,
    top_k: int = 4,
    cluster: ClusterConfig = ClusterConfig(),
) -> List[Tuple[Tuple[int, int, int], int]]:
    """Rank candidate ``(tm, tk, tn)`` tiles by the analytic cluster model.

    This is the autotuner's **pruner** (`repro.tune.search`): instead of
    timing an exhaustive sweep on-device, every candidate is scored with
    :func:`tiled_gemm_cycles` — the same double-buffered compute/DMA-overlap
    model behind :func:`choose_tile` — and only the ``top_k`` cheapest (by
    modeled total cycles) go on to empirical measurement. Returns
    ``[(candidate, modeled_cycles), ...]`` cheapest first; duplicates are
    collapsed, order among equals is first-seen (deterministic).
    """
    scored: List[Tuple[Tuple[int, int, int], int]] = []
    seen = set()
    for tm, tk, tn in candidates:
        cand = (int(tm), int(tk), int(tn))
        if cand in seen:
            continue
        seen.add(cand)
        plan = TilingPlan(cand[0], cand[1], cand[2], elem_bytes)
        cycles = tiled_gemm_cycles(
            engine, m, k, n, cluster=cluster, plan=plan, elem_bytes=elem_bytes
        )["total_cycles"]
        scored.append((cand, cycles))
    scored.sort(key=lambda sc: sc[1])
    return scored[: max(1, top_k)]
