"""Cycle-accurate model of the O-POPE engine.

A copy of :mod:`repro.core.engine` (pure Python, no framework): the port
keeps its own so that it imports nothing of the JAX package, and its tests
hold it equal to the reference's. It models the paper's engine, not the
H100, so the port's tuner does not rank with it (it times every plan).

This module reproduces the paper's §III-C runtime analysis. Two models are
provided and cross-validated against each other in the test suite:

* :func:`simulate_gemm` — an exact closed-form tile-sequence model derived from
  the dataflow in §II (Fig. 1c/1d, Fig. 3). Fast; used everywhere.
* :func:`simulate_gemm_cycle_accurate` — a literal per-cycle streamer/engine
  state machine implementing the same published schedule. Slow; used on small
  GEMMs to validate the closed form (hypothesis property tests).

The dataflow being modelled
---------------------------

An O-POPE instance is a ``p x p`` mesh of PEs. Each PE contains one FMA whose
pipeline has ``L`` stages (paper default L=4) plus ``L`` accumulator registers.
The ``L`` pipeline slots carry ``L`` *independent* accumulation chains, i.e. a
``rm x rn`` output sub-tile per PE with ``rm*rn == L`` (2x2 for L=4), so the
engine's output-stationary C tile is ``(rm*p) x (rn*p)`` (``2p x 2p``).

Per ``L``-cycle group the engine consumes one A vector and one B vector of
``r*p`` elements each (each element reused ``r`` times) and performs one rank-1
update of the full C tile: ``L*p^2`` MACs in ``L`` cycles = ``p^2`` MACs/cycle.
A C tile therefore takes ``L*K`` cycles of compute for ``K`` rank-1 updates.

The streamer moves ``2p`` elements/cycle total. While computing, A+B consume
one ``2p``-element vector every 2 cycles (50% of bandwidth, §II-C); the other
50% (``p`` elems/cycle) moves the output-stationary tile: storing the previous
tile's results and preloading the next tile's initial C values. Hiding the
``2 * (2p)^2`` swap elements under ``L*K`` compute cycles requires
``L*K >= 8p^2/p = 8p``, i.e. ``K >= 2p`` — the paper's utilization condition.

Stalls occur only (a) during the first tile's accumulator preload (C share of
bandwidth = ``p`` elems/cycle → ``4p`` cycles for a full ``4p^2``-element tile),
(b) during the last tile's writeback (dedicated ``2p`` elems/cycle → ``2p``
cycles), and (c) for controller programming (``cfg_cycles``). With the default
``cfg_cycles=15`` the model lands exactly on the paper's headline number:
``64x256x128`` on a 4x4 mesh → ``131072 / (15+16+131072+8) = 99.970%``.

Partial tiles (M or N not a multiple of ``r*p``) still pay the full ``L*K``
compute cycles — the pipeline must rotate through all ``L`` accumulator slots —
which is precisely the paper's tile-quantization utilization loss (§III-C).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

__all__ = [
    "EngineConfig",
    "CycleReport",
    "simulate_gemm",
    "simulate_gemm_cycle_accurate",
    "tile_grid",
    "OPOPE_16x16_FP16",
]


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Design-time parameters of an O-POPE instance (paper §II)."""

    p: int = 16  # mesh side: p x p PEs (power of two in the paper)
    pipe_depth: int = 4  # L: FPU pipeline stages == accumulator registers / PE
    elem_bits: int = 16  # q: operand width (FP16 default)
    acc_bits: int = 16  # accumulator width (q; 2q for widening MACs)
    freq_ghz: float = 1.0  # paper: 1 GHz @ 0.72 V, GF 12LP+
    cfg_cycles: int = 15  # controller/streamer programming overhead per call
    name: str = "opope"

    def __post_init__(self) -> None:
        if self.p < 1:
            raise ValueError(f"mesh side must be >= 1, got {self.p}")
        r = math.isqrt(self.pipe_depth)
        if r * r != self.pipe_depth:
            raise ValueError(
                f"pipe_depth must be a perfect square (rm*rn sub-tile), got "
                f"{self.pipe_depth}"
            )

    # --- derived quantities -------------------------------------------------
    @property
    def r(self) -> int:
        """Per-PE sub-tile side (2 for L=4)."""
        return math.isqrt(self.pipe_depth)

    @property
    def tile_m(self) -> int:
        """Output-stationary C tile rows (2p for L=4)."""
        return self.r * self.p

    @property
    def tile_n(self) -> int:
        return self.r * self.p

    @property
    def n_macs(self) -> int:
        """MAC units == p^2 (one FPU per PE)."""
        return self.p * self.p

    @property
    def streamer_elems_per_cycle(self) -> int:
        """Total streamer bandwidth in elements/cycle (2p x q bits, §II-C)."""
        return 2 * self.p

    @property
    def c_elems_per_cycle_overlapped(self) -> int:
        """C-tile movement bandwidth while A/B streams run (50%, §II-C)."""
        return self.p

    @property
    def peak_gflops(self) -> float:
        """Peak GFLOPS at the configured frequency (2 flops per MAC)."""
        return 2.0 * self.n_macs * self.freq_ghz

    @property
    def input_buffer_bits(self) -> int:
        """Two (2p x q)-bit input vector buffers (§II-B): sqrt(#PE) scaling."""
        return 2 * (2 * self.p * self.elem_bits)

    @property
    def accumulator_bits(self) -> int:
        """L accumulator registers per PE (§II-A)."""
        return self.n_macs * self.pipe_depth * self.acc_bits


@dataclasses.dataclass(frozen=True)
class CycleReport:
    """Result of a GEMM simulation on one engine configuration."""

    m: int
    k: int
    n: int
    total_cycles: int
    compute_cycles: int  # sum over tiles of L*K (includes quantization waste)
    stall_cycles: int  # C-swap stalls not hidden under compute
    prologue_cycles: int  # cfg + first-tile accumulator preload
    epilogue_cycles: int  # last-tile writeback
    useful_macs: int  # M*K*N
    n_tiles: int
    engine: EngineConfig

    @property
    def ideal_cycles(self) -> float:
        return self.useful_macs / self.engine.n_macs

    @property
    def utilization(self) -> float:
        """FPU utilization: useful MAC-cycles / available FPU-cycles."""
        return self.useful_macs / (self.engine.n_macs * self.total_cycles)

    @property
    def runtime_us(self) -> float:
        return self.total_cycles / (self.engine.freq_ghz * 1e3)

    @property
    def achieved_gflops(self) -> float:
        return 2.0 * self.useful_macs / (self.total_cycles / self.engine.freq_ghz)

    def breakdown(self) -> Dict[str, int]:
        return {
            "total": self.total_cycles,
            "compute": self.compute_cycles,
            "stall": self.stall_cycles,
            "prologue": self.prologue_cycles,
            "epilogue": self.epilogue_cycles,
        }


def tile_grid(cfg: EngineConfig, m: int, n: int) -> List[Tuple[int, int]]:
    """Row-major sequence of (tile_rows, tile_cols) C tiles for an M x N output.

    Partial edge tiles carry their true element counts (for C movement) even
    though they cost a full ``L*K`` compute cycles.
    """
    tiles: List[Tuple[int, int]] = []
    for i0 in range(0, m, cfg.tile_m):
        tm = min(cfg.tile_m, m - i0)
        for j0 in range(0, n, cfg.tile_n):
            tn = min(cfg.tile_n, n - j0)
            tiles.append((tm, tn))
    return tiles


def simulate_gemm(cfg: EngineConfig, m: int, k: int, n: int) -> CycleReport:
    """Closed-form cycle count for ``C[m,n] (+)= A[m,k] @ B[k,n]`` on O-POPE.

    Exact under the published schedule (see module docstring): per-tile compute
    of ``L*K`` cycles; the streamer stores tile ``j-1`` and preloads tile
    ``j+1`` during tile ``j``'s compute window at ``p`` elements/cycle, adding
    a stall whenever that movement does not fit.
    """
    if min(m, k, n) < 1:
        raise ValueError(f"GEMM dims must be positive, got {(m, k, n)}")
    tiles = tile_grid(cfg, m, n)
    n_tiles = len(tiles)
    L = cfg.pipe_depth
    per_tile_compute = L * k
    c_bw = cfg.c_elems_per_cycle_overlapped

    prologue = cfg.cfg_cycles + math.ceil(tiles[0][0] * tiles[0][1] / c_bw)
    compute = 0
    stall = 0
    for j in range(n_tiles):
        # C movement overlapped with tile j's compute window:
        work_elems = 0
        if j >= 1:
            work_elems += tiles[j - 1][0] * tiles[j - 1][1]  # store previous
        if j + 1 < n_tiles:
            work_elems += tiles[j + 1][0] * tiles[j + 1][1]  # preload next
        move_cycles = math.ceil(work_elems / c_bw)
        compute += per_tile_compute
        stall += max(0, move_cycles - per_tile_compute)
    # Last tile writeback at the full dedicated C bandwidth (no A/B traffic).
    epilogue = math.ceil(
        tiles[-1][0] * tiles[-1][1] / cfg.streamer_elems_per_cycle
    )

    total = prologue + compute + stall + epilogue
    return CycleReport(
        m=m,
        k=k,
        n=n,
        total_cycles=total,
        compute_cycles=compute,
        stall_cycles=stall,
        prologue_cycles=prologue,
        epilogue_cycles=epilogue,
        useful_macs=m * k * n,
        n_tiles=n_tiles,
        engine=cfg,
    )


def simulate_gemm_cycle_accurate(
    cfg: EngineConfig, m: int, k: int, n: int
) -> CycleReport:
    """Literal per-cycle streamer/engine state machine (validation model).

    Implements the same published schedule as :func:`simulate_gemm` but by
    stepping individual cycles and streamer vector slots:

    * the streamer issues one ``2p``-element vector per cycle;
    * while a tile computes, every L-cycle group reserves 2 slots for the A and
      B vectors of the next rank-1 update; remaining slots go to C movement
      (store of the previous tile, then preload of the next tile);
    * a tile may begin computing only after its initial C values are fully
      preloaded into the accumulator registers (tile 0) or after the previous
      tile's compute finished (accumulator swap is a single-cycle couple/
      decouple, Fig. 2);
    * if the next tile's preload has not finished when the accumulators swap,
      the engine stalls until it has.

    O(total_cycles) in Python — use for small GEMMs only.
    """
    tiles = tile_grid(cfg, m, n)
    n_tiles = len(tiles)
    L = cfg.pipe_depth
    c_bw = cfg.c_elems_per_cycle_overlapped  # p elems/cycle while computing

    t = cfg.cfg_cycles
    # --- first tile preload: interleaved A/B + 2xC vector groups -> C moves
    # at p elems/cycle (2 of 4 slots per L-cycle group, Fig. 3).
    first_elems = tiles[0][0] * tiles[0][1]
    t += math.ceil(first_elems / c_bw)

    store_backlog = 0  # elements of the *previous* tile awaiting store
    preload_done_elems = 0  # elements of the *next* tile already preloaded
    stall = 0
    compute = 0
    for j in range(n_tiles):
        next_elems = tiles[j + 1][0] * tiles[j + 1][1] if j + 1 < n_tiles else 0
        # Compute window: L*k cycles; each cycle the streamer moves up to
        # c_bw C-elements (store backlog first, then preload of tile j+1 —
        # both share the accumulator registers, so stores must drain first).
        for _ in range(L * k):
            t += 1
            compute += 1
            budget = c_bw
            s = min(store_backlog, budget)
            store_backlog -= s
            budget -= s
            preload_done_elems = min(next_elems, preload_done_elems + budget)
        # Accumulator swap (Fig. 2): before tile j's results can enter the
        # accumulator registers, tile j-1's results must be fully drained and
        # tile j+1's initial values fully preloaded. Stall otherwise.
        while store_backlog > 0 or preload_done_elems < next_elems:
            t += 1
            stall += 1
            budget = c_bw
            s = min(store_backlog, budget)
            store_backlog -= s
            budget -= s
            preload_done_elems = min(next_elems, preload_done_elems + budget)
        store_backlog = tiles[j][0] * tiles[j][1]
        preload_done_elems = 0
    # Epilogue: drain the last tile at full streamer bandwidth.
    epi = math.ceil(store_backlog / cfg.streamer_elems_per_cycle)
    t += epi

    return CycleReport(
        m=m,
        k=k,
        n=n,
        total_cycles=t,
        compute_cycles=compute,
        stall_cycles=stall,
        prologue_cycles=cfg.cfg_cycles + math.ceil(first_elems / c_bw),
        epilogue_cycles=epi,
        useful_macs=m * k * n,
        n_tiles=n_tiles,
        engine=cfg,
    )


# The configuration evaluated head-to-head in the paper's Table II.
OPOPE_16x16_FP16 = EngineConfig(p=16, pipe_depth=4, elem_bits=16, name="o-pope")
