// Grouped int8 O-POPE GEMM for Hopper (sm_90a), K5:
// O[g] = epilogue((A_q[g] @ B_q[g]) * (sa[g] * sb[g]) (+ C[g])) for g in
// 0..G-1, one launch, one cast.
//
// Replaces the Pallas TPU kernel
// src/repro/quant/pallas_q8.py::opope_gemm_q8_grouped (bodies
// _q8_grouped_kernel, _q8_grouped_preload_kernel,
// _q8_grouped_epilogue_kernel), which carries the MoE expert FFNs under an
// int8 precision policy: the expert axis is the group axis. A_q [G,M,K] has
// scales per (group, row) [G,M,1], B_q [G,K,N] per (group, column)
// [G,1,N]; C is [G,M,N] or [G,N]; epilogue operands are scalar (1,1,1),
// row (G,1,N) or full (G,M,N).
//
// What bounds it on the card: every expert's int8 weights are read once per
// call. At a decode step (M = capacity = 1 row per expert) and at a prefill
// (M = 30-60) the product is far below the int8 tensor cores' ~590 op/byte
// ridge: deepseek-moe-16b's 3 expert GEMMs move 554 MB of weights a layer,
// so device-memory bandwidth bounds it.
//
// Two routes, chosen on the host from the operands alone
// (quant/opope_q8.py::_plan_grouped):
//
// * sm90 (A_q and B_q whose bases are 16-byte aligned and whose K and N are
//   multiples of 16, so every row and group stride is too, as a TMA tensor
//   map needs): one launch over a grid of (M tiles, N tiles, G) blocks,
//   each running K2's body (opope_q8_sm90.cuh: a producer warp's TMA ring
//   of [128 k x 128 n] weight boxes, each turned into int8 wgmma register
//   fragments by __byte_perm, A_q the K-major shared operand) on one tile of
//   its group. A_q and B_q are rank-3 tensor maps, dims (K, M, G) and
//   (N, K, G), boxes (128, MT, 1) and (128, 128, 1): the group is the third
//   box coordinate, so TMA zero-fills rows past M and the K tail inside each
//   group (a rank-2 map over [G*M, K] would read the next expert's rows at
//   M = 1). The 8-row tile runs at M <= 8 with a 4-stage ring and the
//   128-row tile above with a 3-stage ring, each as two blocks an SM: while
//   one block fills its ring or finishes its tile (the epilogue's loads and
//   transcendental ops, which no load overlaps), the other streams. G x N
//   tiles give 704-1024 blocks on deepseek's experts, several waves, so K
//   is never split.
// * tile (anything else): the first body, opope_q8_tile of
//   opope_q8_tile.cuh, one 64x64 tile of group blockIdx.z a block on
//   mma.sync m16n8k32.
//
// Both finish with opope_q8_tile.cuh's per-element writeback helpers, so
// both equal the plain version bit for bit wherever the epilogue chain holds
// no transcendental op.

#include "opope_q8_sm90.cuh"  // the sm90 body; includes opope_q8_tile.cuh and sm90.cuh

namespace {

// One resident block per SM is enough (minBlocks = 1), as for K2's tile
// kernel: the thread count alone held ptxas to 64 registers, and it spilled.
__global__ void __launch_bounds__(THREADS, 1) opope_q8_grouped_kernel(
    const int8_t* __restrict__ A, const float* __restrict__ SA,
    const int8_t* __restrict__ B, const float* __restrict__ SB, void* __restrict__ O,
    int M, int N, int K, const void* C, int c_kind, int c_dtype, int o_dtype,
    bool vec_a, bool vec_b, OpopeEpilogue ep) {
  const int64_t g = blockIdx.z;
  opope_q8_tile(A + g * M * K, SA + g * M, B + g * K * N, SB + g * N, O, M, N, K, C,
                c_kind, c_dtype, o_dtype, vec_a, vec_b, ep, g * M * N, g * N);
}

// The two tiles as two blocks an SM: 8 rows with a 4-stage ring (2 x 70
// KB of shared memory) and 128 rows with a 3-stage ring (2 x 97 KB).
using Q8DecodePair = Q8Sm90Config<8, 4>;
using Q8PrefillPair = Q8Sm90Config<128, 3>;

// Block (m_tile, n_tile, g): one output tile of group g, all of K.
template <class Cfg>
__global__ void __launch_bounds__(Q8_THREADS, 2) opope_q8_grouped_kernel_sm90(
    const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
    const float* __restrict__ SA, const float* __restrict__ SB, void* __restrict__ O, int M,
    int N, int K, const void* C, int c_kind, int c_dtype, int o_dtype, OpopeEpilogue ep) {
  q8_sm90_tile<Cfg>(&map_a, &map_b, SA, SB, O, M, N, K, blockIdx.z, blockIdx.x, blockIdx.y,
                    gridDim.x, 0, 1, C, c_kind, c_dtype, o_dtype, ep, nullptr, nullptr);
}

template <class Cfg>
int launch_sm90(const void* a, const void* sa, const void* b, const void* sb, void* o, int groups,
                int m, int n, int k, const void* c, int c_kind, int c_dtype, int o_dtype,
                const OpopeEpilogue* ep, cudaStream_t stream) {
  CUtensorMap map_a, map_b;
  static bool opted_in[64] = {};
  const int r = q8_sm90_prepare<Cfg>(opope_q8_grouped_kernel_sm90<Cfg>, opted_in, &map_a,
                                     &map_b, a, b, groups, m, n, k);
  if (r != 0) return r;
  // Tiles walk M fastest: the M tiles of one weight panel run together and
  // share it in L2.
  const dim3 grid((m + Cfg::MT - 1) / Cfg::MT, (n + Q8_BN - 1) / Q8_BN, groups);
  opope_q8_grouped_kernel_sm90<Cfg><<<grid, Q8_THREADS, Cfg::SMEM, stream>>>(
      map_a, map_b, static_cast<const float*>(sa), static_cast<const float*>(sb), o, m, n, k,
      c, c_kind, c_dtype, o_dtype, *ep);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry of the tile route: launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int opope_q8_grouped_launch(
    const void* a, const void* sa, const void* b, const void* sb, void* o,
    int groups, int m, int n, int k, const void* c, int c_kind, int c_dtype,
    int o_dtype, int vec_a, int vec_b, const OpopeEpilogue* ep, void* stream) {
  if (groups > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, groups);
  opope_q8_grouped_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const float*>(sa),
      static_cast<const int8_t*>(b), static_cast<const float*>(sb), o, m, n, k,
      c, c_kind, c_dtype, o_dtype, vec_a != 0, vec_b != 0, *ep);
  return static_cast<int>(cudaGetLastError());
}

// C entry of the sm90 route (A_q [groups, m, k] and B_q [groups, k, n]
// int8, bases 16-byte aligned, k and n multiples of 16, k > 0). `config` 0
// is the 8-row tile, 1 the 128-row tile, as for K2. Returns 0 when
// launched, a CUDA runtime error code, or 1000 + the CUresult code when a
// tensor map could not be encoded.
extern "C" int opope_q8_grouped_sm90_launch(
    const void* a, const void* sa, const void* b, const void* sb, void* o, int groups, int m,
    int n, int k, const void* c, int c_kind, int c_dtype, int o_dtype, const OpopeEpilogue* ep,
    int config, void* stream) {
  if (groups > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (config) {
    case 0:
      return launch_sm90<Q8DecodePair>(a, sa, b, sb, o, groups, m, n, k, c, c_kind, c_dtype,
                                       o_dtype, ep, s);
    case 1:
      return launch_sm90<Q8PrefillPair>(a, sa, b, sb, o, groups, m, n, k, c, c_kind, c_dtype,
                                        o_dtype, ep, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
