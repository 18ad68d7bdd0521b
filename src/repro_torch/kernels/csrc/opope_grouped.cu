// Grouped O-POPE GEMM for Hopper (sm_90a):
// O[g] = epilogue(A[g] @ B[g] (+ C[g])) for g in 0..G-1, one launch, one cast.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/opope_grouped.py::opope_gemm_grouped (bodies
// _grouped_kernel, _grouped_preload_kernel, _grouped_epilogue_kernel), which
// carries the MoE expert FFNs (models/moe.py::_expert_ffn): the expert axis
// is the group axis. Two routes, chosen on the host from the operands alone
// (kernels/opope_grouped.py::_plan):
//
// * sm90 (bf16 A and B whose row strides and bases TMA can describe): one
//   launch over a grid of (M tiles, N tiles, G) blocks, each running the
//   warp-specialised body of opope_sm90_gemm.cuh that K1 runs: a producer
//   warp keeps a ring of TMA stages full, a consumer warpgroup runs wgmma
//   m64n128k16 on each and releases it. A [G, M, K] and B [G, K, N] are
//   rank-3 tensor maps, dims (K, M, G) and (N, K, G), boxes (64, rows, 1)
//   and (64, 64, 1): the group is the third box coordinate, so TMA zero-fills
//   rows past M and the K tail inside each group, never reading the next
//   expert's rows (a rank-2 map over [G*M, K] would: a 64-row box at M = 1
//   fetches the next 63 experts' rows). B stays in its [K, N] layout as the
//   MN-major operand; no weight is re-laid out. The finish is K1's coalesced
//   writeback, offset by group: the output, C and full operands at g*M*N,
//   row operands and a [G, N] C at g*N, the scalar not at all; only rows
//   below M are written.
// * tile (fp32 inputs, on CUDA-core FMAs and never TF32; or bf16 operands
//   TMA cannot describe): block (x, y, g) runs the single-GEMM tile body of
//   opope_tile.cuh on group g's operands, found by strides, with C
//   preloaded into the fp32 accumulator and ragged M/N/K masked.
//
// What bounds it on the card: every group's weights are read once per call.
// In a decode step (M = capacity = 1 row per expert) the product is far
// below the H100's ~295 flop/byte ridge, and at a prefill (M = 30-60 rows
// per expert) it still is: deepseek's 3 expert GEMMs move 1.1 GB of weights
// a layer. The sm90 route answers with bytes in flight: at M <= 64 (config
// 0) two blocks share an SM, each with a 4-stage ring of 16 KB weight
// panels, 128 KB in flight an SM as in K1's 8-stage ring. G x N tiles give
// 704 (w_up, w_gate) or 1024 (w_down) blocks, more than the card holds at
// once, so K is never split; the blocks run in waves, and with two an SM
// one block's ring fill and finish (the fp32 tile through shared memory,
// the epilogue's loads, the stores) overlap the other's stream, where one
// 8-stage block an SM left them exposed every wave (measured slower, as was
// a persistent grid walking tiles on a static schedule). M > 64 takes
// config 1 (128 x 128 tiles, two consumer warpgroups, 5 stages, one block
// an SM), tiles walking M fastest so the M tiles of one weight panel run
// together and share it in L2.

#include "opope_sm90_gemm.cuh"  // the sm90 tile body; includes opope_tile.cuh

namespace {

template <typename Tin>
__global__ void __launch_bounds__(THREADS) opope_grouped_kernel(
    const Tin* __restrict__ A, const Tin* __restrict__ B, void* __restrict__ O,
    int M, int N, int K, const void* C, int c_kind, int c_dtype, int o_dtype,
    bool vec_a, bool vec_b, OpopeEpilogue ep) {
  const int64_t g = blockIdx.z;
  opope_tile<Tin>(A + g * M * K, B + g * K * N, O, M, N, K, C, c_kind, c_dtype,
                  o_dtype, vec_a, vec_b, ep, g * M * N, g * N);
}

// M <= 64: the 64 x 128 tile, a one-warp producer and a 4-stage ring, so
// two blocks share an SM (2 x 160 threads at <= 204 registers, 2 x 97 KB):
// while one block fills its ring or finishes its tile, the other streams.
using GroupedDecodeConfig = Sm90Config<64, 128, 4, 32>;

// Block (m_tile, n_tile, g): one output tile of group g, all of K.
template <class Cfg, int MIN_BLOCKS>
__global__ void __launch_bounds__(Cfg::THREADS, MIN_BLOCKS) opope_grouped_kernel_sm90(
    const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
    void* __restrict__ O, int M, int N, int K, const void* C, int c_kind, int c_dtype,
    int o_dtype, OpopeEpilogue ep) {
  sm90_gemm_tile<Cfg>(&map_a, &map_b, O, M, N, K, blockIdx.z, blockIdx.x, blockIdx.y,
                      gridDim.x, 0, 1, C, c_kind, c_dtype, o_dtype, ep, nullptr, nullptr);
}

template <class Cfg, int MIN_BLOCKS>
int launch_sm90(const void* a, const void* b, void* o, int groups, int m, int n, int k,
                const void* c, int c_kind, int c_dtype, int o_dtype, const OpopeEpilogue* ep,
                cudaStream_t stream) {
  CUtensorMap map_a, map_b;
  const int r = sm90_prepare<Cfg>(opope_grouped_kernel_sm90<Cfg, MIN_BLOCKS>, &map_a, &map_b, a, b,
                                  groups, m, n, k);
  if (r != 0) return r;
  const dim3 grid((m + Cfg::BM - 1) / Cfg::BM, (n + Cfg::BN - 1) / Cfg::BN, groups);
  opope_grouped_kernel_sm90<Cfg, MIN_BLOCKS><<<grid, Cfg::THREADS, Cfg::SMEM, stream>>>(
      map_a, map_b, o, m, n, k, c, c_kind, c_dtype, o_dtype, *ep);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry of the tile route: launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int opope_grouped_launch(
    const void* a, const void* b, void* o, int groups, int m, int n, int k,
    int in_dtype, const void* c, int c_kind, int c_dtype, int o_dtype, int vec_a,
    int vec_b, const OpopeEpilogue* ep, void* stream) {
  if (groups > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, groups);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == DT_BF16) {
    opope_grouped_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
        o, m, n, k, c, c_kind, c_dtype, o_dtype, vec_a != 0, vec_b != 0, *ep);
  } else if (in_dtype == DT_F32) {
    opope_grouped_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b),
        o, m, n, k, c, c_kind, c_dtype, o_dtype, vec_a != 0, vec_b != 0, *ep);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// C entry of the sm90 route (bf16 A [groups, m, k] and B [groups, k, n],
// row strides and bases 16-byte aligned, k > 0). `config` 0 is the 64-row
// tile (m <= 64), 1 the 128-row tile. Returns 0 when launched, a CUDA
// runtime error code, or 1000 + the CUresult code when a tensor map
// could not be encoded.
extern "C" int opope_grouped_sm90_launch(
    const void* a, const void* b, void* o, int groups, int m, int n, int k,
    const void* c, int c_kind, int c_dtype, int o_dtype, const OpopeEpilogue* ep,
    int config, void* stream) {
  if (groups > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (config) {
    case 0:
      return launch_sm90<GroupedDecodeConfig, 2>(a, b, o, groups, m, n, k, c, c_kind, c_dtype,
                                                 o_dtype, ep, s);
    case 1:
      return launch_sm90<PrefillConfig, 1>(a, b, o, groups, m, n, k, c, c_kind, c_dtype, o_dtype,
                                           ep, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
