// int8 O-POPE GEMM for Hopper (sm_90a), K2:
// O = epilogue((A_q @ B_q) * (sa * sb) (+ C)), one cast.
//
// Replaces the Pallas TPU kernel src/repro/quant/pallas_q8.py::opope_gemm_q8
// (bodies _q8_kernel, _q8_preload_kernel, _q8_epilogue_kernel). A_q int8
// [M,K] with row scales sa fp32 [M,1]; B_q int8 [K,N] with column scales sb
// fp32 [1,N]; C a full [M,N] tile or an [N] row. Its grouped twin K5 lives
// in opope_q8_grouped.cu and runs the same two bodies.
//
// What bounds it on the card: on the serving path's decode steps (M = a
// few slots) each weight byte is read once per call and the product is far
// below the ridge of the H100's int8 tensor cores (1979 TOP/s over 3.35
// TB/s, ~590 op/byte), so device-memory bandwidth bounds it; int8 weights
// halve the bytes of the bf16 kernels. At a 512-row prefill its operations
// bound it instead.
//
// Two routes, chosen on the host from the operands alone
// (quant/opope_q8.py::_plan):
//
// * sm90 (A_q and B_q whose bases and row strides, K and N bytes, are
//   multiples of 16, as a TMA tensor map needs): opope_q8_sm90.cuh's body
//   (a producer warp's TMA ring, the [K, N] weight turned into int8 wgmma
//   register fragments by __byte_perm, A_q the K-major shared operand), run
//   as one group. Where the output tiles do not fill the 132 SMs, K is
//   split across blocks in one launch, as K1 does: each block writes its
//   int32 partial, a counter per tile finds the last block, which sums
//   them and finishes the tile. 8 stages of 16 KB of weight at decode keep
//   up to 128 KB in flight on each SM, against device memory's latency.
// * tile (anything else: unaligned bases, K or N not a multiple of 16):
//   the first body, opope_q8_tile of opope_q8_tile.cuh, one 64x64 tile a
//   block on mma.sync m16n8k32.

#include "opope_q8_sm90.cuh"  // the sm90 body; includes opope_q8_tile.cuh and sm90.cuh

namespace {

// One resident block per SM is enough (minBlocks = 1): with the thread count
// alone, ptxas held these kernels to 64 registers and spilled 176-196 bytes;
// with the hint they use 106 registers without spills (PERF.md).
__global__ void __launch_bounds__(THREADS, 1) opope_q8_gemm_kernel(
    const int8_t* __restrict__ A, const float* __restrict__ SA,
    const int8_t* __restrict__ B, const float* __restrict__ SB, void* __restrict__ O,
    int M, int N, int K, const void* C, int c_kind, int c_dtype, int o_dtype,
    bool vec_a, bool vec_b, OpopeEpilogue ep) {
  opope_q8_tile(A, SA, B, SB, O, M, N, K, C, c_kind, c_dtype, o_dtype, vec_a, vec_b, ep, 0, 0);
}

// Block (m_tile, n_tile, split): one output tile, one split of K.
template <class Cfg>
__global__ void __launch_bounds__(Q8_THREADS, 1) opope_q8_gemm_kernel_sm90(
    const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
    const float* __restrict__ SA, const float* __restrict__ SB, void* __restrict__ O, int M,
    int N, int K, const void* C, int c_kind, int c_dtype, int o_dtype, OpopeEpilogue ep,
    int* __restrict__ ws, int* __restrict__ counters) {
  q8_sm90_tile<Cfg>(&map_a, &map_b, SA, SB, O, M, N, K, 0, blockIdx.x, blockIdx.y, gridDim.x,
                    blockIdx.z, gridDim.z, C, c_kind, c_dtype, o_dtype, ep, ws, counters);
}

template <class Cfg>
int launch_q8_sm90(const void* a, const void* sa, const void* b, const void* sb, void* o, int m,
                   int n, int k, const void* c, int c_kind, int c_dtype, int o_dtype,
                   const OpopeEpilogue* ep, int splits, int* ws, int* counters,
                   cudaStream_t stream) {
  CUtensorMap map_a, map_b;
  static bool opted_in[64] = {};
  const int r = q8_sm90_prepare<Cfg>(opope_q8_gemm_kernel_sm90<Cfg>, opted_in, &map_a, &map_b, a,
                                     b, 1, m, n, k);
  if (r != 0) return r;
  // Tiles walk M fastest: blocks that run together share one weight panel in L2.
  const dim3 grid((m + Cfg::MT - 1) / Cfg::MT, (n + Q8_BN - 1) / Q8_BN, splits);
  opope_q8_gemm_kernel_sm90<Cfg><<<grid, Q8_THREADS, Cfg::SMEM, stream>>>(
      map_a, map_b, static_cast<const float*>(sa), static_cast<const float*>(sb), o, m, n, k,
      c, c_kind, c_dtype, o_dtype, *ep, ws, counters);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entries: launch on `stream` and return cudaGetLastError() (0 = launched).
extern "C" int opope_q8_gemm_launch(
    const void* a, const void* sa, const void* b, const void* sb, void* o,
    int m, int n, int k, const void* c, int c_kind, int c_dtype, int o_dtype,
    int vec_a, int vec_b, const OpopeEpilogue* ep, void* stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  opope_q8_gemm_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const float*>(sa),
      static_cast<const int8_t*>(b), static_cast<const float*>(sb), o, m, n, k,
      c, c_kind, c_dtype, o_dtype, vec_a != 0, vec_b != 0, *ep);
  return static_cast<int>(cudaGetLastError());
}

// K2's sm90 route (A_q [m, k] and B_q [k, n] int8, bases 16-byte aligned,
// k and n multiples of 16, k > 0). `config` 0, 1 is the MT = 8, 128
// tile; with `splits` > 1, `ws` holds splits * tiles * MT * 128 int32 and
// `counters` one zeroed int per output tile. Returns 0 when launched, a
// CUDA runtime error code, or 1000 + the CUresult code when a tensor
// map could not be encoded.
extern "C" int opope_q8_gemm_sm90_launch(
    const void* a, const void* sa, const void* b, const void* sb, void* o,
    int m, int n, int k, const void* c, int c_kind, int c_dtype, int o_dtype,
    const OpopeEpilogue* ep, int config, int splits, int* ws, int* counters, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (config == 0)
    return launch_q8_sm90<Q8Decode>(a, sa, b, sb, o, m, n, k, c, c_kind, c_dtype, o_dtype, ep,
                                    splits, ws, counters, s);
  if (config == 1)
    return launch_q8_sm90<Q8Prefill>(a, sa, b, sb, o, m, n, k, c, c_kind, c_dtype, o_dtype, ep,
                                     splits, ws, counters, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
