// int8 O-POPE GEMMs for Hopper (sm_90a), two entry points over the tile body
// of opope_q8_tile.cuh:
//
// K2  O = epilogue((A_q @ B_q) * (sa * sb) (+ C)), one cast.
//     Replaces the Pallas TPU kernel src/repro/quant/pallas_q8.py::opope_gemm_q8
//     (bodies _q8_kernel, _q8_preload_kernel, _q8_epilogue_kernel).
//     A_q int8 [M,K] with row scales sa fp32 [M,1]; B_q int8 [K,N] with
//     column scales sb fp32 [1,N]; C a full [M,N] tile or an [N] row.
// K5  the same per group g: O[g] = epilogue((A_q[g] @ B_q[g]) * (sa[g] * sb[g])
//     (+ C[g])), all groups in one launch.
//     Replaces src/repro/quant/pallas_q8.py::opope_gemm_q8_grouped (bodies
//     _q8_grouped_kernel, _q8_grouped_preload_kernel,
//     _q8_grouped_epilogue_kernel). Scales are per (group, row) [G,M,1] and
//     per (group, column) [G,1,N]; C is [G,M,N] or [G,N].
//
// One thread block owns one 64x64 output tile (K5: of one group, the group
// being blockIdx.z, its operands found by strides). The TPU grid's
// sequential k axis becomes the in-block K loop of opope_q8_tile.
//
// What bounds them on the card: on the serving path's decode steps (M = a
// few slots for K2, M = 1 row per expert for K5) each weight byte is read
// once per call and the product is far below the ridge of the H100's int8
// tensor cores (1979 TOP/s over 3.35 TB/s, ~590 op/byte), so device-memory
// bandwidth bounds them; int8 weights halve the bytes of the bf16 kernels.
// This first version is simple and right: fixed 64x64x64 tiles, register-
// staged double buffering, mma.sync; it issues no TMA/wgmma and has no
// decode-width tile (M = 1 uses 1 of the tile's 64 rows); both are later work.

#include "opope_q8_tile.cuh"

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

__global__ void __launch_bounds__(THREADS, 1) opope_q8_grouped_kernel(
    const int8_t* __restrict__ A, const float* __restrict__ SA,
    const int8_t* __restrict__ B, const float* __restrict__ SB, void* __restrict__ O,
    int M, int N, int K, const void* C, int c_kind, int c_dtype, int o_dtype,
    bool vec_a, bool vec_b, OpopeEpilogue ep) {
  const int64_t g = blockIdx.z;
  opope_q8_tile(A + g * M * K, SA + g * M, B + g * K * N, SB + g * N, O, M, N, K, C,
                c_kind, c_dtype, o_dtype, vec_a, vec_b, ep, g * M * N, g * N);
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
