// Grouped O-POPE GEMM for Hopper (sm_90a):
// O[g] = epilogue(A[g] @ B[g] (+ C[g])) for g in 0..G-1, one launch, one cast.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/opope_grouped.py::opope_gemm_grouped (bodies
// _grouped_kernel, _grouped_preload_kernel, _grouped_epilogue_kernel), which
// carries the MoE expert FFNs (models/moe.py::_expert_ffn): the expert axis
// is the group axis.
//
// Design: the TPU grid (G, m, n, k) becomes one launch over a grid of
// (N/64, M/64, G) blocks. Block (x, y, g) finds group g's operands by
// strides (A M*K, B K*N, output and full operands M*N, rows N, the scalar
// none) and runs the single-GEMM tile body of opope_tile.cuh on them: fp32
// accumulator in registers across the in-block K loop, C preloaded as a full
// [G,M,N] tile or a [G,N] row, the epilogue chain per group before the
// single cast, ragged M/N/K masked in the kernel (no pad copies).
//
// What bounds it on the card: every group's weights are read once per call.
// In a decode step (M = capacity = 1 row per expert) the product is far
// below the H100's ~295 flop/byte ridge, so device-memory bandwidth bounds
// it; at prefill (M = 30-60 rows per expert) it is still bound by bytes.
// The G axis gives the card G times more blocks than one expert's GEMM
// (1408 blocks for 64 experts x N = 1408), so decode fills the 132 SMs that
// K1 leaves half empty; a decode-width tile (M = 1 wastes 63 of 64 rows of
// each mma), wgmma and TMA are later work.

#include "opope_tile.cuh"

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

}  // namespace

// C entry: launches on `stream` and returns cudaGetLastError() (0 = launched).
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
