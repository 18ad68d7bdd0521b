// O-POPE GEMM for Hopper (sm_90a): O = epilogue(A[M,K] @ B[K,N] (+ C)), one cast.
//
// Replaces the Pallas TPU kernel src/repro/kernels/opope_gemm.py::opope_gemm
// (bodies _gemm_kernel, _gemm_preload_kernel, _gemm_epilogue_kernel).
// One thread block owns one 64x64 output tile; the tile's dataflow (resident
// fp32 accumulator, C preload, double-buffered K loop, epilogue chain before
// the single cast, masked ragged edges) is `opope_tile` in opope_tile.cuh.
//
// What bounds it on the card: on the serving path's decode steps (M = a few
// slots) every weight byte is read once per step and the product is far
// below the H100's ~295 flop/byte ridge, so device-memory bandwidth bounds
// it; the prefill GEMMs (M = hundreds of rows) approach the tensor-core
// bound. This first version keeps the design simple and right: fixed
// 64x64x32 tiles, register-staged double buffering and masked ragged edges
// (no host-side pad copies). It does not fill 132 SMs at decode widths
// (N/64 blocks) and issues no TMA/wgmma; both are later work.

#include "opope_tile.cuh"

namespace {

template <typename Tin>
__global__ void __launch_bounds__(THREADS) opope_gemm_kernel(
    const Tin* __restrict__ A, const Tin* __restrict__ B, void* __restrict__ O,
    int M, int N, int K, const void* C, int c_kind, int c_dtype, int o_dtype,
    bool vec_a, bool vec_b, OpopeEpilogue ep) {
  opope_tile<Tin>(A, B, O, M, N, K, C, c_kind, c_dtype, o_dtype, vec_a, vec_b, ep, 0, 0);
}

}  // namespace

// C entry: launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int opope_gemm_launch(
    const void* a, const void* b, void* o, int m, int n, int k, int in_dtype,
    const void* c, int c_kind, int c_dtype, int o_dtype, int vec_a, int vec_b,
    const OpopeEpilogue* ep, void* stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == DT_BF16) {
    opope_gemm_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
        o, m, n, k, c, c_kind, c_dtype, o_dtype, vec_a != 0, vec_b != 0, *ep);
  } else if (in_dtype == DT_F32) {
    opope_gemm_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b),
        o, m, n, k, c, c_kind, c_dtype, o_dtype, vec_a != 0, vec_b != 0, *ep);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
