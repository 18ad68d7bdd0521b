// O-POPE GEMM for Hopper (sm_90a): O = epilogue(A[M,K] @ B[K,N] (+ C)), one cast.
//
// Replaces the Pallas TPU kernel src/repro/kernels/opope_gemm.py::opope_gemm
// (bodies _gemm_kernel, _gemm_preload_kernel, _gemm_epilogue_kernel). Two
// routes, chosen on the host from the operands alone
// (kernels/opope_gemm.py::_plan):
//
// * sm90 (bf16 A and B whose row strides and bases TMA can describe): a
//   warp-specialised kernel. One producer warp keeps a ring of shared-memory
//   stages full with TMA loads (128-byte swizzle, mbarrier completion); the
//   consumer warpgroups run wgmma m64n128k16 (bf16 -> fp32) on each stage as
//   it lands and release it once the wgmma group reading it has retired. A is
//   read K-major; B stays in its natural [K, N] row-major layout and is the
//   MN-major ("transposed") wgmma operand, so no weight is re-laid out. TMA
//   zero-fills rows and columns past the matrix, so no caller pads.
// * tile (fp32 inputs, on CUDA-core FMAs and never TF32; or bf16 operands
//   TMA cannot describe): `opope_tile` of opope_tile.cuh, one 64x64 tile a
//   block, shared with the grouped kernel.
//
// What bounds the sm90 route on the card, and what the design does about it:
// * Decode (M <= 64; config 0: a 64 x 128 tile, one consumer warpgroup,
//   8 stages of 24 KB). A GEMM at M = 4 does ~4 operations a byte against
//   the H100's ridge of ~295, so the weight bytes bound it. Few output tiles
//   exist (N / 128), so K is split across blocks until the grid fills the
//   132 SMs in one wave (the planner's `splits`, capped where the last
//   block's reduction would read more than a split loads), and each SM
//   keeps up to 128 KB of B in flight.
// * Prefill (M > 64; config 1: a 128 x 128 tile, two consumer warpgroups
//   with registers moved to them by setmaxnreg, 5 stages of 32 KB). At
//   M = 512 the GEMMs reach the tensor-core bound; wgmma from swizzled
//   shared memory is the only path to its rate. Tiles walk M fastest, so
//   blocks that run together share one panel of B in L2.
// * Split-K stays deterministic and one launch: each block writes its fp32
//   partial to a workspace the wrapper allocates; a counter per output tile
//   finds the last block to finish, which sums the partials in split order
//   0..S-1, adds C, runs the epilogue chain and the single cast, and resets
//   the counter for the next call. This is the K-split partial accumulation
//   the reference names as a use of its C preload.
//
// The sm90 block body, its finish and its tensor maps are
// opope_sm90_gemm.cuh's, shared with the grouped kernel (K4); K1 runs it
// as one group.

#include "opope_sm90_gemm.cuh"  // the sm90 tile body; includes opope_tile.cuh

namespace {

template <typename Tin>
__global__ void __launch_bounds__(THREADS) opope_gemm_kernel(
    const Tin* __restrict__ A, const Tin* __restrict__ B, void* __restrict__ O,
    int M, int N, int K, const void* C, int c_kind, int c_dtype, int o_dtype,
    bool vec_a, bool vec_b, OpopeEpilogue ep) {
  opope_tile<Tin>(A, B, O, M, N, K, C, c_kind, c_dtype, o_dtype, vec_a, vec_b, ep, 0, 0);
}

// ---------------------------------------------------------------- sm90 route

// Block (m_tile, n_tile, split): one output tile's K panels of one split.
template <class Cfg>
__global__ void __launch_bounds__(Cfg::THREADS, 1) opope_gemm_kernel_sm90(
    const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
    void* __restrict__ O, int M, int N, int K, const void* C, int c_kind, int c_dtype,
    int o_dtype, OpopeEpilogue ep, float* __restrict__ ws, int* __restrict__ counters) {
  sm90_gemm_tile<Cfg>(&map_a, &map_b, O, M, N, K, 0, blockIdx.x, blockIdx.y, gridDim.x,
                      blockIdx.z, gridDim.z, C, c_kind, c_dtype, o_dtype, ep, ws, counters);
}

template <class Cfg>
int launch_sm90(const void* a, const void* b, void* o, int m, int n, int k, const void* c,
                int c_kind, int c_dtype, int o_dtype, const OpopeEpilogue* ep, int splits,
                float* ws, int* counters, cudaStream_t stream) {
  CUtensorMap map_a, map_b;
  const int r = sm90_prepare<Cfg>(opope_gemm_kernel_sm90<Cfg>, &map_a, &map_b, a, b, 1, m, n, k);
  if (r != 0) return r;
  const dim3 grid((m + Cfg::BM - 1) / Cfg::BM, (n + Cfg::BN - 1) / Cfg::BN, splits);
  opope_gemm_kernel_sm90<Cfg><<<grid, Cfg::THREADS, Cfg::SMEM, stream>>>(
      map_a, map_b, o, m, n, k, c, c_kind, c_dtype, o_dtype, *ep, ws, counters);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry of the tile route: launches on `stream` and returns
// cudaGetLastError() (0 = launched).
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

// C entry of the sm90 route (bf16 A [m, k] and B [k, n], row strides and
// bases 16-byte aligned, k > 0). `config` 0 is the decode tile, 1 the
// prefill tile; with `splits` > 1, `ws` holds splits * tiles * BM * BN
// floats and `counters` one zeroed int per output tile. Returns 0 when
// launched, a CUDA runtime error code, or 1000 + the driver's error code
// when a tensor map could not be encoded.
extern "C" int opope_gemm_sm90_launch(
    const void* a, const void* b, void* o, int m, int n, int k,
    const void* c, int c_kind, int c_dtype, int o_dtype, const OpopeEpilogue* ep,
    int config, int splits, float* ws, int* counters, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (config == 0)
    return launch_sm90<DecodeConfig>(a, b, o, m, n, k, c, c_kind, c_dtype, o_dtype, ep, splits,
                                     ws, counters, s);
  if (config == 1)
    return launch_sm90<PrefillConfig>(a, b, o, m, n, k, c, c_kind, c_dtype, o_dtype, ep,
                                      splits, ws, counters, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
