// O-POPE GEMM for Hopper (sm_90a): O = epilogue(A[M,K] @ B[K,N] (+ C)), one cast.
//
// Replaces the Pallas TPU kernel src/repro/kernels/opope_gemm.py::opope_gemm
// (bodies _gemm_kernel, _gemm_preload_kernel, _gemm_epilogue_kernel). Two
// routes, chosen on the host from the operands alone
// (kernels/opope_gemm.py::_plan):
//
// * sm90 (bf16 or fp16 A and B of one dtype whose row strides and bases TMA
//   can describe): a
//   warp-specialised kernel. One producer warp keeps a ring of shared-memory
//   stages full with TMA loads (128-byte swizzle, mbarrier completion); the
//   consumer warpgroups run wgmma m64n128k16 (bf16 or fp16 -> fp32) on each stage as
//   it lands and release it once the wgmma group reading it has retired. A is
//   read K-major; B stays in its natural [K, N] row-major layout and is the
//   MN-major ("transposed") wgmma operand, so no weight is re-laid out. TMA
//   zero-fills rows and columns past the matrix, so no caller pads.
// * tile (everything else: fp32 on CUDA-core FMAs and never TF32; the 8-bit
//   floats and every mixed pair of dtypes, each operand widened on load to
//   the pair's compute type and run on mma.sync; 2-byte operands TMA cannot
//   describe): `opope_tile` of opope_tile.cuh, one 64x64 tile a block,
//   shared with the grouped kernel.
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

template <typename Tc, bool SAME>
__global__ void __launch_bounds__(THREADS) opope_gemm_kernel(
    const void* __restrict__ A, int a_dtype, const void* __restrict__ B, int b_dtype,
    void* __restrict__ O, int M, int N, int K, const void* C, int c_kind, int c_dtype,
    int o_dtype, bool vec_a, bool vec_b, OpopeEpilogue ep) {
  opope_tile<Tc, SAME>(A, a_dtype, B, b_dtype, O, M, N, K, C, c_kind, c_dtype, o_dtype, vec_a,
                       vec_b, ep, 0, 0);
}

// ---------------------------------------------------------------- sm90 route

// Block (m_tile, n_tile, split): one output tile's K panels of one split.
template <class Cfg, bool F16>
__global__ void __launch_bounds__(Cfg::THREADS, 1) opope_gemm_kernel_sm90(
    const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
    void* __restrict__ O, int M, int N, int K, const void* C, int c_kind, int c_dtype,
    int o_dtype, OpopeEpilogue ep, float* __restrict__ ws, int* __restrict__ counters) {
  sm90_gemm_tile<Cfg, F16>(&map_a, &map_b, O, M, N, K, 0, blockIdx.x, blockIdx.y, gridDim.x,
                      blockIdx.z, gridDim.z, C, c_kind, c_dtype, o_dtype, ep, ws, counters);
}

template <class Cfg, bool F16>
int launch_sm90(const void* a, const void* b, void* o, int m, int n, int k, const void* c,
                int c_kind, int c_dtype, int o_dtype, const OpopeEpilogue* ep, int splits,
                float* ws, int* counters, cudaStream_t stream) {
  CUtensorMap map_a, map_b;
  const int r = sm90_prepare<Cfg, F16>(opope_gemm_kernel_sm90<Cfg, F16>, &map_a, &map_b, a, b, 1,
                                       m, n, k);
  if (r != 0) return r;
  const dim3 grid((m + Cfg::BM - 1) / Cfg::BM, (n + Cfg::BN - 1) / Cfg::BN, splits);
  opope_gemm_kernel_sm90<Cfg, F16><<<grid, Cfg::THREADS, Cfg::SMEM, stream>>>(
      map_a, map_b, o, m, n, k, c, c_kind, c_dtype, o_dtype, *ep, ws, counters);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry of the tile route: A and B of dtype codes a_dtype and b_dtype,
// run in compute type `compute` (DT_F32, DT_BF16 or DT_F16:
// kernels/opope_gemm.py::compute_dtype of the pair); operands already in
// it take the kernel without the dtype switch. Launches on `stream` and
// returns cudaGetLastError() (0 = launched).
extern "C" int opope_gemm_launch(
    const void* a, const void* b, void* o, int m, int n, int k, int a_dtype, int b_dtype,
    int compute, const void* c, int c_kind, int c_dtype, int o_dtype, int vec_a, int vec_b,
    const OpopeEpilogue* ep, void* stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool same = a_dtype == compute && b_dtype == compute;
#define OPOPE_GEMM_TILE(TC)                                                                    \
  if (same)                                                                                    \
    opope_gemm_kernel<TC, true><<<grid, THREADS, 0, s>>>(a, a_dtype, b, b_dtype, o, m, n, k, \
                                                         c, c_kind, c_dtype, o_dtype,        \
                                                         vec_a != 0, vec_b != 0, *ep);       \
  else                                                                                         \
    opope_gemm_kernel<TC, false><<<grid, THREADS, 0, s>>>(a, a_dtype, b, b_dtype, o, m, n, k,\
                                                          c, c_kind, c_dtype, o_dtype,       \
                                                          vec_a != 0, vec_b != 0, *ep)
  switch (compute) {
    case DT_F32: OPOPE_GEMM_TILE(float); break;
    case DT_BF16: OPOPE_GEMM_TILE(__nv_bfloat16); break;
    case DT_F16: OPOPE_GEMM_TILE(__half); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef OPOPE_GEMM_TILE
  return static_cast<int>(cudaGetLastError());
}

// C entry of the sm90 route (A [m, k] and B [k, n] both bf16, or both fp16
// with `f16` set; row strides and bases 16-byte aligned, k > 0). `config` 0
// is the decode tile, 1 the prefill tile; with `splits` > 1, `ws` holds
// splits * tiles * BM * BN floats and `counters` one zeroed int per output
// tile. Returns 0 when launched, a CUDA runtime error code, or 1000 + the
// driver's error code when a tensor map could not be encoded.
extern "C" int opope_gemm_sm90_launch(
    const void* a, const void* b, void* o, int m, int n, int k,
    const void* c, int c_kind, int c_dtype, int o_dtype, const OpopeEpilogue* ep,
    int config, int f16, int splits, float* ws, int* counters, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define OPOPE_GEMM_SM90(CFG, F16)                                                              \
  return launch_sm90<CFG, F16>(a, b, o, m, n, k, c, c_kind, c_dtype, o_dtype, ep, splits, ws, \
                               counters, s)
  if (config == 0 && f16) OPOPE_GEMM_SM90(DecodeConfig, true);
  if (config == 0) OPOPE_GEMM_SM90(DecodeConfig, false);
  if (config == 1 && f16) OPOPE_GEMM_SM90(PrefillConfig, true);
  if (config == 1) OPOPE_GEMM_SM90(PrefillConfig, false);
#undef OPOPE_GEMM_SM90
  return static_cast<int>(cudaErrorInvalidValue);
}
