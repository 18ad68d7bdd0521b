// The bf16 / fp16 GEMM body of the sm90 routes of K1 (opope_gemm.cu, one GEMM,
// optionally split along K) and K4 (opope_grouped.cu, G GEMMs of one shape,
// the group the third coordinate of every TMA box): one output tile a block.
//
// One producer warp keeps a ring of shared-memory stages full with TMA loads
// (128-byte swizzle, mbarrier completion); the consumer warpgroups run wgmma
// m64n128k16 (bf16 -> fp32) on each stage as it lands and release it once
// the wgmma group reading it has retired (F16 selects the fp16 instruction
// and tensor maps; both operands are 2-byte, so tiles, swizzle and
// descriptors are the same). A is read K-major; B stays in its
// natural [K, N] row-major layout and is the MN-major ("transposed") wgmma
// operand, so no weight is re-laid out. Both operands are rank-3 tensor maps
// (columns, rows, group): TMA zero-fills rows and columns past a group's
// matrix, inside that group, so no caller pads and a box never reads the
// next group's rows.
//
// The finish stages the fp32 tile in the drained ring and walks it 8
// consecutive columns a thread, four such groups in flight, so the loads of
// C, the epilogue operands and split-K partials coalesce and overlap. C is
// added after the K sum (the tile route preloads it); both are one fp32
// accumulation of the same terms in another order.
#pragma once

#include "opope_tile.cuh"
#include "sm90.cuh"  // mbarriers, TMA, wgmma descriptors and instructions, the map encoder

namespace {

constexpr int SM90_BK = 64;  // one 128-byte swizzle row of bf16 or fp16

template <int BM_, int BN_, int STAGES_, int PRODUCERS_ = 128>
struct Sm90Config {
  static constexpr int BM = BM_, BN = BN_, STAGES = STAGES_;
  static constexpr int WG = BM / 64;              // consumer warpgroups, 64 rows each
  static constexpr int CONSUMERS = 128 * WG;
  // + the producer: a warpgroup (setmaxnreg moves registers per warpgroup)
  // or, with one consumer warpgroup, a warp.
  static constexpr int THREADS = CONSUMERS + PRODUCERS_;
  static constexpr int A_BYTES = BM * SM90_BK * 2;
  static constexpr int B_BOX_BYTES = 64 * SM90_BK * 2;  // one 64-column box of B
  static constexpr int STAGE_BYTES = A_BYTES + BN / 64 * B_BOX_BYTES;
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024;  // + slack to align to 1024
  static constexpr int NREG = BN / 2;  // fp32 accumulators per consumer thread
  static_assert(BN == 128, "the wgmma below is m64n128k16");
  static_assert(BM * (BN + 8) * 4 <= STAGES * STAGE_BYTES, "the fp32 tile is staged in the ring");
};
using DecodeConfig = Sm90Config<64, 128, 8>;    // K1's config 0
using PrefillConfig = Sm90Config<128, 128, 5>;  // config 1 of K1 and K4

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// load_as_float over G = 8 consecutive elements, the dtype switch taken
// once; 8 bf16 or fp16 starting on a 16-byte boundary come in one 16-byte
// load.
template <typename T, int G>
__device__ __forceinline__ void load_half_group(const void* p, int64_t i, float (&o)[G]) {
  static_assert(G == 8, "one 16-byte vector of a 2-byte type");
  const T* q = static_cast<const T*>(p) + i;
  if (aligned16(q)) {
    const uint4 v = *reinterpret_cast<const uint4*>(q);
    const T* h = reinterpret_cast<const T*>(&v);
#pragma unroll
    for (int u = 0; u < G; ++u) o[u] = to_float(h[u]);
  } else {
#pragma unroll
    for (int u = 0; u < G; ++u) o[u] = to_float(q[u]);
  }
}

template <int G>
__device__ __forceinline__ void load_group(const void* p, int dtype, int64_t i, float (&o)[G]) {
  switch (dtype) {
    case DT_BF16: load_half_group<__nv_bfloat16>(p, i, o); break;
    case DT_F16: load_half_group<__half>(p, i, o); break;
    case DT_F32:
#pragma unroll
      for (int u = 0; u < G; ++u) o[u] = static_cast<const float*>(p)[i + u];
      break;
    default:  // the 8-bit floats
#pragma unroll
      for (int u = 0; u < G; ++u) o[u] = load_as_float(p, dtype, i + u);
      break;
  }
}

// The single cast of G = 8 consecutive outputs; 8 bf16 or fp16 starting on
// a 16-byte boundary go out in one 16-byte store.
template <typename T, int G>
__device__ __forceinline__ void store_half_group(void* O, int64_t i, const float (&x)[G]) {
  T* q = static_cast<T*>(O) + i;
  if (aligned16(q)) {
    uint4 v;
    T* h = reinterpret_cast<T*>(&v);
#pragma unroll
    for (int u = 0; u < G; ++u) h[u] = from_float<T>(x[u]);
    *reinterpret_cast<uint4*>(q) = v;
  } else {
#pragma unroll
    for (int u = 0; u < G; ++u) q[u] = from_float<T>(x[u]);
  }
}

template <int G>
__device__ __forceinline__ void store_group(void* O, int o_dtype, int64_t i, const float (&x)[G]) {
  switch (o_dtype) {
    case DT_BF16: store_half_group<__nv_bfloat16>(O, i, x); break;
    case DT_F16: store_half_group<__half>(O, i, x); break;
    case DT_F32:
#pragma unroll
      for (int u = 0; u < G; ++u) static_cast<float*>(O)[i + u] = x[u];
      break;
    default:  // int8 behind requant_int8, the 8-bit floats
#pragma unroll
      for (int u = 0; u < G; ++u) store_out(O, o_dtype, i + u, x[u]);
      break;
  }
}

// apply_op on every element of NG x G, the op switch taken once so each
// case is straight-line code the scheduler can interleave.
template <int OP, int NG, int G>
__device__ __forceinline__ void apply_all(float (&x)[NG][G], const float (&o)[NG][G]) {
#pragma unroll
  for (int g = 0; g < NG; ++g)
#pragma unroll
    for (int u = 0; u < G; ++u) x[g][u] = apply_op(OP, x[g][u], o[g][u]);
}

template <int NG, int G>
__device__ __forceinline__ void apply_groups(int op, float (&x)[NG][G], const float (&o)[NG][G]) {
  switch (op) {
    case OP_GELU: apply_all<OP_GELU>(x, o); break;
    case OP_SILU: apply_all<OP_SILU>(x, o); break;
    case OP_SWISH: apply_all<OP_SWISH>(x, o); break;
    case OP_RELU: apply_all<OP_RELU>(x, o); break;
    case OP_BIAS: apply_all<OP_BIAS>(x, o); break;
    case OP_RESIDUAL: apply_all<OP_RESIDUAL>(x, o); break;
    case OP_MUL: apply_all<OP_MUL>(x, o); break;
    case OP_SCALE: apply_all<OP_SCALE>(x, o); break;
    case OP_REQUANT_INT8: apply_all<OP_REQUANT_INT8>(x, o); break;
    default: break;
  }
}

// Output tile (m_tile, n_tile) of group `g`, K panels of split `split` of
// `splits`. The output, C and the epilogue's full operands of group g start
// at element g*M*N, its row operands (C as [G, N], epilogue rows as
// [G, 1, N]) at g*N; the scalar has no group. With splits > 1, `ws` holds
// splits * m_tiles * n_tiles * BM * BN floats and `counters` one zeroed int
// per output tile (only K1 splits: one group). F16: fp16 operands, else bf16.
template <class Cfg, bool F16>
__device__ __forceinline__ void sm90_gemm_tile(
    const CUtensorMap* map_a, const CUtensorMap* map_b, void* __restrict__ O, int M, int N,
    int K, int g, int m_tile, int n_tile, int m_tiles, int split, int splits, const void* C,
    int c_kind, int c_dtype, int o_dtype, const OpopeEpilogue& ep, float* __restrict__ ws,
    int* __restrict__ counters) {
  constexpr int STAGES = Cfg::STAGES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[STAGES];
  __shared__ __align__(8) uint64_t empty_bar[STAGES];
  __shared__ int is_last;

  // 128-byte swizzle repeats every 1024 bytes: stages start on that grid.
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int m0 = m_tile * Cfg::BM, n0 = n_tile * Cfg::BN;
  // This split's K panels: a whole number of SM90_BK panels, the first
  // `rem` splits one more (kernels/opope_gemm.py::_split_bounds).
  const int panels = (K + SM90_BK - 1) / SM90_BK;
  const int per = panels / splits, rem = panels % splits;
  const int p_begin = split * per + min(split, rem);
  const int p_count = per + (split < rem ? 1 : 0);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&full_bar[s]), 1);
      mbar_init(smem_u32(&empty_bar[s]), 4 * Cfg::WG);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= Cfg::CONSUMERS) {
    // Producer: one thread issues every load; the rest retire.
    if constexpr (Cfg::WG > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == Cfg::CONSUMERS) {
      for (int i = 0; i < p_count; ++i) {
        const int s = i % STAGES;
        mbar_wait(smem_u32(&empty_bar[s]), ((i / STAGES) & 1) ^ 1);
        const uint32_t full = smem_u32(&full_bar[s]);
        const uint32_t a_dst = ring + s * Cfg::STAGE_BYTES;
        const int k0 = (p_begin + i) * SM90_BK;
        mbar_expect_tx(full, Cfg::STAGE_BYTES);  // whole boxes, zero-filled parts included
        tma_load_3d(a_dst, map_a, full, k0, m0, g);
#pragma unroll
        for (int j = 0; j < Cfg::BN / 64; ++j)
          tma_load_3d(a_dst + Cfg::A_BYTES + j * Cfg::B_BOX_BYTES, map_b, full, n0 + 64 * j, k0,
                      g);
      }
    }
    return;
  }
  if constexpr (Cfg::WG > 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int tc = threadIdx.x;  // consumer thread, 0 .. CONSUMERS-1
  const int wg = tc / 128, warp = (tc % 128) / 32, lane = tc % 32;
  float acc[Cfg::NREG];
#pragma unroll
  for (int i = 0; i < Cfg::NREG; ++i) acc[i] = 0.0f;

  // A: this warpgroup's 64 rows of 128 bytes; 8-row swizzle atoms 1024 B
  // apart (SBO); a 16-deep K step is 32 bytes along the row.
  // B: two 64-column boxes 8192 B apart (LBO, along N); 8 K rows 1024 B
  // apart (SBO); a 16-deep K step is 16 rows of 128 bytes.
  for (int i = 0; i < p_count; ++i) {
    const int s = i % STAGES;
    mbar_wait(smem_u32(&full_bar[s]), (i / STAGES) & 1);
    const uint32_t a_st = ring + s * Cfg::STAGE_BYTES + wg * 64 * 128;
    const uint32_t b_st = ring + s * Cfg::STAGE_BYTES + Cfg::A_BYTES;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < SM90_BK / 16; ++kk)
      wgmma_m64n128k16_ss<1, F16>(acc, smem_desc(a_st + kk * 32, 16, 1024),
                             smem_desc(b_st + kk * 2048, Cfg::B_BOX_BYTES, 1024));
    wgmma_commit();
    // At most this panel's group in flight: the previous stage is free.
    wgmma_wait<1>();
    fence_acc(acc);
    if (i > 0 && lane == 0) mbar_arrive(smem_u32(&empty_bar[(i - 1) % STAGES]));
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // Every warpgroup's wgmma has retired, so the ring is free: stage the
  // fp32 tile there (row stride BN + 8 floats), then finish it with one
  // element a thread along each row, so global loads and stores coalesce.
  // acc[4j + h] holds tile row wg*64 + warp*16 + lane/4 + 8*(h/2) and
  // column 8j + 2*(lane%4) + h%2.
  constexpr int LD = Cfg::BN + 8;
  asm volatile("bar.sync 1, %0;" :: "n"(Cfg::CONSUMERS) : "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  float* tile_s = reinterpret_cast<float*>(smem_raw + (ring - smem_u32(smem_raw)));
  {
    const int r = wg * 64 + warp * 16 + lane / 4, c = 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < Cfg::BN / 8; ++j) {
      *reinterpret_cast<float2*>(tile_s + r * LD + 8 * j + c) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(tile_s + (r + 8) * LD + 8 * j + c) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
  asm volatile("bar.sync 1, %0;" :: "n"(Cfg::CONSUMERS) : "memory");

  // The finish works on groups of G consecutive columns a thread: N is a
  // multiple of 8 on this route, so a group lies wholly inside or outside
  // the matrix, and all of a group's loads issue before its arithmetic.
  constexpr int G = 8;
  const int rows = min(Cfg::BM, M - m0), cols = min(Cfg::BN, N - n0);
  const int n_elems = rows * Cfg::BN;
  const int64_t g_mn = static_cast<int64_t>(g) * M * N, g_n = static_cast<int64_t>(g) * N;
  const float* parts = nullptr;
  if (splits > 1) {
    // Partials as [tile][split][BM][BN] fp32, only the part inside the
    // matrix written and read.
    const int tile = n_tile * m_tiles + m_tile;
    float* tile_ws = ws + static_cast<int64_t>(tile) * splits * Cfg::BM * Cfg::BN;
    float* mine = tile_ws + static_cast<int64_t>(split) * Cfg::BM * Cfg::BN;
    for (int e = tc * G; e < n_elems; e += Cfg::CONSUMERS * G) {
      const int r = e / Cfg::BN, c = e % Cfg::BN;
      if (c >= cols) continue;
      const float4* src = reinterpret_cast<const float4*>(tile_s + r * LD + c);
      __stcg(reinterpret_cast<float4*>(mine + e), src[0]);
      __stcg(reinterpret_cast<float4*>(mine + e) + 1, src[1]);
    }
    __threadfence();  // this block's partial is visible before its count is
    asm volatile("bar.sync 1, %0;" :: "n"(Cfg::CONSUMERS) : "memory");
    if (tc == 0) {
      const int last = atomicAdd(counters + tile, 1) == splits - 1;
      if (last) counters[tile] = 0;  // every split has counted: ready for the next call
      is_last = last;
    }
    asm volatile("bar.sync 1, %0;" :: "n"(Cfg::CONSUMERS) : "memory");
    if (!is_last) return;
    __threadfence();
    parts = tile_ws;
  }

  // Writeback: the K sum (with splits, every partial in split order
  // 0..S-1, this block's own included, so the result does not depend on
  // which block finished last), + C, the epilogue chain on the fp32
  // value, one cast. A thread keeps NG groups in flight, so their loads
  // overlap instead of paying one memory latency per group.
  constexpr int NG = 4;
  constexpr int STEP = Cfg::CONSUMERS * G;
  for (int e0 = tc * G; e0 < n_elems; e0 += STEP * NG) {
    float x[NG][G] = {}, o[NG][G] = {};
    bool ok[NG];
    int64_t c[NG], idx[NG];
#pragma unroll
    for (int q = 0; q < NG; ++q) {
      const int e = e0 + q * STEP, lr = e / Cfg::BN, lc = e % Cfg::BN;
      ok[q] = e < n_elems && lc < cols;
      c[q] = g_n + n0 + lc;
      idx[q] = g_mn + static_cast<int64_t>(m0 + lr) * N + n0 + lc;
      if (ok[q] && parts == nullptr) {
        const float4* src = reinterpret_cast<const float4*>(tile_s + lr * LD + lc);
        const float4 lo = src[0], hi = src[1];
        x[q][0] = lo.x; x[q][1] = lo.y; x[q][2] = lo.z; x[q][3] = lo.w;
        x[q][4] = hi.x; x[q][5] = hi.y; x[q][6] = hi.z; x[q][7] = hi.w;
      }
    }
    if (parts != nullptr) {
      for (int sp = 0; sp < splits; ++sp) {
        const float* part = parts + static_cast<int64_t>(sp) * Cfg::BM * Cfg::BN;
#pragma unroll
        for (int q = 0; q < NG; ++q) {
          if (!ok[q]) continue;
          const float4* src = reinterpret_cast<const float4*>(part + e0 + q * STEP);
          const float4 lo = __ldcg(src), hi = __ldcg(src + 1);
          const float v[G] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
          for (int u = 0; u < G; ++u) x[q][u] = sp == 0 ? v[u] : x[q][u] + v[u];
        }
      }
    }
    if (c_kind != K_NONE) {
#pragma unroll
      for (int q = 0; q < NG; ++q)
        if (ok[q]) load_group(C, c_dtype, c_kind == K_ROW ? c[q] : idx[q], o[q]);
#pragma unroll
      for (int q = 0; q < NG; ++q)
#pragma unroll
        for (int u = 0; u < G; ++u) x[q][u] += o[q][u];
    }
    for (int s = 0; s < ep.n_steps; ++s) {
      const int kind = ep.kind[s];
      if (kind == K_SCALAR) {
        const float v = load_as_float(ep.ptr[s], ep.dtype[s], 0);
#pragma unroll
        for (int q = 0; q < NG; ++q)
#pragma unroll
          for (int u = 0; u < G; ++u) o[q][u] = v;
      } else if (kind == K_ROW || kind == K_FULL) {
#pragma unroll
        for (int q = 0; q < NG; ++q)
          if (ok[q]) load_group(ep.ptr[s], ep.dtype[s], kind == K_ROW ? c[q] : idx[q], o[q]);
      }
      apply_groups(ep.op[s], x, o);
    }
#pragma unroll
    for (int q = 0; q < NG; ++q)
      if (ok[q]) store_group(O, o_dtype, idx[q], x[q]);
  }
}

// A row-major bf16 or fp16 [groups, rows, cols] tensor as TMA boxes of
// [1, box_rows, 64], 128-byte swizzled. Reads past a group's rows or
// columns fill zeros: a box never reaches into the next group.
inline CUresult encode_map_3d(CUtensorMap* map, const void* ptr, int groups, int rows, int cols,
                              int box_rows, bool f16) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(groups)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * 2,
                                 static_cast<cuuint64_t>(cols) * rows * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, f16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
            const_cast<void*>(ptr), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Encodes A [groups, m, k] and B [groups, k, n] for config Cfg and opts
// `kernel` into Cfg::SMEM of dynamic shared memory (above 48 KB needs it),
// once per device: the flag is kept per (Cfg, F16, kernel type), and each
// library launches one sm90 kernel per config and operand type. Returns 0,
// a CUDA runtime error, or 1000 + the CUresult code when a tensor map
// could not be encoded.
template <class Cfg, bool F16, class Kernel>
int sm90_prepare(Kernel kernel, CUtensorMap* map_a, CUtensorMap* map_b, const void* a,
                 const void* b, int groups, int m, int n, int k) {
  CUresult r = encode_map_3d(map_a, a, groups, m, k, Cfg::BM, F16);
  if (r == CUDA_SUCCESS) r = encode_map_3d(map_b, b, groups, k, n, SM90_BK, F16);
  if (r != CUDA_SUCCESS) return 1000 + static_cast<int>(r);
  static bool opted_in[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && !opted_in[dev]) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in[dev] = true;
  }
  return 0;
}

}  // namespace
