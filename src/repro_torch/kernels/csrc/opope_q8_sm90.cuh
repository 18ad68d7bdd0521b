// The int8 GEMM body of the sm90 routes of K2 (opope_q8.cu, one GEMM,
// optionally split along K) and K5 (opope_q8_grouped.cu, G GEMMs of one
// shape, the group the third coordinate of every TMA box): one output tile
// a block, O^T = B_q^T A_q^T, so that the [K, N] int8 weight is wgmma's A
// operand and comes from registers, where int8 needs no transposing
// hardware.
//
// - A producer warp keeps a ring of stages full with TMA loads: a
//   [128 k x 128 n] box of the weight read in place from its [K, N]
//   layout, and an [MT rows x 128 k] box of A_q, both 128-byte swizzled.
//   Both operands are rank-3 tensor maps (columns, rows, group): TMA
//   zero-fills rows past M, columns past N and the K tail inside a group,
//   so a box never reads the next group's rows (K2 is one group).
// - One consumer warpgroup reads each weight box from shared memory, 4
//   bytes of 4 rows a thread, and transposes them with __byte_perm into
//   wgmma's register fragments (4 consecutive k of one weight column in a
//   32-bit register, the m16n8k32 A layout); the 4 lanes that share
//   columns read their rows in an order that puts them in 4 different
//   swizzle chunks, so no read conflicts on a bank.
// - It issues wgmma m64nMTk32 .s32.s8.s8 with A_q, already K-major as int8
//   wgmma requires, as the shared-memory operand B: MT = 8 rows for
//   M <= 8 (no wasted rows beyond the 8 of wgmma's narrowest N), 128
//   above (rows past M zero-filled). Each thread's 4 columns are split
//   over two wgmma row groups, so a warpgroup covers 128 weight columns.
// - With K split across blocks (K2 only), each block writes its int32
//   partial, a counter per tile finds the last block, which sums them
//   (exact in any order).
// - The finish stages the int32 tile in the drained ring and runs
//   opope_q8_tile.cuh's writeback helpers (q8_dequant, q8_add_c,
//   q8_apply_op, q8_store) on it, four groups of 4 columns a thread in
//   flight, so its loads overlap: the same arithmetic, element for
//   element, as the tile bodies and the plain version.
#pragma once

#include "opope_q8_tile.cuh"
#include "sm90.cuh"  // mbarriers, TMA, wgmma descriptors and instructions, the map encoder

namespace {

constexpr int Q8_BK = 128;         // K bytes a stage: one 128-byte swizzle row of A_q
constexpr int Q8_BN = 128;         // weight columns a block: one swizzle row of B_q
constexpr int Q8_CONSUMERS = 128;  // one consumer warpgroup
constexpr int Q8_THREADS = Q8_CONSUMERS + 32;  // + the producer warp

template <int MT_, int STAGES_>
struct Q8Sm90Config {
  static constexpr int MT = MT_, STAGES = STAGES_;
  static constexpr int W_BYTES = Q8_BK * Q8_BN;  // one [128 k x 128 n] weight box
  static constexpr int A_BYTES = MT * Q8_BK;     // one [MT rows x 128 k] box of A_q
  static constexpr int STAGE_BYTES = W_BYTES + A_BYTES;
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024;  // + slack to align to 1024
  static constexpr int NACC = MT / 2;   // int32 accumulators a thread, per row group
  static constexpr int LD = Q8_BN + 4;  // row stride (int32) of the tile staged at the end
  static_assert(A_BYTES % 1024 == 0, "boxes start on the 1024-byte swizzle grid");
  static_assert(MT * LD * 4 <= STAGES * STAGE_BYTES, "the int32 tile is staged in the ring");
  static_assert(SMEM <= 227 * 1024, "a block's shared memory");
};
using Q8Decode = Q8Sm90Config<8, 8>;     // M <= 8: 8 stages of 16 KB of weight
using Q8Prefill = Q8Sm90Config<128, 4>;  // M > 8

// D[64 x MT] += A (registers) * B (shared, K-major), int8 in, int32 out.
template <int MT>
__device__ __forceinline__ void wgmma_q8(int (&d)[MT / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (MT == 8) wgmma_m64n8k32_s8_rs(d, a, db, 1);
  else wgmma_m64n128k32_s8_rs(d, a, db, 1);
}

// The finish walks NG groups of G consecutive columns a thread.
constexpr int Q8_G = 4, Q8_NG = 4;

// q8_apply_op on every element of NG x G, the op switch taken once so each
// case is straight-line code the scheduler can interleave.
template <int OP>
__device__ __forceinline__ void q8_apply_all(float (&x)[Q8_NG][Q8_G],
                                             const float (&o)[Q8_NG][Q8_G]) {
#pragma unroll
  for (int g = 0; g < Q8_NG; ++g)
#pragma unroll
    for (int u = 0; u < Q8_G; ++u) x[g][u] = q8_apply_op(OP, x[g][u], o[g][u]);
}

__device__ __forceinline__ void q8_apply_groups(int op, float (&x)[Q8_NG][Q8_G],
                                                const float (&o)[Q8_NG][Q8_G]) {
  switch (op) {
    case OP_GELU: q8_apply_all<OP_GELU>(x, o); break;
    case OP_SILU: q8_apply_all<OP_SILU>(x, o); break;
    case OP_SWISH: q8_apply_all<OP_SWISH>(x, o); break;
    case OP_RELU: q8_apply_all<OP_RELU>(x, o); break;
    case OP_BIAS: q8_apply_all<OP_BIAS>(x, o); break;
    case OP_RESIDUAL: q8_apply_all<OP_RESIDUAL>(x, o); break;
    case OP_MUL: q8_apply_all<OP_MUL>(x, o); break;
    case OP_SCALE: q8_apply_all<OP_SCALE>(x, o); break;
    case OP_REQUANT_INT8: q8_apply_all<OP_REQUANT_INT8>(x, o); break;
    default: break;
  }
}

template <int N>
__device__ __forceinline__ void fence_frags(uint32_t (&f)[2][N]) {
  fence_regs(f[0]);
  fence_regs(f[1]);
}

// The register fragments of one k32 step, both row groups, from the
// stage's weight box (128 rows of 128 bytes, 128-byte swizzled: the 16-byte
// chunk q of row r lies at chunk q ^ (r & 7)). `w_step` is the step's first
// row; `off[e]` the byte offset of this thread's e-th word in rows 0..15,
// whose row is 4t + (e ^ (t & 2)); the same offsets serve rows 16..31 and
// every step, since 16 and 32 rows keep r & 7. f[G] is then row group G's
// m16n8k32 A fragment: {k 4t.., row g}, {k 4t.., row g+8}, {k 16+4t.., row
// g}, {k 16+4t.., row g+8}, rows g and g+8 being weight columns 4p + 2G and
// 4p + 2G + 1 (p = 8 * warp + g).
__device__ __forceinline__ void load_frags(uint32_t (&f)[2][4], uint32_t w_step,
                                           const uint32_t (&off)[4], uint32_t sel_lo,
                                           uint32_t sel_hi) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // k 0..15 and 16..31 of the step
    uint32_t x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      asm volatile("ld.shared.b32 %0, [%1];" : "=r"(x[e]) : "r"(w_step + h * 16 * Q8_BK + off[e]));
    // 4x4 byte transpose (opope_q8_tile.cuh's, rows taken in the order
    // read): byte j of word c <- byte c of row j, i.e. 4 k of column 4p + c.
    const uint32_t p0 = __byte_perm(x[0], x[1], 0x5140), p1 = __byte_perm(x[0], x[1], 0x7362);
    const uint32_t p2 = __byte_perm(x[2], x[3], 0x5140), p3 = __byte_perm(x[2], x[3], 0x7362);
    f[0][2 * h] = __byte_perm(p0, p2, sel_lo);
    f[0][2 * h + 1] = __byte_perm(p0, p2, sel_hi);
    f[1][2 * h] = __byte_perm(p1, p3, sel_lo);
    f[1][2 * h + 1] = __byte_perm(p1, p3, sel_hi);
  }
}

// Output tile (m_tile, n_tile) of group `group`, K panels of split `split`
// of `splits`. SA [G, M] and SB [G, N] are the row and column scales; the
// output, C and the epilogue's full operands of the group start at element
// group*M*N, its row operands (C as [G, N], epilogue rows as [G, 1, N]) at
// group*N; the scalar has no group. With splits > 1 (one group), `ws`
// holds splits * m_tiles * n_tiles * MT * 128 int32 and `counters` one
// zeroed int per output tile.
template <class Cfg>
__device__ __forceinline__ void q8_sm90_tile(
    const CUtensorMap* map_a, const CUtensorMap* map_b, const float* __restrict__ SA,
    const float* __restrict__ SB, void* __restrict__ O, int M, int N, int K, int group,
    int m_tile, int n_tile, int m_tiles, int split, int splits, const void* C, int c_kind,
    int c_dtype, int o_dtype, const OpopeEpilogue& ep, int* __restrict__ ws,
    int* __restrict__ counters) {
  constexpr int STAGES = Cfg::STAGES, MT = Cfg::MT;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[STAGES];
  __shared__ __align__(8) uint64_t empty_bar[STAGES];
  __shared__ int is_last;

  // 128-byte swizzle repeats every 1024 bytes: boxes start on that grid.
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int m0 = m_tile * MT, n0 = n_tile * Q8_BN;
  // This split's K panels: a whole number of Q8_BK panels, the first `rem`
  // splits one more (quant/opope_q8.py::_plan, kernels/opope_gemm.py::_split_bounds).
  const int panels = (K + Q8_BK - 1) / Q8_BK;
  const int per = panels / splits, rem = panels % splits;
  const int p_begin = split * per + min(split, rem);
  const int p_count = per + (split < rem ? 1 : 0);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&full_bar[s]), 1);
      mbar_init(smem_u32(&empty_bar[s]), 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= Q8_CONSUMERS) {
    // Producer warp: one thread issues every load; the rest retire.
    if (threadIdx.x == Q8_CONSUMERS) {
      for (int i = 0; i < p_count; ++i) {
        const int s = i % STAGES;
        mbar_wait(smem_u32(&empty_bar[s]), ((i / STAGES) & 1) ^ 1);
        const uint32_t full = smem_u32(&full_bar[s]);
        const uint32_t w_dst = ring + s * Cfg::STAGE_BYTES;
        const int k0 = (p_begin + i) * Q8_BK;
        mbar_expect_tx(full, Cfg::STAGE_BYTES);  // whole boxes, zero-filled parts included
        tma_load_3d(w_dst, map_b, full, n0, k0, group);
        tma_load_3d(w_dst + Cfg::W_BYTES, map_a, full, k0, m0, group);
      }
    }
    return;
  }

  const int tc = threadIdx.x, warp = tc / 32, lane = tc % 32, g = lane / 4, t = lane % 4;
  // This thread's words of a k32 step (load_frags): columns 4p..4p+3 of the
  // box are bytes 4p.. of chunk 2 * warp + g / 4.
  const int chunk = 2 * warp + (g >> 2), rot = t & 2;
  uint32_t off[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = 4 * t + (e ^ rot);
    off[e] = r * Q8_BK + ((chunk ^ (r & 7)) << 4) + 4 * (g & 3);
  }
  // Words read in the order rows 2, 3, 0, 1 (rot = 2) leave the transpose's
  // two halves swapped: the last byte_perm's selectors swap them back.
  const uint32_t sel_lo = rot ? 0x1054u : 0x5410u, sel_hi = rot ? 0x3276u : 0x7632u;

  int acc[2][Cfg::NACC];
#pragma unroll
  for (int G = 0; G < 2; ++G)
#pragma unroll
    for (int i = 0; i < Cfg::NACC; ++i) acc[G][i] = 0;
  uint32_t frag[2][2][4];  // [k32 step parity][row group][register]

  // A_q's box: MT rows of 128 bytes, 8-row swizzle atoms 1024 B apart (SBO),
  // a k32 step 32 bytes into the row (K-major, as K1 reads its A).
  for (int i = 0; i < p_count; ++i) {
    const int s = i % STAGES;
    mbar_wait(smem_u32(&full_bar[s]), (i / STAGES) & 1);
    const uint32_t w_st = ring + s * Cfg::STAGE_BYTES;
    const uint32_t a_st = w_st + Cfg::W_BYTES;
#pragma unroll
    for (int kk = 0; kk < Q8_BK / 32; ++kk) {
      // The fragments of step kk - 2 (this parity) were read by a wgmma
      // group retired by the last wait: they may be rewritten.
      load_frags(frag[kk & 1], w_st + kk * 32 * Q8_BK, off, sel_lo, sel_hi);
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      wgmma_fence();
      const uint64_t db = smem_desc(a_st + kk * 32, 16, 1024);
      wgmma_q8<MT>(acc[0], frag[kk & 1][0], db);
      wgmma_q8<MT>(acc[1], frag[kk & 1][1], db);
      wgmma_commit();
      // At most this step's group in flight: the previous step's fragments,
      // and at kk = 0 the previous stage, are free.
      wgmma_wait<1>();
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      fence_frags(frag[(kk + 1) & 1]);
      if (kk == 0 && i > 0 && lane == 0) mbar_arrive(smem_u32(&empty_bar[(i - 1) % STAGES]));
    }
  }
  wgmma_wait<0>();
  fence_acc(acc[0]);
  fence_acc(acc[1]);
  fence_frags(frag[0]);
  fence_frags(frag[1]);

  // Every wgmma has retired and every load has landed: stage the int32 tile
  // in the ring as [MT rows][LD], rows of A_q (output rows) by weight
  // columns. acc[G][4j + h] holds wgmma row 16 * warp + g + 8 * (h >> 1),
  // i.e. weight column 4p + 2G + (h >> 1), and A_q row 8j + 2t + (h & 1).
  asm volatile("bar.sync 1, %0;" :: "n"(Q8_CONSUMERS) : "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  int* tile_s = reinterpret_cast<int*>(smem_raw + (ring - smem_u32(smem_raw)));
  {
    const int p = 8 * warp + g;
#pragma unroll
    for (int G = 0; G < 2; ++G)
#pragma unroll
      for (int i = 0; i < Cfg::NACC; ++i) {
        const int r = 8 * (i >> 2) + 2 * t + (i & 1), c = 4 * p + 2 * G + ((i >> 1) & 1);
        tile_s[r * Cfg::LD + c] = acc[G][i];
      }
  }
  asm volatile("bar.sync 1, %0;" :: "n"(Q8_CONSUMERS) : "memory");

  // The finish walks 4 consecutive columns a thread: N is a multiple of 16
  // on this route, so a group lies wholly inside or outside the matrix.
  const int rows = min(MT, M - m0), cols = min(Q8_BN, N - n0);
  const int n_elems = rows * Q8_BN;
  // The group's scales, and the element offsets of its output, full
  // operands (g_mn) and rows (g_n).
  const int64_t g_mn = static_cast<int64_t>(group) * M * N, g_n = static_cast<int64_t>(group) * N;
  SA += static_cast<int64_t>(group) * M;
  SB += g_n;
  const int* parts = nullptr;
  if (splits > 1) {
    // Partials as [tile][split][MT][Q8_BN] int32, only the part inside the
    // matrix written and read.
    const int tile = n_tile * m_tiles + m_tile;
    int* tile_ws = ws + static_cast<int64_t>(tile) * splits * MT * Q8_BN;
    int* mine = tile_ws + static_cast<int64_t>(split) * MT * Q8_BN;
    for (int e = tc * 4; e < n_elems; e += Q8_CONSUMERS * 4) {
      const int r = e / Q8_BN, c = e % Q8_BN;
      if (c >= cols) continue;
      __stcg(reinterpret_cast<int4*>(mine + e),
             *reinterpret_cast<const int4*>(tile_s + r * Cfg::LD + c));
    }
    __threadfence();  // this block's partial is visible before its count is
    asm volatile("bar.sync 1, %0;" :: "n"(Q8_CONSUMERS) : "memory");
    if (tc == 0) {
      const int last = atomicAdd(counters + tile, 1) == splits - 1;
      if (last) counters[tile] = 0;  // every split has counted: ready for the next call
      is_last = last;
    }
    asm volatile("bar.sync 1, %0;" :: "n"(Q8_CONSUMERS) : "memory");
    if (!is_last) return;
    __threadfence();
    parts = tile_ws;
  }

  // Writeback: the K sum (with splits, every partial; int32 addition is
  // exact, so the order does not matter), then opope_q8_tile.cuh's helpers
  // element for element: q8_dequant (the scale product first), q8_add_c,
  // the epilogue chain of q8_apply_op, q8_store's one cast.
  // A thread keeps NG groups in flight, every load of a step issued before
  // the arithmetic that uses it, so their latencies overlap.
  constexpr int STEP = Q8_CONSUMERS * Q8_G;
  for (int e0 = tc * Q8_G; e0 < n_elems; e0 += STEP * Q8_NG) {
    int sum[Q8_NG][Q8_G] = {};
    float x[Q8_NG][Q8_G], o[Q8_NG][Q8_G] = {}, sa[Q8_NG] = {}, sb[Q8_NG][Q8_G] = {};
    bool ok[Q8_NG];
    int r[Q8_NG], c[Q8_NG];
#pragma unroll
    for (int g = 0; g < Q8_NG; ++g) {
      const int e = e0 + g * STEP, lr = e / Q8_BN, lc = e % Q8_BN;
      ok[g] = e < n_elems && lc < cols;
      r[g] = m0 + lr;
      c[g] = n0 + lc;
      if (!ok[g]) continue;
      if (parts == nullptr) {
        const int4 v = *reinterpret_cast<const int4*>(tile_s + lr * Cfg::LD + lc);
        sum[g][0] = v.x; sum[g][1] = v.y; sum[g][2] = v.z; sum[g][3] = v.w;
      }
      sa[g] = SA[r[g]];
#pragma unroll
      for (int u = 0; u < Q8_G; ++u) sb[g][u] = SB[c[g] + u];
    }
    if (parts != nullptr) {
      for (int sp = 0; sp < splits; ++sp) {
#pragma unroll
        for (int g = 0; g < Q8_NG; ++g) {
          if (!ok[g]) continue;
          const int4 q = __ldcg(reinterpret_cast<const int4*>(
              parts + static_cast<int64_t>(sp) * MT * Q8_BN + e0 + g * STEP));
          sum[g][0] += q.x; sum[g][1] += q.y; sum[g][2] += q.z; sum[g][3] += q.w;
        }
      }
    }
#pragma unroll
    for (int g = 0; g < Q8_NG; ++g)
#pragma unroll
      for (int u = 0; u < Q8_G; ++u)
        x[g][u] = q8_dequant(sum[g][u], sa[g], sb[g][u]);
    if (c_kind != K_NONE) {
#pragma unroll
      for (int g = 0; g < Q8_NG; ++g) {
        if (!ok[g]) continue;
        const int64_t i0 =
            c_kind == K_ROW ? g_n + c[g] : g_mn + static_cast<int64_t>(r[g]) * N + c[g];
#pragma unroll
        for (int u = 0; u < Q8_G; ++u) o[g][u] = load_as_float(C, c_dtype, i0 + u);
      }
#pragma unroll
      for (int g = 0; g < Q8_NG; ++g)
#pragma unroll
        for (int u = 0; u < Q8_G; ++u) x[g][u] = q8_add_c(x[g][u], o[g][u]);
    }
    for (int st = 0; st < ep.n_steps; ++st) {
      const int kind = ep.kind[st];
      if (kind == K_SCALAR) {
        const float v = load_as_float(ep.ptr[st], ep.dtype[st], 0);
#pragma unroll
        for (int g = 0; g < Q8_NG; ++g)
#pragma unroll
          for (int u = 0; u < Q8_G; ++u) o[g][u] = v;
      } else if (kind == K_ROW || kind == K_FULL) {
#pragma unroll
        for (int g = 0; g < Q8_NG; ++g) {
          if (!ok[g]) continue;
          const int64_t i0 =
              kind == K_ROW ? g_n + c[g] : g_mn + static_cast<int64_t>(r[g]) * N + c[g];
#pragma unroll
          for (int u = 0; u < Q8_G; ++u)
            o[g][u] = load_as_float(ep.ptr[st], ep.dtype[st], i0 + u);
        }
      }
      q8_apply_groups(ep.op[st], x, o);
    }
#pragma unroll
    for (int g = 0; g < Q8_NG; ++g) {
      if (!ok[g]) continue;
      const int64_t i0 = g_mn + static_cast<int64_t>(r[g]) * N + c[g];
#pragma unroll
      for (int u = 0; u < Q8_G; ++u) q8_store(O, o_dtype, i0 + u, x[g][u]);
    }
  }
}

// A row-major int8 [groups, rows, cols] tensor as TMA boxes of
// [1, box_rows, 128], 128-byte swizzled. Reads past a group's rows or
// columns fill zeros: a box never reaches into the next group.
inline CUresult encode_q8_map(CUtensorMap* map, const void* ptr, int groups, int rows, int cols,
                              int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(groups)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols),
                                 static_cast<cuuint64_t>(cols) * rows};
  const cuuint32_t box[3] = {128, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Encodes A_q [groups, m, k] and B_q [groups, k, n] for config Cfg and opts
// `kernel` into Cfg::SMEM of dynamic shared memory (above 48 KB needs it)
// once per device, `opted_in` being the caller's flags for this kernel.
// Returns 0, a CUDA runtime error, or 1000 + the CUresult code when a
// tensor map could not be encoded.
template <class Cfg, class Kernel>
int q8_sm90_prepare(Kernel kernel, bool (&opted_in)[64], CUtensorMap* map_a, CUtensorMap* map_b,
                    const void* a, const void* b, int groups, int m, int n, int k) {
  CUresult r = encode_q8_map(map_a, a, groups, m, k, Cfg::MT);
  if (r == CUDA_SUCCESS) r = encode_q8_map(map_b, b, groups, k, n, Q8_BK);
  if (r != CUDA_SUCCESS) return 1000 + static_cast<int>(r);
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
