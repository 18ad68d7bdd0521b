// Flash attention for Hopper (sm_90a), one launch over every (batch, head):
// out[b,h] = softmax(q[b,h] k[b,h]^T * D^-0.5, masked) v[b,h], q [S, D],
// k/v [T, D], one dtype of fp32, bf16, fp16, e4m3 and e5m2, any head dim D.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/opope_attention.py::opope_attention (body _attn_kernel;
// opope_attention_bhsd vmaps it over [B, H]). Its contract, kept here: fp32
// scores scaled after the product, keys at or past T masked, a causal mask
// aligned to the end of the keys (q_offset = T - S), the finite
// NEG_INF = -0.7 * FLT_MAX, an online softmax whose state (m, l, acc) stays
// fp32 across the KV loop, P cast to the value dtype before P.V, and
// out = acc / max(l, 1e-37) cast to the query dtype. Causal query rows with
// no valid key (row + q_offset < 0) get what the TPU kernel gives them: its
// finite NEG_INF weighs every key of each panel their query block visits
// with 1, padded keys included, so out = sum(v[:min(L, T)]) / L, L those
// panels' keys at the reference's block sizes (passed in as ref_bq,
// ref_bk). Such a row here takes weight 1 on keys [0, min(L, T)) and is
// divided by L (0 when L = 0).
//
// Two routes, chosen on the host from the operands alone
// (kernels/opope_attention.py::_plan):
//
// * sm90 (bf16 q, k, v of head dim 64 or 128 that TMA tensor maps describe;
//   every call but a causal one with S > T): a warp-specialised kernel. One
//   block per (b*h, 128-query tile); blocks walk one head's tiles, heaviest
//   causal tiles first, before the next head's, so the blocks in flight
//   share a few heads' K and V in L2. A producer warp loads Q once and
//   keeps a ring of K and V panels (128 keys each, 2 stages at D = 128) full
//   by TMA, through rank-4 tensor maps over (D, rows, heads, batch) with the
//   tensors' own strides: [B, S, H, D] tensors viewed as [B, H, S, D] are
//   read in place, and rows past S or T of a head come in as zeros. Each
//   stage completes on an mbarrier and is released once the wgmma reading
//   it has retired. Two consumer warpgroups own 64 query rows each: S = Q K^T
//   on wgmma m64n128k16 from 128-byte-swizzled shared memory (K is [T, D]
//   row-major, K-major already), the online softmax in registers (base-2
//   units, one exp2f a weight; a mask only on panels that cross the causal
//   diagonal or T; panels past a warpgroup's rows skipped), then
//   O += P V on wgmma with P rounded to bf16 in registers (the C fragment of
//   S is the register A fragment of P) and V read MN-major (transposed).
// * tile (everything else: fp32, which wgmma would run as TF32; fp16 and
//   the 8-bit floats; every head dim but 64 and 128 in bf16; causal calls
//   with S > T, whose rows without a valid key follow the reference's block
//   sizes; operands TMA cannot describe): one block per (b*h, 64-query
//   tile, output pass), 64-key panels double-buffered, each of 4 warps
//   owning 16 rows, their m, l and acc in registers for the whole loop (the
//   O-POPE output-stationary accumulator). One kernel template,
//   opope_attention_kernel<T, D, ANY>: the fast instantiation (ANY false)
//   for q, k, v already in fp32, bf16 or fp16 at a compiled head dim with
//   16-byte rows, all by cp.async; the general one for the rest. The head dim runs on the
//   narrowest compiled width D of 16, 32, 64, 128 that holds it, columns
//   past it zero-filled on load (a zero column of q and k changes no score)
//   and never stored. Past 128 it runs in chunks of 128: S = Q K^T sums
//   the chunks, one chunk of Q and K a step, and grid z makes one pass per
//   128 output columns, every pass computing the same scores and so the
//   same P.
//     bf16, fp16: Q fragments loaded once a chunk (ldmatrix); S = Q K^T and
//     acc += P V on mma.sync m16n8k16, P cast to v's dtype in registers, V
//     by ldmatrix.trans. e4m3 and e5m2 q, k, v are widened exactly to fp16
//     as they are loaded (the threads' own loads; cp.async moves operands
//     already in the compute type) and run the fp16 body, P rounded to v's
//     8-bit format before its fp16 product. With 3 or 2 mantissa bits
//     where P rounds matters, so 8-bit v rounds it where the reference
//     does: at the running maximum through each of the reference's KV
//     panels (ref_bk keys), taken in a first pass over the panel's scores.
//     fp32: the same tiles and fragment layout on CUDA-core FMAs, never TF32;
//     P goes through a per-warp shared buffer.
//   The output is cast to q's dtype by the reference's rule (dtypes.cuh).
//
// What bounds each on the card, and what the design does about it:
// * Prefill (S = T = 2048, causal): the 4*S*T*D flops, halved by causality,
//   against 989 TFLOP/s bf16. The tile route's mma.sync on 64-row tiles
//   reaches ~200 TFLOP/s; the sm90 route's wgmma from swizzled shared
//   memory, fed by TMA with no thread spending registers or instructions on
//   a copy, ~400. Softmax and the two products run one after the other in a
//   warpgroup: overlapping them (S_j+1 in flight during the softmax of S_j)
//   needs S, P and O in registers together (160 of the 168 a thread of a
//   384- or 288-thread block gets), and the compiler then serialises every
//   wgmma and spills; setmaxnreg did not raise its allocation past 168.
// * A decode row (S = 1): reading K and V. Both routes waste all but one row
//   of a tile there; the sm90 route keeps 128 KB of K and V in flight per SM
//   and is the faster of the two (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "dtypes.cuh"  // dtype codes, widening on load, the final cast
#include "sm90.cuh"    // mbarriers, TMA, wgmma descriptors and instructions, the map encoder

// Must match kernels/opope_attention.py::_Params field for field.
struct AttnParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t q_strides[3];  // elements, over (batch, head, row); unit stride along D
  int64_t k_strides[3];
  int64_t v_strides[3];
  int64_t o_strides[3];
  int batch_heads, heads, s, t, d, dtype, causal;
  int ref_bq, ref_bk, ref_kv_steps;  // the reference's clipped blocks and KV steps
  int vec[3];  // q, k, v: rows may be read in whole 16-byte vectors of the compute type
  float scale;
};

// Must match kernels/opope_attention.py::_Maps field for field: the rank-4
// tensor maps of q, k and v over (D, rows, heads, batch), as the wrapper's
// plan (`_tma_map`) computed them from the tensors' shapes and strides.
struct AttnMaps {
  uint64_t dims[3][4];     // elements: D, rows (S or T), heads, batch
  uint64_t strides[3][3];  // bytes along rows, heads, batch
};

namespace {

constexpr int BQ = 64;    // query rows per block: 4 warps x 16
constexpr int BKV = 64;   // keys per panel
constexpr int THREADS = 128;
constexpr int PLD = BKV + 4;  // row stride of the fp32 path's P buffer
constexpr float NEG_INF = static_cast<float>(-0.7 * 3.4028234663852886e38);

// Shared-memory row stride (elements): rows stay 16-byte aligned, and the
// 8 rows of an ldmatrix (or of a quad's float4 reads) fall on distinct banks.
template <typename T, int D>
__host__ __device__ constexpr int row_ld() { return sizeof(T) == 4 ? D + 4 : D + 8; }

// Q (two buffers when the head dim takes more than one chunk), K and V
// double-buffered, and the fp32 path's P buffers.
template <typename T, int D>
constexpr size_t smem_bytes(bool two_q) {
  return static_cast<size_t>((two_q ? 2 : 1) * BQ + 4 * BKV) * row_ld<T, D>() * sizeof(T) +
         (sizeof(T) == 4 ? 4 * 16 * PLD * sizeof(float) : 0);
}

// 16 bytes global -> shared; the first `bytes` come from global memory and
// the rest are zero.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// VEC consecutive elements of a Tin row at `p` (the first `valid` inside
// the operand, the rest zero) widened to T, as one 16-byte vector; `vec`:
// p may be read as one load of VEC * sizeof(Tin) bytes.
template <typename T, typename Tin>
__device__ __forceinline__ uint4 widen_vec(const Tin* p, int valid, bool vec) {
  constexpr int VEC = 16 / sizeof(T);
  struct alignas(VEC * sizeof(Tin)) Pack { Tin v[VEC]; };
  alignas(16) T out[VEC];
  if (vec && valid == VEC) {
    const Pack pk = *reinterpret_cast<const Pack*>(p);
#pragma unroll
    for (int e = 0; e < VEC; ++e) out[e] = from_float<T>(to_float(pk.v[e]));
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) out[e] = from_float<T>(e < valid ? to_float(p[e]) : 0.0f);
  }
  return *reinterpret_cast<const uint4*>(out);
}

// 64 rows of D columns of one operand into shared memory: rows row0.. and
// columns col0.. of a [rows, d] matrix at `src` (dtype `dt`, row stride
// `ld_g` elements); rows at or past `n_rows` and columns at or past `d` are
// zero. Operands already in the compute type T whose rows are 16-byte
// vectors (`vec`) go by cp.async; the rest are read, widened exactly to T
// and stored by the threads (the 8-bit floats widen to fp16).
template <typename T, int D>
__device__ __forceinline__ void load_rows(T* dst, const void* src, int dt, bool vec,
                                          int64_t ld_g, int row0, int n_rows, int col0, int d) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CH = D / VEC;  // 16-byte chunks per row
  static_assert((64 * CH) % THREADS == 0, "chunks must split evenly over the block");
  const bool same = dt == (sizeof(T) == 4 ? DT_F32 : std::is_same<T, __half>::value ? DT_F16
                                                                                    : DT_BF16);
  if (same && vec) {
#pragma unroll
    for (int i = 0; i < 64 * CH / THREADS; ++i) {
      const int c = threadIdx.x + i * THREADS;
      const int r = c / CH, col = (c % CH) * VEC, gc = col0 + col;
      const int valid = row0 + r < n_rows ? max(0, min(VEC, d - gc)) : 0;
      const int64_t off = valid > 0 ? static_cast<int64_t>(row0 + r) * ld_g + gc : 0;
      cp_async16(dst + r * row_ld<T, D>() + col, static_cast<const T*>(src) + off,
                 valid * static_cast<int>(sizeof(T)));
    }
    return;
  }
#pragma unroll 1
  for (int i = 0; i < 64 * CH / THREADS; ++i) {
    const int c = threadIdx.x + i * THREADS;
    const int r = c / CH, col = (c % CH) * VEC, gc = col0 + col;
    const int valid = row0 + r < n_rows ? max(0, min(VEC, d - gc)) : 0;
    const int64_t off = valid > 0 ? static_cast<int64_t>(row0 + r) * ld_g + gc : 0;
    uint4 w;
    switch (dt) {
      case DT_BF16:
        w = widen_vec<T>(static_cast<const __nv_bfloat16*>(src) + off, valid, vec); break;
      case DT_F16: w = widen_vec<T>(static_cast<const __half*>(src) + off, valid, vec); break;
      case DT_E4M3:
        w = widen_vec<T>(static_cast<const __nv_fp8_e4m3*>(src) + off, valid, vec); break;
      case DT_E5M2:
        w = widen_vec<T>(static_cast<const __nv_fp8_e5m2*>(src) + off, valid, vec); break;
      default: w = widen_vec<T>(static_cast<const float*>(src) + off, valid, vec); break;
    }
    *reinterpret_cast<uint4*>(dst + r * row_ld<T, D>() + col) = w;
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a (16x16, row) * b (16x8, col), bf16 or fp16 in, fp32 accumulate.
template <typename T>
__device__ __forceinline__ void mma_tc(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  if constexpr (std::is_same<T, __half>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two probabilities as the A fragment of P V: cast to v's dtype `vdt` (the
// reference's p.astype(v.dtype)), in T. An 8-bit v rounds P to e4m3 or e5m2
// first, which fp16 then holds exactly.
template <typename T>
__device__ __forceinline__ uint32_t pack_p(float lo, float hi, int vdt) {
  if constexpr (std::is_same<T, __half>::value) {
    if (vdt == DT_E4M3 || vdt == DT_E5M2) {
      lo = round_fp8(lo, vdt);
      hi = round_fp8(hi, vdt);
    }
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    return pack_bf16(lo, hi);
  }
}

// L of a causal row with no valid key: the keys of the panels its
// reference query block visits (module comment).
__device__ __forceinline__ int no_key_len(int row, const AttnParams& p) {
  const int lim = (row / p.ref_bq + 1) * p.ref_bq - 1 + (p.t - p.s);
  if (lim < 0) return 0;
  return min(p.ref_kv_steps, lim / p.ref_bk + 1) * p.ref_bk;
}

// Score fragments (the m16n8 C layout, per warp a 16 x 64 tile):
// sc[nt][j] is row g + 8*(j >> 1), key nt*8 + 2*tq + (j & 1) of the panel,
// with g = lane / 4, tq = lane % 4. The accumulator o[dt][j] has the same
// layout over head-dim columns dt*8 + 2*tq + (j & 1).

// S += Q K^T over one D-wide chunk of one panel, on the tensor cores.
template <typename T, int D>
__device__ __forceinline__ void scores(float (&sc)[8][4], const uint32_t (&qf)[D / 16][4],
                                       const T* Ks, int lane) {
  constexpr int LD = row_ld<T, D>();
  const int i = lane / 8, r = lane % 8;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
#pragma unroll
    for (int ntp = 0; ntp < 4; ++ntp) {
      uint32_t b[4];  // b0, b1 of key tiles 2*ntp and 2*ntp + 1
      ldmatrix_x4(b, Ks + ((2 * ntp + (i >> 1)) * 8 + r) * LD + kc * 16 + (i & 1) * 8);
      mma_tc<T>(sc[2 * ntp], qf[kc], b[0], b[1]);
      mma_tc<T>(sc[2 * ntp + 1], qf[kc], b[2], b[3]);
    }
  }
}

// S += Q K^T over one D-wide chunk of one panel, fp32 on CUDA cores (Q read
// from shared memory).
template <int D>
__device__ __forceinline__ void scores_f32(float (&sc)[8][4], const float* Qs, const float* Ks,
                                           int warp, int g, int tq) {
  constexpr int LD = row_ld<float, D>();
  const float* q0 = Qs + (warp * 16 + g) * LD;
  const float* q1 = q0 + 8 * LD;
#pragma unroll 2
  for (int dd = 0; dd < D; dd += 4) {
    const float4 qa = *reinterpret_cast<const float4*>(q0 + dd);
    const float4 qb = *reinterpret_cast<const float4*>(q1 + dd);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float4 kv =
            *reinterpret_cast<const float4*>(Ks + (nt * 8 + 2 * tq + c) * LD + dd);
        float& s0 = sc[nt][c];
        float& s1 = sc[nt][2 + c];
        s0 = fmaf(qa.x, kv.x, s0); s0 = fmaf(qa.y, kv.y, s0);
        s0 = fmaf(qa.z, kv.z, s0); s0 = fmaf(qa.w, kv.w, s0);
        s1 = fmaf(qb.x, kv.x, s1); s1 = fmaf(qb.y, kv.y, s1);
        s1 = fmaf(qb.z, kv.z, s1); s1 = fmaf(qb.w, kv.w, s1);
      }
    }
  }
}

// acc += P V for one panel, on the tensor cores; P cast to v's dtype.
template <typename T, int D>
__device__ __forceinline__ void accumulate_pv(float (&o)[D / 8][4], const float (&sc)[8][4],
                                              const T* Vs, int lane, int vdt) {
  constexpr int LD = row_ld<T, D>();
  const int i = lane / 8, r = lane % 8;
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {  // 16 keys: score tiles 2*kc, 2*kc + 1
    const uint32_t a[4] = {pack_p<T>(sc[2 * kc][0], sc[2 * kc][1], vdt),
                           pack_p<T>(sc[2 * kc][2], sc[2 * kc][3], vdt),
                           pack_p<T>(sc[2 * kc + 1][0], sc[2 * kc + 1][1], vdt),
                           pack_p<T>(sc[2 * kc + 1][2], sc[2 * kc + 1][3], vdt)};
#pragma unroll
    for (int dtp = 0; dtp < D / 16; ++dtp) {
      uint32_t b[4];  // b0, b1 of column tiles 2*dtp and 2*dtp + 1
      ldmatrix_x4_trans(b, Vs + (kc * 16 + (i & 1) * 8 + r) * LD + (2 * dtp + (i >> 1)) * 8);
      mma_tc<T>(o[2 * dtp], a, b[0], b[1]);
      mma_tc<T>(o[2 * dtp + 1], a, b[2], b[3]);
    }
  }
}

// acc += P V for one panel, fp32 on CUDA cores through the warp's P buffer.
template <int D>
__device__ __forceinline__ void accumulate_pv_f32(float (&o)[D / 8][4], const float (&sc)[8][4],
                                                  const float* Vs, float* Pw, int g, int tq) {
  constexpr int LD = row_ld<float, D>();
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      Pw[(g + 8 * (j >> 1)) * PLD + nt * 8 + 2 * tq + (j & 1)] = sc[nt][j];
  __syncwarp();
#pragma unroll 4
  for (int key = 0; key < BKV; ++key) {
    const float p0 = Pw[g * PLD + key], p1 = Pw[(g + 8) * PLD + key];
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const float2 vv = *reinterpret_cast<const float2*>(Vs + key * LD + dt * 8 + 2 * tq);
      o[dt][0] = fmaf(p0, vv.x, o[dt][0]);
      o[dt][1] = fmaf(p0, vv.y, o[dt][1]);
      o[dt][2] = fmaf(p1, vv.x, o[dt][2]);
      o[dt][3] = fmaf(p1, vv.y, o[dt][3]);
    }
  }
  __syncwarp();
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store_pair(__half* dst, float a, float b) {
  *reinterpret_cast<__half2*>(dst) = __floats2half2_rn(a, b);
}
__device__ __forceinline__ void store_pair(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}

// 64 rows of D elements, rows row0.. of a [rows, D] matrix of T with row
// stride `ld_g` (16-byte rows), into shared memory by cp.async; rows at or
// past `n_rows` are zero. The fast instantiation's loader.
template <typename T, int D>
__device__ __forceinline__ void load_rows_whole(T* dst, const T* src, int64_t ld_g, int row0,
                                                int n_rows) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CH = D / VEC;  // 16-byte chunks per row
  static_assert((64 * CH) % THREADS == 0, "chunks must split evenly over the block");
#pragma unroll
  for (int i = 0; i < 64 * CH / THREADS; ++i) {
    const int c = threadIdx.x + i * THREADS;
    const int r = c / CH, col = (c % CH) * VEC;
    const bool ok = row0 + r < n_rows;
    cp_async16(dst + r * row_ld<T, D>() + col,
               ok ? src + static_cast<int64_t>(row0 + r) * ld_g + col : src, ok ? 16 : 0);
  }
}

// The general instantiation's walk over a tile's keys, in steps. A step is
// one head-dim chunk c of one 64-key panel jp. The panels come in groups,
// each the span of keys whose probabilities round to v's dtype at one
// running maximum. In the one-pass walk a group is one panel. The two-pass walk (8-bit v, whose P
// keeps 3 or 2 mantissa bits) makes each group one of the reference's KV
// panels (ref_bk keys): pass 0 takes the group's row maximum over its
// panels, pass 1 its softmax and P V at that maximum, as the reference
// rounds P after each of its panels.
struct Walk {
  int nc, groups, keys, hi, t;  // keys: a group's span; hi: panels the tile needs
  bool two_pass;
  __device__ int jp_begin(int g) const { return g * keys / BKV; }
  __device__ int jp_end(int g) const {
    return min(hi, (min((g + 1) * keys, t) + BKV - 1) / BKV);
  }
};
struct Step {
  int g, pass, jp, c;
};

// The step after `s`; false past the walk's end.
__device__ __forceinline__ bool next_step(Step& s, const Walk& w) {
  if (++s.c < w.nc) return true;
  s.c = 0;
  if (++s.jp < w.jp_end(s.g)) return true;
  if (s.pass == 0) {
    s.pass = 1;
    s.jp = w.jp_begin(s.g);
    return true;
  }
  if (++s.g >= w.groups) return false;
  s.pass = w.two_pass ? 0 : 1;
  s.jp = w.jp_begin(s.g);
  return true;
}

// The loads of one step of the general instantiation into K buffer
// `buf`: the Q chunk when the head dim takes more than one (nc > 1), the K
// chunk, and in pass 1 with the panel's last chunk the panel's V columns
// of this output pass; one cp.async group. Operands in any dtype,
// zero-filled past d (load_rows).
template <typename T, int D>
__device__ __forceinline__ void load_step(const AttnParams& p, const Step& st, int nc, int buf,
                                          T* Qs, T* Ks, T* Vs, const char* Q, const char* K,
                                          const char* V, int q0, int v0) {
  constexpr int LD = row_ld<T, D>();
  if (nc > 1)
    load_rows<T, D>(Qs + buf * BQ * LD, Q, p.dtype, p.vec[0], p.q_strides[2], q0, p.s,
                    st.c * D, p.d);
  load_rows<T, D>(Ks + buf * BKV * LD, K, p.dtype, p.vec[1], p.k_strides[2], st.jp * BKV, p.t,
                  st.c * D, p.d);
  if (st.pass == 1 && st.c == nc - 1)
    load_rows<T, D>(Vs + (st.jp & 1) * BKV * LD, V, p.dtype, p.vec[2], p.v_strides[2],
                    st.jp * BKV, p.t, v0, p.d);
  cp_async_commit();
}

// A panel's scores scaled and masked in place (keys at or past a row's
// key_lim, and with GROUP those outside [g_lo, g_hi), score NEG_INF; a
// row without a valid key scores 0), and their row maximum over the quad.
template <bool GROUP>
__device__ __forceinline__ void mask_scores(float (&sc)[8][4], float (&mx)[2], int k0,
                                            const int (&key_lim)[2], const bool (&no_key)[2],
                                            float scale, int tq, int g_lo, int g_hi) {
  mx[0] = mx[1] = NEG_INF;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = j >> 1;
      const int key = k0 + nt * 8 + 2 * tq + (j & 1);
      const float x = no_key[r] ? 0.0f : sc[nt][j] * scale;
      bool in = key < key_lim[r];
      if constexpr (GROUP) in = in && key >= g_lo && key < g_hi;
      sc[nt][j] = in ? x : NEG_INF;
      mx[r] = fmaxf(mx[r], sc[nt][j]);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
}

// The online softmax over one panel's masked scores (fp32, expf) with the
// running maximum moved to max(m, mx), then acc += P V, P cast to v's
// dtype: on the tensor cores, or for fp32 on CUDA cores through the warp's
// P buffer Pw.
template <typename T, int D>
__device__ __forceinline__ void softmax_pv(float (&sc)[8][4], const float (&mx)[2],
                                           float (&m)[2], float (&l)[2], float (&o)[D / 8][4],
                                           const T* Vst, float* Pw, int lane, int vdt) {
  float corr[2], lsum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], mx[r]);
    corr[r] = expf(m[r] - m_new);
    m[r] = m_new;
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      sc[nt][j] = expf(sc[nt][j] - m[j >> 1]);
      lsum[j >> 1] += sc[nt][j];
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + lsum[r];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[dt][j] *= corr[j >> 1];
  if constexpr (sizeof(T) == 2) {
    accumulate_pv<T, D>(o, sc, Vst, lane, vdt);
  } else {
    accumulate_pv_f32<D>(o, sc, Vst, Pw, lane / 4, lane % 4);
  }
}

// The tile route's kernel. T is the compute type in shared memory (float,
// bf16, or fp16, which the 8-bit floats widen to), D the compiled chunk
// width. Both instantiations share the panel bounds, the rows without a
// valid key, the masks, the online softmax and P V, and the writeback.
//
// ANY = false, the fast instantiation: q, k and v already in T at head dim
// D, every row a run of 16-byte vectors. Q fragments loaded once; S = Q K^T
// and acc += P V per 64-key panel, K and V double-buffered by cp.async; no
// column masking and no conversion on any path.
//
// ANY = true, every other call: the head dim p.d runs in nc = ceil(d / D)
// chunks of D columns, S = Q K^T summed over them one chunk of Q and K a
// step, operands widened to T as they are stored to shared memory (by
// cp.async where already in T). Block z owns output columns
// [z*D, z*D + D); with nc > 1 every such pass computes the same scores, so
// the same P. 8-bit v takes the two-pass walk (Walk).
template <typename T, int D, bool ANY>
__global__ void __launch_bounds__(THREADS) opope_attention_kernel(const AttnParams p) {
  constexpr int LD = row_ld<T, D>();
  constexpr bool TC = sizeof(T) == 2;  // bf16 or fp16: tensor cores
  const int nc = ANY ? (p.d + D - 1) / D : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);   // [1 or 2][BQ][LD]
  T* Ks = Qs + (nc > 1 ? 2 : 1) * BQ * LD;  // [2][BKV][LD]
  T* Vs = Ks + 2 * BKV * LD;                // [2][BKV][LD]
  float* Ps = reinterpret_cast<float*>(Vs + 2 * BKV * LD);  // fp32 path: [4][16][PLD]

  const int bh = blockIdx.x;
  const int64_t b = bh / p.heads, h = bh % p.heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest causal tiles first
  const int v0 = ANY ? blockIdx.z * D : 0;           // this pass's output columns
  const int esz = ANY ? dtype_size(p.dtype) : static_cast<int>(sizeof(T));
  const char* Q = static_cast<const char*>(p.q) + (b * p.q_strides[0] + h * p.q_strides[1]) * esz;
  const char* K = static_cast<const char*>(p.k) + (b * p.k_strides[0] + h * p.k_strides[1]) * esz;
  const char* V = static_cast<const char*>(p.v) + (b * p.v_strides[0] + h * p.v_strides[1]) * esz;
  const int64_t o_base = b * p.o_strides[0] + h * p.o_strides[1];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  const int q_off = p.t - p.s;
  float* Pw = Ps + warp * 16 * PLD;

  // Panels [0, hi): up to the causal limit of the tile's last row, and far
  // enough for the tile's rows without a valid key.
  const int n_panels = (p.t + BKV - 1) / BKV;
  const int last_row = min(q0 + BQ, p.s) - 1;
  int hi = n_panels;
  if (p.causal) {
    const int lim = last_row + q_off;
    hi = lim < 0 ? 0 : min(n_panels, lim / BKV + 1);
    if (q0 + q_off < 0) {
      const int need = min(no_key_len(min(last_row, -q_off - 1), p), p.t);
      hi = max(hi, (need + BKV - 1) / BKV);
    }
  }

  // This thread's two rows: valid keys are those below key_lim; a row
  // without a valid key scores 0 on keys [0, min(L, T)) and divides by L.
  int row[2], key_lim[2];
  bool no_key[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row[r] = q0 + warp * 16 + g + 8 * r;
    no_key[r] = p.causal && row[r] + q_off < 0;
    key_lim[r] = no_key[r] ? min(no_key_len(row[r], p), p.t)
                           : (p.causal ? min(row[r] + q_off + 1, p.t) : p.t);
  }

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};
  float o[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[dt][j] = 0.0f;
  uint32_t qf[TC ? D / 16 : 1][4];
  float sc[8][4], mx[2];

  if constexpr (!ANY) {
    const T* Qt = reinterpret_cast<const T*>(Q);
    const T* Kt = reinterpret_cast<const T*>(K);
    const T* Vt = reinterpret_cast<const T*>(V);
    load_rows_whole<T, D>(Qs, Qt, p.q_strides[2], q0, p.s);
    cp_async_commit();
    if (hi > 0) {
      load_rows_whole<T, D>(Ks, Kt, p.k_strides[2], 0, p.t);
      load_rows_whole<T, D>(Vs, Vt, p.v_strides[2], 0, p.t);
      cp_async_commit();
    }
    for (int jp = 0; jp < hi; ++jp) {
      const int stage = jp & 1;
      if (jp + 1 < hi) {
        load_rows_whole<T, D>(Ks + (stage ^ 1) * BKV * LD, Kt, p.k_strides[2], (jp + 1) * BKV,
                              p.t);
        load_rows_whole<T, D>(Vs + (stage ^ 1) * BKV * LD, Vt, p.v_strides[2], (jp + 1) * BKV,
                              p.t);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[nt][j] = 0.0f;
      if constexpr (TC) {
        if (jp == 0) {
          const int i = lane / 8, r = lane % 8;
#pragma unroll
          for (int kc = 0; kc < D / 16; ++kc)
            ldmatrix_x4(qf[kc], Qs + (warp * 16 + (i & 1) * 8 + r) * LD + kc * 16 + (i >> 1) * 8);
        }
        scores<T, D>(sc, qf, Ks + stage * BKV * LD, lane);
      } else {
        scores_f32<D>(sc, Qs, Ks + stage * BKV * LD, warp, g, tq);
      }
      mask_scores<false>(sc, mx, jp * BKV, key_lim, no_key, p.scale, tq, 0, 0);
      softmax_pv<T, D>(sc, mx, m, l, o, Vs + stage * BKV * LD, Pw, lane, p.dtype);
      __syncthreads();  // every warp is done with this stage before it is refilled
    }
  } else {
    // One pass where each of the reference's panels is one of the
    // kernel's: 64 keys, or the only panel (T <= 64 keys, all of them).
    Walk walk{nc, hi, BKV, hi, p.t, false};
    const bool own = p.ref_bk == BKV || (p.ref_bk == p.t && p.t <= BKV);
    if ((p.dtype == DT_E4M3 || p.dtype == DT_E5M2) && !own) {
      walk.two_pass = true;
      walk.keys = p.ref_bk;
      walk.groups = (min(hi * BKV, p.t) + p.ref_bk - 1) / p.ref_bk;
    }
    float gm[2] = {NEG_INF, NEG_INF};  // the two-pass walk's group maximum

    // The loads of step i + 1 are in flight while step i computes.
    if (nc == 1) {
      load_rows<T, D>(Qs, Q, p.dtype, p.vec[0], p.q_strides[2], q0, p.s, 0, p.d);
      cp_async_commit();
    }
    Step st{0, walk.two_pass ? 0 : 1, 0, 0};
    bool live = hi > 0;
    if (live) load_step<T, D>(p, st, nc, 0, Qs, Ks, Vs, Q, K, V, q0, v0);
    for (int i = 0; live; ++i) {
      const int buf = i & 1;
      Step nx = st;
      live = next_step(nx, walk);
      if (live) {
        load_step<T, D>(p, nx, nc, buf ^ 1, Qs, Ks, Vs, Q, K, V, q0, v0);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const T* Qst = Qs + (nc > 1 ? buf : 0) * BQ * LD;
      const T* Kst = Ks + buf * BKV * LD;

      if (st.c == 0) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[nt][j] = 0.0f;
      }
      if constexpr (TC) {
        if (nc > 1 || i == 0) {
          const int li = lane / 8, lr = lane % 8;
#pragma unroll
          for (int kc = 0; kc < D / 16; ++kc)
            ldmatrix_x4(qf[kc],
                        Qst + (warp * 16 + (li & 1) * 8 + lr) * LD + kc * 16 + (li >> 1) * 8);
        }
        scores<T, D>(sc, qf, Kst, lane);
      } else {
        scores_f32<D>(sc, Qst, Kst, warp, g, tq);
      }

      if (st.c == nc - 1) {
        // The panel's scores masked, in the two-pass walk to its group's keys.
        const int g_lo = walk.two_pass ? st.g * walk.keys : 0;
        const int g_hi = walk.two_pass ? (st.g + 1) * walk.keys : p.t;
        mask_scores<true>(sc, mx, st.jp * BKV, key_lim, no_key, p.scale, tq, g_lo, g_hi);
        if (st.pass == 0) {  // two-pass walk: the group's maximum so far
          const bool first = st.jp == walk.jp_begin(st.g);
#pragma unroll
          for (int r = 0; r < 2; ++r) gm[r] = fmaxf(first ? NEG_INF : gm[r], mx[r]);
        } else {
          // The running maximum moves to the group's at its first panel.
          if (walk.two_pass) {
            mx[0] = gm[0];
            mx[1] = gm[1];
          }
          softmax_pv<T, D>(sc, mx, m, l, o, Vs + (st.jp & 1) * BKV * LD, Pw, lane, p.dtype);
        }
      }
      __syncthreads();  // every warp is done with this step's buffers before they are refilled
      st = nx;
    }
  }
  cp_async_wait<0>();

  // Writeback: acc / max(l, 1e-37) (l summed over the quad), or / L, cast
  // to q's dtype; no column at or past d is written.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lt = l[r];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    float denom = fmaxf(lt, 1e-37f);
    bool zero = false;
    if (no_key[r]) {
      const int n_keys = no_key_len(row[r], p);
      zero = n_keys == 0;
      denom = static_cast<float>(n_keys);
    }
    if (row[r] >= p.s) continue;
    const int64_t dst = o_base + row[r] * p.o_strides[2];
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const float a = zero ? 0.0f : o[dt][2 * r] / denom;
      const float c = zero ? 0.0f : o[dt][2 * r + 1] / denom;
      const int col = v0 + dt * 8 + 2 * tq;
      if constexpr (ANY) {
        if (col < p.d) store_out(p.o, p.dtype, dst + col, a);
        if (col + 1 < p.d) store_out(p.o, p.dtype, dst + col + 1, c);
      } else {
        store_pair(static_cast<T*>(p.o) + dst + col, a, c);
      }
    }
  }
}

template <typename T, int D, bool ANY>
int launch(const AttnParams& p, cudaStream_t stream) {
  const int nc = ANY ? (p.d + D - 1) / D : 1;
  const size_t smem = smem_bytes<T, D>(nc > 1);
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        opope_attention_kernel<T, D, ANY>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes<T, D>(ANY)));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid(p.batch_heads, (p.s + BQ - 1) / BQ, nc);
  if (grid.y > 65535 || grid.z > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  opope_attention_kernel<T, D, ANY><<<grid, THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The compiled chunk width: the narrowest of 16, 32, 64, 128 that holds
// the head dim, else 128 (chunks and passes of 128 columns). Operands in
// T itself, at a compiled width, with 16-byte rows take the fast
// instantiation.
template <typename T>
int launch_dim(const AttnParams& p, cudaStream_t stream) {
  const int own = sizeof(T) == 4 ? DT_F32 : std::is_same<T, __half>::value ? DT_F16 : DT_BF16;
  if (p.dtype == own && p.vec[0] && p.vec[1] && p.vec[2]) {
    switch (p.d) {
      case 16: return launch<T, 16, false>(p, stream);
      case 32: return launch<T, 32, false>(p, stream);
      case 64: return launch<T, 64, false>(p, stream);
      case 128: return launch<T, 128, false>(p, stream);
      default: break;
    }
  }
  if (p.d <= 16) return launch<T, 16, true>(p, stream);
  if (p.d <= 32) return launch<T, 32, true>(p, stream);
  if (p.d <= 64) return launch<T, 64, true>(p, stream);
  return launch<T, 128, true>(p, stream);
}

// ---------------------------------------------------------------- sm90 route

template <int D>
struct Sm90Attn {
  static constexpr int BQ = 128;          // query rows a block: two consumer warpgroups of 64
  static constexpr int BKV = 128;         // keys a panel
  static constexpr int BOXES = D / 64;    // 64-column (128-byte, swizzled) boxes across D
  static constexpr int STAGES = D == 128 ? 2 : 4;
  static constexpr int Q_BOX = BQ * 128;  // bytes of one [BQ rows x 64] box
  static constexpr int KV_BOX = BKV * 128;
  static constexpr int Q_BYTES = BOXES * Q_BOX;
  static constexpr int KV_BYTES = BOXES * KV_BOX;  // one K (or V) panel
  static constexpr int SMEM = Q_BYTES + 2 * STAGES * KV_BYTES + 1024;  // + slack to align to 1024
  static constexpr int CONSUMERS = 256;
  static constexpr int THREADS = CONSUMERS + 32;  // + the producer warp
  static_assert(D == 64 || D == 128, "the sm90 route takes head dims 64 and 128");
  static_assert(SMEM <= 227 * 1024, "one block an SM");
};

// O[64 x D] += P[64 x 16] (registers) * V[16 x D] (shared, MN-major).
template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 128) wgmma_m64n128k16_rs(o, a, db);
  else wgmma_m64n64k16_rs(o, a, db);
}

// S = Q K^T for one panel into sc (overwritten), issued and committed as
// one wgmma group. Q: this warpgroup's 64 rows of each box, 8-row swizzle
// atoms 1024 B apart (SBO), a 16-deep step along D 32 bytes into the row;
// K: the panel's [128 keys x 64] boxes read the same way (K-major, so no
// transpose). sc[4n + j] is then row 8 (j >> 1) + g of the warp's 16, key
// 8n + 2 tq + (j & 1) of the panel: the m16n8 C layout.
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[64], uint32_t q_wg, uint32_t k_st) {
  using C = Sm90Attn<D>;
  wgmma_fence();
  wgmma_m64n128k16_ss_init<0>(sc, smem_desc(q_wg, 16, 1024), smem_desc(k_st, 16, 1024));
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk)
    wgmma_m64n128k16_ss<0>(sc, smem_desc(q_wg + (kk / 4) * C::Q_BOX + (kk % 4) * 32, 16, 1024),
                           smem_desc(k_st + (kk / 4) * C::KV_BOX + (kk % 4) * 32, 16, 1024));
  wgmma_commit();
}

// O += P V for one panel, one wgmma group: P from registers, V's
// [128 keys x 64] boxes read MN-major (transposed), the D boxes KV_BOX
// apart (LBO), 8 key rows 1024 B apart (SBO), a 16-key step 2048 B.
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&pa)[8][4],
                                         uint32_t v_st) {
  using C = Sm90Attn<D>;
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < C::BKV / 16; ++kc)
    wgmma_pv<D>(o, pa[kc], smem_desc(v_st + kc * 2048, C::KV_BOX, 1024));
  wgmma_commit();
}

// Online softmax of one panel, in place (fp32). Scores are kept in base-2
// units, scaled by D^-0.5 * log2(e), so each weight is one exp2f of one
// FMA; that rounds differently from expf of the natural-unit score (a few
// fp32 ulp, far inside the bf16 gates). With `masked`, keys at or past a
// row's limit score NEG_INF first. m and l move on; corr is the factor the
// accumulator takes before this panel's P V; sc becomes the weights.
__device__ __forceinline__ void softmax_panel(float (&sc)[64], float (&m)[2], float (&l)[2],
                                              float (&corr)[2], bool masked, int k0,
                                              const int (&key_lim)[2], int tq, float scale_log2) {
  if (masked) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int key = k0 + 8 * (i / 4) + 2 * tq + (i & 1);
      if (key >= key_lim[(i >> 1) & 1]) sc[i] = NEG_INF;
    }
  }
  float mx[2] = {NEG_INF, NEG_INF}, lsum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * scale_log2);
    corr[r] = exp2f(m[r] - m_new);
    m[r] = m_new;
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = (i >> 1) & 1;
    sc[i] = exp2f(fmaf(sc[i], scale_log2, -m[r]));
    lsum[r] += sc[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + lsum[r];
}

// P rounded to bf16: the C fragment of S is the register A fragment of P
// (keys 16 kc .. 16 kc + 15 are score columns 2 kc and 2 kc + 1).
__device__ __forceinline__ void pack_p(uint32_t (&pa)[8][4], const float (&sc)[64]) {
#pragma unroll
  for (int kc = 0; kc < 8; ++kc) {
    pa[kc][0] = pack_bf16(sc[8 * kc], sc[8 * kc + 1]);
    pa[kc][1] = pack_bf16(sc[8 * kc + 2], sc[8 * kc + 3]);
    pa[kc][2] = pack_bf16(sc[8 * kc + 4], sc[8 * kc + 5]);
    pa[kc][3] = pack_bf16(sc[8 * kc + 6], sc[8 * kc + 7]);
  }
}

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], const float (&corr)[2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) o[i] *= corr[(i >> 1) & 1];
}

template <int D>
__global__ void __launch_bounds__(Sm90Attn<D>::THREADS, 1) opope_attention_kernel_sm90(
    const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v, const AttnParams p) {
  using C = Sm90Attn<D>;
  constexpr int BKV = C::BKV, STAGES = C::STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t q_bar;
  __shared__ __align__(8) uint64_t full_k[STAGES], full_v[STAGES];
  __shared__ __align__(8) uint64_t empty_k[STAGES], empty_v[STAGES];

  // 128-byte swizzle repeats every 1024 bytes: Q and every panel start on
  // that grid. Q, then the K stages, then the V stages.
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_s = q_s + C::Q_BYTES, v_s = k_s + STAGES * C::KV_BYTES;

  // Blocks walk the query tiles of one head before the next head, heaviest
  // causal tiles first, so the blocks in flight together share few heads'
  // K and V in L2.
  const int q_tiles = (p.s + C::BQ - 1) / C::BQ;
  const int bh = blockIdx.x / q_tiles;
  const int q0 = (q_tiles - 1 - blockIdx.x % q_tiles) * C::BQ;
  const int b = bh / p.heads, h = bh % p.heads;
  const int q_off = p.t - p.s;  // >= 0 when causal on this route
  const int n_panels = (p.t + BKV - 1) / BKV;
  const int last_row = min(q0 + C::BQ, p.s) - 1;
  // Panels [0, hi): up to the causal limit of the tile's last row.
  const int hi = p.causal ? min(n_panels, (last_row + q_off) / BKV + 1) : n_panels;

  if (threadIdx.x == 0) {
    mbar_init(smem_u32(&q_bar), 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&full_k[s]), 1);
      mbar_init(smem_u32(&full_v[s]), 1);
      mbar_init(smem_u32(&empty_k[s]), 8);  // one arrival per consumer warp
      mbar_init(smem_u32(&empty_v[s]), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= C::CONSUMERS) {
    // Producer warp: one thread issues every load; the rest retire.
    if (threadIdx.x == C::CONSUMERS) {
      const uint32_t qb = smem_u32(&q_bar);
      mbar_expect_tx(qb, C::Q_BYTES);  // whole boxes, zero-filled rows past S included
#pragma unroll
      for (int c = 0; c < C::BOXES; ++c)
        tma_load_4d(q_s + c * C::Q_BOX, &map_q, qb, 64 * c, q0, h, b);
      for (int i = 0; i < hi; ++i) {
        const int s = i % STAGES;
        const uint32_t parity = ((i / STAGES) & 1) ^ 1;
        const uint32_t fk = smem_u32(&full_k[s]), fv = smem_u32(&full_v[s]);
        mbar_wait(smem_u32(&empty_k[s]), parity);
        mbar_expect_tx(fk, C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < C::BOXES; ++c)
          tma_load_4d(k_s + s * C::KV_BYTES + c * C::KV_BOX, &map_k, fk, 64 * c, i * BKV, h, b);
        mbar_wait(smem_u32(&empty_v[s]), parity);
        mbar_expect_tx(fv, C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < C::BOXES; ++c)
          tma_load_4d(v_s + s * C::KV_BYTES + c * C::KV_BOX, &map_v, fv, 64 * c, i * BKV, h, b);
      }
    }
    return;
  }

  const int tc = threadIdx.x;  // consumer thread, 0 .. 255
  const int wg = tc / 128, warp = (tc % 128) / 32, lane = tc % 32, g = lane / 4, tq = lane % 4;
  const int wrow0 = q0 + wg * 64;          // this warpgroup's first row
  const int row0 = wrow0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  // Panels this warpgroup reads ([0, wg_hi)), and the fewest valid keys of
  // its rows: a panel reaching past that is the only one that needs a mask.
  int wg_hi = 0;
  if (wrow0 < p.s) {
    const int wlast = min(wrow0 + 63, p.s - 1);
    wg_hi = p.causal ? min(n_panels, (wlast + q_off) / BKV + 1) : n_panels;
  }
  const int wg_lim = p.causal ? min(wrow0 + q_off + 1, p.t) : p.t;
  int key_lim[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) key_lim[r] = p.causal ? min(row0 + 8 * r + q_off + 1, p.t) : p.t;

  const float scale_log2 = p.scale * 1.4426950408889634f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
  const uint32_t q_wg = q_s + wg * 64 * 128;

  // One product in flight at a time, and P made and used inside one
  // panel's step: S, O and P never hold registers together (O and S, 128,
  // are the most), so the compiler keeps each wgmma chain pipelined within
  // the 168 registers a thread gets (file comment). The two consumer
  // warpgroups run unsynchronised: one's softmax can overlap the other's
  // products.
  mbar_wait(smem_u32(&q_bar), 0);
  for (int jp = 0; jp < hi; ++jp) {
    const int s = jp % STAGES;
    const uint32_t parity = (jp / STAGES) & 1;
    if (jp >= wg_hi) {  // a panel wholly past this warpgroup's rows: released unread
      mbar_wait(smem_u32(&full_k[s]), parity);
      if (lane == 0) mbar_arrive(smem_u32(&empty_k[s]));
      mbar_wait(smem_u32(&full_v[s]), parity);
      if (lane == 0) mbar_arrive(smem_u32(&empty_v[s]));
      continue;
    }
    float sc[BKV / 2], corr[2];
    uint32_t pa[BKV / 16][4];
    mbar_wait(smem_u32(&full_k[s]), parity);
    issue_qk<D>(sc, q_wg, k_s + s * C::KV_BYTES);
    wgmma_wait<0>();
    fence_acc(sc);
    if (lane == 0) mbar_arrive(smem_u32(&empty_k[s]));

    softmax_panel(sc, m, l, corr, (jp + 1) * BKV > wg_lim, jp * BKV, key_lim, tq, scale_log2);
    rescale(o, corr);
    pack_p(pa, sc);

    mbar_wait(smem_u32(&full_v[s]), parity);
    issue_pv<D>(o, pa, v_s + s * C::KV_BYTES);
    wgmma_wait<0>();
    fence_acc(o);
#pragma unroll
    for (int kc = 0; kc < BKV / 16; ++kc) fence_regs(pa[kc]);
    if (lane == 0) mbar_arrive(smem_u32(&empty_v[s]));
  }

  // Writeback: acc / max(l, 1e-37), l summed over the quad, one cast.
  __nv_bfloat16* O = static_cast<__nv_bfloat16*>(p.o) + b * p.o_strides[0] +
                     static_cast<int64_t>(h) * p.o_strides[1];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lt = l[r];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const float denom = fmaxf(lt, 1e-37f);
    const int row = row0 + 8 * r;
    if (row >= p.s) continue;
    __nv_bfloat16* dst = O + row * p.o_strides[2];
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      store_pair(dst + dt * 8 + 2 * tq, o[4 * dt + 2 * r] / denom, o[4 * dt + 2 * r + 1] / denom);
  }
}

// A bf16 [B, H, rows, D] operand as TMA boxes of [128 rows x 64], 128-byte
// swizzled; rows past the operand's (of this head) fill zeros.
CUresult encode_map(CUtensorMap* map, const void* ptr, const uint64_t (&dims)[4],
                    const uint64_t (&strides)[3]) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return CUDA_ERROR_NOT_FOUND;
  const cuuint64_t gdims[4] = {dims[0], dims[1], dims[2], dims[3]};
  const cuuint64_t gstrides[3] = {strides[0], strides[1], strides[2]};
  const cuuint32_t box[4] = {64, 128, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), gdims, gstrides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int D>
int launch_sm90(const AttnParams& p, const AttnMaps& m, cudaStream_t stream) {
  using C = Sm90Attn<D>;
  CUtensorMap map_q, map_k, map_v;
  CUresult r = encode_map(&map_q, p.q, m.dims[0], m.strides[0]);
  if (r == CUDA_SUCCESS) r = encode_map(&map_k, p.k, m.dims[1], m.strides[1]);
  if (r == CUDA_SUCCESS) r = encode_map(&map_v, p.v, m.dims[2], m.strides[2]);
  if (r != CUDA_SUCCESS) return 1000 + static_cast<int>(r);
  // Above 48 KB of dynamic shared memory needs an opt-in, once per device.
  static bool opted_in[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && !opted_in[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        opope_attention_kernel_sm90<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in[dev] = true;
  }
  const int64_t blocks = static_cast<int64_t>((p.s + C::BQ - 1) / C::BQ) * p.batch_heads;
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidConfiguration);
  opope_attention_kernel_sm90<D><<<static_cast<unsigned>(blocks), C::THREADS, C::SMEM, stream>>>(
      map_q, map_k, map_v, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry: launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int opope_attention_launch(const AttnParams* p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->d < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (p->dtype) {
    case DT_F32: return launch_dim<float>(*p, s);
    case DT_BF16: return launch_dim<__nv_bfloat16>(*p, s);
    case DT_F16:
    case DT_E4M3:
    case DT_E5M2: return launch_dim<__half>(*p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// C entry of the sm90 route (bf16, head dim 64 or 128, every operand one
// that a TMA tensor map describes, no causal call with S > T): returns 0
// when launched, a CUDA runtime error code, or 1000 + the driver's error
// code when a tensor map could not be encoded.
extern "C" int opope_attention_sm90_launch(const AttnParams* p, const AttnMaps* m, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->dtype != DT_BF16 || (p->causal && p->s > p->t))
    return static_cast<int>(cudaErrorInvalidValue);
  if (p->d == 64) return launch_sm90<64>(*p, *m, s);
  if (p->d == 128) return launch_sm90<128>(*p, *m, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
