// Flash attention for Hopper (sm_90a), one launch over every (batch, head):
// out[b,h] = softmax(q[b,h] k[b,h]^T * D^-0.5, masked) v[b,h], q [S, D],
// k/v [T, D], bf16 or fp32, head dim D in {16, 32, 64, 128}.
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
// * tile (fp32, which wgmma would run as TF32; head dims 16 and 32; causal
//   calls with S > T, whose rows without a valid key follow the reference's
//   block sizes; operands TMA cannot describe): one block per (b*h, 64-query
//   tile), 64-key panels double-buffered by cp.async, each of 4 warps owning
//   16 rows, their m, l and acc in registers for the whole loop (the O-POPE
//   output-stationary accumulator).
//     bf16: Q fragments loaded once (ldmatrix); S = Q K^T and acc += P V on
//     mma.sync m16n8k16, P rounded to bf16 in registers, V by
//     ldmatrix.trans.
//     fp32: the same tiles and fragment layout on CUDA-core FMAs, never TF32;
//     P goes through a per-warp shared buffer.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"  // mbarriers, TMA, wgmma descriptors and instructions, the map encoder

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

enum : int { DT_F32 = 0, DT_BF16 = 1 };  // kernels/opope_attention.py::_DTYPE_CODES

// Shared-memory row stride (elements): rows stay 16-byte aligned, and the
// 8 rows of an ldmatrix (or of a quad's float4 reads) fall on distinct banks.
template <typename T, int D>
__host__ __device__ constexpr int row_ld() { return sizeof(T) == 4 ? D + 4 : D + 8; }

template <typename T, int D>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(BQ + 4 * BKV) * row_ld<T, D>() * sizeof(T) +
         (sizeof(T) == 4 ? 4 * 16 * PLD * sizeof(float) : 0);
}

// 16 bytes global -> shared; zero-filled when `full` is false.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 64 rows of D elements, rows row0.. of a [rows, D] matrix with stride
// `ld_g`, into shared memory; rows at or past `n_rows` are zero.
template <typename T, int D>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int64_t ld_g, int row0,
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
               ok ? src + static_cast<int64_t>(row0 + r) * ld_g + col : src, ok);
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

// d += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

// S = Q K^T for one panel, bf16 tensor cores.
template <int D>
__device__ __forceinline__ void scores(float (&sc)[8][4], const uint32_t (&qf)[D / 16][4],
                                       const __nv_bfloat16* Ks, int lane) {
  constexpr int LD = row_ld<__nv_bfloat16, D>();
  const int i = lane / 8, r = lane % 8;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
#pragma unroll
    for (int ntp = 0; ntp < 4; ++ntp) {
      uint32_t b[4];  // b0, b1 of key tiles 2*ntp and 2*ntp + 1
      ldmatrix_x4(b, Ks + ((2 * ntp + (i >> 1)) * 8 + r) * LD + kc * 16 + (i & 1) * 8);
      mma_bf16(sc[2 * ntp], qf[kc], b[0], b[1]);
      mma_bf16(sc[2 * ntp + 1], qf[kc], b[2], b[3]);
    }
  }
}

// S = Q K^T for one panel, fp32 on CUDA cores (Q read from shared memory).
template <int D>
__device__ __forceinline__ void scores(float (&sc)[8][4], const float* Qs, const float* Ks,
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

// acc += P V for one panel, bf16 tensor cores; P rounded to bf16.
template <int D>
__device__ __forceinline__ void accumulate_pv(float (&o)[D / 8][4], const float (&sc)[8][4],
                                              const __nv_bfloat16* Vs, int lane) {
  constexpr int LD = row_ld<__nv_bfloat16, D>();
  const int i = lane / 8, r = lane % 8;
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {  // 16 keys: score tiles 2*kc, 2*kc + 1
    const uint32_t a[4] = {pack_bf16(sc[2 * kc][0], sc[2 * kc][1]),
                           pack_bf16(sc[2 * kc][2], sc[2 * kc][3]),
                           pack_bf16(sc[2 * kc + 1][0], sc[2 * kc + 1][1]),
                           pack_bf16(sc[2 * kc + 1][2], sc[2 * kc + 1][3])};
#pragma unroll
    for (int dtp = 0; dtp < D / 16; ++dtp) {
      uint32_t b[4];  // b0, b1 of column tiles 2*dtp and 2*dtp + 1
      ldmatrix_x4_trans(b, Vs + (kc * 16 + (i & 1) * 8 + r) * LD + (2 * dtp + (i >> 1)) * 8);
      mma_bf16(o[2 * dtp], a, b[0], b[1]);
      mma_bf16(o[2 * dtp + 1], a, b[2], b[3]);
    }
  }
}

// acc += P V for one panel, fp32 on CUDA cores through the warp's P buffer.
template <int D>
__device__ __forceinline__ void accumulate_pv(float (&o)[D / 8][4], const float (&sc)[8][4],
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
__device__ __forceinline__ void store_pair(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) opope_attention_kernel(const AttnParams p) {
  constexpr int LD = row_ld<T, D>();
  constexpr bool TC = sizeof(T) == 2;  // bf16: tensor cores
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + BQ * LD;        // [2][BKV][LD]
  T* Vs = Ks + 2 * BKV * LD;   // [2][BKV][LD]
  float* Ps = reinterpret_cast<float*>(Vs + 2 * BKV * LD);  // fp32 path: [4][16][PLD]

  const int bh = blockIdx.x;
  const int64_t b = bh / p.heads, h = bh % p.heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest causal tiles first
  const T* Q = static_cast<const T*>(p.q) + b * p.q_strides[0] + h * p.q_strides[1];
  const T* K = static_cast<const T*>(p.k) + b * p.k_strides[0] + h * p.k_strides[1];
  const T* V = static_cast<const T*>(p.v) + b * p.v_strides[0] + h * p.v_strides[1];
  T* O = static_cast<T*>(p.o) + b * p.o_strides[0] + h * p.o_strides[1];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  const int q_off = p.t - p.s;

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

  load_rows<T, D>(Qs, Q, p.q_strides[2], q0, p.s);
  cp_async_commit();
  if (hi > 0) {
    load_rows<T, D>(Ks, K, p.k_strides[2], 0, p.t);
    load_rows<T, D>(Vs, V, p.v_strides[2], 0, p.t);
    cp_async_commit();
  }

  for (int jp = 0; jp < hi; ++jp) {
    const int stage = jp & 1;
    if (jp + 1 < hi) {
      load_rows<T, D>(Ks + (stage ^ 1) * BKV * LD, K, p.k_strides[2], (jp + 1) * BKV, p.t);
      load_rows<T, D>(Vs + (stage ^ 1) * BKV * LD, V, p.v_strides[2], (jp + 1) * BKV, p.t);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* Kst = Ks + stage * BKV * LD;
    const T* Vst = Vs + stage * BKV * LD;

    float sc[8][4];
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
      scores<D>(sc, qf, Kst, lane);
    } else {
      scores<D>(sc, Qs, Kst, warp, g, tq);
    }

    // Online softmax over the panel (fp32, expf).
    const int k0 = jp * BKV;
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = j >> 1;
        const int key = k0 + nt * 8 + 2 * tq + (j & 1);
        const float x = no_key[r] ? 0.0f : sc[nt][j] * p.scale;
        sc[nt][j] = key < key_lim[r] ? x : NEG_INF;
        mx[r] = fmaxf(mx[r], sc[nt][j]);
      }
    float corr[2], lsum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
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

    if constexpr (TC) {
      accumulate_pv<D>(o, sc, Vst, lane);
    } else {
      accumulate_pv<D>(o, sc, Vst, Ps + warp * 16 * PLD, g, tq);
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();

  // Writeback: acc / max(l, 1e-37) (l summed over the quad), or / L.
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
    T* dst = O + row[r] * p.o_strides[2];
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const float a = zero ? 0.0f : o[dt][2 * r] / denom;
      const float c = zero ? 0.0f : o[dt][2 * r + 1] / denom;
      store_pair(dst + dt * 8 + 2 * tq, a, c);
    }
  }
}

template <typename T, int D>
int launch(const AttnParams& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, D>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        opope_attention_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid(p.batch_heads, (p.s + BQ - 1) / BQ);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  opope_attention_kernel<T, D><<<grid, THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dim(const AttnParams& p, cudaStream_t stream) {
  switch (p.d) {
    case 16: return launch<T, 16>(p, stream);
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
  if (p->dtype == DT_BF16) return launch_dim<__nv_bfloat16>(*p, s);
  if (p->dtype == DT_F32) return launch_dim<float>(*p, s);
  return static_cast<int>(cudaErrorInvalidValue);
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
