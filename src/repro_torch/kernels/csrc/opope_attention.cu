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
// Design: the TPU grid (q blocks, kv panels) becomes one block per
// (b*h, 64-query tile), heaviest causal tiles first, and a loop over
// 64-key K/V panels inside the block, staged through two shared-memory
// buffers by cp.async so panel j+1 arrives while panel j is consumed.
// Panels past the causal limit of the tile's last row are skipped, as the
// TPU kernel skips dead panels with pl.when. Each of the 4 warps owns 16
// query rows; its m, l and acc stay in registers for the whole loop (the
// O-POPE output-stationary accumulator).
//   bf16: Q fragments are loaded once into registers (ldmatrix); S = Q K^T
//   and acc += P V run on mma.sync m16n8k16 bf16 x bf16 -> fp32, with P
//   rounded to bf16 in registers (the C fragment of S is the A fragment of
//   P) and V read with ldmatrix.trans.
//   fp32: the same tiles and fragment layout on CUDA-core FMAs, never TF32;
//   P goes through a per-warp shared buffer.
//
// What bounds it on the card: at prefill widths the 4*S*T*D flops (halved
// by causality) against 989 TFLOP/s bf16; mma.sync reaches a fraction of
// that rate (wgmma, TMA and warp specialisation are later work). A single
// decode row (S = 1) is bound by reading K and V, and a 64-row tile wastes
// 63 of its rows there; a decode-width split over T is later work too.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled when `full` is false.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
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
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
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

}  // namespace

// C entry: launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int opope_attention_launch(const AttnParams* p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->dtype == DT_BF16) return launch_dim<__nv_bfloat16>(*p, s);
  if (p->dtype == DT_F32) return launch_dim<float>(*p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
