// Shared device code of the int8 O-POPE GEMM kernels for Hopper (sm_90a):
// the tile routes of K2 (opope_q8.cu, one GEMM) and K5 (opope_q8_grouped.cu,
// one group a grid z index) both run `opope_q8_tile`, one BM x BN output
// tile per block, on the grid, warp layout and accumulator layout of
// opope_tile.cuh. Their sm90 routes (opope_q8_sm90.cuh) run their own main
// loop and finish, on the same per-element writeback helpers (q8_dequant,
// q8_add_c, q8_apply_op, q8_store).
//
// Dataflow, as on the TPU: output-stationary with an int32 accumulator. A
// block's int32 tile lives in registers for the whole K loop (int8 x int8
// products summed exactly: integer addition is associative, so every tiling
// gives the same bits), and is dequantized only at writeback:
//     x = float(acc) * (a_scale[row] * b_scale[col])  (+ C)  -> epilogue -> one cast
// with the scale product formed first, as in the reference. Each rounding is
// written with an explicit _rn intrinsic, so nvcc cannot contract the
// multiply and the C add into an FMA: the output equals the plain PyTorch
// version bit for bit wherever the chain holds no transcendental op.
//
// The K loop stages QBK = 64-byte panels of A (BM x 64, row-major) and B
// through two shared-memory buffers, the next panel fetched into registers
// while the tensor cores (mma.sync m16n8k32, s8 x s8 -> s32) consume the
// current one. The mma's B fragment wants 4 consecutive k of one column in
// a 32-bit register, while B arrives [K, N] row-major (n contiguous); each
// thread therefore fetches 4 x 4-byte blocks (4 k rows x 4 columns) and
// transposes them in registers with __byte_perm before the store, so B
// lies k-contiguous per column ("Bt") in shared memory and the caller's
// [K, N] layout needs no transposing copy. Ragged M/N/K edges are
// zero-filled (zero products add exactly nothing); scales of masked rows
// and columns are never read.

#pragma once

#include "opope_tile.cuh"

namespace {

constexpr int QBK = 64;                // K bytes per panel: two k32 mma steps
constexpr int Q_LD = QBK + 16;         // padded row stride (bytes) of As and Bt
constexpr int QA_VECS = BM * QBK / 16 / THREADS;          // 16-byte A vectors per thread
constexpr int QB_UNITS = (QBK / 4) * (BN / 4) / THREADS;  // 4x4-byte B blocks per thread

struct QStage {
  uint4 a[QA_VECS];
  uint32_t b[QB_UNITS][4];  // after the transpose: word j = 4 k of column 4*nq + j
};

// Fetch one K panel of A (BM x QBK) and B (QBK x BN) into registers,
// zero-filling the ragged edge. `vec_a`: K % 16 == 0 and A 16-byte aligned
// (whole uint4 vectors per row); `vec_b`: N % 4 == 0 and B 4-byte aligned.
__device__ __forceinline__ void q8_fetch_panel(
    QStage& st, const int8_t* __restrict__ A, const int8_t* __restrict__ B,
    int M, int N, int K, int m0, int n0, int k0, bool vec_a, bool vec_b) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < QA_VECS; ++i) {
    const int v = tid + i * THREADS;
    const int r = v / (QBK / 16), c = (v % (QBK / 16)) * 16;
    const int gr = m0 + r, gc = k0 + c;
    if (vec_a) {
      st.a[i] = (gr < M && gc < K)
                    ? *reinterpret_cast<const uint4*>(A + (int64_t)gr * K + gc)
                    : make_uint4(0u, 0u, 0u, 0u);
    } else {
      alignas(16) int8_t tmp[16];
#pragma unroll
      for (int e = 0; e < 16; ++e)
        tmp[e] = (gr < M && gc + e < K) ? A[(int64_t)gr * K + gc + e] : int8_t(0);
      st.a[i] = *reinterpret_cast<uint4*>(tmp);
    }
  }
#pragma unroll
  for (int i = 0; i < QB_UNITS; ++i) {
    const int u = tid + i * THREADS;
    const int kq = u / (BN / 4), nq = u % (BN / 4);
    const int gk = k0 + 4 * kq, gn = n0 + 4 * nq;
    uint32_t row[4];  // row[j]: columns gn..gn+3 of k row gk + j
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = gk + j;
      if (vec_b) {
        row[j] = (k < K && gn < N)
                     ? *reinterpret_cast<const uint32_t*>(B + (int64_t)k * N + gn)
                     : 0u;
      } else {
        uint32_t w = 0u;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k < K && gn + e < N)
            w |= uint32_t(uint8_t(B[(int64_t)k * N + gn + e])) << (8 * e);
        row[j] = w;
      }
    }
    // 4x4 byte transpose: byte e of word j <- byte j of row[e].
    const uint32_t t0 = __byte_perm(row[0], row[1], 0x5140);
    const uint32_t t1 = __byte_perm(row[0], row[1], 0x7362);
    const uint32_t t2 = __byte_perm(row[2], row[3], 0x5140);
    const uint32_t t3 = __byte_perm(row[2], row[3], 0x7362);
    st.b[i][0] = __byte_perm(t0, t2, 0x5410);
    st.b[i][1] = __byte_perm(t0, t2, 0x7632);
    st.b[i][2] = __byte_perm(t1, t3, 0x5410);
    st.b[i][3] = __byte_perm(t1, t3, 0x7632);
  }
}

// As: [BM][Q_LD] row-major; Bt: [BN][Q_LD], k contiguous per column.
__device__ __forceinline__ void q8_store_panel(const QStage& st, int8_t* As, int8_t* Bt) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < QA_VECS; ++i) {
    const int v = tid + i * THREADS;
    const int r = v / (QBK / 16), c = (v % (QBK / 16)) * 16;
    *reinterpret_cast<uint4*>(As + r * Q_LD + c) = st.a[i];
  }
#pragma unroll
  for (int i = 0; i < QB_UNITS; ++i) {
    const int u = tid + i * THREADS;
    const int kq = u / (BN / 4), nq = u % (BN / 4);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<uint32_t*>(Bt + (4 * nq + j) * Q_LD + 4 * kq) = st.b[i][j];
  }
}

// acc[mi][ni][j] holds row wm*32 + mi*16 + g + 8*(j >= 2), col wn*32 + ni*8 +
// 2*t + (j & 1) (the m16n8 C fragment, as in opope_tile.cuh).
__device__ __forceinline__ void q8_mma_panel(
    int (&acc)[2][4][4], const int8_t* As, const int8_t* Bt, int wm, int wn, int g, int t) {
#pragma unroll
  for (int ks = 0; ks < QBK; ks += 32) {
    uint32_t af[2][4];
    uint32_t bf[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int r = wm * 32 + mi * 16 + g;
      const int c = ks + 4 * t;
      af[mi][0] = *reinterpret_cast<const uint32_t*>(As + r * Q_LD + c);
      af[mi][1] = *reinterpret_cast<const uint32_t*>(As + (r + 8) * Q_LD + c);
      af[mi][2] = *reinterpret_cast<const uint32_t*>(As + r * Q_LD + c + 16);
      af[mi][3] = *reinterpret_cast<const uint32_t*>(As + (r + 8) * Q_LD + c + 16);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int n = wn * 32 + ni * 8 + g;
      const int c = ks + 4 * t;
      bf[ni][0] = *reinterpret_cast<const uint32_t*>(Bt + n * Q_LD + c);
      bf[ni][1] = *reinterpret_cast<const uint32_t*>(Bt + n * Q_LD + c + 16);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        int* d = acc[mi][ni];
        asm volatile(
            "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
            : "r"(af[mi][0]), "r"(af[mi][1]), "r"(af[mi][2]), "r"(af[mi][3]),
              "r"(bf[ni][0]), "r"(bf[ni][1]));
      }
    }
  }
}

// The writeback arithmetic, element for element, shared by every int8 body
// (this tile body and the sm90 finish of K2 and K5), so they agree bit for
// bit.

// Dequantize: float(acc) * (sa * sb), the scale product formed first.
__device__ __forceinline__ float q8_dequant(int acc, float sa, float sb) {
  return __fmul_rn(__int2float_rn(acc), __fmul_rn(sa, sb));
}

// + C, rounded on its own.
__device__ __forceinline__ float q8_add_c(float x, float c) { return __fadd_rn(x, c); }

// One epilogue step: apply_op with every linear step rounded on its own (no
// FMA contraction across steps), so such chains match the plain version bit
// for bit.
__device__ __forceinline__ float q8_apply_op(int op, float x, float o) {
  switch (op) {
    case OP_BIAS:
    case OP_RESIDUAL: return __fadd_rn(x, o);
    case OP_MUL:
    case OP_SCALE: return __fmul_rn(x, o);
    case OP_REQUANT_INT8:  // clip(round_half_even(x / s), -127, 127)
      return fminf(fmaxf(rintf(__fdiv_rn(x, o)), -127.0f), 127.0f);
    default: return apply_op(op, x, o);
  }
}

// The one cast: O[idx] = x in the output's dtype.
__device__ __forceinline__ void q8_store(void* O, int o_dtype, int64_t idx, float x) {
  switch (o_dtype) {
    case DT_BF16: static_cast<__nv_bfloat16*>(O)[idx] = __float2bfloat16_rn(x); break;
    case DT_F16: static_cast<__half*>(O)[idx] = __float2half_rn(x); break;
    // int8 only behind requant_int8: x is an exact integer in [-127, 127].
    case DT_I8: static_cast<int8_t*>(O)[idx] = static_cast<int8_t>(x); break;
    default: static_cast<float*>(O)[idx] = x; break;
  }
}

// One BM x BN output tile of one int8 GEMM, the whole of a block's work. A,
// SA (row scales), B and SB (column scales) point at this GEMM's operands;
// `g_mn` and `g_n` are the element offsets of its output, full operands and
// rows (0 for K2; g*M*N and g*N for group g of K5).
__device__ __forceinline__ void opope_q8_tile(
    const int8_t* __restrict__ A, const float* __restrict__ SA,
    const int8_t* __restrict__ B, const float* __restrict__ SB, void* __restrict__ O,
    int M, int N, int K, const void* C, int c_kind, int c_dtype, int o_dtype,
    bool vec_a, bool vec_b, OpopeEpilogue ep, int64_t g_mn, int64_t g_n) {
  __shared__ __align__(16) int8_t As[2][BM * Q_LD];
  __shared__ __align__(16) int8_t Bt[2][BN * Q_LD];

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 2, wn = warp % 2, g = lane / 4, t = lane % 4;

  int acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0;

  // K loop: panel kt computes from buffer kt % 2 while panel kt + 1 is
  // fetched into registers; one barrier per panel.
  const int k_tiles = (K + QBK - 1) / QBK;
  QStage st;
  q8_fetch_panel(st, A, B, M, N, K, m0, n0, 0, vec_a, vec_b);
  q8_store_panel(st, As[0], Bt[0]);
  __syncthreads();
  for (int kt = 0; kt < k_tiles; ++kt) {
    const bool more = kt + 1 < k_tiles;
    if (more) q8_fetch_panel(st, A, B, M, N, K, m0, n0, (kt + 1) * QBK, vec_a, vec_b);
    q8_mma_panel(acc, As[kt & 1], Bt[kt & 1], wm, wn, g, t);
    if (more) q8_store_panel(st, As[(kt + 1) & 1], Bt[(kt + 1) & 1]);
    __syncthreads();
  }

  // Writeback: dequant, C, epilogue chain in fp32, one cast.
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = m0 + wm * 32 + mi * 16 + g + 8 * (j >> 1);
        const int c = n0 + wn * 32 + ni * 8 + 2 * t + (j & 1);
        if (r >= M || c >= N) continue;
        const int64_t idx = g_mn + (int64_t)r * N + c;
        float x = q8_dequant(acc[mi][ni][j], SA[r], SB[c]);
        if (c_kind != K_NONE)
          x = q8_add_c(x, load_as_float(C, c_dtype, c_kind == K_ROW ? g_n + c : idx));
        for (int s = 0; s < ep.n_steps; ++s) {
          float o = 0.0f;
          const int kind = ep.kind[s];
          if (kind == K_SCALAR) o = load_as_float(ep.ptr[s], ep.dtype[s], 0);
          else if (kind == K_ROW) o = load_as_float(ep.ptr[s], ep.dtype[s], g_n + c);
          else if (kind == K_FULL) o = load_as_float(ep.ptr[s], ep.dtype[s], idx);
          x = q8_apply_op(ep.op[s], x, o);
        }
        q8_store(O, o_dtype, idx, x);
      }
}

}  // namespace
