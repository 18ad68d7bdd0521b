// Shared device code of the O-POPE GEMM kernels for Hopper (sm_90a):
// opope_gemm.cu (one GEMM) and opope_grouped.cu (G GEMMs of one shape in one
// launch) both run `opope_tile`, one BM x BN output tile per block.
//
// Dataflow, as on the TPU: output-stationary. A block's fp32 accumulator
// lives in registers for the whole K loop (the paper's accumulator
// registers), is optionally preloaded from C (a full [M,N] tile or an [N]
// bias row), and is written to device memory exactly once, after the
// epilogue chain has run on it in fp32 and a single cast to the output type.
// The TPU grid's sequential k axis becomes a loop over BK-deep K panels
// inside the block, staged through two shared-memory buffers: the next panel
// is fetched into registers while the tensor cores (mma.sync m16n8k16,
// bf16 or fp16 in, fp32 accumulate) consume the current one. Ragged M/N/K
// edges are masked here, so no caller pads.
//
// A and B may be of any of fp32, bf16, fp16, e4m3 and e5m2, each its own.
// The block runs in the compute type Tc the host picks for the pair
// (kernels/opope_gemm.py::compute_dtype): the narrowest of fp16, bf16 and
// fp32 that holds both exactly. Each operand's panel comes into registers
// as it lies in memory and is widened to Tc as it is stored to shared
// memory, after the current panel's products: no widened copy exists in
// device memory, the loads stay in flight behind the tensor cores, and
// every product of two Tc values is exact in the fp32 accumulator.
// fp32 runs the same tiles and accumulator layout with CUDA-core FMAs
// (full fp32, never TF32), so the epilogue and writeback are shared.
//
// The final cast follows the reference's (ml_dtypes') rule: round to
// nearest even; fp16, bf16 and e5m2 overflow to infinity; e4m3, which has
// no infinity, gives NaN past 448 where the hardware's saturating convert
// would give 448 (store_out).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "dtypes.cuh"  // dtype codes, widening on load, the final cast

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int THREADS = 128;  // 4 warps in a 2 x 2 grid, 32 x 32 each
constexpr int MAX_STEPS = 8;

// epilogue op codes (kernels/epilogue.py::OP_CODES)
enum : int {
  OP_GELU = 0, OP_SILU = 1, OP_SWISH = 2, OP_RELU = 3, OP_BIAS = 4,
  OP_RESIDUAL = 5, OP_MUL = 6, OP_SCALE = 7, OP_REQUANT_INT8 = 8,
};

// operand kinds (kernels/epilogue.py::KIND_CODES)
enum : int { K_NONE = 0, K_SCALAR = 1, K_ROW = 2, K_FULL = 3 };

}  // namespace

// Must match kernels/opope_gemm.py::_Epilogue field for field.
struct OpopeEpilogue {
  int n_steps;
  int op[MAX_STEPS];
  int kind[MAX_STEPS];
  int dtype[MAX_STEPS];
  const void* ptr[MAX_STEPS];
};

namespace {

__device__ __forceinline__ float apply_op(int op, float x, float o) {
  switch (op) {
    case OP_GELU: {  // tanh approximation, as jax.nn.gelu's default
      const float c = 0.7978845608028654f;  // sqrt(2 / pi)
      return 0.5f * x * (1.0f + tanhf(c * (x + 0.044715f * x * x * x)));
    }
    case OP_SILU:
    case OP_SWISH: return x / (1.0f + expf(-x));
    case OP_RELU: return fmaxf(x, 0.0f);
    case OP_BIAS:
    case OP_RESIDUAL: return x + o;
    case OP_MUL:
    case OP_SCALE: return x * o;
    case OP_REQUANT_INT8:  // clip(round_half_even(x / s), -127, 127)
      return fminf(fmaxf(rintf(x / o), -127.0f), 127.0f);
    default: return x;
  }
}

// Input panel staging in the compute type Tc (__nv_bfloat16, __half or
// float); a vector is 16 bytes of Tc.
template <typename Tc>
struct Stage {
  static constexpr int VEC = 16 / sizeof(Tc);
  static constexpr int A_VECS = BM * BK / VEC / THREADS;  // per thread
  static constexpr int B_VECS = BK * BN / VEC / THREADS;
  static constexpr int A_LD = BK + 8;  // padded row strides (elements)
  static constexpr int B_LD = BN + 8;
  uint4 a[A_VECS];
  uint4 b[B_VECS];
};

// One vector of VEC = 16 / sizeof(Tc) consecutive elements of a Tin matrix
// at `p`, as they lie in memory: VEC * sizeof(Tin) bytes at the front of a
// uint4 (the rest zero); only the first `valid` lie inside the matrix (the
// rest are zero). `vec` says whether the vector may be read in one load
// (the row stride a multiple of VEC and the base 16-byte aligned): then p
// is aligned to VEC * sizeof(Tin) bytes and `valid` is VEC or 0. Nothing here uses the loaded
// value, so the load stays in flight while the tensor cores work on the
// current panel; `widen` converts it when it is stored.
template <typename Tc, typename Tin>
__device__ __forceinline__ uint4 load_raw(const Tin* __restrict__ p, int valid, bool vec) {
  constexpr int VEC = 16 / sizeof(Tc);
  constexpr int BYTES = VEC * sizeof(Tin);
  uint4 out = make_uint4(0, 0, 0, 0);
  if constexpr (BYTES > 16) {
    return out;  // a pair compute_dtype never makes (fp32 into a 2-byte type)
  } else if (vec) {
    // Whole vectors: each lies wholly inside the matrix or wholly outside.
    if (valid > 0) {
      if constexpr (BYTES == 16) {
        out = *reinterpret_cast<const uint4*>(p);
      } else if constexpr (BYTES == 8) {
        const uint2 v = *reinterpret_cast<const uint2*>(p);
        out.x = v.x;
        out.y = v.y;
      } else {
        static_assert(BYTES == 4, "a vector of VEC inputs is 4, 8 or 16 bytes");
        out.x = *reinterpret_cast<const uint32_t*>(p);
      }
    }
  } else {
    Tin* e = reinterpret_cast<Tin*>(&out);
#pragma unroll
    for (int u = 0; u < VEC; ++u)
      if (u < valid) e[u] = p[u];
  }
  return out;
}

// NV vectors of a ROWS x COLS panel of a Tin matrix (row stride `ld`) at
// (r0, c0), masked to `rows` x `cols`, raw (load_raw).
template <typename Tc, typename Tin, int ROWS, int COLS, int NV>
__device__ __forceinline__ void fetch_part(uint4 (&dst)[NV], const void* __restrict__ src,
                                           int64_t ld, int rows, int cols, int r0, int c0,
                                           bool vec) {
  constexpr int VEC = 16 / sizeof(Tc);
  const Tin* base = static_cast<const Tin*>(src);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int v = threadIdx.x + i * THREADS;
    const int gr = r0 + v / (COLS / VEC), gc = c0 + (v % (COLS / VEC)) * VEC;
    const int valid = gr < rows ? max(0, min(VEC, cols - gc)) : 0;
    dst[i] = load_raw<Tc>(base + (valid > 0 ? gr * ld + gc : 0), valid, vec);
  }
}

template <typename Tc, int ROWS, int COLS, int NV>
__device__ __forceinline__ void fetch_any(uint4 (&dst)[NV], const void* __restrict__ src,
                                          int dtype, int64_t ld, int rows, int cols, int r0,
                                          int c0, bool vec) {
  switch (dtype) {
    case DT_BF16:
      fetch_part<Tc, __nv_bfloat16, ROWS, COLS>(dst, src, ld, rows, cols, r0, c0, vec); break;
    case DT_F16: fetch_part<Tc, __half, ROWS, COLS>(dst, src, ld, rows, cols, r0, c0, vec); break;
    case DT_E4M3:
      fetch_part<Tc, __nv_fp8_e4m3, ROWS, COLS>(dst, src, ld, rows, cols, r0, c0, vec); break;
    case DT_E5M2:
      fetch_part<Tc, __nv_fp8_e5m2, ROWS, COLS>(dst, src, ld, rows, cols, r0, c0, vec); break;
    default: fetch_part<Tc, float, ROWS, COLS>(dst, src, ld, rows, cols, r0, c0, vec); break;
  }
}

// Fetch one K panel of A (BM x BK) and B (BK x BN) into registers, raw,
// masking the ragged edge. SAME: both operands are already in Tc, so the
// loads are straight-line code with no dtype switch.
template <typename Tc, bool SAME>
__device__ __forceinline__ void fetch_panel(
    Stage<Tc>& st, const void* __restrict__ A, int a_dtype, const void* __restrict__ B,
    int b_dtype, int M, int N, int K, int m0, int n0, int k0, bool vec_a, bool vec_b) {
  if constexpr (SAME) {
    fetch_part<Tc, Tc, BM, BK>(st.a, A, K, M, K, m0, k0, vec_a);
    fetch_part<Tc, Tc, BK, BN>(st.b, B, N, K, N, k0, n0, vec_b);
  } else {
    fetch_any<Tc, BM, BK>(st.a, A, a_dtype, K, M, K, m0, k0, vec_a);
    fetch_any<Tc, BK, BN>(st.b, B, b_dtype, N, K, N, k0, n0, vec_b);
  }
}

// NV raw vectors of Tin (load_raw's layout) widened in place to Tc;
// exact, since Tc holds every Tin of its pair.
template <typename Tc, typename Tin, int NV>
__device__ __forceinline__ void widen_part(uint4 (&v)[NV]) {
  constexpr int VEC = 16 / sizeof(Tc);
  if constexpr (!std::is_same<Tc, Tin>::value && VEC * sizeof(Tin) <= 16) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const Tin* e = reinterpret_cast<const Tin*>(&v[i]);
      alignas(16) Tc out[VEC];
#pragma unroll
      for (int u = 0; u < VEC; ++u) out[u] = from_float<Tc>(to_float(e[u]));
      v[i] = *reinterpret_cast<const uint4*>(out);
    }
  }
}

template <typename Tc, int NV>
__device__ __forceinline__ void widen(uint4 (&v)[NV], int dtype) {
  switch (dtype) {
    case DT_BF16: widen_part<Tc, __nv_bfloat16>(v); break;
    case DT_F16: widen_part<Tc, __half>(v); break;
    case DT_E4M3: widen_part<Tc, __nv_fp8_e4m3>(v); break;
    case DT_E5M2: widen_part<Tc, __nv_fp8_e5m2>(v); break;
    default: widen_part<Tc, float>(v); break;
  }
}

// Widen a fetched panel to Tc and store it; row strides are padded so
// every 16-byte vector lands 16-byte aligned.
template <typename Tc, bool SAME>
__device__ __forceinline__ void store_panel(Stage<Tc>& st, int a_dtype, int b_dtype, Tc* As,
                                            Tc* Bs) {
  constexpr int VEC = Stage<Tc>::VEC;
  if constexpr (!SAME) {
    widen<Tc>(st.a, a_dtype);
    widen<Tc>(st.b, b_dtype);
  }
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < Stage<Tc>::A_VECS; ++i) {
    const int v = tid + i * THREADS;
    const int r = v / (BK / VEC), c = (v % (BK / VEC)) * VEC;
    *reinterpret_cast<uint4*>(As + r * Stage<Tc>::A_LD + c) = st.a[i];
  }
#pragma unroll
  for (int i = 0; i < Stage<Tc>::B_VECS; ++i) {
    const int v = tid + i * THREADS;
    const int r = v / (BN / VEC), c = (v % (BN / VEC)) * VEC;
    *reinterpret_cast<uint4*>(Bs + r * Stage<Tc>::B_LD + c) = st.b[i];
  }
}

// d += a (16x16, row) * b (16x8, col) on the tensor cores, fp32 accumulate:
// bf16 or fp16 inputs (the same fragment layout).
template <typename Tc>
__device__ __forceinline__ void mma_16816(float* d, const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  if constexpr (std::is_same<Tc, __half>::value) {
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

// Accumulator layout (the m16n8 mma C fragment, reused by the fp32 path):
// acc[mi][ni][j] holds row  wm*32 + mi*16 + g + 8*(j >= 2)
//                     col  wn*32 + ni*8 + 2*t + (j & 1)
// with g = lane / 4, t = lane % 4.
template <typename Tc>
__device__ __forceinline__ void mma_panel(
    float (&acc)[2][4][4], const Tc* As, const Tc* Bs, int wm, int wn, int g, int t) {
  constexpr int A_LD = Stage<Tc>::A_LD;
  constexpr int B_LD = Stage<Tc>::B_LD;
  if constexpr (std::is_same<Tc, float>::value) {
#pragma unroll 4
    for (int k = 0; k < BK; ++k) {
      float a[2][2], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        a[mi][0] = As[(wm * 32 + mi * 16 + g) * A_LD + k];
        a[mi][1] = As[(wm * 32 + mi * 16 + g + 8) * A_LD + k];
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        b[ni][0] = Bs[k * B_LD + wn * 32 + ni * 8 + 2 * t];
        b[ni][1] = Bs[k * B_LD + wn * 32 + ni * 8 + 2 * t + 1];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[mi][ni][j] = fmaf(a[mi][j >> 1], b[ni][j & 1], acc[mi][ni][j]);
    }
  } else {
    const uint16_t* Bh = reinterpret_cast<const uint16_t*>(Bs);
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t af[2][4];
      uint32_t bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm * 32 + mi * 16 + g;
        const int c = ks + 2 * t;
        af[mi][0] = *reinterpret_cast<const uint32_t*>(As + r * A_LD + c);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(As + (r + 8) * A_LD + c);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(As + r * A_LD + c + 8);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(As + (r + 8) * A_LD + c + 8);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = wn * 32 + ni * 8 + g;
        const int k = ks + 2 * t;
        bf[ni][0] = (uint32_t)Bh[k * B_LD + n] | ((uint32_t)Bh[(k + 1) * B_LD + n] << 16);
        bf[ni][1] = (uint32_t)Bh[(k + 8) * B_LD + n] | ((uint32_t)Bh[(k + 9) * B_LD + n] << 16);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_16816<Tc>(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
    }
  }
}

// One BM x BN output tile of one GEMM, the whole of a block's work, in
// compute type Tc. A and B point at this GEMM's operands (dtype codes
// a_dtype, b_dtype; SAME when both are Tc); `g_mn` and `g_n` are the
// element offsets of its output tile and of its row in the output, the
// full and row operands (0 for a single GEMM; g*M*N and g*N for group g of
// a grouped one).
template <typename Tc, bool SAME>
__device__ __forceinline__ void opope_tile(
    const void* __restrict__ A, int a_dtype, const void* __restrict__ B, int b_dtype,
    void* __restrict__ O, int M, int N, int K, const void* C, int c_kind, int c_dtype,
    int o_dtype, bool vec_a, bool vec_b, OpopeEpilogue ep, int64_t g_mn, int64_t g_n) {
  __shared__ __align__(16) Tc As[2][BM * Stage<Tc>::A_LD];
  __shared__ __align__(16) Tc Bs[2][BK * Stage<Tc>::B_LD];

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 2, wn = warp % 2, g = lane / 4, t = lane % 4;

  // Accumulator preload: zeros, the C tile, or the C bias row.
  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = m0 + wm * 32 + mi * 16 + g + 8 * (j >> 1);
        const int c = n0 + wn * 32 + ni * 8 + 2 * t + (j & 1);
        float v = 0.0f;
        if (c_kind != K_NONE && r < M && c < N)
          v = load_as_float(C, c_dtype, c_kind == K_ROW ? g_n + c : g_mn + (int64_t)r * N + c);
        acc[mi][ni][j] = v;
      }

  // K loop: panel kt computes from shared buffer kt % 2 while panel kt + 1
  // is fetched into registers; one barrier per panel.
  const int k_tiles = (K + BK - 1) / BK;
  Stage<Tc> st;
  fetch_panel<Tc, SAME>(st, A, a_dtype, B, b_dtype, M, N, K, m0, n0, 0, vec_a, vec_b);
  store_panel<Tc, SAME>(st, a_dtype, b_dtype, As[0], Bs[0]);
  __syncthreads();
  for (int kt = 0; kt < k_tiles; ++kt) {
    const bool more = kt + 1 < k_tiles;
    if (more)
      fetch_panel<Tc, SAME>(st, A, a_dtype, B, b_dtype, M, N, K, m0, n0, (kt + 1) * BK, vec_a,
                            vec_b);
    mma_panel<Tc>(acc, As[kt & 1], Bs[kt & 1], wm, wn, g, t);
    if (more) store_panel<Tc, SAME>(st, a_dtype, b_dtype, As[(kt + 1) & 1], Bs[(kt + 1) & 1]);
    __syncthreads();
  }

  // Writeback: epilogue chain on the fp32 accumulator, then one cast.
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
        float x = acc[mi][ni][j];
        for (int s = 0; s < ep.n_steps; ++s) {
          float o = 0.0f;
          const int kind = ep.kind[s];
          if (kind == K_SCALAR) o = load_as_float(ep.ptr[s], ep.dtype[s], 0);
          else if (kind == K_ROW) o = load_as_float(ep.ptr[s], ep.dtype[s], g_n + c);
          else if (kind == K_FULL) o = load_as_float(ep.ptr[s], ep.dtype[s], idx);
          x = apply_op(ep.op[s], x, o);
        }
        store_out(O, o_dtype, idx, x);
      }
}

}  // namespace
