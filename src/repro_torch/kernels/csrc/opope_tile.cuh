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
// bf16 x bf16 -> fp32) consume the current one. Ragged M/N/K edges are
// masked here, so no caller pads.
//
// fp32 inputs run the same tiles and accumulator layout with CUDA-core FMAs
// (full fp32, never TF32), so the epilogue and writeback are shared.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int THREADS = 128;  // 4 warps in a 2 x 2 grid, 32 x 32 each
constexpr int MAX_STEPS = 8;

// dtype codes (kernels/opope_gemm.py::_DTYPE_CODES)
enum : int { DT_F32 = 0, DT_BF16 = 1, DT_F16 = 2, DT_I8 = 3 };

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

__device__ __forceinline__ float load_as_float(const void* p, int dtype, int64_t i) {
  switch (dtype) {
    case DT_BF16: return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
    case DT_F16: return __half2float(static_cast<const __half*>(p)[i]);
    default: return static_cast<const float*>(p)[i];
  }
}

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

// Input panel staging. Tin is __nv_bfloat16 or float; a vector is 16 bytes.
template <typename Tin>
struct Stage {
  static constexpr int VEC = 16 / sizeof(Tin);
  static constexpr int A_VECS = BM * BK / VEC / THREADS;  // per thread
  static constexpr int B_VECS = BK * BN / VEC / THREADS;
  static constexpr int A_LD = BK + 8;  // padded row strides (elements)
  static constexpr int B_LD = BN + 8;
  uint4 a[A_VECS];
  uint4 b[B_VECS];
};

// Fetch one K panel of A (BM x BK) and B (BK x BN) into registers, masking
// the ragged edge. `vec_a`/`vec_b` say whether 16-byte loads are legal
// (row stride a multiple of the vector and the base aligned); then a vector
// is either wholly inside or wholly outside the matrix.
template <typename Tin>
__device__ __forceinline__ void fetch_panel(
    Stage<Tin>& st, const Tin* __restrict__ A, const Tin* __restrict__ B,
    int M, int N, int K, int m0, int n0, int k0, bool vec_a, bool vec_b) {
  constexpr int VEC = Stage<Tin>::VEC;
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < Stage<Tin>::A_VECS; ++i) {
    const int v = tid + i * THREADS;
    const int r = v / (BK / VEC), c = (v % (BK / VEC)) * VEC;
    const int gr = m0 + r, gc = k0 + c;
    alignas(16) Tin tmp[VEC];
    if (vec_a) {
      if (gr < M && gc < K) {
        *reinterpret_cast<uint4*>(tmp) =
            *reinterpret_cast<const uint4*>(A + (int64_t)gr * K + gc);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) tmp[e] = Tin(0.0f);
      }
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        tmp[e] = (gr < M && gc + e < K) ? A[(int64_t)gr * K + gc + e] : Tin(0.0f);
    }
    st.a[i] = *reinterpret_cast<uint4*>(tmp);
  }
#pragma unroll
  for (int i = 0; i < Stage<Tin>::B_VECS; ++i) {
    const int v = tid + i * THREADS;
    const int r = v / (BN / VEC), c = (v % (BN / VEC)) * VEC;
    const int gr = k0 + r, gc = n0 + c;
    alignas(16) Tin tmp[VEC];
    if (vec_b) {
      if (gr < K && gc < N) {
        *reinterpret_cast<uint4*>(tmp) =
            *reinterpret_cast<const uint4*>(B + (int64_t)gr * N + gc);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) tmp[e] = Tin(0.0f);
      }
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        tmp[e] = (gr < K && gc + e < N) ? B[(int64_t)gr * N + gc + e] : Tin(0.0f);
    }
    st.b[i] = *reinterpret_cast<uint4*>(tmp);
  }
}

// Row strides are padded so every 16-byte vector lands 16-byte aligned.
template <typename Tin>
__device__ __forceinline__ void store_panel(const Stage<Tin>& st, Tin* As, Tin* Bs) {
  constexpr int VEC = Stage<Tin>::VEC;
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < Stage<Tin>::A_VECS; ++i) {
    const int v = tid + i * THREADS;
    const int r = v / (BK / VEC), c = (v % (BK / VEC)) * VEC;
    *reinterpret_cast<uint4*>(As + r * Stage<Tin>::A_LD + c) = st.a[i];
  }
#pragma unroll
  for (int i = 0; i < Stage<Tin>::B_VECS; ++i) {
    const int v = tid + i * THREADS;
    const int r = v / (BN / VEC), c = (v % (BN / VEC)) * VEC;
    *reinterpret_cast<uint4*>(Bs + r * Stage<Tin>::B_LD + c) = st.b[i];
  }
}

// Accumulator layout (the m16n8 mma C fragment, reused by the fp32 path):
// acc[mi][ni][j] holds row  wm*32 + mi*16 + g + 8*(j >= 2)
//                     col  wn*32 + ni*8 + 2*t + (j & 1)
// with g = lane / 4, t = lane % 4.
__device__ __forceinline__ void mma_panel(
    float (&acc)[2][4][4], const __nv_bfloat16* As, const __nv_bfloat16* Bs,
    int wm, int wn, int g, int t) {
  constexpr int A_LD = Stage<__nv_bfloat16>::A_LD;
  constexpr int B_LD = Stage<__nv_bfloat16>::B_LD;
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
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        float* d = acc[mi][ni];
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
            : "r"(af[mi][0]), "r"(af[mi][1]), "r"(af[mi][2]), "r"(af[mi][3]),
              "r"(bf[ni][0]), "r"(bf[ni][1]));
      }
    }
  }
}

__device__ __forceinline__ void mma_panel(
    float (&acc)[2][4][4], const float* As, const float* Bs,
    int wm, int wn, int g, int t) {
  constexpr int A_LD = Stage<float>::A_LD;
  constexpr int B_LD = Stage<float>::B_LD;
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
}

// One BM x BN output tile of one GEMM, the whole of a block's work. A and B
// point at this GEMM's operands; `g_mn` and `g_n` are the element offsets of
// its output tile and of its row in the output, the full and row operands
// (0 for a single GEMM; g*M*N and g*N for group g of a grouped one).
template <typename Tin>
__device__ __forceinline__ void opope_tile(
    const Tin* __restrict__ A, const Tin* __restrict__ B, void* __restrict__ O,
    int M, int N, int K, const void* C, int c_kind, int c_dtype, int o_dtype,
    bool vec_a, bool vec_b, OpopeEpilogue ep, int64_t g_mn, int64_t g_n) {
  __shared__ __align__(16) Tin As[2][BM * Stage<Tin>::A_LD];
  __shared__ __align__(16) Tin Bs[2][BK * Stage<Tin>::B_LD];

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
  Stage<Tin> st;
  fetch_panel(st, A, B, M, N, K, m0, n0, 0, vec_a, vec_b);
  store_panel(st, As[0], Bs[0]);
  __syncthreads();
  for (int kt = 0; kt < k_tiles; ++kt) {
    const bool more = kt + 1 < k_tiles;
    if (more) fetch_panel(st, A, B, M, N, K, m0, n0, (kt + 1) * BK, vec_a, vec_b);
    mma_panel(acc, As[kt & 1], Bs[kt & 1], wm, wn, g, t);
    if (more) store_panel(st, As[(kt + 1) & 1], Bs[(kt + 1) & 1]);
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
        switch (o_dtype) {
          case DT_BF16: static_cast<__nv_bfloat16*>(O)[idx] = __float2bfloat16_rn(x); break;
          case DT_F16: static_cast<__half*>(O)[idx] = __float2half_rn(x); break;
          // int8 only behind requant_int8: x is an exact integer in [-127, 127].
          case DT_I8: static_cast<int8_t*>(O)[idx] = static_cast<int8_t>(x); break;
          default: static_cast<float*>(O)[idx] = x; break;
        }
      }
}

}  // namespace
