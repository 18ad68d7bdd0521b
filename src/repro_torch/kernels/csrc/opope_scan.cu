// State-resident linear scan for Hopper (sm_90a):
// h[t] = decay[t] * h[t-1] + update[t], h[-1] = 0, every state written in
// fp32; decay/update [S, D] row-major, each fp32, bf16, fp16, e4m3 or e5m2
// on its own, widened exactly to fp32 as it is loaded.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/opope_scan.py::opope_chunked_scan (body _scan_kernel),
// the mamba/xLSTM recurrence. On the TPU the state vector stays in VMEM
// across a sequential grid of chunk panels; here each thread owns one
// column d and keeps its state in a register for the whole of t, so no
// chunk boundary exists and the result cannot depend on the chunk length.
// Each step is one __fmaf_rn (a single rounding), as the reference's scan
// rounds on the CPU.
//
// What bounds it on the card: bytes. Every input element is read once and
// every state written once (12 bytes per element in fp32), against 2 flops
// per element. Neighbouring threads own neighbouring columns, so each warp's
// loads and stores of one step are coalesced rows; the next STEPS steps'
// inputs are loaded into registers before the current STEPS are computed,
// so 2 * STEPS loads per thread are in flight behind the dependent FMA
// chain. With D = 131072 columns (jamba's d_inner * d_state) that is 4096
// warps, ~31 resident per SM. A chunked two-pass variant for narrow D (few
// columns, long S) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dtypes.cuh"  // the dtype codes and exact widening to fp32

namespace {

constexpr int THREADS = 256;
constexpr int STEPS = 8;  // steps prefetched ahead of the FMA chain

template <typename TA, typename TB>
__device__ __forceinline__ void load_steps(float (&a)[STEPS], float (&b)[STEPS],
                                           const TA* __restrict__ pa,
                                           const TB* __restrict__ pb, int64_t t0,
                                           int64_t n, int64_t D) {
#pragma unroll
  for (int i = 0; i < STEPS; ++i) {
    if (i < n) {
      a[i] = to_float(pa[(t0 + i) * D]);
      b[i] = to_float(pb[(t0 + i) * D]);
    }
  }
}

template <typename TA, typename TB>
__global__ void __launch_bounds__(THREADS) opope_scan_kernel(
    const TA* __restrict__ A, const TB* __restrict__ B, float* __restrict__ O, int S,
    int D) {
  const int64_t d = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (d >= D) return;
  const TA* pa = A + d;
  const TB* pb = B + d;
  float* po = O + d;
  float a[STEPS], b[STEPS], na[STEPS], nb[STEPS];
  float h = 0.0f;
  load_steps(a, b, pa, pb, 0, S < STEPS ? S : STEPS, D);
  for (int64_t t0 = 0; t0 < S; t0 += STEPS) {
    const int64_t n = S - t0 < STEPS ? S - t0 : STEPS;
    const int64_t next = t0 + STEPS;
    if (next < S) load_steps(na, nb, pa, pb, next, S - next < STEPS ? S - next : STEPS, D);
#pragma unroll
    for (int i = 0; i < STEPS; ++i) {
      if (i < n) {
        h = __fmaf_rn(a[i], h, b[i]);
        po[(t0 + i) * (int64_t)D] = h;
      }
    }
#pragma unroll
    for (int i = 0; i < STEPS; ++i) {
      a[i] = na[i];
      b[i] = nb[i];
    }
  }
}

template <typename TA, typename TB>
int launch(const void* a, const void* b, float* o, int s, int d, cudaStream_t stream) {
  const int blocks = (d + THREADS - 1) / THREADS;
  opope_scan_kernel<TA, TB><<<blocks, THREADS, 0, stream>>>(
      static_cast<const TA*>(a), static_cast<const TB*>(b), o, s, d);
  return static_cast<int>(cudaGetLastError());
}

// The update's dtype, decay's already fixed as TA.
template <typename TA>
int launch_update(const void* a, const void* b, float* o, int s, int d, int update_dtype,
                  cudaStream_t stream) {
  switch (update_dtype) {
    case DT_F32: return launch<TA, float>(a, b, o, s, d, stream);
    case DT_BF16: return launch<TA, __nv_bfloat16>(a, b, o, s, d, stream);
    case DT_F16: return launch<TA, __half>(a, b, o, s, d, stream);
    case DT_E4M3: return launch<TA, __nv_fp8_e4m3>(a, b, o, s, d, stream);
    case DT_E5M2: return launch<TA, __nv_fp8_e5m2>(a, b, o, s, d, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C entry: launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int opope_scan_launch(const void* decay, const void* update, void* out, int s,
                                 int d, int decay_dtype, int update_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  switch (decay_dtype) {
    case DT_F32: return launch_update<float>(decay, update, o, s, d, update_dtype, st);
    case DT_BF16: return launch_update<__nv_bfloat16>(decay, update, o, s, d, update_dtype, st);
    case DT_F16: return launch_update<__half>(decay, update, o, s, d, update_dtype, st);
    case DT_E4M3: return launch_update<__nv_fp8_e4m3>(decay, update, o, s, d, update_dtype, st);
    case DT_E5M2: return launch_update<__nv_fp8_e5m2>(decay, update, o, s, d, update_dtype, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
