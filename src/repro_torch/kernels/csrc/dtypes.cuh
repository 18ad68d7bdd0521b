// The dtypes the port's kernels take and write, shared by opope_tile.cuh
// (K1, K4 and, through it, K2 and K5), opope_scan.cu (K6) and
// opope_attention.cu (K3): the dtype codes, exact widening of every input
// type to fp32, rounding fp32 to a compute type, and the single final cast.
//
// The final cast follows the reference's (ml_dtypes') rule: round to
// nearest even; fp16, bf16 and e5m2 overflow to infinity; e4m3, which has
// no infinity, gives NaN past 448 where the hardware's saturating convert
// would give 448 (store_out; kernels/epilogue.py::cast_out is its plain
// version).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// dtype codes (kernels/opope_gemm.py::_DTYPE_CODES)
enum : int { DT_F32 = 0, DT_BF16 = 1, DT_F16 = 2, DT_I8 = 3, DT_E4M3 = 4, DT_E5M2 = 5 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_float(__nv_fp8_e4m3 x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_float(__nv_fp8_e5m2 x) { return static_cast<float>(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float x) { return __float2half_rn(x); }

__device__ __forceinline__ int dtype_size(int dtype) {
  switch (dtype) {
    case DT_BF16:
    case DT_F16: return 2;
    case DT_I8:
    case DT_E4M3:
    case DT_E5M2: return 1;
    default: return 4;
  }
}

__device__ __forceinline__ float load_as_float(const void* p, int dtype, int64_t i) {
  switch (dtype) {
    case DT_BF16: return to_float(static_cast<const __nv_bfloat16*>(p)[i]);
    case DT_F16: return to_float(static_cast<const __half*>(p)[i]);
    case DT_E4M3: return to_float(static_cast<const __nv_fp8_e4m3*>(p)[i]);
    case DT_E5M2: return to_float(static_cast<const __nv_fp8_e5m2*>(p)[i]);
    default: return static_cast<const float*>(p)[i];
  }
}

// fp32 -> e4m3 / e5m2 bits by the reference's rule: round to nearest even;
// past the largest finite value's tie with the next step (464 for e4m3,
// 61440 for e5m2) e4m3 gives NaN (0x7F) and e5m2 infinity; NaN stays NaN.
// Inside those bounds the saturating hardware convert rounds the same.
__device__ __forceinline__ uint8_t f32_to_e4m3(float x) {
  if (!(fabsf(x) <= 464.0f)) return 0x7F;
  return __nv_cvt_float_to_fp8(x, __NV_SATFINITE, __NV_E4M3);
}
__device__ __forceinline__ uint8_t f32_to_e5m2(float x) {
  if (isnan(x)) return 0x7F;
  if (!(fabsf(x) < 61440.0f)) return x > 0.0f ? 0x7C : 0xFC;
  return __nv_cvt_float_to_fp8(x, __NV_SATFINITE, __NV_E5M2);
}

// The single cast of one output element to `o_dtype` at element `i`.
__device__ __forceinline__ void store_out(void* O, int o_dtype, int64_t i, float x) {
  switch (o_dtype) {
    case DT_BF16: static_cast<__nv_bfloat16*>(O)[i] = __float2bfloat16_rn(x); break;
    case DT_F16: static_cast<__half*>(O)[i] = __float2half_rn(x); break;
    // int8 only behind requant_int8: x is an exact integer in [-127, 127].
    case DT_I8: static_cast<int8_t*>(O)[i] = static_cast<int8_t>(x); break;
    case DT_E4M3: static_cast<uint8_t*>(O)[i] = f32_to_e4m3(x); break;
    case DT_E5M2: static_cast<uint8_t*>(O)[i] = f32_to_e5m2(x); break;
    default: static_cast<float*>(O)[i] = x; break;
  }
}

// x rounded to e4m3 or e5m2 (`dtype`) and widened back, exactly.
__device__ __forceinline__ float round_fp8(float x, int dtype) {
  __nv_fp8_storage_t bits;
  if (dtype == DT_E4M3) {
    bits = f32_to_e4m3(x);
    return __half2float(__half(__nv_cvt_fp8_to_halfraw(bits, __NV_E4M3)));
  }
  bits = f32_to_e5m2(x);
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(bits, __NV_E5M2)));
}

}  // namespace
