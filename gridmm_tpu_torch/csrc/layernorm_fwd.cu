// LayerNorm forward for Hopper (sm_90a): f32 statistics, one warp per row.
//
// Replaces the TPU kernel `_ln_kernel` in gridmm_tpu/ops/pallas/layernorm.py:24
// (wrapper fused_layernorm :36). For every row r of x (rows, C):
//     m    = mean(x[r])                          f32
//     v    = mean((x[r] - m)^2)                  f32, centred form
//     y[r] = (x[r] - m) * rsqrt(v + eps) * scale + bias, written in x.dtype
//
// Bound: bytes. One read and one write of x against ~8 flops per element; at
// the CLIP B/32 encode shape (9600 x 768 bf16) that is 29.5 MB, ~8.8 us at
// 3.35 TB/s. The design keeps x to that one read and one write:
//   * one warp per row, 8 rows per 256-thread block; lane l owns columns
//     l, l + 32, ..., so every warp-wide load or store touches 32 consecutive
//     elements;
//   * for C <= 1024 the row stays in registers (kPer values per lane, a
//     template constant): the mean, the centred variance and the output all
//     come from one read;
//   * sums are warp shuffles: no shared memory, no block barrier;
//   * any C works (the Pallas wrapper needs C % 128 == 0 for its lane tiles);
//     above 1024 a loop variant reads the row three times, the second and
//     third reads served by L1/L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // rows per block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int kPer>
__global__ void __launch_bounds__(32 * kWarps)
layernorm_reg_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                     const float* __restrict__ bias, T* __restrict__ y,
                     int rows, int c, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const T* xr = x + (size_t)row * c;
  T* yr = y + (size_t)row * c;
  float v[kPer];
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int col = lane + 32 * k;
    v[k] = col < c ? to_f32(xr[col]) : 0.f;
    s += v[k];
  }
  const float mean = warp_sum(s) / (float)c;
  float q = 0.f;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int col = lane + 32 * k;
    const float d = col < c ? v[k] - mean : 0.f;
    q += d * d;
  }
  const float rstd = rsqrtf(warp_sum(q) / (float)c + eps);
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int col = lane + 32 * k;
    if (col < c) store(&yr[col], (v[k] - mean) * rstd * scale[col] + bias[col]);
  }
}

template <typename T>
__global__ void __launch_bounds__(32 * kWarps)
layernorm_loop_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                      const float* __restrict__ bias, T* __restrict__ y,
                      int rows, int c, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + (size_t)row * c;
  T* yr = y + (size_t)row * c;
  float s = 0.f;
  for (int col = lane; col < c; col += 32) s += to_f32(xr[col]);
  const float mean = warp_sum(s) / (float)c;
  float q = 0.f;
  for (int col = lane; col < c; col += 32) {
    const float d = to_f32(xr[col]) - mean;
    q += d * d;
  }
  const float rstd = rsqrtf(warp_sum(q) / (float)c + eps);
  for (int col = lane; col < c; col += 32) {
    store(&yr[col], (to_f32(xr[col]) - mean) * rstd * scale[col] + bias[col]);
  }
}

template <typename T>
int launch(const void* xv, const float* scale, const float* bias, void* yv,
           int rows, int c, float eps, cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  T* y = static_cast<T*>(yv);
  const dim3 grid((rows + kWarps - 1) / kWarps);
  const dim3 block(32 * kWarps);
  const int per = (c + 31) / 32;
  if (per <= 1) {
    layernorm_reg_kernel<T, 1><<<grid, block, 0, s>>>(x, scale, bias, y, rows, c, eps);
  } else if (per <= 2) {
    layernorm_reg_kernel<T, 2><<<grid, block, 0, s>>>(x, scale, bias, y, rows, c, eps);
  } else if (per <= 4) {
    layernorm_reg_kernel<T, 4><<<grid, block, 0, s>>>(x, scale, bias, y, rows, c, eps);
  } else if (per <= 8) {
    layernorm_reg_kernel<T, 8><<<grid, block, 0, s>>>(x, scale, bias, y, rows, c, eps);
  } else if (per <= 16) {
    layernorm_reg_kernel<T, 16><<<grid, block, 0, s>>>(x, scale, bias, y, rows, c, eps);
  } else if (per <= 24) {
    layernorm_reg_kernel<T, 24><<<grid, block, 0, s>>>(x, scale, bias, y, rows, c, eps);
  } else if (per <= 32) {
    layernorm_reg_kernel<T, 32><<<grid, block, 0, s>>>(x, scale, bias, y, rows, c, eps);
  } else {
    layernorm_loop_kernel<T><<<grid, block, 0, s>>>(x, scale, bias, y, rows, c, eps);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. x and y are (rows, c) row-major in the
// same type (dtype 0 = f32, 1 = bf16); scale and bias are (c,) f32.
// Returns the launch's cudaError_t (0 = success).
extern "C" int gridmm_layernorm_fwd(const void* x, int dtype,
                                    const float* scale, const float* bias,
                                    void* y, int rows, int c, float eps,
                                    void* stream) {
  if (rows < 1 || c < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, scale, bias, y, rows, c, eps, s);
  if (dtype == 1) {
    return launch<__nv_bfloat16>(x, scale, bias, y, rows, c, eps, s);
  }
  return (int)cudaErrorInvalidValue;
}
