// Grid-pool backward for Hopper (sm_90a): the analytic VJP of the per-cell
// segment-softmax pool, in two passes.
//
// Replaces the TPU kernels `_pool_bwd1_kernel` and `_pool_bwd2_kernel` in
// gridmm_tpu/ops/pallas/grid_pool_kernel.py:164 and :198 (wrapper
// pallas_grid_pool_bwd :216). With G the cotangent of the pooled cells and
// the in-cell softmax p_i = exp(w_i - cmax[c_i]) / denom[c_i] (0 where the
// id is outside [0, num_cells) or the cell's denominator is 0):
//     pass 1:  dg_i = p_i * G[c_i]          (B, N, D), in the features' type
//              s_i  = <g_i, G[c_i]>         (B, N) f32
//              S_c  = sum_{j in c} p_j s_j  (B, 256) f32
//     pass 2:  dw_i = p_i * (s_i - S[c_i])  (B, N) f32
// Pass 2 needs the complete S, hence the second launch. `cmax` and `denom`
// are the forward's residuals.
//
// Bound: bytes. Pass 1 reads every valid point's D features once and writes
// D gradients per point (~2 x 433 MB at B=16, N=8820, D=768 in f32), against
// 4 flops per element. The Pallas bodies build a (256 x chunk) one-hot and
// run four matrix products because the TPU has no gather; here G[c_i] is a
// row lookup:
//   * one warp per point: the lanes walk the D columns with 16-byte (f32) or
//     8-byte (bf16) accesses, neighbouring lanes on neighbouring addresses,
//     for the feature row, the cotangent row and the gradient row alike;
//   * the cotangent of one batch row is 196 x 768 x 4 B = 602 KB, more than
//     an SM's shared memory, so its rows are read through L2 (9.6 MB at
//     B=16 against 50 MB of L2), where every point of a cell finds its row
//     again;
//   * s_i is a warp shuffle reduction, complete in one place, so no partial
//     sums cross blocks; lane 0 adds p_i s_i into S with one global f32
//     atomic per point (about N / num_cells adds per address);
//   * invalid points write a zero gradient row and never read their
//     features;
//   * N is any length: a point is addressed as b * N + i, no padding.
// The order of the atomic adds into S varies from run to run, so S and dw
// agree with a sequential f32 sum to a few ulp, not bit for bit. Pass 2 is
// one thread per point and moves 16 bytes per point (it reads the id, w and
// s and writes dw) besides the per-cell tables: launch-sized.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kCellPad = 256;  // row length of denom and S

// four consecutive feature columns, as f32
struct Vec4 {
  float x, y, z, w;
};

__device__ __forceinline__ Vec4 load4(const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  return {v.x, v.y, v.z, v.w};
}
__device__ __forceinline__ Vec4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  return {a.x, a.y, b.x, b.y};
}
__device__ __forceinline__ void store4(float* p, Vec4 v) {
  *reinterpret_cast<float4*>(p) = make_float4(v.x, v.y, v.z, v.w);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, Vec4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const unsigned int*>(&lo);
  raw.y = *reinterpret_cast<const unsigned int*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}
__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Pass 1. VEC = 4 needs d % 4 == 0 (rows then start on 16- or 8-byte
// boundaries); VEC = 1 takes any d.
template <typename T, int VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
grid_pool_bwd1_kernel(const T* __restrict__ g, const int* __restrict__ cells,
                      const float* __restrict__ w,
                      const float* __restrict__ cmax,
                      const float* __restrict__ denom,
                      const float* __restrict__ cot, T* __restrict__ dg,
                      float* __restrict__ s, float* __restrict__ S,
                      long long total, int n, int d, int num_cells) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const long long n_warps = (long long)gridDim.x * kWarpsPerBlock;

  for (long long i = warp; i < total; i += n_warps) {
    const int b = (int)(i / n);
    const int c = cells[i];
    T* dg_row = dg + (size_t)i * d;
    const float den = (c >= 0 && c < num_cells)
                          ? denom[(size_t)b * kCellPad + c]
                          : 0.f;
    if (!(den > 0.f)) {
      // invalid id or empty cell: zero gradient and s_i = 0; the features
      // stay unread
      if constexpr (VEC == 4) {
        for (int k = lane * 4; k < d; k += 128) {
          store4(dg_row + k, Vec4{0.f, 0.f, 0.f, 0.f});
        }
      } else {
        for (int k = lane; k < d; k += 32) store1(dg_row + k, 0.f);
      }
      if (lane == 0) s[i] = 0.f;
      continue;
    }
    const float p = expf(w[i] - cmax[(size_t)b * num_cells + c]) / den;
    const T* g_row = g + (size_t)i * d;
    const float* cot_row = cot + ((size_t)b * num_cells + c) * d;
    float dot = 0.f;
    if constexpr (VEC == 4) {
#pragma unroll 2
      for (int k = lane * 4; k < d; k += 128) {
        const Vec4 gv = load4(g_row + k);
        const Vec4 cv = load4(cot_row + k);
        store4(dg_row + k, Vec4{p * cv.x, p * cv.y, p * cv.z, p * cv.w});
        dot += gv.x * cv.x + gv.y * cv.y + gv.z * cv.z + gv.w * cv.w;
      }
    } else {
      for (int k = lane; k < d; k += 32) {
        const float cv = cot_row[k];
        store1(dg_row + k, p * cv);
        dot += load1(g_row + k) * cv;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      dot += __shfl_xor_sync(0xffffffffu, dot, off);
    }
    if (lane == 0) {
      s[i] = dot;
      atomicAdd(&S[(size_t)b * kCellPad + c], p * dot);
    }
  }
}

// Pass 2: one thread per point.
__global__ void __launch_bounds__(256)
grid_pool_bwd2_kernel(const int* __restrict__ cells,
                      const float* __restrict__ w,
                      const float* __restrict__ cmax,
                      const float* __restrict__ denom,
                      const float* __restrict__ S,
                      const float* __restrict__ s, float* __restrict__ dw,
                      long long total, int n, int num_cells) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int b = (int)(i / n);
  const int c = cells[i];
  float out = 0.f;
  if (c >= 0 && c < num_cells) {
    const float den = denom[(size_t)b * kCellPad + c];
    if (den > 0.f) {
      const float p = expf(w[i] - cmax[(size_t)b * num_cells + c]) / den;
      out = p * (s[i] - S[(size_t)b * kCellPad + c]);
    }
  }
  dw[i] = out;
}

template <typename T>
int launch_bwd1(const void* g, const int* cells, const float* w,
                const float* cmax, const float* denom, const float* cot,
                void* dg, float* s, float* S, int b, int n, int d,
                int num_cells, int max_blocks, cudaStream_t stream) {
  const long long total = (long long)b * n;
  long long blocks = (total + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > max_blocks) blocks = max_blocks;
  const dim3 grid((unsigned)blocks);
  const T* gp = static_cast<const T*>(g);
  T* dgp = static_cast<T*>(dg);
  if (d % 4 == 0) {
    grid_pool_bwd1_kernel<T, 4><<<grid, kWarpsPerBlock * 32, 0, stream>>>(
        gp, cells, w, cmax, denom, cot, dgp, s, S, total, n, d, num_cells);
  } else {
    grid_pool_bwd1_kernel<T, 1><<<grid, kWarpsPerBlock * 32, 0, stream>>>(
        gp, cells, w, cmax, denom, cot, dgp, s, S, total, n, d, num_cells);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes. feature_dtype: 0 = f32, 1 = bf16 (the
// type of both g and dg). S (b, 256) must be zero-filled by the caller; dg
// and s are written in full. Each returns the launch's cudaError_t.
extern "C" int gridmm_grid_pool_bwd1(const void* g, int feature_dtype,
                                     const int* cells, const float* w,
                                     const float* cmax, const float* denom,
                                     const float* cot, void* dg, float* s,
                                     float* S, int b, int n, int d,
                                     int num_cells, int max_blocks,
                                     void* stream) {
  if (num_cells < 1 || num_cells > kCellPad || b < 1 || n < 1 || d < 1 ||
      max_blocks < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (feature_dtype == 1) {
    return launch_bwd1<__nv_bfloat16>(g, cells, w, cmax, denom, cot, dg, s, S,
                                      b, n, d, num_cells, max_blocks, st);
  }
  if (feature_dtype == 0) {
    return launch_bwd1<float>(g, cells, w, cmax, denom, cot, dg, s, S, b, n,
                              d, num_cells, max_blocks, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int gridmm_grid_pool_bwd2(const int* cells, const float* w,
                                     const float* cmax, const float* denom,
                                     const float* S, const float* s,
                                     float* dw, int b, int n, int num_cells,
                                     void* stream) {
  if (num_cells < 1 || num_cells > kCellPad || b < 1 || n < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const long long total = (long long)b * n;
  const unsigned blocks = (unsigned)((total + 255) / 256);
  grid_pool_bwd2_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      cells, w, cmax, denom, S, s, dw, total, n, num_cells);
  return (int)cudaGetLastError();
}
