// LayerNorm forward for Hopper (sm_90a): f32 statistics, persistent warps,
// 16-byte accesses.
//
// Replaces the TPU kernel `_ln_kernel` in gridmm_tpu/ops/pallas/layernorm.py:24
// (wrapper fused_layernorm :36). For every row r of x (rows, C):
//     m    = mean(x[r])                          f32
//     v    = mean((x[r] - m)^2)                  f32, centred form
//     y[r] = (x[r] - m) * rsqrt(v + eps) * scale + bias, written in x.dtype
//
// Bound: bytes. One read and one write of x against ~8 flops per element; at
// the CLIP B/32 encode shape (9600 x 768 bf16) that is 29.5 MB, ~8.8 us at
// 3.35 TB/s. The vector body keeps x to that one read and one write and
// keeps the memory system busy:
//   * 16-byte accesses: a lane moves 8 bf16 or 4 f32 values at a time,
//     neighbouring lanes on neighbouring 16-byte chunks (at C = 768 bf16,
//     three loads and three stores a lane per row);
//   * a group of G lanes takes a row (G = 32 from 32 chunks a row up; fewer
//     lanes for narrow rows, e.g. 8 lanes at C = 64 bf16, four rows a warp);
//   * scale and bias are read once per block, all loads in flight together,
//     into shared memory; a lane reads its columns' values from there (held
//     in registers instead, they cost 48 registers a lane at C = 768 and
//     halved the warps an SM holds);
//   * persistent warps: the grid is at most as many blocks as are resident
//     at once (occupancy queried once per body and device), and each group
//     walks the rows with a grid stride;
//   * two rows in flight: a group issues the next row's loads before the
//     current row's two shuffle reductions and its stores, so a device-memory
//     latency overlaps them;
//   * the row stays in registers, so the mean, the centred variance and the
//     output come from one read; sums are shuffles within the group.
// Shape dispatch: where C is not a multiple of the vector width, a row is
// wider than the vector body holds (above 1536 bf16 or 768 f32 values), or
// x or y does not start on a 16-byte boundary, a scalar body runs: one warp
// a row, lane l on columns l, l + 32, ...; the row in registers up to
// C = 1024, else a loop that reads it three times (the second and third
// reads from L1/L2). Every body computes the same f32 arithmetic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;  // warps per block
// Blocks of the vector body an SM should hold, which caps its registers:
// four (64 registers) while a lane holds at most three chunks a row; more
// chunks would spill there, so three (85 registers).
template <int NV>
struct VecBlocks {
  static constexpr int kMin = NV <= 3 ? 4 : 3;
};
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even
}

// 16 bytes of T as f32 values, and back (round to nearest even for bf16)
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void unpack(const uint4& r, float* v) {
    v[0] = __uint_as_float(r.x);
    v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z);
    v[3] = __uint_as_float(r.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ float2 pair(unsigned int u) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
  }
  static __device__ __forceinline__ unsigned int pair(float a, float b) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const unsigned int*>(&h);
  }
  static __device__ __forceinline__ void unpack(const uint4& r, float* v) {
    const float2 a = pair(r.x), b = pair(r.y), c = pair(r.z), d = pair(r.w);
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
    v[4] = c.x; v[5] = c.y; v[6] = d.x; v[7] = d.y;
  }
  static __device__ __forceinline__ uint4 pack(const float* v) {
    return make_uint4(pair(v[0], v[1]), pair(v[2], v[3]), pair(v[4], v[5]),
                      pair(v[6], v[7]));
  }
};

// sum over the G lanes of an aligned group (every lane of the warp calls it)
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Vector body. A group of G lanes takes a row; lane l of a group owns the
// 16-byte chunks l, l + G, ..., l + (NV - 1) G of every row it takes. Needs
// c % kN == 0, c / kN <= NV * G, and x and y on 16-byte boundaries.
template <typename T, int G, int NV>
__global__ void __launch_bounds__(32 * kWarps, VecBlocks<NV>::kMin)
layernorm_vec_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                     const float* __restrict__ bias, T* __restrict__ y,
                     int rows, int c, float eps) {
  constexpr int kN = Vec<T>::kN;
  constexpr int kGroups = 32 / G;  // rows a warp takes at a time
  __shared__ float4 sh_sc[NV * G * kN / 4], sh_bi[NV * G * kN / 4];
  const int lane = threadIdx.x & 31;
  const int gl = lane % G;
  const int nvec = c / kN;
  // rows are dealt out in rounds of `stride`; a warp's groups take
  // consecutive rows, so the warp stays or leaves as one (its shuffles
  // need every lane)
  const long long stride = (long long)gridDim.x * kWarps * kGroups;
  long long base =
      ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * kGroups;
  long long row = base + lane / G;
  bool own[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) own[k] = gl + k * G < nvec;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* yv = reinterpret_cast<uint4*>(y);

  // the first row's loads go out before scale and bias are staged
  uint4 cur[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    cur[k] = (row < rows && own[k]) ? xv[row * nvec + gl + k * G]
                                    : make_uint4(0u, 0u, 0u, 0u);
  }
  // scale and bias: every load of the block's share in flight at once
  constexpr int kAffine = NV * G * kN;
  constexpr int kAffineRounds = (kAffine + 32 * kWarps - 1) / (32 * kWarps);
  float sc_r[kAffineRounds], bi_r[kAffineRounds];
#pragma unroll
  for (int r = 0; r < kAffineRounds; ++r) {
    const int i = threadIdx.x + r * 32 * kWarps;
    if (i < c) {
      sc_r[r] = scale[i];
      bi_r[r] = bias[i];
    }
  }
  float* sc = reinterpret_cast<float*>(sh_sc);
  float* bi = reinterpret_cast<float*>(sh_bi);
#pragma unroll
  for (int r = 0; r < kAffineRounds; ++r) {
    const int i = threadIdx.x + r * 32 * kWarps;
    if (i < c) {
      sc[i] = sc_r[r];
      bi[i] = bi_r[r];
    }
  }
  __syncthreads();
  if (base >= rows) return;  // the whole warp leaves together

  while (true) {
    // the next row's loads go out before this row's reductions
    const long long next = row + stride;
    uint4 nxt[NV];
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      nxt[k] = (next < rows && own[k]) ? xv[next * nvec + gl + k * G]
                                       : make_uint4(0u, 0u, 0u, 0u);
    }
    float v[NV][kN];
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      Vec<T>::unpack(cur[k], v[k]);
#pragma unroll
      for (int e = 0; e < kN; ++e) s += v[k][e];
    }
    const float mean = group_sum<G>(s) / (float)c;
    float q = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
#pragma unroll
      for (int e = 0; e < kN; ++e) {
        const float d = own[k] ? v[k][e] - mean : 0.f;
        q += d * d;
      }
    }
    const float rstd = rsqrtf(group_sum<G>(q) / (float)c + eps);
    if (row < rows) {
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        if (!own[k]) continue;
        const int chunk = gl + k * G;
        float o[kN];
#pragma unroll
        for (int e4 = 0; e4 < kN / 4; ++e4) {
          const float4 a = sh_sc[chunk * (kN / 4) + e4];
          const float4 b = sh_bi[chunk * (kN / 4) + e4];
          const float* v4 = v[k] + 4 * e4;
          o[4 * e4 + 0] = (v4[0] - mean) * rstd * a.x + b.x;
          o[4 * e4 + 1] = (v4[1] - mean) * rstd * a.y + b.y;
          o[4 * e4 + 2] = (v4[2] - mean) * rstd * a.z + b.z;
          o[4 * e4 + 3] = (v4[3] - mean) * rstd * a.w + b.w;
        }
        yv[row * nvec + chunk] = Vec<T>::pack(o);
      }
    }
    base += stride;
    if (base >= rows) break;
    row = next;
#pragma unroll
    for (int k = 0; k < NV; ++k) cur[k] = nxt[k];
  }
}

// Scalar bodies: one warp a row, any C, any alignment.
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
  const float mean = group_sum<32>(s) / (float)c;
  float q = 0.f;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int col = lane + 32 * k;
    const float d = col < c ? v[k] - mean : 0.f;
    q += d * d;
  }
  const float rstd = rsqrtf(group_sum<32>(q) / (float)c + eps);
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
  const float mean = group_sum<32>(s) / (float)c;
  float q = 0.f;
  for (int col = lane; col < c; col += 32) {
    const float d = to_f32(xr[col]) - mean;
    q += d * d;
  }
  const float rstd = rsqrtf(group_sum<32>(q) / (float)c + eps);
  for (int col = lane; col < c; col += 32) {
    store(&yr[col], (to_f32(xr[col]) - mean) * rstd * scale[col] + bias[col]);
  }
}

// Blocks of one vector body resident on the current device at once: the
// occupancy of the body, queried on its first launch on each device, times
// the SM count.
template <typename T, int G, int NV>
cudaError_t resident_blocks(int* out) {
  static int per_device[kMaxDevices] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (per_device[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, layernorm_vec_kernel<T, G, NV>, 32 * kWarps, 0);
    if (err != cudaSuccess) return err;
    if (sms * per_sm < 1) return cudaErrorInvalidConfiguration;
    per_device[dev] = sms * per_sm;
  }
  *out = per_device[dev];
  return cudaSuccess;
}

template <typename T, int G, int NV>
int launch_vec(const T* x, const float* scale, const float* bias, T* y,
               int rows, int c, float eps, cudaStream_t s) {
  int resident = 0;
  const cudaError_t err = resident_blocks<T, G, NV>(&resident);
  if (err != cudaSuccess) return (int)err;
  // every resident warp, or fewer where the rows need fewer (measured on
  // the H100: more warps in flight beat an even share of rows per warp)
  constexpr int kRowsPerBlock = kWarps * (32 / G);
  long long blocks = ((long long)rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > resident) blocks = resident;
  layernorm_vec_kernel<T, G, NV><<<(unsigned)blocks, 32 * kWarps, 0, s>>>(
      x, scale, bias, y, rows, c, eps);
  return (int)cudaGetLastError();
}

// The vector body for nvec = c / kN chunks a row: G lanes a row (the next
// power of two up to 32), NV chunks a lane. Returns -1 where no vector body
// holds the row.
template <typename T>
int dispatch_vec(const T* x, const float* scale, const float* bias, T* y,
                 int rows, int c, float eps, cudaStream_t s) {
  const int nvec = c / Vec<T>::kN;
#define LN_VEC(G, NV) launch_vec<T, G, NV>(x, scale, bias, y, rows, c, eps, s)
  if (nvec <= 1) return LN_VEC(1, 1);
  if (nvec <= 2) return LN_VEC(2, 1);
  if (nvec <= 4) return LN_VEC(4, 1);
  if (nvec <= 8) return LN_VEC(8, 1);
  if (nvec <= 16) return LN_VEC(16, 1);
  if (nvec <= 32) return LN_VEC(32, 1);
  if (nvec <= 64) return LN_VEC(32, 2);
  if (nvec <= 96) return LN_VEC(32, 3);
  if (nvec <= 128) return LN_VEC(32, 4);
  if (nvec <= 192) return LN_VEC(32, 6);
#undef LN_VEC
  return -1;
}

template <typename T>
int launch(const void* xv, const float* scale, const float* bias, void* yv,
           int rows, int c, float eps, cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  T* y = static_cast<T*>(yv);
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) &
       15) == 0;
  if (aligned && c % Vec<T>::kN == 0) {
    const int err = dispatch_vec<T>(x, scale, bias, y, rows, c, eps, s);
    if (err >= 0) return err;
  }
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
