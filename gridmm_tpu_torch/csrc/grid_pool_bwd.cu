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
//   * s_i is a warp shuffle reduction, complete in one place. S is summed
//     without atomics, in an order fixed by the shape: the grid is (batch
//     row x tile), a block owns one of `tiles` contiguous tiles of a row and
//     its warps take the tile's points in turn; lane 0 of a warp adds p_i s_i
//     into the warp's own row of a shared (warps x 256) table, point after
//     point; the block adds its warps' rows in warp order and writes one
//     (256) partial of the tile. The block that finishes a row last (a
//     counter per row, which the caller zero-fills, elects it; it decides
//     who sums, not in what order) adds the row's partials in tile order
//     into S, padding cells included (0). Two runs give the same bits;
//   * invalid points write a zero gradient row and never read their
//     features;
//   * N is any length: a point is addressed as b * N + i, no padding, and
//     the batch rides on the grid's x axis (2^31 - 1 blocks).
//
// Pass 2 moves 16 bytes a point (it reads the id, w and s and writes dw)
// besides the per-cell tables: at B=16, N=8820 that is 2.3 MB, 0.69 us at
// 3.35 TB/s, so the launch and one chain of latencies set its time, not the
// bytes. It keeps that chain to one device-memory round trip:
//   * the grid is (slices of a row, rows): blockIdx.y is the batch row, so
//     no division finds it; beyond 65,535 rows a block takes every
//     gridDim.y-th row in turn;
//   * a thread takes two consecutive points with one 8-byte load each of
//     the ids, the weights and s, and writes their dw with one 8-byte store
//     (four points a thread, with 16-byte accesses, measured slower on the
//     H100: a quarter as many warps hide the arithmetic's latency worse);
//     where a row starts at an odd point, or N is odd, its first or last
//     point is taken alone (a scalar head and tail), and where cells, w, s
//     or dw start off an 8-byte boundary the whole row is;
//   * the block stages its row's cell max, 1 / denominator and S (num_cells
//     of each, 2.3 KB at 196 cells) in shared memory with loads issued
//     together with the point loads, so the lookups that depend on the id
//     are shared-memory reads, not a second trip to device memory;
//   * p = __expf(w - cmax) * (1 / denom): dw differs from the plain
//     version's expf and divide by ~1e-6 of its largest value.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

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
// boundaries); VEC = 1 takes any d. Block x is tile x % tiles of batch row
// x / tiles.
template <typename T, int VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
grid_pool_bwd1_kernel(const T* __restrict__ g, const int* __restrict__ cells,
                      const float* __restrict__ w,
                      const float* __restrict__ cmax,
                      const float* __restrict__ denom,
                      const float* __restrict__ cot, T* __restrict__ dg,
                      float* __restrict__ s, float* __restrict__ S,
                      float* __restrict__ partial,
                      unsigned int* __restrict__ done, int n, int d,
                      int num_cells, int tiles) {
  __shared__ float s_tab[kWarpsPerBlock][kCellPad];   // p_i s_i per warp
  __shared__ bool s_last;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t b = blockIdx.x / tiles;
  const int tile = (int)(blockIdx.x % tiles);
  const int per = (int)(((long long)n + tiles - 1) / tiles);
  const int p0 = (int)min((long long)n, (long long)tile * per);
  const int p1 = (int)min((long long)n, (long long)p0 + per);
  for (int c = lane; c < kCellPad; c += 32) s_tab[warp][c] = 0.f;
  __syncwarp();

  for (int p = p0 + warp; p < p1; p += kWarpsPerBlock) {
    const size_t i = b * (size_t)n + p;
    const int c = cells[i];
    T* dg_row = dg + i * d;
    const float den = (c >= 0 && c < num_cells) ? denom[b * kCellPad + c]
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
    const float pr = expf(w[i] - cmax[b * num_cells + c]) / den;
    const T* g_row = g + i * d;
    const float* cot_row = cot + (b * num_cells + c) * d;
    float dot = 0.f;
    if constexpr (VEC == 4) {
#pragma unroll 2
      for (int k = lane * 4; k < d; k += 128) {
        const Vec4 gv = load4(g_row + k);
        const Vec4 cv = load4(cot_row + k);
        store4(dg_row + k, Vec4{pr * cv.x, pr * cv.y, pr * cv.z, pr * cv.w});
        dot += gv.x * cv.x + gv.y * cv.y + gv.z * cv.z + gv.w * cv.w;
      }
    } else {
      for (int k = lane; k < d; k += 32) {
        const float cv = cot_row[k];
        store1(dg_row + k, pr * cv);
        dot += load1(g_row + k) * cv;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      dot += __shfl_xor_sync(0xffffffffu, dot, off);
    }
    if (lane == 0) {
      s[i] = dot;
      s_tab[warp][c] += pr * dot;   // this warp's points, in turn
    }
  }
  __syncthreads();

  // the tile's partial: the warps' rows in warp order
  float* mine = partial + (size_t)blockIdx.x * kCellPad;
  for (int c = threadIdx.x; c < kCellPad; c += blockDim.x) {
    float v = 0.f;
#pragma unroll
    for (int k = 0; k < kWarpsPerBlock; ++k) v += s_tab[k][c];
    mine[c] = v;
  }
  // the last of the row's blocks to get here adds the partials in tile
  // order (threadFenceReduction: each partial is visible before its count)
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    s_last = atomicAdd(&done[b], 1u) == (unsigned)tiles - 1u;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const float* row_parts = partial + b * (size_t)tiles * kCellPad;
  for (int c = threadIdx.x; c < kCellPad; c += blockDim.x) {
    constexpr int kLoads = 16;   // partials in flight a thread
    float v = 0.f;
    for (int t0 = 0; t0 < tiles; t0 += kLoads) {
      float x[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        x[u] = t0 + u < tiles
                   ? __ldcg(row_parts + (size_t)(t0 + u) * kCellPad + c)
                   : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) v += x[u];
    }
    S[b * kCellPad + c] = v;
  }
}

// Pass 2. Block (slice, y) covers points [2 * blockDim.x * slice, ...) of
// the aligned middle of rows y, y + gridDim.y, ...; `vec` says whether
// cells, w, s and dw all start on 8-byte boundaries.
constexpr int kBwd2Threads = 128;
constexpr int kBwd2Per = 2;  // points a thread takes
constexpr int kMaxGridY = 65535;

// dw of one point from the staged tables: cmax, 1 / denom (0 for an empty
// cell) and S of the row's cells
__device__ __forceinline__ float bwd2_point(int c, float wi, float si,
                                            const float* cmax,
                                            const float* inv_den,
                                            const float* S, int num_cells) {
  if (c < 0 || c >= num_cells) return 0.f;
  const float r = inv_den[c];
  if (r == 0.f) return 0.f;
  const float p = __expf(wi - cmax[c]) * r;
  return p * (si - S[c]);
}

__global__ void __launch_bounds__(kBwd2Threads)
grid_pool_bwd2_kernel(const int* __restrict__ cells,
                      const float* __restrict__ w,
                      const float* __restrict__ cmax,
                      const float* __restrict__ denom,
                      const float* __restrict__ S,
                      const float* __restrict__ s, float* __restrict__ dw,
                      int rows, int n, int num_cells, int vec) {
  __shared__ float sh_cmax[kCellPad], sh_inv_den[kCellPad], sh_S[kCellPad];
  for (int b = blockIdx.y; b < rows; b += gridDim.y) {
    const size_t row0 = (size_t)b * n;
    // points of this row taken one by one before (head) and after (tail)
    // the aligned middle, which a thread takes kBwd2Per at a time
    int head = n, nvec = 0;
    if (vec) {
      head = (int)((kBwd2Per - row0 % kBwd2Per) % kBwd2Per);
      if (head > n) head = n;
      nvec = (n - head) / kBwd2Per;
    }
    const int tail_start = head + nvec * kBwd2Per;
    const int n_scalar = head + (n - tail_start);

    // the point loads first, then the tables: all in flight together
    const int t = blockIdx.x * kBwd2Threads + threadIdx.x;
    int2 ci = make_int2(-1, -1);
    float2 wi = make_float2(0.f, 0.f), si = wi;
    const bool has_vec = t < nvec;
    if (has_vec) {
      const size_t at = row0 + head + (size_t)t * kBwd2Per;
      ci = *reinterpret_cast<const int2*>(cells + at);
      wi = *reinterpret_cast<const float2*>(w + at);
      si = *reinterpret_cast<const float2*>(s + at);
    }
    constexpr int kRounds = kCellPad / kBwd2Threads;
    float tc[kRounds], td[kRounds], tS[kRounds];
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int k = threadIdx.x + r * kBwd2Threads;
      if (k < num_cells) {
        tc[r] = cmax[(size_t)b * num_cells + k];
        td[r] = denom[(size_t)b * kCellPad + k];
        tS[r] = S[(size_t)b * kCellPad + k];
      }
    }
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int k = threadIdx.x + r * kBwd2Threads;
      if (k < num_cells) {
        sh_cmax[k] = tc[r];
        sh_inv_den[k] = td[r] > 0.f ? 1.f / td[r] : 0.f;
        sh_S[k] = tS[r];
      }
    }
    __syncthreads();

    if (has_vec) {
      const float2 out = make_float2(
          bwd2_point(ci.x, wi.x, si.x, sh_cmax, sh_inv_den, sh_S, num_cells),
          bwd2_point(ci.y, wi.y, si.y, sh_cmax, sh_inv_den, sh_S, num_cells));
      *reinterpret_cast<float2*>(dw + row0 + head + (size_t)t * kBwd2Per) =
          out;
    }
    // the scalar head and tail: at most one point at each end of an aligned
    // row; the whole row where an array is off an 8-byte boundary
    for (int e = t; e < n_scalar; e += gridDim.x * kBwd2Threads) {
      const size_t i = row0 + (e < head ? e : tail_start + (e - head));
      dw[i] = bwd2_point(cells[i], w[i], s[i], sh_cmax, sh_inv_den, sh_S,
                         num_cells);
    }
    __syncthreads();   // the next row restages the tables
  }
}

template <typename T>
int launch_bwd1(const void* g, const int* cells, const float* w,
                const float* cmax, const float* denom, const float* cot,
                void* dg, float* s, float* S, float* partial,
                unsigned int* done, int b, int n, int d, int num_cells,
                int tiles, cudaStream_t stream) {
  const dim3 grid((unsigned)((long long)b * tiles));
  const T* gp = static_cast<const T*>(g);
  T* dgp = static_cast<T*>(dg);
  if (d % 4 == 0) {
    grid_pool_bwd1_kernel<T, 4><<<grid, kWarpsPerBlock * 32, 0, stream>>>(
        gp, cells, w, cmax, denom, cot, dgp, s, S, partial, done, n, d,
        num_cells, tiles);
  } else {
    grid_pool_bwd1_kernel<T, 1><<<grid, kWarpsPerBlock * 32, 0, stream>>>(
        gp, cells, w, cmax, denom, cot, dgp, s, S, partial, done, n, d,
        num_cells, tiles);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes. feature_dtype: 0 = f32, 1 = bf16 (the
// type of both g and dg). dg, s and S (b, 256) are written in full; partial
// (b * tiles, 256) f32 is scratch and needs no initialisation; done (b)
// unsigned int must be zero-filled by the caller. `tiles` (1 to n) is the
// number of blocks a row is cut into. Each returns the launch's
// cudaError_t.
extern "C" int gridmm_grid_pool_bwd1(const void* g, int feature_dtype,
                                     const int* cells, const float* w,
                                     const float* cmax, const float* denom,
                                     const float* cot, void* dg, float* s,
                                     float* S, float* partial,
                                     unsigned int* done, int b, int n, int d,
                                     int num_cells, int tiles,
                                     void* stream) {
  if (num_cells < 1 || num_cells > kCellPad || b < 1 || n < 1 || d < 1 ||
      tiles < 1 || tiles > n || (long long)b * tiles > INT_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (feature_dtype == 1) {
    return launch_bwd1<__nv_bfloat16>(g, cells, w, cmax, denom, cot, dg, s, S,
                                      partial, done, b, n, d, num_cells,
                                      tiles, st);
  }
  if (feature_dtype == 0) {
    return launch_bwd1<float>(g, cells, w, cmax, denom, cot, dg, s, S,
                              partial, done, b, n, d, num_cells, tiles, st);
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
  const int vec = ((reinterpret_cast<uintptr_t>(cells) |
                    reinterpret_cast<uintptr_t>(w) |
                    reinterpret_cast<uintptr_t>(s) |
                    reinterpret_cast<uintptr_t>(dw)) & 7) == 0;
  const int per_block = kBwd2Threads * kBwd2Per;
  const dim3 grid((unsigned)((n + (long long)per_block - 1) / per_block),
                  (unsigned)(b < kMaxGridY ? b : kMaxGridY));
  grid_pool_bwd2_kernel<<<grid, kBwd2Threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      cells, w, cmax, denom, S, s, dw, b, n, num_cells, vec);
  return (int)cudaGetLastError();
}
