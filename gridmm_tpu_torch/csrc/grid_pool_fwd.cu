// Grid-pool forward for Hopper (sm_90a): the per-cell segment-softmax pool in
// one launch, owner-computes, without atomics.
//
// Replaces the TPU kernel `_pool_kernel` in
// gridmm_tpu/ops/pallas/grid_pool_kernel.py:30 (wrapper pallas_grid_pool_raw
// :92) together with what surrounds it there (the per-cell max of
// _prep_inputs :65-87 and the final divide :135-141). For every batch row b
// and cell c in [0, num_cells), over the points i with cell id c:
//     cmax[b, c]   = max_i w_i                          (-inf if empty)
//     e_i          = exp(w_i - cmax[b, c])
//     denom[b, c]  = sum_i e_i                          (B, 256) f32, 0 if empty
//     pooled[b, c] = sum_i e_i * g[b, i, :] / denom     (B, num_cells, D) f32
//     mask[b, c]   = denom > 0
// Points with any other id (-1 = invalid) vanish; empty cells pool to 0.
//
// Bound: bytes. Each valid point's D features are read once and multiplied
// once; at B=16, N=8832, D=768 the bf16 feature read is ~217 MB (~65 us at
// 3.35 TB/s) against ~0.2 GFLOP. The Pallas body builds a (256 x chunk)
// one-hot and runs a matrix product to reach the TPU's matrix unit. A
// point-major reduction with atomics is bound by shared and global atomic
// traffic, not by bytes, needs zero-filled outputs and a dozen small
// launches around it (cell max, divide, mask), and sums in an order that
// changes from run to run. Here the reduction is cell-major with owners:
//   * one block per (batch row, group of `group` consecutive cells, slab of
//     up to eight column warps); the wrapper picks `group` so that the card gets
//     several hundred blocks at any batch size;
//   * the block reads the row's N cell ids twice (the second time from
//     cache, kScan loads in flight a lane): each warp owns a contiguous
//     range of points, counts its matches per cell with ballots, and after
//     one prefix over the warps fills the compact list of each cell in
//     shared memory, point index (16 bits) and weight, in ascending point
//     order;
//   * one warp per cell takes the max of the weights, turns them into
//     e_i = exp(w - max) in place, sums them (lane-strided, then a shuffle
//     tree) and writes the cell max, the denominator and the mask;
//   * for each cell, a warp owns 32 x 16 bytes of every row (a lane's 16-byte
//     load: four f32 or eight bf16 columns) and one of `split` contiguous
//     parts of the cell's list; a block has about twelve warps, so a bf16
//     row of 768 columns has three column warps and four parts, an f32 row
//     six and two. A warp takes 32 indices and e_i at a time, one a lane,
//     and walks them with shuffles, kUnroll feature rows in flight, adding
//     e_i * g_i into its registers; no barrier separates one cell from the
//     next. The parts meet in shared memory in a fixed order; the owner
//     divides by the denominator and writes the row.
// Every feature row is read once, nothing is zero-filled, every output
// element has one writer, and the order of every sum depends on the inputs'
// shape alone: two runs give the same bits. The price of owners: a cell that
// holds most of a row's points is streamed by one block alone.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kCellPad = 256;      // denominator row length (max num_cells)
constexpr int kBlockWarps = 12;    // warps a block aims for
constexpr int kMaxColWarps = 8;    // column warps a block has at most
constexpr int kMaxSplit = 4;       // warps that share one cell's points
constexpr int kMaxWarps = 16;
constexpr int kMaxGroup = 4;       // cells per block, at most
constexpr int kScan = 8;           // cell-id loads in flight per lane
constexpr int kUnroll = 4;         // feature rows in flight per warp
constexpr int kMaxSmem = 232448;   // bytes a block may use on sm_90
constexpr unsigned kFull = 0xffffffffu;

// What a lane holds of one feature row: 16 bytes. kVec (d % kCols == 0, so
// every row keeps the load's alignment): kCols = 4 (f32) or 8 (bf16)
// consecutive columns, col0 + kCols * lane + {0..}; otherwise four columns
// col0 + lane + 32 * {0..3}, any d, as f32 bits.
template <typename T, bool kVec>
struct Lane {
  static constexpr int kCols = kVec ? 16 / (int)sizeof(T) : 4;
  static constexpr int kWarpCols = 32 * kCols;   // columns a warp owns
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, bool kVec>
__device__ __forceinline__ uint4 load_cols(const T* row, int col0, int lane,
                                           int d) {
  if constexpr (kVec) {
    const int col = col0 + Lane<T, kVec>::kCols * lane;
    if (col < d) return *reinterpret_cast<const uint4*>(row + col);
    return make_uint4(0u, 0u, 0u, 0u);
  } else {
    const int col = col0 + lane;
    uint4 v;
    v.x = __float_as_uint(col < d ? to_f32(row[col]) : 0.f);
    v.y = __float_as_uint(col + 32 < d ? to_f32(row[col + 32]) : 0.f);
    v.z = __float_as_uint(col + 64 < d ? to_f32(row[col + 64]) : 0.f);
    v.w = __float_as_uint(col + 96 < d ? to_f32(row[col + 96]) : 0.f);
    return v;
  }
}

// acc += e * (the lane's columns in `raw`)
template <typename T, bool kVec>
__device__ __forceinline__ void add_cols(float* acc, uint4 raw, float e) {
  if constexpr (kVec && sizeof(T) == 2) {
    const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&words[i]));
      acc[2 * i] = fmaf(e, f.x, acc[2 * i]);
      acc[2 * i + 1] = fmaf(e, f.y, acc[2 * i + 1]);
    }
  } else {
    acc[0] = fmaf(e, __uint_as_float(raw.x), acc[0]);
    acc[1] = fmaf(e, __uint_as_float(raw.y), acc[1]);
    acc[2] = fmaf(e, __uint_as_float(raw.z), acc[2]);
    acc[3] = fmaf(e, __uint_as_float(raw.w), acc[3]);
  }
}

template <typename T, bool kVec>
__device__ __forceinline__ void store_cols(float* row, int col0, int lane,
                                           int d, const float* v) {
  if constexpr (kVec) {
    constexpr int kCols = Lane<T, kVec>::kCols;
    const int col = col0 + kCols * lane;
    if (col < d) {
#pragma unroll
      for (int i = 0; i < kCols; i += 4) {
        *reinterpret_cast<float4*>(row + col + i) =
            make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
      }
    }
  } else {
    const int col = col0 + lane;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (col + 32 * i < d) row[col + 32 * i] = v[i];
    }
  }
}

// grid (cell groups, batch rows, column slabs); col_warps * split warps a
// block. Dynamic shared memory: the partial sums
// [group][split][col_warps][32 lanes][kCols] f32, then per point of the row
// a weight (f32) and an index (16 bits): the lists of the block's cells.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kMaxWarps * 32)
grid_pool_fwd_kernel(const T* __restrict__ g, const int* __restrict__ cells,
                     const float* __restrict__ w, float* __restrict__ pooled,
                     unsigned char* __restrict__ mask,
                     float* __restrict__ denom, float* __restrict__ cmax,
                     int n, int d, int num_cells, int group, int col_warps,
                     int split) {
  constexpr int kCols = Lane<T, kVec>::kCols;
  extern __shared__ float4 smem_raw[];
  float* s_part = reinterpret_cast<float*>(smem_raw);
  float* s_e = s_part + group * split * col_warps * 32 * kCols;
  unsigned short* s_idx = reinterpret_cast<unsigned short*>(s_e + n);
  __shared__ int s_cnt[kMaxWarps][kMaxGroup];    // matches per warp and cell
  __shared__ int s_start[kMaxGroup + 1];         // list offset of each cell
  __shared__ float s_den[kMaxGroup];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * group;
  const int n_here = min(group, num_cells - c0);   // cells of this block
  const size_t row0 = (size_t)b * n;
  const int* crow = cells + row0;
  const float* wrow = w + row0;
  const bool writes_stats = blockIdx.z == 0;

  // ---- the lists: count, prefix over the warps, fill. A lane has kScan
  // cell ids in flight at a time. Chunks past `end` match nothing, and a
  // chunk of 32 ids with no match (most of them) costs one ballot.
  const int per_warp = ((n + n_warps - 1) / n_warps + 31) / 32 * 32;
  const int begin = min(n, warp * per_warp);
  const int end = min(n, begin + per_warp);
  const unsigned lanes_below = (1u << lane) - 1u;

  int rel[kScan];    // cell id less c0 where the block owns the cell, or -1
  auto load_ids = [&](int i0) {
#pragma unroll
    for (int u = 0; u < kScan; ++u) {
      const int p = i0 + 32 * u + lane;
      const int id = p < end ? crow[p] : -1;
      rel[u] = (id >= c0 && id < c0 + n_here) ? id - c0 : -1;
    }
  };

  int cnt[kMaxGroup];
#pragma unroll
  for (int k = 0; k < kMaxGroup; ++k) cnt[k] = 0;
  for (int i0 = begin; i0 < end; i0 += 32 * kScan) {
    load_ids(i0);
#pragma unroll
    for (int u = 0; u < kScan; ++u) {
      if (__ballot_sync(kFull, rel[u] >= 0) == 0u) continue;
#pragma unroll
      for (int k = 0; k < kMaxGroup; ++k) {
        if (k < n_here) cnt[k] += __popc(__ballot_sync(kFull, rel[u] == k));
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kMaxGroup; ++k) s_cnt[warp][k] = cnt[k];
  }
  __syncthreads();

  int base[kMaxGroup];   // where this warp's next point of cell k goes
  {
    int run = 0;
#pragma unroll
    for (int k = 0; k < kMaxGroup; ++k) {
      base[k] = 0;
      if (k < n_here) {
        int before = 0, total = 0;
        for (int w2 = 0; w2 < n_warps; ++w2) {
          const int c = s_cnt[w2][k];
          if (w2 < warp) before += c;
          total += c;
        }
        base[k] = run + before;
        if (threadIdx.x == 0) s_start[k] = run;
        run += total;
      }
    }
    if (threadIdx.x == 0) s_start[n_here] = run;
  }
  for (int i0 = begin; i0 < end; i0 += 32 * kScan) {
    load_ids(i0);   // from cache this time
    float wv[kScan];
#pragma unroll
    for (int u = 0; u < kScan; ++u) {
      wv[u] = rel[u] >= 0 ? wrow[i0 + 32 * u + lane] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kScan; ++u) {
      if (__ballot_sync(kFull, rel[u] >= 0) == 0u) continue;
#pragma unroll
      for (int k = 0; k < kMaxGroup; ++k) {
        if (k < n_here) {
          const unsigned hit = __ballot_sync(kFull, rel[u] == k);
          if (rel[u] == k) {
            const int pos = base[k] + __popc(hit & lanes_below);
            s_idx[pos] = (unsigned short)(i0 + 32 * u + lane);
            s_e[pos] = wv[u];
          }
          base[k] += __popc(hit);
        }
      }
    }
  }
  __syncthreads();

  // ---- per cell: max, e_i in place of the weights, denominator, mask
  for (int k = warp; k < n_here; k += n_warps) {
    const int st = s_start[k];
    const int cn = s_start[k + 1] - st;
    float mx = -INFINITY;
    for (int i = lane; i < cn; i += 32) mx = fmaxf(mx, s_e[st + i]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
    }
    float sum = 0.f;
    for (int i = lane; i < cn; i += 32) {
      // 0 for a cell whose weights are all -inf
      const float e = mx == -INFINITY ? 0.f : expf(s_e[st + i] - mx);
      s_e[st + i] = e;
      sum += e;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sum += __shfl_xor_sync(kFull, sum, off);
    }
    if (lane == 0) {
      s_den[k] = sum;
      if (writes_stats) {
        cmax[(size_t)b * num_cells + c0 + k] = mx;
        denom[(size_t)b * kCellPad + c0 + k] = sum;
        mask[(size_t)b * num_cells + c0 + k] = sum > 0.f ? 1 : 0;
      }
    }
  }
  if (writes_stats && blockIdx.x == 0) {   // the denominator row's padding
    for (int c = num_cells + threadIdx.x; c < kCellPad; c += blockDim.x) {
      denom[(size_t)b * kCellPad + c] = 0.f;
    }
  }
  __syncthreads();

  // ---- per cell and part: the weighted sum of the points' rows
  const int cw = warp % col_warps;     // which columns of the slab
  const int part = warp / col_warps;   // which part of each cell's list
  const int col0 = (blockIdx.z * col_warps + cw) * Lane<T, kVec>::kWarpCols;
  const T* grow = g + row0 * d;
  for (int k = 0; k < n_here; ++k) {
    const int st = s_start[k];
    const int cn = s_start[k + 1] - st;
    const int per = (cn + split - 1) / split;
    const int pb = min(cn, part * per);
    const int pe = min(cn, pb + per);
    float acc[kCols];
#pragma unroll
    for (int i = 0; i < kCols; ++i) acc[i] = 0.f;
    for (int q = pb; q < pe; q += 32) {
      const int m = min(32, pe - q);
      int idx = 0;
      float e = 0.f;
      if (lane < m) {
        idx = s_idx[st + q + lane];
        e = s_e[st + q + lane];
      }
      for (int j0 = 0; j0 < m; j0 += kUnroll) {
        uint4 v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int pi = __shfl_sync(kFull, idx, (j0 + u) & 31);
          v[u] = make_uint4(0u, 0u, 0u, 0u);
          if (j0 + u < m) {
            v[u] = load_cols<T, kVec>(grow + (size_t)pi * d, col0, lane, d);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const float ej = __shfl_sync(kFull, e, (j0 + u) & 31);
          add_cols<T, kVec>(acc, v[u], ej);
        }
      }
    }
    float* mine = s_part + (((k * split + part) * col_warps + cw) * 32 +
                            lane) * kCols;
#pragma unroll
    for (int i = 0; i < kCols; i += 4) {
      *reinterpret_cast<float4*>(mine + i) =
          make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
    }
  }
  __syncthreads();

  // ---- the parts meet in a fixed order (part 0 + part 1 + ...); divide
  for (int k = part; k < n_here; k += split) {
    float acc[kCols];
#pragma unroll
    for (int i = 0; i < kCols; ++i) acc[i] = 0.f;
    for (int p = 0; p < split; ++p) {
      const float* theirs =
          s_part + (((k * split + p) * col_warps + cw) * 32 + lane) * kCols;
#pragma unroll
      for (int i = 0; i < kCols; ++i) acc[i] += theirs[i];
    }
    const float den = s_den[k];
#pragma unroll
    for (int i = 0; i < kCols; ++i) acc[i] = den > 0.f ? acc[i] / den : 0.f;
    store_cols<T, kVec>(pooled + ((size_t)b * num_cells + c0 + k) * d, col0,
                        lane, d, acc);
  }
}

template <typename T, bool kVec>
int launch_kernel(const T* g, const int* cells, const float* w, float* pooled,
                  unsigned char* mask, float* denom, float* cmax, int b,
                  int n, int d, int num_cells, int group,
                  cudaStream_t stream) {
  constexpr int kWarpCols = Lane<T, kVec>::kWarpCols;
  const int total_cw = (d + kWarpCols - 1) / kWarpCols;
  const int col_warps = total_cw < kMaxColWarps ? total_cw : kMaxColWarps;
  const int slabs = (total_cw + col_warps - 1) / col_warps;
  int split = kBlockWarps / col_warps;
  split = split < 1 ? 1 : (split > kMaxSplit ? kMaxSplit : split);
  const size_t smem =
      sizeof(float) * group * split * col_warps * 32 * Lane<T, kVec>::kCols +
      (sizeof(float) + sizeof(unsigned short)) * (size_t)n;
  if (smem + 1024 > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      grid_pool_fwd_kernel<T, kVec>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((num_cells + group - 1) / group, b, slabs);
  grid_pool_fwd_kernel<T, kVec><<<grid, col_warps * split * 32, smem,
                                  stream>>>(
      g, cells, w, pooled, mask, denom, cmax, n, d, num_cells, group,
      col_warps, split);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* g, const int* cells, const float* w, float* pooled,
           unsigned char* mask, float* denom, float* cmax, int b, int n,
           int d, int num_cells, int group, cudaStream_t stream) {
  const T* gp = static_cast<const T*>(g);
  if (d % Lane<T, true>::kCols == 0) {
    return launch_kernel<T, true>(gp, cells, w, pooled, mask, denom, cmax, b,
                                  n, d, num_cells, group, stream);
  }
  return launch_kernel<T, false>(gp, cells, w, pooled, mask, denom, cmax, b,
                                 n, d, num_cells, group, stream);
}

}  // namespace

// Plain C entry point for ctypes. Every output is written in full and needs
// no initialisation: pooled (b, num_cells, d) f32, mask (b, num_cells) bytes
// (0 or 1), denom (b, 256) f32, cmax (b, num_cells) f32. `group` is the
// number of consecutive cells a block owns, 1..4. feature_dtype: 0 = f32,
// 1 = bf16. n is capped by the shared memory a block may use (6 bytes a
// point besides the partial sums). Returns the launch's cudaError_t (0 = success).
extern "C" int gridmm_grid_pool_fwd(const void* g, int feature_dtype,
                                    const int* cells, const float* w,
                                    float* pooled, unsigned char* mask,
                                    float* denom, float* cmax, int b, int n,
                                    int d, int num_cells, int group,
                                    void* stream) {
  if (num_cells < 1 || num_cells > kCellPad || group < 1 ||
      group > kMaxGroup || b < 1 || b > 65535 || n < 1 || n > 65535 ||
      d < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (feature_dtype == 1) {
    return launch<__nv_bfloat16>(g, cells, w, pooled, mask, denom, cmax, b, n,
                                 d, num_cells, group, s);
  }
  if (feature_dtype == 0) {
    return launch<float>(g, cells, w, pooled, mask, denom, cmax, b, n, d,
                         num_cells, group, s);
  }
  return (int)cudaErrorInvalidValue;
}
