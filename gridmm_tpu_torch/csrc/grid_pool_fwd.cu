// Grid-pool forward for Hopper (sm_90a): the per-cell segment-softmax pool in
// one launch, owner-computes, without atomics, over any row length and batch.
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
// one-hot and runs a matrix product to reach the TPU's matrix unit, and sums
// over a sequential grid. A point-major reduction with atomics is bound by
// atomic traffic, not by bytes, needs zero-filled outputs and small launches
// around it, and sums in an order that changes from run to run. Here the
// reduction is cell-major with owners, and a long row is split over a
// thread-block cluster:
//   * a cluster of `rsplit` blocks (1..8) owns (batch row, group of `group`
//     consecutive cells, slab of up to eight column warps); the row is dealt
//     to the blocks in runs of 32 points (block r takes runs r, r + rsplit,
//     ...), so a cell that holds most of a row is streamed by rsplit SMs,
//     not by one, and a cell whose points sit in one stretch of the row (a
//     buffer gains a view's points at a time) is shared out too. The
//     wrapper takes rsplit, `chunk` and `group` from the inputs' shape
//     (ops/cuda/grid_pool.fwd_launch_shape): a block for each 8,832 points
//     of a row, which on the main paths' own buffers leaves the serving
//     and pipeline rows whole and splits the pretraining and CE rows in
//     two, where each measured fastest (PERF.md, section 6);
//   * a block lists its share in chunks of at most `chunk` points (one
//     chunk at the main paths' shapes): it reads
//     the chunk's cell ids twice (the second time from cache, kScan loads in
//     flight a lane); each warp owns a contiguous range, counts its matches
//     per cell with ballots, and after one prefix over the warps fills the
//     compact list of each cell in shared memory, chunk-local point index
//     (16 bits) and weight, in ascending point order. Shared memory bounds
//     the chunk (6 bytes a point), not the row: N is any length;
//   * per chunk, one warp per cell takes the max of the weights, updates the
//     block's running max and rescales its running denominator and sums to
//     it (online softmax: by exp(old max - new max), exactly 0 before the
//     first point), turns the weights into e_i = exp(w - max) in place and
//     adds them (lane-strided, then a shuffle tree);
//   * for each cell, a warp owns 32 x 16 bytes of every row (a lane's 16-byte
//     load: four f32 or eight bf16 columns) and one of `split` contiguous
//     parts of the cell's list; a block has twelve warps or fewer, so a bf16
//     row of 768 columns has three column warps and four parts, an f32 row
//     six and two. A warp takes 32 indices and e_i at a time, one a lane,
//     and walks them with shuffles, kUnroll feature rows in flight, adding
//     e_i * g_i into its registers, then into its running sums; no barrier
//     separates one cell from the next. Registers are capped at what lets
//     an SM hold as many blocks as its shared memory does (three for a
//     cluster's block; for a lone block three where they fit, else two). The
//     parts meet in shared memory in a fixed order;
//   * alone (rsplit 1, no cluster), the block divides and writes; in a
//     cluster, the blocks meet through distributed shared memory (the
//     unsplit rows of the main paths took 8-15% longer through this merge
//     as a cluster of one block, so both finishing paths stay): after a
//     cluster barrier one warp of one block merges each (cell, column warp),
//     reading the blocks' max, denominator and sums in rank order, each
//     rescaled by exp(its max - the cell's max), divides and writes the row;
//     a second barrier keeps every block's shared memory alive until the
//     others have read it.
// Every feature row is read once, no global scratch is used, nothing is
// zero-filled, every output element has one writer, and the order of every
// sum depends on the inputs' shape alone: two runs give the same bits. Rows
// past the grid's 65,535 are taken in turn; every row offset is 64-bit.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCellPad = 256;      // denominator row length (max num_cells)
constexpr int kBlockWarps = 12;    // warps a block aims for
constexpr int kMaxColWarps = 8;    // column warps a block has at most
constexpr int kMaxSplit = 4;       // warps that share one cell's points
constexpr int kMaxWarps = 16;
// blocks an SM must hold, which caps the registers: a cluster's blocks
// (kClusterMinBlocks), and a lone block where its shared memory lets an SM
// hold three (else two, 80 registers a thread); PERF.md section 6 has the
// builds this was chosen from
constexpr int kClusterMinBlocks = 3;
constexpr int kSmemPerSm = 233472;  // bytes of shared memory an SM has
constexpr int kSmemPerBlock = 1024; // bytes the system keeps for each block
constexpr int kMaxGroup = 4;       // cells per block, at most
constexpr int kMaxRowSplit = 8;    // blocks of a row: a portable cluster
constexpr int kMaxChunk = 65536;   // points a list may hold: 16-bit indices
constexpr int kMaxGridYZ = 65535;  // rows and slabs beyond it: in turn
constexpr int kScan = 8;           // cell-id loads in flight per lane
constexpr int kUnroll = 4;         // feature rows in flight per warp
constexpr int kMaxSmem = 232448;   // bytes a block may use on sm_90
constexpr int kStaticSmem = 1024;  // the fixed tables below, rounded up
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

// grid (cell groups x rsplit, batch rows, column slabs); with kCluster,
// clusters of (rsplit, 1, 1), else rsplit is 1. Rows past gridDim.y and
// slabs past gridDim.z are taken in turn. col_warps * split warps a block.
// Dynamic shared memory: the running sums [group][split][col_warps][32
// lanes][kCols] f32, then per point of a chunk a weight (f32) and an index
// (16 bits): the chunk's lists of the block's cells.
template <typename T, bool kVec, bool kCluster, int kMinBlocks>
__global__ void __launch_bounds__(kBlockWarps * 32, kMinBlocks)
grid_pool_fwd_kernel(const T* __restrict__ g, const int* __restrict__ cells,
                     const float* __restrict__ w, float* __restrict__ pooled,
                     unsigned char* __restrict__ mask,
                     float* __restrict__ denom, float* __restrict__ cmax,
                     int rows, int n, int d, int num_cells, int group,
                     int col_warps, int split, int rsplit, int chunk,
                     int slabs) {
  constexpr int kCols = Lane<T, kVec>::kCols;
  constexpr int kWarpCols = Lane<T, kVec>::kWarpCols;
  extern __shared__ float4 smem_raw[];
  float* s_part = reinterpret_cast<float*>(smem_raw);
  float* s_e = s_part + group * split * col_warps * 32 * kCols;
  unsigned short* s_idx = reinterpret_cast<unsigned short*>(s_e + chunk);
  __shared__ int s_cnt[kMaxWarps][kMaxGroup];    // matches per warp and cell
  __shared__ int s_start[kMaxGroup + 1];         // list offset of each cell
  __shared__ float s_max[kMaxGroup];     // the block's running max per cell
  __shared__ float s_den[kMaxGroup];     // its sum of exp(w - s_max)
  __shared__ float s_scale[kMaxGroup];   // this chunk's rescale of the sums

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int rank = 0;
  if constexpr (kCluster) rank = (int)cg::this_cluster().block_rank();
  const int c0 = (blockIdx.x / rsplit) * group;
  const int n_here = min(group, num_cells - c0);   // cells of this block
  // this block's share of a row: the 32-point runs rank, rank + rsplit,
  // ... ; share position j is the row's point at(j)
  const unsigned runs = ((unsigned)n + 31u) / 32u;
  const int share = rank < (int)runs
                        ? (int)((runs - rank + rsplit - 1) / rsplit) * 32
                        : 0;
  auto at = [&](int j) -> unsigned {
    if constexpr (kCluster) {
      return (((unsigned)j >> 5) * rsplit + rank) * 32u + (j & 31);
    } else {
      return (unsigned)j;
    }
  };
  const int cw = warp % col_warps;     // which columns of the slab
  const int part = warp / col_warps;   // which part of each cell's list
  const unsigned lanes_below = (1u << lane) - 1u;

  for (int row = blockIdx.y; row < rows; row += gridDim.y)
  for (int slab = blockIdx.z; slab < slabs; slab += gridDim.z) {
    const size_t b = (size_t)row;
    const size_t row0 = b * (size_t)n;
    const int* crow = cells + row0;
    const float* wrow = w + row0;
    const T* grow = g + row0 * d;
    const int col0 = (slab * col_warps + cw) * kWarpCols;
    for (int k = 0; k < n_here; ++k) {
      float* mine =
          s_part + (((k * split + part) * col_warps + cw) * 32 + lane) * kCols;
#pragma unroll
      for (int i = 0; i < kCols; ++i) mine[i] = 0.f;
    }
    if (threadIdx.x < kMaxGroup) {
      s_max[threadIdx.x] = -INFINITY;
      s_den[threadIdx.x] = 0.f;
    }

    for (int q0 = 0; q0 < share; q0 += chunk) {
      // ---- the chunk's lists: count, prefix over the warps, fill. Ids
      // past `end` or the row match nothing, and 32 ids with no match (most
      // of them) cost one ballot. A warp's 32 share positions are 32
      // consecutive points of the row.
      const int len = min(share - q0, chunk);
      const int per_warp = ((len + n_warps - 1) / n_warps + 31) / 32 * 32;
      const int begin = q0 + min(len, warp * per_warp);
      const int end = min(q0 + len, begin + per_warp);

      int rel[kScan];   // cell id less c0 where the block owns the cell, or -1
      auto load_ids = [&](int i0) {
#pragma unroll
        for (int u = 0; u < kScan; ++u) {
          const int p = i0 + 32 * u + lane;
          const unsigned i = at(p);
          const int id = p < end && i < (unsigned)n ? crow[i] : -1;
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
            if (k < n_here) {
              cnt[k] += __popc(__ballot_sync(kFull, rel[u] == k));
            }
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
          wv[u] = rel[u] >= 0 ? wrow[at(i0 + 32 * u + lane)] : 0.f;
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
                s_idx[pos] = (unsigned short)(i0 + 32 * u + lane - q0);
                s_e[pos] = wv[u];
              }
              base[k] += __popc(hit);
            }
          }
        }
      }
      __syncthreads();

      // ---- per cell: the chunk's max, the running max and the rescale of
      // the running sums to it, e_i in place of the weights, the denominator
      for (int k = warp; k < n_here; k += n_warps) {
        const int st = s_start[k];
        const int cn = s_start[k + 1] - st;
        const float m_old = s_max[k];
        float mx = m_old;
        for (int i = lane; i < cn; i += 32) mx = fmaxf(mx, s_e[st + i]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
        }
        float sum = 0.f;
        for (int i = lane; i < cn; i += 32) {
          // 0 while every weight of the cell so far is -inf
          const float e = mx == -INFINITY ? 0.f : expf(s_e[st + i] - mx);
          s_e[st + i] = e;
          sum += e;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          sum += __shfl_xor_sync(kFull, sum, off);
        }
        if (lane == 0) {
          // 0 before the cell's first point, 1 where the max holds
          const float scale = mx == -INFINITY ? 1.f : expf(m_old - mx);
          s_scale[k] = scale;
          s_den[k] = fmaf(s_den[k], scale, sum);
          s_max[k] = mx;
        }
      }
      __syncthreads();

      // ---- per cell and part: the weighted sum of the chunk's rows, added
      // to the rescaled running sums
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
                v[u] = load_cols<T, kVec>(grow + (size_t)at(q0 + pi) * d,
                                          col0, lane, d);
              }
            }
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
              const float ej = __shfl_sync(kFull, e, (j0 + u) & 31);
              add_cols<T, kVec>(acc, v[u], ej);
            }
          }
        }
        const float scale = s_scale[k];
        float* mine =
            s_part + (((k * split + part) * col_warps + cw) * 32 + lane) *
                         kCols;
#pragma unroll
        for (int i = 0; i < kCols; ++i) mine[i] = fmaf(mine[i], scale, acc[i]);
      }
      __syncthreads();   // the next chunk refills the lists
    }
    __syncthreads();   // a block whose part is empty zeroed its sums above

    const bool writes_stats = slab == 0;
    if (writes_stats && blockIdx.x == 0) {   // the denominator row's padding
      for (int c = num_cells + threadIdx.x; c < kCellPad; c += blockDim.x) {
        denom[b * kCellPad + c] = 0.f;
      }
    }
    // ---- the parts meet in a fixed order (part 0 + part 1 + ...); alone,
    // the block divides and writes, in a cluster it keeps the sum in part
    // 0's place for the merge
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
      if constexpr (kCluster) {
        float* first =
            s_part + ((k * split * col_warps + cw) * 32 + lane) * kCols;
#pragma unroll
        for (int i = 0; i < kCols; ++i) first[i] = acc[i];
      } else {
        const float den = s_den[k];
        if (writes_stats && cw == 0 && lane == 0) {
          cmax[b * num_cells + c0 + k] = s_max[k];
          denom[b * kCellPad + c0 + k] = den;
          mask[b * num_cells + c0 + k] = den > 0.f ? 1 : 0;
        }
#pragma unroll
        for (int i = 0; i < kCols; ++i) {
          acc[i] = den > 0.f ? acc[i] / den : 0.f;
        }
        store_cols<T, kVec>(pooled + (b * num_cells + c0 + k) * d, col0,
                            lane, d, acc);
      }
    }
    if constexpr (kCluster) {
      cg::cluster_group cluster = cg::this_cluster();
      // a peer block's copy of a shared variable
      auto peer = [&](auto* p, int r) {
        return cluster.map_shared_rank(p, (unsigned)r);
      };
      cluster.sync();
      // ---- the cluster's blocks meet in rank order; divide, write. Item
      // (cell k, column warp icw) goes to block it % rsplit.
      const int items = n_here * col_warps;
      for (int it = rank + rsplit * warp; it < items; it += rsplit * n_warps) {
        const int k = it / col_warps;
        const int icw = it % col_warps;
        float mx = -INFINITY;
        for (int r = 0; r < rsplit; ++r) mx = fmaxf(mx, *peer(&s_max[k], r));
        float den = 0.f;
        float acc[kCols];
#pragma unroll
        for (int i = 0; i < kCols; ++i) acc[i] = 0.f;
        const float* mine =
            s_part + ((k * split * col_warps + icw) * 32 + lane) * kCols;
        for (int r = 0; r < rsplit; ++r) {
          const float m_r = *peer(&s_max[k], r);
          const float sc = m_r == -INFINITY ? 0.f : expf(m_r - mx);
          den = fmaf(*peer(&s_den[k], r), sc, den);
          const float* theirs = peer(mine, r);
#pragma unroll
          for (int i = 0; i < kCols; ++i) {
            acc[i] = fmaf(theirs[i], sc, acc[i]);
          }
        }
        if (writes_stats && icw == 0 && lane == 0) {
          cmax[b * num_cells + c0 + k] = mx;
          denom[b * kCellPad + c0 + k] = den;
          mask[b * num_cells + c0 + k] = den > 0.f ? 1 : 0;
        }
#pragma unroll
        for (int i = 0; i < kCols; ++i) {
          acc[i] = den > 0.f ? acc[i] / den : 0.f;
        }
        store_cols<T, kVec>(pooled + (b * num_cells + c0 + k) * d,
                            (slab * col_warps + icw) * kWarpCols, lane, d,
                            acc);
      }
    }
    // the running sums are reset for the next row; in a cluster every
    // block's stay until the others have read them
    if constexpr (kCluster) {
      cg::this_cluster().sync();
    } else {
      __syncthreads();
    }
  }
}

// a block's warps over the columns: col_warps column warps (a slab) times
// split parts of each cell's list, and the slabs of a row
template <typename T, bool kVec>
void fwd_layout(int d, int* col_warps, int* split, int* slabs) {
  constexpr int kWarpCols = Lane<T, kVec>::kWarpCols;
  const int total_cw = (int)(((long long)d + kWarpCols - 1) / kWarpCols);
  *col_warps = total_cw < kMaxColWarps ? total_cw : kMaxColWarps;
  *slabs = (total_cw + *col_warps - 1) / *col_warps;
  const int s = kBlockWarps / *col_warps;
  *split = s < 1 ? 1 : (s > kMaxSplit ? kMaxSplit : s);
}

// a block's dynamic shared memory: the running sums and a chunk's lists
template <typename T, bool kVec>
size_t fwd_smem(int d, int group, int chunk) {
  int col_warps, split, slabs;
  fwd_layout<T, kVec>(d, &col_warps, &split, &slabs);
  return sizeof(float) * group * split * col_warps * 32 *
             Lane<T, kVec>::kCols +
         (sizeof(float) + sizeof(unsigned short)) * (size_t)chunk;
}

template <typename T, bool kVec, bool kCluster, int kMinBlocks>
int launch_kernel(const T* g, const int* cells, const float* w, float* pooled,
                  unsigned char* mask, float* denom, float* cmax, int b,
                  int n, int d, int num_cells, int group, int rsplit,
                  int chunk, cudaStream_t stream) {
  int col_warps, split, slabs;
  fwd_layout<T, kVec>(d, &col_warps, &split, &slabs);
  const size_t smem = fwd_smem<T, kVec>(d, group, chunk);
  if (smem + kStaticSmem > (size_t)kMaxSmem) {
    return (int)cudaErrorInvalidValue;
  }
  auto kernel = grid_pool_fwd_kernel<T, kVec, kCluster, kMinBlocks>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)((num_cells + group - 1) / group * rsplit),
                        (unsigned)(b < kMaxGridYZ ? b : kMaxGridYZ),
                        (unsigned)(slabs < kMaxGridYZ ? slabs : kMaxGridYZ));
  config.blockDim = dim3((unsigned)(col_warps * split * 32));
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)rsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = kCluster ? 1 : 0;
  err = cudaLaunchKernelEx(&config, kernel, g, cells, w, pooled, mask, denom,
                           cmax, b, n, d, num_cells, group, col_warps, split,
                           rsplit, chunk, slabs);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, bool kVec>
int launch_split(const T* g, const int* cells, const float* w, float* pooled,
                 unsigned char* mask, float* denom, float* cmax, int b, int n,
                 int d, int num_cells, int group, int rsplit, int chunk,
                 cudaStream_t stream) {
  if (rsplit > 1) {
    return launch_kernel<T, kVec, true, kClusterMinBlocks>(
        g, cells, w, pooled, mask, denom, cmax, b, n, d, num_cells, group,
        rsplit, chunk, stream);
  }
  if (kSmemPerSm / (fwd_smem<T, kVec>(d, group, chunk) + kStaticSmem +
                    kSmemPerBlock) >= 3) {
    return launch_kernel<T, kVec, false, 3>(g, cells, w, pooled, mask, denom,
                                            cmax, b, n, d, num_cells, group,
                                            1, chunk, stream);
  }
  return launch_kernel<T, kVec, false, 2>(g, cells, w, pooled, mask, denom,
                                          cmax, b, n, d, num_cells, group, 1,
                                          chunk, stream);
}

template <typename T>
int launch(const void* g, const int* cells, const float* w, float* pooled,
           unsigned char* mask, float* denom, float* cmax, int b, int n,
           int d, int num_cells, int group, int rsplit, int chunk,
           cudaStream_t stream) {
  const T* gp = static_cast<const T*>(g);
  if (d % Lane<T, true>::kCols == 0) {
    return launch_split<T, true>(gp, cells, w, pooled, mask, denom, cmax, b,
                                 n, d, num_cells, group, rsplit, chunk,
                                 stream);
  }
  return launch_split<T, false>(gp, cells, w, pooled, mask, denom, cmax, b,
                                n, d, num_cells, group, rsplit, chunk,
                                stream);
}

}  // namespace

// Plain C entry point for ctypes. Every output is written in full and needs
// no initialisation: pooled (b, num_cells, d) f32, mask (b, num_cells) bytes
// (0 or 1), denom (b, 256) f32, cmax (b, num_cells) f32. `group` is the
// number of consecutive cells a block owns, 1..4; `row_split` the blocks (a
// cluster) that share a row, 1..8; `chunk` the points of a row's chunks,
// 1..65536, which go to the blocks in turn (6 bytes of shared memory a
// point besides the running sums). feature_dtype: 0 = f32, 1 =
// bf16. Returns the launch's cudaError_t (0 = success).
extern "C" int gridmm_grid_pool_fwd(const void* g, int feature_dtype,
                                    const int* cells, const float* w,
                                    float* pooled, unsigned char* mask,
                                    float* denom, float* cmax, int b, int n,
                                    int d, int num_cells, int group,
                                    int row_split, int chunk, void* stream) {
  if (num_cells < 1 || num_cells > kCellPad || group < 1 ||
      group > kMaxGroup || row_split < 1 || row_split > kMaxRowSplit ||
      chunk < 1 || chunk > kMaxChunk || b < 1 || n < 1 || d < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (feature_dtype == 1) {
    return launch<__nv_bfloat16>(g, cells, w, pooled, mask, denom, cmax, b, n,
                                 d, num_cells, group, row_split, chunk, s);
  }
  if (feature_dtype == 0) {
    return launch<float>(g, cells, w, pooled, mask, denom, cmax, b, n, d,
                         num_cells, group, row_split, chunk, s);
  }
  return (int)cudaErrorInvalidValue;
}
