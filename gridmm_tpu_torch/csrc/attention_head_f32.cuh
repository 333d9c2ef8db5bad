// CUDA-core body of the per-head attention kernel (attention_fwd.cu), f32,
// any head_dim: for each (slice, query row t),
//     o[t] = sum_j softmax_j(q[t] . k[j] * scale) v[j]
// in exact f32 FMAs (no TF32: the f32 tolerance is 2e-5).
//
// Design of attention_head_f32_kernel (kHdP <= 256; one block = up to
// sixteen warps, eight above kHdP 128, over kQ x warps query rows of one
// slice):
//   * hd is zero-padded on chip to kHdP (16, or the next multiple of 32);
//     K and V rows sit in shared memory kHdP + 4 floats apart, so that the
//     16-byte reads of eight lanes on eight rows fall in eight bank groups;
//   * a warp takes kQ = 4 query rows, copies them into its own rows of
//     shared memory and walks the keys 32 at a time, one key a lane, each
//     K row read once for the four queries; the softmax is online (a
//     running max a row, each lane's share of the sum, the accumulator
//     rescaled where the max grows), so a warp keeps one tile's
//     probabilities, kQ x 32 floats, whatever `len`;
//   * P V runs with lanes over output dims (and, at kHdP 16, two halves of
//     the warp over even and odd keys), reading the probabilities from the
//     warp's rows. A tile's products are summed apart and then added to the
//     rescaled running sum: added one by one, the many small terms of a
//     long row fall below half an ulp of the sum and are lost;
//   * the slice's 32-key tiles of K and V stream through a ring of
//     ring_slots(kHdP) slots (four, or the most up to four that fit; the
//     same at every len), up to three copies ahead of the products, one
//     barrier a tile. Staging a block's slices whole where they fit was
//     not faster at the main paths' shapes (`chip_profile.py --k4-builds`,
//     NVIDIA H100 80GB HBM3, 700 W, mean of two turns: the tiny tower's
//     (192, 50, 16) 0.01101 ms staged against 0.01097 streamed, the tiny
//     CE agent's (96, 50, 16) 0.01077 against 0.00835).
//
// attention_head_f32_wide_kernel takes hd above 256: a work item is (slice,
// 128-column share of the output, 32 query rows of eight warps); for every
// 32-key tile the ring carries K in 128-column chunks, each with the warp's
// Q rows of that chunk, whose products sum into the scores, then the
// share's V, whose products are summed by tiles as above.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace gridmm_head_f32 {

constexpr int kMaxWarps = 16;   // warps a block, fewer where fewer have rows
constexpr int kQ = 4;           // query rows a warp takes at once
constexpr int kKeys = 32;       // keys a tile (a lane each)
constexpr int kAhead = 3;       // copies in flight ahead of the products
constexpr int kChunk = 128;     // columns a chunk of the wide kernel
constexpr int kWideWarps = 8;
constexpr int kWideSlots = 4;
constexpr size_t kMaxSmem = 232448;   // bytes a block may use on sm_90

__host__ __device__ constexpr int padded_hd(int hd) {
  return hd <= 16 ? 16 : (hd + 31) / 32 * 32;
}

// warps a block at most: sixteen, or eight above kHdP 128, where a lane's
// accumulators take more registers than sixteen warps leave
__host__ __device__ constexpr int max_warps(int hdp) {
  return hdp > 128 ? kMaxWarps / 2 : kMaxWarps;
}
// a block's warps' probability rows and query rows, in floats
__host__ __device__ constexpr size_t fixed_floats(int hdp) {
  return (size_t)max_warps(hdp) * kQ * (kKeys + hdp);
}
// one slot of the ring: 32 rows of K and of V, hdp + 4 floats each
__host__ __device__ constexpr size_t slot_floats(int hdp) {
  return (size_t)2 * kKeys * (hdp + 4);
}
// Slots of the ring: kAhead + 1 (four), or the most that fit (two at
// kHdP 256).
inline int ring_slots(int hdp) {
  const int n = (int)((kMaxSmem - fixed_floats(hdp) * sizeof(float)) /
                      (slot_floats(hdp) * sizeof(float)));
  return n < kAhead + 1 ? n : kAhead + 1;
}
inline size_t smem_bytes(int hdp) {
  return (fixed_floats(hdp) + ring_slots(hdp) * slot_floats(hdp)) *
         sizeof(float);
}
// the wide kernel: probability and Q rows of its warps, then the ring of
// 32-row pieces of kChunk + 4 floats
constexpr size_t kWideSmemBytes =
    ((size_t)kWideWarps * kQ * (kKeys + kChunk) +
     (size_t)kWideSlots * kKeys * (kChunk + 4)) * sizeof(float);

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// cp.async.wait_group with a count known only at run time (0 .. kAhead - 1)
__device__ __forceinline__ void wait_pending(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  }
}

// Block-wide: rows [0, rows) x columns [c0, c0 + cols) of a row-major
// (rows, hd) f32 array into shared rows of `stride` floats by cp.async (16
// bytes where hd and c0 are multiples of 4, else 4), columns cols ..
// stride zeroed. The caller commits and waits.
__device__ __forceinline__ void stage_rows(float* dst, int stride,
                                           const float* src, int rows, int hd,
                                           int c0, int cols) {
  if ((hd & 3) == 0 && (c0 & 3) == 0 && (cols & 3) == 0) {
    const int per_row = cols / 4;
    for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
      const int r = i / per_row;
      const int c = (i - r * per_row) * 4;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       smem_addr(dst + r * stride + c)),
                   "l"(src + (size_t)r * hd + c0 + c)
                   : "memory");
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
      const int r = i / cols;
      const int c = i - r * cols;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                       smem_addr(dst + r * stride + c)),
                   "l"(src + (size_t)r * hd + c0 + c)
                   : "memory");
    }
  }
  const int pad = stride - cols;
  for (int i = threadIdx.x; i < rows * pad; i += blockDim.x) {
    const int r = i / pad;
    dst[r * stride + cols + (i - r * pad)] = 0.f;
  }
}

// A warp's running softmax over its kQ query rows: the max of each row
// (the same in every lane) and this lane's share of its sum.
struct Running {
  float m[kQ], l[kQ];

  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int qi = 0; qi < kQ; ++qi) {
      m[qi] = -INFINITY;
      l[qi] = 0.f;
    }
  }

  // A tile's scores (times log2 e; one key a lane, -inf past the keys):
  // the new max of each row, the factor `corr` that rescales what was
  // summed before, and the lane's probabilities into `ss` ([kQ][32]).
  __device__ __forceinline__ void absorb(const float (&s)[kQ],
                                         float (&corr)[kQ], float* ss) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int qi = 0; qi < kQ; ++qi) {
      float mx = s[qi];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float mn = fmaxf(m[qi], mx);   // finite: key 0 of a tile is real
      corr[qi] = exp2f(m[qi] - mn);        // 0 on the first tile
      m[qi] = mn;
      const float p = exp2f(s[qi] - mn);
      l[qi] = l[qi] * corr[qi] + p;
      ss[qi * kKeys + lane] = p;
    }
  }

  // 1 / each row's sum
  __device__ __forceinline__ void totals(float (&inv)[kQ]) const {
#pragma unroll
    for (int qi = 0; qi < kQ; ++qi) {
      float t = l[qi];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        t += __shfl_xor_sync(0xffffffffu, t, off);
      }
      inv[qi] = 1.f / t;
    }
  }
};

// q, k, v, o (bh, len, hd) f32; blockDim.x = 32 x warps, warps in 1 ..
// max_warps(kHdP); grid bh * ceil(ceil(len / kQ) / warps): a block takes
// kQ x warps query rows of one slice. Dynamic shared memory
// smem_bytes(kHdP) (slots = ring_slots(kHdP)). scale_log2e = log2(e) /
// sqrt(hd).
template <int kHdP>
__global__ void __launch_bounds__(32 * max_warps(kHdP))
attention_head_f32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o,
                          int len, int hd, int slots, float scale_log2e) {
  constexpr int kStride = kHdP + 4;
  constexpr int kDimLanes = kHdP < 32 ? kHdP : 32;  // lanes over dims in PV
  constexpr int kGroups = 32 / kDimLanes;           // key groups in PV
  constexpr int kDpl = kHdP / kDimLanes;            // dims a lane in PV
  constexpr int kVecs = kHdP / 4;
  extern __shared__ __align__(16) float smem[];
  const int nw = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int groups = (len + kQ - 1) / kQ;   // query groups of a slice
  const int per_slice = (groups + nw - 1) / nw;
  const int g = (blockIdx.x % per_slice) * nw + warp;   // the warp's group
  const bool valid = g < groups;
  const int t0 = g * kQ;
  const int nq = valid ? min(kQ, len - t0) : 0;
  const size_t base = (size_t)(blockIdx.x / per_slice) * len * hd;
  const int tiles = (len + kKeys - 1) / kKeys;
  float* ss = smem + warp * kQ * kKeys;                    // [kQ][32]
  float* sq = smem + max_warps(kHdP) * kQ * kKeys + warp * kQ * kHdP;
  float* sk = smem + fixed_floats(kHdP);
  float* sv = sk + (size_t)slots * kKeys * kStride;

  // key tile t of the slice into its slot of the ring
  auto load_tile = [&](int t) {
    const int rows = min(kKeys, len - t * kKeys);
    const size_t off = base + (size_t)t * kKeys * hd;
    const int slot = (t % slots) * kKeys * kStride;
    stage_rows(sk + slot, kStride, k + off, rows, hd, 0, hd);
    stage_rows(sv + slot, kStride, v + off, rows, hd, 0, hd);
  };
  const int ahead = min(kAhead, slots - 1);
  for (int t = 0; t < ahead; ++t) {
    if (t < tiles) load_tile(t);
    commit();
  }
  // the warp's kQ query rows, zero past hd and past `len`
  for (int i = lane; i < kQ * kHdP; i += 32) {
    const int qi = i / kHdP;
    const int c = i - qi * kHdP;
    sq[i] = qi < nq && c < hd ? q[base + (size_t)(t0 + qi) * hd + c] : 0.f;
  }
  __syncwarp();

  const int dl = lane % kDimLanes;
  const int grp = lane / kDimLanes;
  Running run;
  run.reset();
  float acc[kQ][kDpl];
#pragma unroll
  for (int qi = 0; qi < kQ; ++qi) {
#pragma unroll
    for (int t = 0; t < kDpl; ++t) acc[qi][t] = 0.f;
  }
  for (int t = 0; t < tiles; ++t) {
    // tile t has landed; every warp is done with the slot the next copy
    // fills (that of tile t - 1)
    wait_pending(ahead - 1);
    __syncthreads();
    if (t + ahead < tiles) load_tile(t + ahead);
    commit();
    if (!valid) continue;
    const int j0 = t * kKeys;
    const int r0 = (t % slots) * kKeys;   // the tile's first shared row
    const int nr = min(kKeys, len - j0);

    // scores (times log2 e) of key j0 + lane
    float s[kQ];
    {
      const float4* kr = reinterpret_cast<const float4*>(
          sk + (size_t)(r0 + lane) * kStride);
#pragma unroll
      for (int qi = 0; qi < kQ; ++qi) s[qi] = 0.f;
#pragma unroll
      for (int c = 0; c < kVecs; ++c) {
        const float4 kv = kr[c];
#pragma unroll
        for (int qi = 0; qi < kQ; ++qi) {
          const float4 qv = reinterpret_cast<const float4*>(sq + qi * kHdP)[c];
          s[qi] = fmaf(qv.x, kv.x, s[qi]);
          s[qi] = fmaf(qv.y, kv.y, s[qi]);
          s[qi] = fmaf(qv.z, kv.z, s[qi]);
          s[qi] = fmaf(qv.w, kv.w, s[qi]);
        }
      }
#pragma unroll
      for (int qi = 0; qi < kQ; ++qi) {
        s[qi] = lane < nr ? s[qi] * scale_log2e : -INFINITY;
      }
    }
    float corr[kQ];
    run.absorb(s, corr, ss);
    __syncwarp();
    // this tile's P V, lanes over dims, kGroups key groups; then O = O *
    // corr + P V
    float tacc[kQ][kDpl];
#pragma unroll
    for (int qi = 0; qi < kQ; ++qi) {
#pragma unroll
      for (int d = 0; d < kDpl; ++d) tacc[qi][d] = 0.f;
    }
#pragma unroll 4
    for (int j = grp; j < nr; j += kGroups) {
      const float* vr = sv + (size_t)(r0 + j) * kStride + dl;
      float vv[kDpl];
#pragma unroll
      for (int d = 0; d < kDpl; ++d) vv[d] = vr[d * kDimLanes];
#pragma unroll
      for (int qi = 0; qi < kQ; ++qi) {
        const float p = ss[qi * kKeys + j];
#pragma unroll
        for (int d = 0; d < kDpl; ++d) {
          tacc[qi][d] = fmaf(p, vv[d], tacc[qi][d]);
        }
      }
    }
#pragma unroll
    for (int qi = 0; qi < kQ; ++qi) {
#pragma unroll
      for (int d = 0; d < kDpl; ++d) {
        acc[qi][d] = fmaf(acc[qi][d], corr[qi], tacc[qi][d]);
      }
    }
    __syncwarp();   // the probabilities are read before the next tile's
  }
  wait_pending(0);
  if (!valid) return;
  if constexpr (kGroups == 2) {
#pragma unroll
    for (int qi = 0; qi < kQ; ++qi) {
#pragma unroll
      for (int d = 0; d < kDpl; ++d) {
        acc[qi][d] += __shfl_xor_sync(0xffffffffu, acc[qi][d], 16);
      }
    }
  }
  float inv[kQ];
  run.totals(inv);
  if (grp != 0) return;
#pragma unroll
  for (int qi = 0; qi < kQ; ++qi) {
    if (qi < nq) {
#pragma unroll
      for (int d = 0; d < kDpl; ++d) {
        const int col = dl + d * kDimLanes;
        if (col < hd) {
          o[base + (size_t)(t0 + qi) * hd + col] = acc[qi][d] * inv[qi];
        }
      }
    }
  }
}

// q, k, v, o (bh, len, hd) f32, hd > 256; items = bh * shares * ceil(len /
// (kQ * kWideWarps)), shares = ceil(hd / kChunk); grid <= items,
// persistent; blockDim.x = 32 * kWideWarps; dynamic shared memory
// kWideSmemBytes. scale_log2e = log2(e) / sqrt(hd). Each 32-key tile brings
// `chunks` K pieces of kChunk columns, then the share's V piece, through a
// ring of kWideSlots slots.
__global__ void __launch_bounds__(32 * kWideWarps)
attention_head_f32_wide_kernel(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               float* __restrict__ o, long long items,
                               int len, int hd, float scale_log2e) {
  constexpr int kStride = kChunk + 4;
  constexpr int kDpl = kChunk / 32;
  constexpr int kRowsPerItem = kQ * kWideWarps;
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* ss = smem + warp * kQ * kKeys;
  float* sq = smem + kWideWarps * kQ * kKeys + warp * kQ * kChunk;
  float* ring = smem + kWideWarps * kQ * (kKeys + kChunk);
  const int tiles = (len + kKeys - 1) / kKeys;
  const int chunks = (hd + kChunk - 1) / kChunk;
  const int groups = (len + kRowsPerItem - 1) / kRowsPerItem;
  const int pieces = tiles * (chunks + 1);     // K chunks, then V, a tile

  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const long long slice_share = item / groups;
    const int share = (int)(slice_share % chunks);
    const size_t base = (size_t)(slice_share / chunks) * len * hd;
    const int c0 = share * kChunk;
    const int t0 = (int)(item % groups) * kRowsPerItem + warp * kQ;
    const int nq = max(0, min(kQ, len - t0));

    // piece p: tile p / (chunks + 1); column chunk p % (chunks + 1), or the
    // share's V where that is `chunks`; columns past hd are zero
    auto load_piece = [&](int p) {
      const int t = p / (chunks + 1);
      const int c = p % (chunks + 1);
      const int rows = min(kKeys, len - t * kKeys);
      const int col0 = c < chunks ? c * kChunk : c0;
      stage_rows(ring + (p % kWideSlots) * kKeys * kStride, kStride,
                 (c < chunks ? k : v) + base + (size_t)t * kKeys * hd, rows,
                 hd, col0, min(kChunk, hd - col0));
    };
    for (int p = 0; p < kWideSlots - 1; ++p) {
      if (p < pieces) load_piece(p);
      commit();
    }
    Running run;
    run.reset();
    float acc[kQ][kDpl];
#pragma unroll
    for (int qi = 0; qi < kQ; ++qi) {
#pragma unroll
      for (int d = 0; d < kDpl; ++d) acc[qi][d] = 0.f;
    }
    float s[kQ];
    for (int p = 0; p < pieces; ++p) {
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kWideSlots - 2)
                   : "memory");
      __syncthreads();
      if (p + kWideSlots - 1 < pieces) load_piece(p + kWideSlots - 1);
      commit();
      if (nq == 0) continue;
      const int t = p / (chunks + 1);
      const int c = p % (chunks + 1);
      const int nr = min(kKeys, len - t * kKeys);
      const float* piece = ring + (p % kWideSlots) * kKeys * kStride;
      if (c < chunks) {
        // the warp's Q rows of this chunk, zero past hd and past len
        const int col0 = c * kChunk;
        __syncwarp();
        for (int i = lane; i < kQ * kChunk; i += 32) {
          const int qi = i / kChunk;
          const int col = col0 + i - qi * kChunk;
          sq[i] = qi < nq && col < hd
                      ? q[base + (size_t)(t0 + qi) * hd + col] : 0.f;
        }
        __syncwarp();
        if (c == 0) {
#pragma unroll
          for (int qi = 0; qi < kQ; ++qi) s[qi] = 0.f;
        }
        const float4* kr =
            reinterpret_cast<const float4*>(piece + lane * kStride);
#pragma unroll 8
        for (int cc = 0; cc < kChunk / 4; ++cc) {
          const float4 kv = kr[cc];
#pragma unroll
          for (int qi = 0; qi < kQ; ++qi) {
            const float4 qv =
                reinterpret_cast<const float4*>(sq + qi * kChunk)[cc];
            s[qi] = fmaf(qv.x, kv.x, s[qi]);
            s[qi] = fmaf(qv.y, kv.y, s[qi]);
            s[qi] = fmaf(qv.z, kv.z, s[qi]);
            s[qi] = fmaf(qv.w, kv.w, s[qi]);
          }
        }
        continue;
      }
      float sc[kQ], corr[kQ];
#pragma unroll
      for (int qi = 0; qi < kQ; ++qi) {
        sc[qi] = lane < nr ? s[qi] * scale_log2e : -INFINITY;
      }
      run.absorb(sc, corr, ss);
      __syncwarp();
      float tacc[kQ][kDpl];
#pragma unroll
      for (int qi = 0; qi < kQ; ++qi) {
#pragma unroll
        for (int d = 0; d < kDpl; ++d) tacc[qi][d] = 0.f;
      }
      for (int j = 0; j < nr; ++j) {
        const float* vr = piece + j * kStride + lane;
        float vv[kDpl];
#pragma unroll
        for (int d = 0; d < kDpl; ++d) vv[d] = vr[d * 32];
#pragma unroll
        for (int qi = 0; qi < kQ; ++qi) {
          const float pr = ss[qi * kKeys + j];
#pragma unroll
          for (int d = 0; d < kDpl; ++d) {
            tacc[qi][d] = fmaf(pr, vv[d], tacc[qi][d]);
          }
        }
      }
#pragma unroll
      for (int qi = 0; qi < kQ; ++qi) {
#pragma unroll
        for (int d = 0; d < kDpl; ++d) {
          acc[qi][d] = fmaf(acc[qi][d], corr[qi], tacc[qi][d]);
        }
      }
      __syncwarp();
    }
    if (nq > 0) {
      float inv[kQ];
      run.totals(inv);
#pragma unroll
      for (int qi = 0; qi < kQ; ++qi) {
        if (qi < nq) {
#pragma unroll
          for (int d = 0; d < kDpl; ++d) {
            const int col = c0 + lane + d * 32;
            if (col < hd) {
              o[base + (size_t)(t0 + qi) * hd + col] = acc[qi][d] * inv[qi];
            }
          }
        }
      }
    }
    __syncthreads();      // the ring is free for the next item's copies
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

}  // namespace gridmm_head_f32
