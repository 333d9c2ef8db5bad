// CUDA-core body of the per-head attention kernel (attention_fwd.cu), f32,
// any head_dim from 1 to 256: for each (slice, query row t),
//     o[t] = sum_j softmax_j(q[t] . k[j] * scale) v[j]
// in exact f32 FMAs (no TF32: the f32 tolerance is 2e-5).
//
// Design (one block = up to sixteen warps over one or more slices):
//   * hd is zero-padded on chip to kHdP (16, or the next multiple of 32);
//     K and V rows sit in shared memory kHdP + 4 floats apart, so that the
//     16-byte reads of eight lanes on eight rows fall in eight bank groups;
//   * a warp takes kQ = 4 query rows of one slice at a time. The score rows
//     are spread over its lanes, one key a lane, each K row read once for
//     the four queries; the softmax is exact, in two passes (a warp max,
//     then exp and a warp sum), with no per-key rescale, as the Pallas
//     kernel computes it;
//   * P V runs with lanes over output dims (and, at kHdP 16, two halves of
//     the warp over even and odd keys), reading the probabilities from the
//     warp's score rows;
//   * Q, K and V of the block's slices are staged once, all by cp.async in
//     flight together, where they fit in shared memory: the block then
//     waits on device memory once. A
//     block has a warp for every four query rows, up to sixteen, and at
//     short L several slices, so that every warp has rows. Where one
//     slice's Q, K and V do not fit (large hd and L), each warp loads its
//     query rows, and K and V stream through shared memory in chunks of
//     keys, once for the scores and once for P V, per round of query rows.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace gridmm_head_f32 {

constexpr int kMaxWarps = 16;   // warps a block, fewer where fewer have rows
constexpr int kQ = 4;           // query rows a warp takes at once
constexpr int kMaxSlices = 16;  // slices a block holds at short L

__host__ __device__ constexpr int padded_hd(int hd) {
  return hd <= 16 ? 16 : (hd + 31) / 32 * 32;
}
__host__ __device__ inline int round32(int n) { return (n + 31) / 32 * 32; }

// Shared memory of a block of `warps` warps: their score rows; then, with
// `slices` whole slices resident, the slices' Q rows (and kQ zero rows
// after them) and K and V; else the warps' query rows and K and V of `kc`
// keys.
inline size_t smem_bytes(int warps, int len, int hdp, int slices, int kc) {
  const size_t scores = (size_t)warps * kQ * round32(len);
  const size_t qrows = slices > 0 ? (size_t)slices * len + kQ
                                  : (size_t)warps * kQ;
  const size_t kv = 2 * (size_t)(slices > 0 ? slices * len : kc) * (hdp + 4);
  return (scores + qrows * hdp + kv) * sizeof(float);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Block-wide: `rows` rows of a row-major (rows, hd) f32 array into shared
// rows of `stride` floats by cp.async (16 bytes where hd is a multiple of
// 4, else 4), columns hd .. stride zeroed. The caller commits and waits, so
// that every array it stages is in flight at once.
__device__ __forceinline__ void stage_rows(float* dst, int stride,
                                           const float* src, int rows,
                                           int hd) {
  if ((hd & 3) == 0) {
    const int per_row = hd / 4;
    for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
      const int r = i / per_row;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       smem_addr(dst + r * stride + (i - r * per_row) * 4)),
                   "l"(src + 4 * i)
                   : "memory");
    }
  } else {
    for (int i = threadIdx.x; i < rows * hd; i += blockDim.x) {
      const int r = i / hd;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                       smem_addr(dst + r * stride + (i - r * hd))),
                   "l"(src + i)
                   : "memory");
    }
  }
  const int pad = stride - hd;
  for (int i = threadIdx.x; i < rows * pad; i += blockDim.x) {
    const int r = i / pad;
    dst[r * stride + hd + (i - r * pad)] = 0.f;
  }
}

__device__ __forceinline__ void staged() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// q, k, v, o (bh, len, hd) f32; grid ceil(bh / nsl), blockDim.x = 32 x
// (1 .. kMaxWarps). A block holds slices [blockIdx.x * nsl, + nsl).
// kc >= len: Q, K and V of all of them are staged once; else nsl = 1, each
// warp loads its query rows and K and V stream in chunks of kc keys (a
// multiple of 32). Dynamic shared memory smem_bytes(warps, len, kHdP, nsl
// or 0, kc). scale_log2e = log2(e) / sqrt(hd).
template <int kHdP>
__global__ void __launch_bounds__(32 * kMaxWarps)
attention_head_f32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o,
                          int bh, int len, int hd, int nsl, int kc,
                          float scale_log2e) {
  constexpr int kStride = kHdP + 4;
  constexpr int kDimLanes = kHdP < 32 ? kHdP : 32;  // lanes over dims in PV
  constexpr int kGroups = 32 / kDimLanes;           // key groups in PV
  constexpr int kDpl = kHdP / kDimLanes;            // dims a lane in PV
  constexpr int kVecs = kHdP / 4;
  extern __shared__ __align__(16) float smem[];
  const int nw = blockDim.x >> 5;
  const int lr = round32(len);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool resident = kc >= len;
  const int s0 = blockIdx.x * nsl;
  const int ns = min(nsl, bh - s0);
  float* ss = smem + warp * kQ * lr;                 // [kQ][lr]
  float* sqs = smem + nw * kQ * lr;
  float* sk = sqs + (size_t)(resident ? nsl * len + kQ : nw * kQ) * kHdP;
  float* sv = sk + (size_t)(resident ? nsl * len : kc) * kStride;
  const size_t block_base = (size_t)s0 * len * hd;

  if (resident) {   // the block's slices are consecutive rows
    stage_rows(sqs, kHdP, q + block_base, ns * len, hd);
    for (int i = threadIdx.x; i < kQ * kHdP; i += blockDim.x) {
      sqs[(size_t)ns * len * kHdP + i] = 0.f;
    }
    stage_rows(sk, kStride, k + block_base, ns * len, hd);
    stage_rows(sv, kStride, v + block_base, ns * len, hd);
    staged();
  }

  const int groups = (len + kQ - 1) / kQ;   // query groups of a slice
  const int rounds = (ns * groups + nw - 1) / nw;
  const int dl = lane % kDimLanes;
  const int grp = lane / kDimLanes;
  for (int round = 0; round < rounds; ++round) {
    const int g = round * nw + warp;
    const bool valid = g < ns * groups;
    const int sl = valid ? g / groups : 0;
    const int t0 = (g - sl * groups) * kQ;
    const int nq = valid ? min(kQ, len - t0) : 0;
    const size_t base = block_base + (size_t)sl * len * hd;
    const int row0 = resident ? sl * len : 0;   // the slice's first row

    // the warp's kQ query rows, zero past hd (and, when they are loaded
    // here, past `len`)
    const float* sq = sqs + (size_t)(row0 + t0) * kHdP;
    if (!resident) {
      float* own = sqs + warp * kQ * kHdP;
      __syncwarp();
      for (int i = lane; i < kQ * kHdP; i += 32) {
        const int qi = i / kHdP;
        const int c = i - qi * kHdP;
        own[i] = qi < nq && c < hd ? q[base + (size_t)(t0 + qi) * hd + c]
                                   : 0.f;
      }
      __syncwarp();
      sq = own;
    }

    // pass 1: scores (times log2 e) into the warp's score rows, lane max
    float m[kQ];
#pragma unroll
    for (int qi = 0; qi < kQ; ++qi) m[qi] = -INFINITY;
    for (int c0 = 0; c0 < len; c0 += kc) {
      const int nr = min(kc, len - c0);
      if (!resident) {
        __syncthreads();
        stage_rows(sk, kStride, k + base + (size_t)c0 * hd, nr, hd);
        staged();
      }
      if (!valid) continue;
      for (int j = lane; j < nr; j += 32) {
        const float4* kr =
            reinterpret_cast<const float4*>(sk + (size_t)(row0 + j) * kStride);
        float acc[kQ];
#pragma unroll
        for (int qi = 0; qi < kQ; ++qi) acc[qi] = 0.f;
#pragma unroll
        for (int c = 0; c < kVecs; ++c) {
          const float4 kv = kr[c];
#pragma unroll
          for (int qi = 0; qi < kQ; ++qi) {
            const float4 qv = reinterpret_cast<const float4*>(sq + qi * kHdP)[c];
            acc[qi] = fmaf(qv.x, kv.x, acc[qi]);
            acc[qi] = fmaf(qv.y, kv.y, acc[qi]);
            acc[qi] = fmaf(qv.z, kv.z, acc[qi]);
            acc[qi] = fmaf(qv.w, kv.w, acc[qi]);
          }
        }
#pragma unroll
        for (int qi = 0; qi < kQ; ++qi) {
          const float sc = acc[qi] * scale_log2e;
          ss[qi * lr + c0 + j] = sc;
          m[qi] = fmaxf(m[qi], sc);
        }
      }
    }

    // the exact softmax: warp max, exp, warp sum (a lane rewrites only the
    // scores it wrote)
    float l[kQ];
#pragma unroll
    for (int qi = 0; qi < kQ; ++qi) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        m[qi] = fmaxf(m[qi], __shfl_xor_sync(0xffffffffu, m[qi], off));
      }
      l[qi] = 0.f;
    }
    if (valid) {
      for (int j = lane; j < len; j += 32) {
#pragma unroll
        for (int qi = 0; qi < kQ; ++qi) {
          const float p = exp2f(ss[qi * lr + j] - m[qi]);
          ss[qi * lr + j] = p;
          l[qi] += p;
        }
      }
    }
#pragma unroll
    for (int qi = 0; qi < kQ; ++qi) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        l[qi] += __shfl_xor_sync(0xffffffffu, l[qi], off);
      }
    }
    __syncwarp();

    // pass 2: O = P V, lanes over dims, kGroups key groups
    float acc[kQ][kDpl];
#pragma unroll
    for (int qi = 0; qi < kQ; ++qi) {
#pragma unroll
      for (int t = 0; t < kDpl; ++t) acc[qi][t] = 0.f;
    }
    for (int c0 = 0; c0 < len; c0 += kc) {
      const int nr = min(kc, len - c0);
      if (!resident) {
        __syncthreads();
        stage_rows(sv, kStride, v + base + (size_t)c0 * hd, nr, hd);
        staged();
      }
      if (!valid) continue;
#pragma unroll 4
      for (int j = grp; j < nr; j += kGroups) {
        const float* vr = sv + (size_t)(row0 + j) * kStride + dl;
        float vv[kDpl];
#pragma unroll
        for (int t = 0; t < kDpl; ++t) vv[t] = vr[t * kDimLanes];
#pragma unroll
        for (int qi = 0; qi < kQ; ++qi) {
          const float p = ss[qi * lr + c0 + j];
#pragma unroll
          for (int t = 0; t < kDpl; ++t) acc[qi][t] = fmaf(p, vv[t], acc[qi][t]);
        }
      }
    }
    if (!valid) continue;
    if constexpr (kGroups == 2) {
#pragma unroll
      for (int qi = 0; qi < kQ; ++qi) {
#pragma unroll
        for (int t = 0; t < kDpl; ++t) {
          acc[qi][t] += __shfl_xor_sync(0xffffffffu, acc[qi][t], 16);
        }
      }
    }
    if (grp != 0) continue;
#pragma unroll
    for (int qi = 0; qi < kQ; ++qi) {
      if (qi < nq) {
        const float inv = 1.f / l[qi];
#pragma unroll
        for (int t = 0; t < kDpl; ++t) {
          const int d = dl + t * kDimLanes;
          if (d < hd) o[base + (size_t)(t0 + qi) * hd + d] = acc[qi][t] * inv;
        }
      }
    }
  }
}

}  // namespace gridmm_head_f32
