// CUDA-core body of the packed-qkv attention kernel (attention_qkv_fwd.cu),
// f32, head_dim 64: for one (image, head, block of kQueries query rows),
//     o[t] = sum_j softmax_j(q[t] . k[j] * scale) v[j]
// over all `len` keys, in exact f32 FMAs (the f32 tolerance is 2e-5, which
// TF32 products would not hold).
//
// Design (one block = kThreads threads, two a query row):
//   * the two threads of a row each hold half of its query and of its f32
//     output accumulator in registers (32 dims); their partial dot products
//     meet with one warp shuffle. Every thread of a warp reads the same K or
//     V row at the same time, so shared-memory reads are broadcasts with no
//     bank conflict;
//   * K and V stream through a ring of two slots of kKeys keys, filled by
//     16-byte cp.async copies: the copy of tile t + 1 is in flight while
//     the block walks tile t. The ring is the block's whole shared memory,
//     whatever `len`;
//   * the softmax is online: a running max, a running sum and a rescaled
//     accumulator, so the (len x len) scores never exist anywhere. Each
//     tile's terms are summed apart and then added to the running sums:
//     added one by one, the many small terms of a long row fall below half
//     an ulp of the sum and are lost (1.5e-4 of a 6.6 output at L = 5000,
//     against 7.6e-6 summed by tiles);
//   * the output row is divided by the sum once and written in 16-byte
//     stores.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace gridmm_attn {

constexpr int kHd = 64;
constexpr int kTpq = 2;                   // threads a query row
constexpr int kDpt = kHd / kTpq;          // dims a thread
constexpr int kQueries = 64;              // query rows a block
constexpr int kThreads = kQueries * kTpq;
constexpr int kKeys = 32;                 // keys a slot of the ring holds
constexpr int kStages = 2;
constexpr int kVecsPerRow = kHd / 4;      // 16-byte vectors a row
constexpr int kSlotFloats = 2 * kKeys * kHd;       // K then V
constexpr size_t kSmemBytes = (size_t)kStages * kSlotFloats * sizeof(float);

// q, k, v point at element [row 0, dim 0] of this head's column block; row t
// is `in_stride` elements further on, and row t of o is `out_stride`
// further. Every pointer and stride keeps 16-byte alignment (the wrapper
// checks). Dynamic shared memory kSmemBytes; blockDim.x = kThreads; the
// block takes query rows q0 .. q0 + kQueries - 1.
__device__ __forceinline__ void attend(const float* __restrict__ q,
                                       const float* __restrict__ k,
                                       const float* __restrict__ v,
                                       float* __restrict__ o, int len,
                                       long in_stride, long out_stride,
                                       float scale, int q0, float* ring) {
  const int tiles = (len + kKeys - 1) / kKeys;
  auto load_tile = [&](int t) {
    float* sk = ring + (t % kStages) * kSlotFloats;
    float* sv = sk + kKeys * kHd;
    const int k0 = t * kKeys;
    const int rows = min(kKeys, len - k0);
    for (int i = threadIdx.x; i < rows * kVecsPerRow; i += blockDim.x) {
      const int r = i / kVecsPerRow;
      const int c = (i % kVecsPerRow) * 4;
      const size_t src = (size_t)(k0 + r) * in_stride + c;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       (uint32_t)__cvta_generic_to_shared(sk + r * kHd + c)),
                   "l"(k + src)
                   : "memory");
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       (uint32_t)__cvta_generic_to_shared(sv + r * kHd + c)),
                   "l"(v + src)
                   : "memory");
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  load_tile(0);

  const int qi_raw = q0 + threadIdx.x / kTpq;
  const bool active = qi_raw < len;
  const int qi = active ? qi_raw : len - 1;  // idle threads still stage
  const int d0 = (threadIdx.x % kTpq) * kDpt;

  float qr[kDpt];
  {
    const float4* src =
        reinterpret_cast<const float4*>(q + qi * in_stride + d0);
#pragma unroll
    for (int i = 0; i < kDpt / 4; ++i) {
      const float4 x = src[i];
      qr[4 * i] = x.x;
      qr[4 * i + 1] = x.y;
      qr[4 * i + 2] = x.z;
      qr[4 * i + 3] = x.w;
    }
  }

  float acc[kDpt], tacc[kDpt];    // the running sum, and this tile's
#pragma unroll
  for (int d = 0; d < kDpt; ++d) acc[d] = 0.f;
  float m = -INFINITY;
  float l = 0.f;

  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) {
      load_tile(t + 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const float* sk = ring + (t % kStages) * kSlotFloats + d0;
    const float* sv = sk + kKeys * kHd;
    const int rows = min(kKeys, len - t * kKeys);
#pragma unroll
    for (int d = 0; d < kDpt; ++d) tacc[d] = 0.f;
    float tl = 0.f;
    for (int j = 0; j < rows; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(sk + j * kHd);
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < kDpt / 4; ++i) {
        const float4 x = kr[i];
        part[0] = fmaf(qr[4 * i], x.x, part[0]);
        part[1] = fmaf(qr[4 * i + 1], x.y, part[1]);
        part[2] = fmaf(qr[4 * i + 2], x.z, part[2]);
        part[3] = fmaf(qr[4 * i + 3], x.w, part[3]);
      }
      float s = (part[0] + part[1]) + (part[2] + part[3]);
      s = (s + __shfl_xor_sync(0xffffffffu, s, 1)) * scale;
      if (s > m) {  // new running max: rescale what was summed so far
        const float corr = expf(m - s);
        l *= corr;
        tl *= corr;
#pragma unroll
        for (int d = 0; d < kDpt; ++d) {
          acc[d] *= corr;
          tacc[d] *= corr;
        }
        m = s;
      }
      const float p = expf(s - m);
      tl += p;
      const float4* vr = reinterpret_cast<const float4*>(sv + j * kHd);
#pragma unroll
      for (int i = 0; i < kDpt / 4; ++i) {
        const float4 x = vr[i];
        tacc[4 * i] = fmaf(p, x.x, tacc[4 * i]);
        tacc[4 * i + 1] = fmaf(p, x.y, tacc[4 * i + 1]);
        tacc[4 * i + 2] = fmaf(p, x.z, tacc[4 * i + 2]);
        tacc[4 * i + 3] = fmaf(p, x.w, tacc[4 * i + 3]);
      }
    }
    l += tl;
#pragma unroll
    for (int d = 0; d < kDpt; ++d) acc[d] += tacc[d];
    __syncthreads();    // every thread is done with the slot tile t + 2 fills
  }

  if (!active) return;
  const float inv = 1.f / l;
  float4* dst = reinterpret_cast<float4*>(o + qi * out_stride + d0);
#pragma unroll
  for (int i = 0; i < kDpt / 4; ++i) {
    dst[i] = make_float4(acc[4 * i] * inv, acc[4 * i + 1] * inv,
                         acc[4 * i + 2] * inv, acc[4 * i + 3] * inv);
  }
}

}  // namespace gridmm_attn
