// Shared body of the two attention kernels, attention_qkv_fwd.cu (packed
// (B, L, 3W) input, head_dim 64) and attention_fwd.cu ((BH, L, hd) input):
// for one (sequence, head) column block,
//     o[t] = sum_j softmax_j(q[t] . k[j] * scale) v[j]
// over all `len` keys, with the score row and the softmax in f32 on chip.
//
// Design (one block = up to kThreads / kTpq query rows of one head):
//   * K and V of the head (len x kHd, in the input type) are staged once in
//     dynamic shared memory with 16-byte copies; 197 x 64 bf16 is ~25 KB each;
//   * kTpq threads share one query row, each holding kDpt = kHd / kTpq of its
//     dims in registers (kTpq = 2 at hd 128 keeps a thread under ~150
//     registers); their partial dot products meet with one warp shuffle;
//   * every thread of a warp reads the same K or V row at the same time, so
//     shared-memory reads are broadcasts with no bank conflict;
//   * the softmax is online: a running max, a running sum and a rescaled f32
//     accumulator, so the (len x len) scores never exist anywhere;
//   * the output row is divided by the sum once and written in 16-byte
//     stores in the input type.
// Scores run on the CUDA cores in f32: a simple kernel, right first. The
// tensor-core version (wgmma) is a later step.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace gridmm_attn {

constexpr int kThreads = 64;              // threads per block
constexpr int kMaxSmem = 232448;          // bytes a block may use on sm_90

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int kHd>
struct Shape {
  static constexpr int kTpq = kHd > 64 ? kHd / 64 : 1;  // threads per query
  static constexpr int kDpt = kHd / kTpq;               // dims per thread
  static constexpr int kQueries = kThreads / kTpq;      // query rows / block
  static constexpr int kPerVec = 16 / (int)sizeof(T);   // elements / 16 B
  static_assert(kDpt % kPerVec == 0, "a thread's dims must be whole 16 B");
  static_assert((kHd * (int)sizeof(T)) % 16 == 0, "rows must be whole 16 B");
};

template <typename T, int kHd>
size_t smem_bytes(int len) {
  return (size_t)2 * len * kHd * sizeof(T);
}

// q, k, v point at element [row 0, dim 0] of this head's column block; row t
// is `in_stride` elements further on, and row t of o is `out_stride` further.
// Every pointer and stride must keep 16-byte alignment (the wrappers check).
template <typename T, int kHd>
__device__ __forceinline__ void attend(const T* __restrict__ q,
                                       const T* __restrict__ k,
                                       const T* __restrict__ v,
                                       T* __restrict__ o, int len,
                                       long in_stride, long out_stride,
                                       float scale, unsigned char* smem_raw) {
  using S = Shape<T, kHd>;
  T* sk = reinterpret_cast<T*>(smem_raw);
  T* sv = sk + (size_t)len * kHd;

  // stage K and V: len rows of kHd elements, in 16-byte vectors
  constexpr int kVecsPerRow = kHd * (int)sizeof(T) / 16;
  for (int i = threadIdx.x; i < len * kVecsPerRow; i += blockDim.x) {
    const int r = i / kVecsPerRow;
    const int c = i % kVecsPerRow;
    reinterpret_cast<uint4*>(sk + (size_t)r * kHd)[c] =
        reinterpret_cast<const uint4*>(k + r * in_stride)[c];
    reinterpret_cast<uint4*>(sv + (size_t)r * kHd)[c] =
        reinterpret_cast<const uint4*>(v + r * in_stride)[c];
  }
  __syncthreads();

  const int qi_raw = blockIdx.y * S::kQueries + threadIdx.x / S::kTpq;
  const bool active = qi_raw < len;
  const int qi = active ? qi_raw : len - 1;  // idle threads still shuffle
  const int d0 = (threadIdx.x % S::kTpq) * S::kDpt;

  float qr[S::kDpt];
  {
    const uint4* src = reinterpret_cast<const uint4*>(q + qi * in_stride + d0);
#pragma unroll
    for (int i = 0; i < S::kDpt / S::kPerVec; ++i) {
      const uint4 raw = src[i];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < S::kPerVec; ++j) qr[i * S::kPerVec + j] = to_f32(e[j]);
    }
  }

  float acc[S::kDpt];
#pragma unroll
  for (int d = 0; d < S::kDpt; ++d) acc[d] = 0.f;
  float m = -INFINITY;
  float l = 0.f;

  for (int j = 0; j < len; ++j) {
    const uint4* kr = reinterpret_cast<const uint4*>(sk + (size_t)j * kHd + d0);
    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < S::kDpt / S::kPerVec; ++i) {
      const uint4 raw = kr[i];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int jj = 0; jj < S::kPerVec; ++jj) {
        part[jj & 3] = fmaf(qr[i * S::kPerVec + jj], to_f32(e[jj]), part[jj & 3]);
      }
    }
    float s = (part[0] + part[1]) + (part[2] + part[3]);
#pragma unroll
    for (int off = 1; off < S::kTpq; off <<= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, off);
    }
    s *= scale;
    if (s > m) {  // new running max: rescale what was summed so far
      const float corr = expf(m - s);
      l *= corr;
#pragma unroll
      for (int d = 0; d < S::kDpt; ++d) acc[d] *= corr;
      m = s;
    }
    const float p = expf(s - m);
    l += p;
    const uint4* vr = reinterpret_cast<const uint4*>(sv + (size_t)j * kHd + d0);
#pragma unroll
    for (int i = 0; i < S::kDpt / S::kPerVec; ++i) {
      const uint4 raw = vr[i];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int jj = 0; jj < S::kPerVec; ++jj) {
        acc[i * S::kPerVec + jj] = fmaf(p, to_f32(e[jj]), acc[i * S::kPerVec + jj]);
      }
    }
  }

  if (!active) return;
  uint4* dst = reinterpret_cast<uint4*>(o + qi * out_stride + d0);
#pragma unroll
  for (int i = 0; i < S::kDpt / S::kPerVec; ++i) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int jj = 0; jj < S::kPerVec; ++jj) from_f32(&e[jj], acc[i * S::kPerVec + jj] / l);
    dst[i] = raw;
  }
}

}  // namespace gridmm_attn
