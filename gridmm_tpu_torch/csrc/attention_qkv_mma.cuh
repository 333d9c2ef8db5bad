// Tensor-core body of the packed-qkv attention kernel (attention_qkv_fwd.cu),
// bf16, head_dim 64: for one (image, head, tile of 64 queries),
//     o[t] = sum_j softmax_j(q[t] . k[j] / 8) v[j]
// over all `len` keys, scores and softmax in f32, products on the tensor cores.
//
// Design (one block = four warps, 16 query rows a warp):
//   * Q of the tile and K, V of the head are staged once in shared memory
//     with 16-byte cp.async copies straight from the packed projection; rows
//     are padded from 128 to 144 bytes, so the eight rows of an ldmatrix fall
//     in eight different 16-byte bank groups; keys are padded to a multiple
//     of 16 with zero rows (0 x garbage could be NaN), query rows beyond
//     `len` are zero rows too, computed and never stored;
//   * S = Q K^T and O = P V are mma.sync.aligned.m16n8k16 bf16 products with
//     f32 accumulators; Q and K fragments come from ldmatrix, V fragments
//     from ldmatrix.trans (V is stored key-major, the product needs it
//     dim-major);
//   * keys are walked in tiles of 64 with a running max and sum (at len <= 64
//     that is one pass and nothing is rescaled); padded keys score -inf
//     before the max; the row max and sum are shuffles within the four lanes
//     that share a row;
//   * the probabilities are rounded to bf16 in registers and are, as they
//     stand, the A fragments of P V: the (len x len) scores never touch
//     shared or device memory;
//   * each warp stages its 16 output rows in its own rows of the Q tile and
//     writes them with 16-byte stores in place (no head transpose).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace gridmm_attn_mma {

constexpr int kHd = 64;                 // head_dim
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kQTile = 16 * kWarps;     // query rows per block
constexpr int kKTile = 64;              // keys per pass of the online softmax
constexpr int kRow = kHd + 8;           // padded shared-memory row, elements
constexpr int kVecs = kHd / 8;          // 16-byte vectors per row

__host__ __device__ inline int padded_len(int len) {
  return (len + 15) / 16 * 16;
}

inline size_t smem_bytes(int len) {
  return (size_t)(2 * padded_len(len) + kQTile) * kRow *
         sizeof(__nv_bfloat16);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// c (16 x 8, f32) += a (16 x 16, bf16, row-major) * b (16 x 8, bf16, col-major)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// qkv (batch, len, 3 * heads * 64) bf16, out (batch, len, heads * 64) bf16;
// grid (batch * heads, ceil(len / 64)); dynamic shared memory
// smem_bytes(len). scale_log2e = log2(e) / sqrt(64).
__global__ void __launch_bounds__(kThreads)
attention_qkv_mma_kernel(const __nv_bfloat16* __restrict__ qkv,
                         __nv_bfloat16* __restrict__ out, int len, int heads,
                         float scale_log2e) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lp = padded_len(len);
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sk = sq + kQTile * kRow;
  __nv_bfloat16* sv = sk + (size_t)lp * kRow;

  const int seq = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const int q0 = blockIdx.y * kQTile;
  const size_t width = (size_t)heads * kHd;
  const size_t in_stride = 3 * width;
  const __nv_bfloat16* qg = qkv + (size_t)seq * len * in_stride + h * kHd;
  const __nv_bfloat16* kg = qg + width;
  const __nv_bfloat16* vg = kg + width;
  const int tid = threadIdx.x;
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);

  // stage Q of the tile, K and V of the head; rows past `len` are zeros
  for (int i = tid; i < kQTile * kVecs; i += kThreads) {
    const int r = i / kVecs;
    const int c = (i % kVecs) * 8;
    __nv_bfloat16* dst = sq + r * kRow + c;
    if (q0 + r < len) {
      cp_async16(dst, qg + (size_t)(q0 + r) * in_stride + c);
    } else {
      *reinterpret_cast<uint4*>(dst) = zero4;
    }
  }
  for (int i = tid; i < lp * kVecs; i += kThreads) {
    const int r = i / kVecs;
    const int c = (i % kVecs) * 8;
    __nv_bfloat16* dk = sk + (size_t)r * kRow + c;
    __nv_bfloat16* dv = sv + (size_t)r * kRow + c;
    if (r < len) {
      cp_async16(dk, kg + (size_t)r * in_stride + c);
      cp_async16(dv, vg + (size_t)r * in_stride + c);
    } else {
      *reinterpret_cast<uint4*>(dk) = zero4;
      *reinterpret_cast<uint4*>(dv) = zero4;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wrow = warp * 16;          // this warp's first row of the tile
  if (q0 + wrow >= len) return;        // no block-wide barrier follows

  // A fragments of Q: 16 rows x 64 dims = four 16 x 16 steps
  uint32_t qf[4][4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    ldmatrix_x4(qf[ks], sq + (wrow + (lane & 15)) * kRow + ks * 16 +
                            (lane >> 4) * 8);
  }

  // a lane holds columns (lane & 3) * 2 + {0, 1} of every 8-wide tile, for
  // row lane / 4 (elements 0, 1) and row lane / 4 + 8 (elements 2, 3)
  float o[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  }
  float m0 = -INFINITY, m1 = -INFINITY;   // running max of the two rows
  float l0 = 0.f, l1 = 0.f;               // this lane's share of the sums

  for (int kt = 0; kt < lp; kt += kKTile) {
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    }
    // S = Q K^T, 16 keys (two 8-wide tiles) at a time
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      if (kt + np * 16 < lp) {
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          uint32_t kf[4];
          ldmatrix_x4(kf, sk + (size_t)(kt + np * 16 + (lane & 7) +
                                        (lane >> 4) * 8) * kRow +
                              ks * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(s[2 * np], qf[ks], kf[0], kf[1]);
          mma_bf16(s[2 * np + 1], qf[ks], kf[2], kf[3]);
        }
      }
    }
    // scale; keys past `len` (padding, or tiles not computed) score -inf
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kt + j * 8 + (lane & 3) * 2 + (e & 1);
        s[j][e] = key < len ? s[j][e] * scale_log2e : -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // every tile starts below `len`, so the new max is finite
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    const float c0 = exp2f(m0 - mn0);    // 0 on the first tile
    const float c1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    uint32_t pf[8][2];
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p0 = exp2f(s[j][0] - m0);
      const float p1 = exp2f(s[j][1] - m0);
      const float p2 = exp2f(s[j][2] - m1);
      const float p3 = exp2f(s[j][3] - m1);
      rs0 += p0 + p1;
      rs1 += p2 + p3;
      pf[j][0] = pack_bf16(p0, p1);
      pf[j][1] = pack_bf16(p2, p3);
      o[j][0] *= c0;
      o[j][1] *= c0;
      o[j][2] *= c1;
      o[j][3] *= c1;
    }
    l0 = l0 * c0 + rs0;
    l1 = l1 * c1 + rs1;

    // O += P V, 16 keys a step; P's accumulator layout is the A layout
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kt + kk * 16 < lp) {
        const uint32_t a[4] = {pf[2 * kk][0], pf[2 * kk][1],
                               pf[2 * kk + 1][0], pf[2 * kk + 1][1]};
#pragma unroll
        for (int dp = 0; dp < 4; ++dp) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, sv + (size_t)(kt + kk * 16 + (lane & 7) +
                                              ((lane >> 3) & 1) * 8) * kRow +
                                    dp * 16 + (lane >> 4) * 8);
          mma_bf16(o[2 * dp], a, vf[0], vf[1]);
          mma_bf16(o[2 * dp + 1], a, vf[2], vf[3]);
        }
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0;
  const float inv1 = 1.f / l1;

  // stage the warp's 16 x 64 outputs in its own rows of the Q tile (its Q
  // fragments are in registers), then write whole 16-byte vectors
  __syncwarp();
  __nv_bfloat16* so = sq + wrow * kRow;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = j * 8 + (lane & 3) * 2;
    *reinterpret_cast<uint32_t*>(so + (lane >> 2) * kRow + col) =
        pack_bf16(o[j][0] * inv0, o[j][1] * inv0);
    *reinterpret_cast<uint32_t*>(so + ((lane >> 2) + 8) * kRow + col) =
        pack_bf16(o[j][2] * inv1, o[j][3] * inv1);
  }
  __syncwarp();
  __nv_bfloat16* og = out + (size_t)seq * len * width + h * kHd;
#pragma unroll
  for (int i = lane; i < 16 * kVecs; i += 32) {
    const int r = i / kVecs;
    const int c = (i % kVecs) * 8;
    if (q0 + wrow + r < len) {
      *reinterpret_cast<uint4*>(og + (size_t)(q0 + wrow + r) * width + c) =
          *reinterpret_cast<const uint4*>(so + r * kRow + c);
    }
  }
}

}  // namespace gridmm_attn_mma
