// Tensor-core body of the per-head attention kernel (attention_fwd.cu), bf16,
// any head_dim from 1 to 256: for each (slice, query row t),
//     o[t] = sum_j softmax_j(q[t] . k[j] * scale) v[j]
// over the slice's `len` keys, scores and softmax in f32, both products on
// the tensor cores.
//
// Design (a persistent grid of four-warp blocks, each walking work items):
//   * hd is zero-padded on chip to kHdP, the next multiple of 16 (of 32
//     above 128): zero columns of Q and K add nothing to a score, and zero
//     columns of V give output columns that are never stored;
//   * a work item is one slice, or above kHdP 128 one half of its output
//     columns: both halves compute every score, each does P V for its half,
//     so that no warp holds more than 64 f32 accumulators;
//   * K and V of a work item are staged once in shared memory, and every
//     query tile of the slice is computed from them (four warps take the
//     16-row query tiles in turn). The copies are cp.async of 16, 8 or 4
//     bytes, whichever the row's bytes allow, and plain 2-byte copies for a
//     bf16 row of odd length. Where two stages fit beside the Q tiles with
//     two blocks an SM, the next work item's K and V arrive behind the
//     current one's products;
//   * rows are padded by 8 elements (16 bytes), so the eight rows of an
//     ldmatrix fall in eight 16-byte bank groups; keys are padded to a
//     multiple of 16 with zero rows, and padded keys score -inf before the
//     max; padded query rows are computed and never stored;
//   * the products and the online softmax over 64-key tiles are those of
//     attention_qkv_mma.cuh: mma.sync.m16n8k16 bf16 with f32 accumulators,
//     K fragments from ldmatrix, V from ldmatrix.trans, and P kept in
//     registers as the A fragment of P V;
//   * up to kHdP 128 a warp loads its Q fragments from device memory
//     straight into registers and stores its outputs from the accumulators:
//     no Q tile in shared memory. Above, each warp stages its Q tile in
//     shared memory, reads the fragments from it with ldmatrix and stages
//     its outputs there.

#pragma once

#include "attention_qkv_mma.cuh"

namespace gridmm_head_mma {

using gridmm_attn_mma::cp_async16;
using gridmm_attn_mma::ldmatrix_x4;
using gridmm_attn_mma::ldmatrix_x4_trans;
using gridmm_attn_mma::pack_bf16;
using gridmm_attn_mma::smem_addr;
using bf16 = __nv_bfloat16;

// four warps: eight (measured on the H100) shorten one slice but leave
// fewer warps an SM where registers bound them
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kKTile = 64;      // keys per pass of the online softmax

__host__ __device__ constexpr int padded_hd(int hd) {
  return hd <= 128 ? (hd + 15) / 16 * 16 : (hd + 31) / 32 * 32;
}
// output columns of one work item
__host__ __device__ constexpr int out_width(int hdp) {
  return hdp <= 128 ? hdp : hdp / 2;
}
__host__ __device__ inline int padded_len(int len) {
  return (len + 15) / 16 * 16;
}
// one stage: K (lp x (hdp + 8)) and V (lp x (out_width + 8))
inline size_t stage_bytes(int len, int hdp) {
  return (size_t)padded_len(len) * (hdp + 8 + out_width(hdp) + 8) *
         sizeof(bf16);
}
// the warps' 16-row Q tiles, which also stage their outputs (above kHdP
// 128 only: below, Q and the outputs stay in registers)
inline size_t q_bytes(int hdp) {
  return hdp <= 128 ? 0 : (size_t)kWarps * 16 * (hdp + 8) * sizeof(bf16);
}

// c (16 x 8, f32) += a (16 x 16, bf16, row-major) * b (16 x 8, bf16,
// col-major): mma_bf16 of attention_qkv_mma.cuh, but not volatile, so that
// the compiler may schedule the products between the shared-memory loads
__device__ __forceinline__ void mma16816(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int kBytes>
__device__ __forceinline__ void cp_async_ca(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "n"(kBytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// One `vec`-byte piece, src to dst (both aligned to `vec`).
__device__ __forceinline__ void copy_piece(void* dst, const void* src,
                                           int vec) {
  switch (vec) {
    case 16: *reinterpret_cast<uint4*>(dst) =
                 *reinterpret_cast<const uint4*>(src); break;
    case 8: *reinterpret_cast<uint2*>(dst) =
                *reinterpret_cast<const uint2*>(src); break;
    case 4: *reinterpret_cast<uint32_t*>(dst) =
                *reinterpret_cast<const uint32_t*>(src); break;
    default: *reinterpret_cast<uint16_t*>(dst) =
                 *reinterpret_cast<const uint16_t*>(src);
  }
}

__device__ __forceinline__ void zero_piece(void* dst, int vec) {
  switch (vec) {
    case 16: *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
             break;
    case 8: *reinterpret_cast<uint2*>(dst) = make_uint2(0u, 0u); break;
    case 4: *reinterpret_cast<uint32_t*>(dst) = 0u; break;
    default: *reinterpret_cast<uint16_t*>(dst) = 0;
  }
}

// Block-wide: rows [0, rows) x columns [c0, c0 + cols) of a row-major
// (rows, hd) array into shared rows of `stride` elements, in `vec`-byte
// pieces (cp.async where the piece is 4 bytes or more). cols * 2 and c0 * 2
// are multiples of vec.
__device__ __forceinline__ void stage_async(bf16* dst, int stride,
                                            const bf16* src, int rows, int hd,
                                            int c0, int cols, int vec) {
  const int per = vec / 2;
  const int pieces = cols / per;
  for (int i = threadIdx.x; i < rows * pieces; i += kThreads) {
    const int r = i / pieces;
    const int c = (i - r * pieces) * per;
    bf16* d = dst + r * stride + c;
    const bf16* s = src + (size_t)r * hd + c0 + c;
    switch (vec) {
      case 16: cp_async16(d, s); break;
      case 8: cp_async_ca<8>(d, s); break;
      case 4: cp_async_ca<4>(d, s); break;
      default: *d = *s;
    }
  }
}

// A fragments of rows q0 .. q0 + 15 of a (len, hd) Q, zero past len and hd,
// for every 16-wide step of kHdP: a lane holds row q0 + lane / 4 (elements
// 0, 2) and q0 + lane / 4 + 8 (1, 3), columns (lane & 3) * 2 + {0, 1} (+ 8
// in elements 2, 3), as ldmatrix.x4 would give them. Pairs are 4-byte loads
// where hd is even.
template <int kKs>
__device__ __forceinline__ void load_q_frags(uint32_t (&qf)[kKs][4],
                                             const bf16* q, int q0, int len,
                                             int hd) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int ks = 0; ks < kKs; ++ks) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = q0 + (lane >> 2) + (e & 1) * 8;
      const int col = ks * 16 + (lane & 3) * 2 + (e >> 1) * 8;
      const bf16* p = q + (size_t)row * hd + col;
      uint32_t x = 0u;
      if (row < len && col < hd) {
        if ((hd & 1) == 0) {
          x = *reinterpret_cast<const uint32_t*>(p);
        } else {
          x = *reinterpret_cast<const uint16_t*>(p);
          if (col + 1 < hd) {
            x |= (uint32_t)*reinterpret_cast<const uint16_t*>(p + 1) << 16;
          }
        }
      }
      qf[ks][e] = x;
    }
  }
}

// One accumulator pair (row, columns col, col + 1) of the output, where
// inside (row < len, col < hd).
__device__ __forceinline__ void store_pair(bf16* o, int row, int col, int len,
                                           int hd, float a, float b) {
  if (row >= len || col >= hd) return;
  bf16* p = o + (size_t)row * hd + col;
  if ((hd & 1) == 0) {
    *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
  } else {
    p[0] = __float2bfloat16(a);
    if (col + 1 < hd) p[1] = __float2bfloat16(b);
  }
}

// q, k, v, o (slices, len, hd) bf16; items = slices * (kHdP / out_width);
// grid <= items, persistent; dynamic shared memory q_bytes + stages *
// stage_bytes. vec: the widest of 16, 8, 4, 2 bytes that divides hd * 2.
// scale_log2e = log2(e) / sqrt(hd).
template <int kHdP>
__global__ void __launch_bounds__(kThreads)
attention_head_mma_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o,
                          int items, int len, int hd, int vec, int stages,
                          float scale_log2e) {
  constexpr int kOut = out_width(kHdP);
  constexpr int kSplit = kHdP / kOut;          // work items per slice
  constexpr int kRowK = kHdP + 8;              // shared row of Q and K
  constexpr int kRowV = kOut + 8;              // shared row of V
  constexpr int kQRegs = kHdP <= 128;
  constexpr int kKs = kHdP / 16;               // 16-wide steps of a score
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lp = padded_len(len);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  constexpr int kQTileElems = kQRegs ? 0 : 16 * kRowK;
  bf16* sq = reinterpret_cast<bf16*>(smem_raw) + warp * kQTileElems;
  bf16* sbuf = reinterpret_cast<bf16*>(smem_raw) + kWarps * kQTileElems;
  const size_t stage_elems = (size_t)lp * (kRowK + kRowV);

  // padding stays zero: the stages only ever write the true rectangle
  for (size_t i = tid; i < stages * stage_elems / 8; i += kThreads) {
    reinterpret_cast<uint4*>(sbuf)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();

  auto stage = [&](int item, int buf) {
    const size_t base = (size_t)(item / kSplit) * len * hd;
    const int c0 = (item % kSplit) * kOut;
    bf16* sk = sbuf + buf * stage_elems;
    stage_async(sk, kRowK, k + base, len, hd, 0, hd, vec);
    stage_async(sk + (size_t)lp * kRowK, kRowV, v + base, len, hd, c0,
                min(kOut, hd - c0), vec);
  };

  if (blockIdx.x < items) stage(blockIdx.x, 0);
  cp_async_commit();
  int it = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++it) {
    const int next = item + gridDim.x;
    const int buf = stages == 2 ? (it & 1) : 0;
    if (stages == 2 && next < items) {
      stage(next, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const size_t base = (size_t)(item / kSplit) * len * hd;
    const int c0 = (item % kSplit) * kOut;
    const int cols = min(kOut, hd - c0);
    const bf16* sk = sbuf + buf * stage_elems;
    const bf16* sv = sk + (size_t)lp * kRowK;
    const int per = vec / 2;

    for (int q0 = warp * 16; q0 < lp; q0 += kWarps * 16) {
      uint32_t qf[kQRegs ? kKs : 1][4];
      if constexpr (kQRegs) {
        load_q_frags(qf, q + base, q0, len, hd);
      } else {
        // this tile's Q rows, zero past `len` and past hd
        __syncwarp();
        for (int i = lane; i < 16 * (kHdP / per); i += 32) {
          const int r = i / (kHdP / per);
          const int c = (i - r * (kHdP / per)) * per;
          if (q0 + r < len && c < hd) {
            copy_piece(sq + r * kRowK + c,
                       q + base + (size_t)(q0 + r) * hd + c, vec);
          } else {
            zero_piece(sq + r * kRowK + c, vec);
          }
        }
        __syncwarp();
      }

      // a lane holds columns (lane & 3) * 2 + {0, 1} of every 8-wide tile,
      // for row lane / 4 (elements 0, 1) and row lane / 4 + 8 (2, 3)
      float acc[kOut / 8][4];
#pragma unroll
      for (int j = 0; j < kOut / 8; ++j) {
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      }
      float m0 = -INFINITY, m1 = -INFINITY;   // running max of the two rows
      float l0 = 0.f, l1 = 0.f;               // this lane's share of the sums

      for (int kt = 0; kt < lp; kt += kKTile) {
        float s[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        // S = Q K^T, 16 dims of every key at a time
#pragma unroll
        for (int ks = 0; ks < kKs; ++ks) {
          uint32_t af[4];
          if constexpr (kQRegs) {
            af[0] = qf[ks][0]; af[1] = qf[ks][1];
            af[2] = qf[ks][2]; af[3] = qf[ks][3];
          } else {
            ldmatrix_x4(af, sq + (lane & 15) * kRowK + ks * 16 +
                                (lane >> 4) * 8);
          }
          // every fragment of the step first, then the products: the
          // loads are issued in program order, so each product does not
          // wait for a load issued just before it
          uint32_t kf[4][4];
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            if (kt + np * 16 < lp) {
              ldmatrix_x4(kf[np], sk + (size_t)(kt + np * 16 + (lane & 7) +
                                                (lane >> 4) * 8) * kRowK +
                                      ks * 16 + ((lane >> 3) & 1) * 8);
            }
          }
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            if (kt + np * 16 < lp) {
              mma16816(s[2 * np], af, kf[np][0], kf[np][1]);
              mma16816(s[2 * np + 1], af, kf[np][2], kf[np][3]);
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
        // key kt < len on every tile, so the new max is finite
        const float mn0 = fmaxf(m0, mx0);
        const float mn1 = fmaxf(m1, mx1);
        const float cr0 = exp2f(m0 - mn0);   // 0 on the first tile
        const float cr1 = exp2f(m1 - mn1);
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
        }
#pragma unroll
        for (int j = 0; j < kOut / 8; ++j) {
          acc[j][0] *= cr0;
          acc[j][1] *= cr0;
          acc[j][2] *= cr1;
          acc[j][3] *= cr1;
        }
        l0 = l0 * cr0 + rs0;
        l1 = l1 * cr1 + rs1;

        // O += P V, 16 keys a step; P's accumulator layout is the A layout
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (kt + kk * 16 < lp) {
            const uint32_t a[4] = {pf[2 * kk][0], pf[2 * kk][1],
                                   pf[2 * kk + 1][0], pf[2 * kk + 1][1]};
            // up to four fragments of V first, then their products
#pragma unroll
            for (int d0 = 0; d0 < kOut / 16; d0 += 4) {
              constexpr int kDp = kOut / 16 < 4 ? kOut / 16 : 4;
              uint32_t vf[kDp][4];
#pragma unroll
              for (int dp = 0; dp < kDp; ++dp) {
                if (d0 + dp < kOut / 16) {
                  ldmatrix_x4_trans(
                      vf[dp], sv + (size_t)(kt + kk * 16 + (lane & 7) +
                                            ((lane >> 3) & 1) * 8) * kRowV +
                                  (d0 + dp) * 16 + (lane >> 4) * 8);
                }
              }
#pragma unroll
              for (int dp = 0; dp < kDp; ++dp) {
                if (d0 + dp < kOut / 16) {
                  mma16816(acc[2 * (d0 + dp)], a, vf[dp][0], vf[dp][1]);
                  mma16816(acc[2 * (d0 + dp) + 1], a, vf[dp][2], vf[dp][3]);
                }
              }
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

      if constexpr (kQRegs) {
        // straight from the accumulators (c0 is 0: one item a slice)
#pragma unroll
        for (int j = 0; j < kOut / 8; ++j) {
          const int col = j * 8 + (lane & 3) * 2;
          const int row = q0 + (lane >> 2);
          store_pair(o + base, row, col, len, hd, acc[j][0] * inv0,
                     acc[j][1] * inv0);
          store_pair(o + base, row + 8, col, len, hd, acc[j][2] * inv1,
                     acc[j][3] * inv1);
        }
      } else {
        // stage the 16 x kOut outputs in the warp's Q tile (its last reads
        // of Q are done), then write the true rows and columns in vec
        // pieces
        __syncwarp();
#pragma unroll
        for (int j = 0; j < kOut / 8; ++j) {
          const int col = j * 8 + (lane & 3) * 2;
          *reinterpret_cast<uint32_t*>(sq + (lane >> 2) * kRowK + col) =
              pack_bf16(acc[j][0] * inv0, acc[j][1] * inv0);
          *reinterpret_cast<uint32_t*>(sq + ((lane >> 2) + 8) * kRowK + col) =
              pack_bf16(acc[j][2] * inv1, acc[j][3] * inv1);
        }
        __syncwarp();
        for (int i = lane; i < 16 * (cols / per); i += 32) {
          const int r = i / (cols / per);
          const int c = (i - r * (cols / per)) * per;
          if (q0 + r < len) {
            copy_piece(o + base + (size_t)(q0 + r) * hd + c0 + c,
                       sq + r * kRowK + c, vec);
          }
        }
      }
    }
    __syncthreads();    // every warp is done with this stage
    if (stages == 1 && next < items) {
      stage(next, 0);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();
}

}  // namespace gridmm_head_mma
