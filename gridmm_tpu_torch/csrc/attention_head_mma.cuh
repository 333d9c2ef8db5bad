// Tensor-core body of the per-head attention kernel (attention_fwd.cu), bf16,
// any head_dim: for each (slice, query row t),
//     o[t] = sum_j softmax_j(q[t] . k[j] * scale) v[j]
// over the slice's `len` keys, scores and softmax in f32, both products on
// the tensor cores.
//
// Design of attention_head_mma_kernel (kHdP <= 256: a persistent grid of
// four-warp blocks, each walking work items):
//   * hd is zero-padded on chip to kHdP, the next multiple of 16 (of 32
//     above 128): zero columns of Q and K add nothing to a score, and zero
//     columns of V give output columns that are never stored;
//   * a work item is one slice, or above kHdP 128 one half of its output
//     columns: both halves compute every score, each does P V for its half,
//     so that no warp holds more than 64 f32 accumulators;
//   * K and V pass through a ring of `slots` slots of 64 keys in shared
//     memory (ring_slots(kHdP), the same at every len). Where a work item's
//     tiles fit in the ring they are staged once and every query tile of
//     the item is computed from them (four warps take the 16-row query
//     tiles in turn). Where they do not fit, a unit of work is 64 query
//     rows of an item (so that a few long slices still fill the card): the
//     item's tiles stream through the ring, up to three copies ahead of the
//     products, one barrier a tile. Both paths stay because streaming
//     every item, as the second path does, loses at the main paths' shapes
//     (`chip_profile.py --k4-builds`, NVIDIA H100 80GB HBM3, 700 W, mean of
//     two turns): ViT-H/14's (3072, 257, 80) 1.12631 ms streamed against
//     0.60635 staged once (+86%), (2304, 197, 64) 0.38048 against 0.21462
//     (+77%). The copies are cp.async of 16, 8 or 4 bytes, whichever the
//     row's bytes allow, and plain 2-byte copies for a bf16 row of odd
//     length;
//   * rows are padded by 8 elements (16 bytes), so the eight rows of an
//     ldmatrix fall in eight 16-byte bank groups; key rows past `len` are
//     zero rows and score -inf before the max; padded query rows are
//     computed and never stored;
//   * the products and the online softmax over 64-key tiles are those of
//     attention_qkv_mma.cuh: mma.sync.m16n8k16 bf16 with f32 accumulators,
//     K fragments from ldmatrix, V from ldmatrix.trans, and P kept in
//     registers as the A fragment of P V;
//   * up to kHdP 128 a warp loads its Q fragments from device memory
//     straight into registers and stores its outputs from the accumulators:
//     no Q tile in shared memory. Above, each warp stages its Q tile in
//     shared memory, reads the fragments from it with ldmatrix and stages
//     its outputs there.
//
// attention_head_wide_kernel takes hd above 256, as the JAX wrapper pads hd
// to any multiple of 128: hd is padded to kChunk (128) columns at a time, a
// work item is (slice, 128-column share of the output, 64 query rows), and
// for every 64-key tile the ring carries K in 128-column chunks, whose
// products sum into the scores, then the share's V; each warp reads its Q
// fragments of a chunk from device memory (L1 keeps them between tiles).

#pragma once

#include "attention_qkv_mma.cuh"

namespace gridmm_head_mma {

using gridmm_attn_mma::cp_async16;
using gridmm_attn_mma::cp_async_commit;
using gridmm_attn_mma::cp_async_wait;
using gridmm_attn_mma::ldmatrix_x4;
using gridmm_attn_mma::ldmatrix_x4_trans;
using gridmm_attn_mma::pack_bf16;
using gridmm_attn_mma::smem_addr;
using bf16 = __nv_bfloat16;

// four warps: eight (measured on the H100) shorten one slice but leave
// fewer warps an SM where registers bound them
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kKTile = 64;      // keys a slot of the ring holds
constexpr int kMaxSlots = 8;
constexpr int kAhead = 3;       // copies in flight ahead of the products
constexpr int kChunk = 128;     // columns a chunk of the wide kernel
constexpr int kWideSlots = 4;   // slots of the wide kernel's ring
// bytes a block may use on sm_90: one block, or two or three an SM (each
// block also holds 1 KB of the SM's 228 KB for the system)
constexpr size_t kMaxSmem = 232448;
constexpr size_t kTwoBlockSmem = 115712;
constexpr size_t kThreeBlockSmem = 76800;

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
// one slot: K (64 x (hdp + 8)) and V (64 x (out_width + 8))
__host__ __device__ constexpr size_t slot_elems(int hdp) {
  return (size_t)kKTile * (hdp + 8 + out_width(hdp) + 8);
}
// the warps' 16-row Q tiles, which also stage their outputs (above kHdP
// 128 only: below, Q and the outputs stay in registers)
inline size_t q_bytes(int hdp) {
  return hdp <= 128 ? 0 : (size_t)kWarps * 16 * (hdp + 8) * sizeof(bf16);
}
// Slots of the ring: the most (up to kMaxSlots) that leave room for three
// blocks an SM, if that is four or more; else for two blocks, if three or
// more; else for one (three or more at every kHdP up to 256).
inline int ring_slots(int hdp) {
  const size_t slot = slot_elems(hdp) * sizeof(bf16);
  const size_t budgets[3] = {kThreeBlockSmem, kTwoBlockSmem, kMaxSmem};
  const int least[3] = {4, 3, 2};
  for (int i = 0; i < 3; ++i) {
    const int n = (int)((budgets[i] - q_bytes(hdp)) / slot);
    if (n >= least[i]) return n < kMaxSlots ? n : kMaxSlots;
  }
  return 1;
}
inline size_t smem_bytes(int hdp) {
  return q_bytes(hdp) + ring_slots(hdp) * slot_elems(hdp) * sizeof(bf16);
}
// the wide kernel: kWideSlots slots of 64 rows x (kChunk + 8)
constexpr size_t kWideSmemBytes =
    (size_t)kWideSlots * kKTile * (kChunk + 8) * sizeof(bf16);

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

// cp.async.wait_group with a count known only at run time (0 .. kAhead - 1)
__device__ __forceinline__ void cp_async_wait_n(int pending) {
  switch (pending) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    default: cp_async_wait<2>();
  }
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
// pieces (cp.async where the piece is 4 bytes or more), and zeros into
// columns [0, zero_cols) of shared rows [rows, zero_rows). cols * 2, c0 * 2
// and zero_cols * 2 are multiples of vec.
__device__ __forceinline__ void stage_async(bf16* dst, int stride,
                                            const bf16* src, int rows, int hd,
                                            int c0, int cols, int vec,
                                            int zero_rows, int zero_cols) {
  const int per = vec / 2;
  const int pieces = cols / per;
  for (int i = threadIdx.x; i < rows * pieces; i += blockDim.x) {
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
  const int zpieces = zero_cols / per;
  for (int i = threadIdx.x; i < (zero_rows - rows) * zpieces;
       i += blockDim.x) {
    const int r = i / zpieces;
    zero_piece(dst + (rows + r) * stride + (i - r * zpieces) * per, vec);
  }
}

// A fragments of rows q0 .. q0 + 15 and columns c0 .. c0 + 16 * kKs - 1 of
// a (len, hd) Q, zero past len and hd: a lane holds row q0 + lane / 4
// (elements 0, 2) and q0 + lane / 4 + 8 (1, 3), columns (lane & 3) * 2 +
// {0, 1} (+ 8 in elements 2, 3) of every 16-wide step, as ldmatrix.x4 would
// give them. Pairs are 4-byte loads where hd is even.
template <int kKs>
__device__ __forceinline__ void load_q_frags(uint32_t (&qf)[kKs][4],
                                             const bf16* q, int q0, int len,
                                             int hd, int c0 = 0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int ks = 0; ks < kKs; ++ks) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = q0 + (lane >> 2) + (e & 1) * 8;
      const int col = c0 + ks * 16 + (lane & 3) * 2 + (e >> 1) * 8;
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

// Running state of a warp's 16 query rows: a lane holds columns (lane & 3)
// * 2 + {0, 1} of every 8-wide output tile, for row lane / 4 (elements 0,
// 1) and row lane / 4 + 8 (2, 3); the running max of the two rows and this
// lane's share of their sums.
template <int kOut>
struct RowState {
  float acc[kOut / 8][4];
  float m0, m1, l0, l1;

  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int j = 0; j < kOut / 8; ++j) {
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    }
    m0 = m1 = -INFINITY;
    l0 = l1 = 0.f;
  }

  // The online softmax over one 64-key tile whose scores s (already
  // computed, 16 rows x 64 keys) start at key kt, then O += P V from the
  // tile's V rows `sv` (stride kRowV). Keys past `len` score -inf.
  template <int kRowV>
  __device__ __forceinline__ void absorb(float (&s)[8][4], const bf16* sv,
                                         int kt, int len, int chunks,
                                         float scale_log2e) {
    const int lane = threadIdx.x & 31;
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
      if (kk < chunks) {
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
                  vf[dp], sv + (kk * 16 + (lane & 7) +
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

  // 1 / the two rows' sums (the four lanes of a row add their shares)
  __device__ __forceinline__ void totals(float& inv0, float& inv1) const {
    float a = l0, b = l1;
    a += __shfl_xor_sync(0xffffffffu, a, 1);
    a += __shfl_xor_sync(0xffffffffu, a, 2);
    b += __shfl_xor_sync(0xffffffffu, b, 1);
    b += __shfl_xor_sync(0xffffffffu, b, 2);
    inv0 = 1.f / a;
    inv1 = 1.f / b;
  }
};

// s += Q K^T over 16 * kKs dims for the 64 keys of a tile (rows of `sk`,
// stride kRowK, from column kc0), 16 keys of every step at a time; the A
// fragments from registers (qf) or, where kQRegs is false, from the warp's
// Q tile `sq` (stride kRowK) by ldmatrix. Only steps below `chunks` run.
template <int kKs, bool kQRegs, int kRowK>
__device__ __forceinline__ void scores(
    float (&s)[8][4], const uint32_t (&qf)[kQRegs ? kKs : 1][4],
    const bf16* sq, const bf16* sk, int chunks) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int ks = 0; ks < kKs; ++ks) {
    uint32_t af[4];
    if constexpr (kQRegs) {
      af[0] = qf[ks][0]; af[1] = qf[ks][1];
      af[2] = qf[ks][2]; af[3] = qf[ks][3];
    } else {
      ldmatrix_x4(af, sq + (lane & 15) * kRowK + ks * 16 + (lane >> 4) * 8);
    }
    // every fragment of the step first, then the products: the loads are
    // issued in program order, so each product does not wait for a load
    // issued just before it
    uint32_t kf[4][4];
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      if (np < chunks) {
        ldmatrix_x4(kf[np], sk + (np * 16 + (lane & 7) + (lane >> 4) * 8) *
                                     kRowK +
                                ks * 16 + ((lane >> 3) & 1) * 8);
      }
    }
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      if (np < chunks) {
        mma16816(s[2 * np], af, kf[np][0], kf[np][1]);
        mma16816(s[2 * np + 1], af, kf[np][2], kf[np][3]);
      }
    }
  }
}

// q, k, v, o (slices, len, hd) bf16; items = slices * (kHdP / out_width);
// grid <= items, or where an item's tiles outgrow the ring <= items *
// ceil(len / 64), persistent; dynamic shared memory q_bytes + `slots` *
// slot_elems * 2 (slots = ring_slots(kHdP)). vec: the widest of 16, 8, 4, 2
// bytes that divides hd * 2. scale_log2e = log2(e) / sqrt(hd).
template <int kHdP>
__global__ void __launch_bounds__(kThreads)
attention_head_mma_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o,
                          int items, int len, int hd, int vec, int slots,
                          float scale_log2e) {
  constexpr int kOut = out_width(kHdP);
  constexpr int kSplit = kHdP / kOut;          // work items per slice
  constexpr int kRowK = kHdP + 8;              // shared row of Q and K
  constexpr int kRowV = kOut + 8;              // shared row of V
  constexpr bool kQRegs = kHdP <= 128;
  constexpr int kKs = kHdP / 16;               // 16-wide steps of a score
  constexpr int kSlot = (int)slot_elems(kHdP);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lp = padded_len(len);
  const int tiles = (lp + kKTile - 1) / kKTile;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  constexpr int kQTileElems = kQRegs ? 0 : 16 * kRowK;
  bf16* sq = reinterpret_cast<bf16*>(smem_raw) + warp * kQTileElems;
  bf16* ring = reinterpret_cast<bf16*>(smem_raw) + kWarps * kQTileElems;
  const int per = vec / 2;                     // elements a piece
  // an item's tiles fit in the ring (staged once), or stream through it
  const bool resident = tiles <= slots;

  // padding stays zero: the copies only ever write the true columns
  for (size_t i = tid; i < (size_t)slots * kSlot / 8; i += kThreads) {
    reinterpret_cast<uint4*>(ring)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();

  // key tile t of `item` into `slot`; rows past len up to the next 16 zeroed
  auto load_tile = [&](int item, int t, int slot) {
    const size_t base = (size_t)(item / kSplit) * len * hd;
    const int c0 = (item % kSplit) * kOut;
    const int k0 = t * kKTile;
    const int rows = min(kKTile, len - k0);
    const int rows16 = min(kKTile, lp - k0);
    bf16* sk = ring + (size_t)slot * kSlot;
    stage_async(sk, kRowK, k + base + (size_t)k0 * hd, rows, hd, 0, hd, vec,
                rows16, hd);
    stage_async(sk + kKTile * kRowK, kRowV, v + base + (size_t)k0 * hd,
                rows, hd, c0, min(kOut, hd - c0), vec, rows16,
                min(kOut, hd - c0));
  };
  // the warp's Q rows q0 .. q0 + 15 of the slice at `base`: fragments in
  // registers, or its Q tile in shared memory, zero past len and hd
  auto load_q = [&](uint32_t (&qf)[kQRegs ? kKs : 1][4], size_t base,
                    int q0) {
    if constexpr (kQRegs) {
      load_q_frags(qf, q + base, q0, len, hd);
    } else {
      __syncwarp();
      for (int i = lane; i < 16 * (kHdP / per); i += 32) {
        const int r = i / (kHdP / per);
        const int c = (i - r * (kHdP / per)) * per;
        if (q0 + r < len && c < hd) {
          copy_piece(sq + r * kRowK + c, q + base + (size_t)(q0 + r) * hd + c,
                     vec);
        } else {
          zero_piece(sq + r * kRowK + c, vec);
        }
      }
      __syncwarp();
    }
  };
  // the warp's finished rows into o
  auto store = [&](const RowState<kOut>& st, size_t base, int c0, int q0) {
    float inv0, inv1;
    st.totals(inv0, inv1);
    if constexpr (kQRegs) {
      // straight from the accumulators (c0 is 0: one item a slice)
#pragma unroll
      for (int j = 0; j < kOut / 8; ++j) {
        const int col = j * 8 + (lane & 3) * 2;
        const int row = q0 + (lane >> 2);
        store_pair(o + base, row, col, len, hd, st.acc[j][0] * inv0,
                   st.acc[j][1] * inv0);
        store_pair(o + base, row + 8, col, len, hd, st.acc[j][2] * inv1,
                   st.acc[j][3] * inv1);
      }
    } else {
      // stage the 16 x kOut outputs in the warp's Q tile (its last reads of
      // Q are done), then write the true rows and columns in vec pieces
      const int cols = min(kOut, hd - c0);
      __syncwarp();
#pragma unroll
      for (int j = 0; j < kOut / 8; ++j) {
        const int col = j * 8 + (lane & 3) * 2;
        *reinterpret_cast<uint32_t*>(sq + (lane >> 2) * kRowK + col) =
            pack_bf16(st.acc[j][0] * inv0, st.acc[j][1] * inv0);
        *reinterpret_cast<uint32_t*>(sq + ((lane >> 2) + 8) * kRowK + col) =
            pack_bf16(st.acc[j][2] * inv1, st.acc[j][3] * inv1);
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
  };
  // the warp's rows against key tile t, staged in `slot`
  auto attend = [&](RowState<kOut>& st,
                    const uint32_t (&qf)[kQRegs ? kKs : 1][4], int t,
                    int slot) {
    const bf16* sk = ring + (size_t)slot * kSlot;
    const int kt = t * kKTile;
    const int chunks = min(4, (lp - kt) / 16);
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    scores<kKs, kQRegs, kRowK>(s, qf, sq, sk, chunks);
    st.template absorb<kRowV>(s, sk + kKTile * kRowK, kt, len, chunks,
                              scale_log2e);
  };

  if (resident) {
    // every tile of an item staged once, then every query tile
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      for (int t = 0; t < tiles; ++t) load_tile(item, t, t);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();

      const size_t base = (size_t)(item / kSplit) * len * hd;
      const int c0 = (item % kSplit) * kOut;
      for (int q0 = warp * 16; q0 < lp; q0 += kWarps * 16) {
        uint32_t qf[kQRegs ? kKs : 1][4];
        load_q(qf, base, q0);
        RowState<kOut> st;
        st.reset();
        for (int t = 0; t < tiles; ++t) attend(st, qf, t, t);
        store(st, base, c0, q0);
      }
      __syncthreads();    // every warp is done with this item's tiles
    }
    return;
  }

  // the tiles stream: a unit of work is 64 query rows of an item, against
  // every tile, up to kAhead copies in flight ahead of the products
  const int ahead = min(kAhead, slots - 1);
  const int groups = (len + kWarps * 16 - 1) / (kWarps * 16);
  const long long units = (long long)items * groups;
  for (long long u = blockIdx.x; u < units; u += gridDim.x) {
    const int item = (int)(u / groups);
    const size_t base = (size_t)(item / kSplit) * len * hd;
    const int c0 = (item % kSplit) * kOut;
    {
      const int q0 = (int)(u % groups) * kWarps * 16 + warp * 16;
      const bool active = q0 < len;
      for (int t = 0; t < ahead; ++t) {
        if (t < tiles) load_tile(item, t, t % slots);
        cp_async_commit();
      }
      uint32_t qf[kQRegs ? kKs : 1][4];
      if (active) load_q(qf, base, q0);
      RowState<kOut> st;
      st.reset();
      for (int t = 0; t < tiles; ++t) {
        // tile t has landed; every warp is done with the slot the next
        // copy fills (that of tile t - 1)
        cp_async_wait_n(ahead - 1);
        __syncthreads();
        if (t + ahead < tiles) load_tile(item, t + ahead, (t + ahead) % slots);
        cp_async_commit();
        if (active) attend(st, qf, t, t % slots);
      }
      if (active) store(st, base, c0, q0);
      __syncthreads();    // the ring is free for the next rows' copies
    }
  }
  cp_async_wait<0>();
}

// q, k, v, o (slices, len, hd) bf16, hd > 256; items = slices * shares *
// ceil(len / 64), shares = ceil(hd / kChunk); grid <= items, persistent;
// dynamic shared memory kWideSmemBytes. vec as above; scale_log2e =
// log2(e) / sqrt(hd). A work item is (slice, share, 64 query rows): its
// 64-key tiles each bring `chunks` K pieces of kChunk columns, then the
// share's V piece, through a ring of kWideSlots slots.
__global__ void __launch_bounds__(kThreads)
attention_head_wide_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ o,
                           long long items, int len, int hd, int vec,
                           float scale_log2e) {
  constexpr int kRow = kChunk + 8;
  constexpr int kPieceElems = kKTile * kRow;
  constexpr int kKs = kChunk / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int lp = padded_len(len);
  const int tiles = (lp + kKTile - 1) / kKTile;
  const int chunks = (hd + kChunk - 1) / kChunk;
  const int groups = (len + kKTile - 1) / kKTile;
  const int per = vec / 2;
  const int pieces = tiles * (chunks + 1);     // K chunks, then V, a tile

  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const long long slice_share = item / groups;
    const int g0 = (int)(item % groups) * kKTile;
    const int share = (int)(slice_share % chunks);
    const size_t base = (size_t)(slice_share / chunks) * len * hd;
    const int c0 = share * kChunk;
    const int q0 = g0 + warp * 16;
    const bool active = q0 < len;

    // piece p: tile p / (chunks + 1); column chunk p % (chunks + 1), or the
    // share's V where that is `chunks`
    auto load_piece = [&](int p) {
      const int t = p / (chunks + 1);
      const int c = p % (chunks + 1);
      const int k0 = t * kKTile;
      const int rows = min(kKTile, len - k0);
      const int rows16 = min(kKTile, lp - k0);
      const int col0 = c < chunks ? c * kChunk : c0;
      const int cols = min(kChunk, hd - col0);
      bf16* dst = ring + (size_t)(p % kWideSlots) * kPieceElems;
      // columns past hd are zero in every row (K's add nothing to a score)
      stage_async(dst, kRow, (c < chunks ? k : v) + base + (size_t)k0 * hd,
                  rows, hd, col0, cols, vec, rows16, cols);
      for (int i = threadIdx.x; i < rows16 * ((kChunk - cols) / per);
           i += blockDim.x) {
        const int n = (kChunk - cols) / per;
        const int r = i / n;
        zero_piece(dst + r * kRow + cols + (i - r * n) * per, vec);
      }
    };
    for (int p = 0; p < kWideSlots - 1; ++p) {
      if (p < pieces) load_piece(p);
      cp_async_commit();
    }
    RowState<kChunk> st;
    st.reset();
    float s[8][4];
    for (int p = 0; p < pieces; ++p) {
      cp_async_wait<kWideSlots - 2>();
      __syncthreads();
      if (p + kWideSlots - 1 < pieces) load_piece(p + kWideSlots - 1);
      cp_async_commit();
      if (!active) continue;
      const int t = p / (chunks + 1);
      const int c = p % (chunks + 1);
      const int kt = t * kKTile;
      const int steps = min(4, (lp - kt) / 16);
      const bf16* piece = ring + (size_t)(p % kWideSlots) * kPieceElems;
      if (c == 0) {
#pragma unroll
        for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      }
      if (c < chunks) {
        uint32_t qf[kKs][4];
        load_q_frags(qf, q + base, q0, len, hd, c * kChunk);
        scores<kKs, true, kRow>(s, qf, nullptr, piece, steps);
      } else {
        st.absorb<kRow>(s, piece, kt, len, steps, scale_log2e);
      }
    }
    if (active) {
      float inv0, inv1;
      st.totals(inv0, inv1);
#pragma unroll
      for (int j = 0; j < kChunk / 8; ++j) {
        const int col = c0 + j * 8 + (lane & 3) * 2;
        const int row = q0 + (lane >> 2);
        store_pair(o + base, row, col, len, hd, st.acc[j][0] * inv0,
                   st.acc[j][1] * inv0);
        store_pair(o + base, row + 8, col, len, hd, st.acc[j][2] * inv1,
                   st.acc[j][3] * inv1);
      }
    }
    __syncthreads();      // the ring is free for the next item's copies
  }
  cp_async_wait<0>();
}

}  // namespace gridmm_head_mma
