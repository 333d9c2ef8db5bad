// Tensor-core body of the packed-qkv attention kernel (attention_qkv_fwd.cu),
// bf16, head_dim 64: for one (image, head, block of query rows),
//     o[t] = sum_j softmax_j(q[t] . k[j] / 8) v[j]
// over all `len` keys, scores and softmax in f32, products on the tensor cores.
//
// Design (one block = `warps` warps, 16 query rows a warp, up to 8 warps):
//   * K and V stream through a ring of kStages slots of 64 keys in shared
//     memory, filled by 16-byte cp.async copies straight from the packed
//     projection: the copy of tile t + kStages - 1 is in flight while the
//     block computes tile t, and one barrier a tile hands the slots on
//     (two slots: a third, `chip_profile.py --k2-builds`, bought nothing
//     at L >= 197 and cost L = 50 blocks an SM). The ring is the block's
//     whole shared memory, whatever `len`; at len <= 64 it holds the only
//     tile and nothing is restaged;
//   * a block covers up to 128 query rows (the launcher picks `warps` from
//     `len`), so each staged tile serves them all: at L = 197, two blocks of
//     seven warps read K and V of a head where four blocks of four did;
//   * each warp reads its Q fragments from device memory straight into
//     registers while the first tiles' copies are in flight; its 16 output
//     rows pass through its own rows of a slot no tile used (len <= 64: no
//     block barrier), else of the first slot once every warp is done with
//     the ring, to leave in 16-byte stores in place (no head transpose on
//     either side);
//   * rows are padded from 128 to 144 bytes, so the eight rows of an
//     ldmatrix fall in eight 16-byte bank groups; key rows past `len` are
//     zero rows (0 x garbage could be NaN) and score -inf before the max;
//     query rows past `len` are computed and never stored;
//   * S = Q K^T and O = P V are mma.sync.aligned.m16n8k16 bf16 products with
//     f32 accumulators; Q and K fragments come from ldmatrix, V fragments
//     from ldmatrix.trans (V is stored key-major, the product needs it
//     dim-major); the softmax is online (running max and sum a row, shuffles
//     within the four lanes that share a row);
//   * the probabilities are rounded to bf16 in registers and are, as they
//     stand, the A fragments of P V: the (len x len) scores never touch
//     shared or device memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace gridmm_attn_mma {

constexpr int kHd = 64;                 // head_dim
constexpr int kMaxWarps = 8;
constexpr int kMaxThreads = kMaxWarps * 32;
constexpr int kKTile = 64;              // keys a slot of the ring holds
constexpr int kStages = 2;              // slots of the ring
constexpr int kRow = kHd + 8;           // padded shared-memory row, elements
constexpr int kVecs = kHd / 8;          // 16-byte vectors per row
constexpr int kTileElems = kKTile * kRow;         // K (or V) of one slot
constexpr int kSlotElems = 2 * kTileElems;        // K then V

// the block's shared memory: the ring, at every len
constexpr size_t kSmemBytes =
    (size_t)kStages * kSlotElems * sizeof(__nv_bfloat16);
static_assert(kMaxWarps * 16 * kRow <= kSlotElems,
              "a slot must hold the block's outputs");

// warps a block for `len` query rows: 16 rows a warp, at most kMaxWarps,
// and as few idle warps as the blocks of a head allow
inline int warps_for(int len) {
  const int wn = (len + 15) / 16;
  const int nb = (wn + kMaxWarps - 1) / kMaxWarps;
  return (wn + nb - 1) / nb;
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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
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

// Block-wide: `rows` rows of 64 elements, `stride` elements apart in device
// memory, into shared rows of kRow; rows past `valid` are zero rows.
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           size_t stride, int rows,
                                           int valid) {
  for (int i = threadIdx.x; i < rows * kVecs; i += blockDim.x) {
    const int r = i / kVecs;
    const int c = (i % kVecs) * 8;
    __nv_bfloat16* d = dst + r * kRow + c;
    if (r < valid) {
      cp_async16(d, src + (size_t)r * stride + c);
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// qkv (batch, len, 3 * heads * 64) bf16, out (batch, len, heads * 64) bf16;
// grid batch * heads * ceil(len / (16 * warps)), the blocks of a head next
// to each other; blockDim.x = 32 * warps with warps = warps_for(len);
// dynamic shared memory kSmemBytes.
// scale_log2e = log2(e) / sqrt(64).
__global__ void __launch_bounds__(kMaxThreads, 2)
attention_qkv_mma_kernel(const __nv_bfloat16* __restrict__ qkv,
                         __nv_bfloat16* __restrict__ out, int len, int heads,
                         float scale_log2e) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int rows = blockDim.x / 2;               // 16 query rows a warp
  const int qblocks = (len + rows - 1) / rows;
  const int head = blockIdx.x / qblocks;         // image * heads + head
  const int seq = head / heads;
  const int h = head % heads;
  const int q0 = (blockIdx.x % qblocks) * rows;
  const size_t width = (size_t)heads * kHd;
  const size_t in_stride = 3 * width;
  const __nv_bfloat16* qg = qkv + (size_t)seq * len * in_stride + h * kHd;
  const __nv_bfloat16* kg = qg + width;
  const __nv_bfloat16* vg = kg + width;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wrow = warp * 16;          // this warp's first row of the block
  const bool active = q0 + wrow < len;
  const int tiles = (len + kKTile - 1) / kKTile;

  auto load_tile = [&](int t) {
    __nv_bfloat16* sk = ring + (t % kStages) * kSlotElems;
    const int k0 = t * kKTile;
    const int valid = min(kKTile, len - k0);
    // rows up to the next multiple of 16 are read; zero those past len
    const int staged = min(kKTile, (valid + 15) / 16 * 16);
    stage_rows(sk, kg + (size_t)k0 * in_stride, in_stride, staged, valid);
    stage_rows(sk + kTileElems, vg + (size_t)k0 * in_stride, in_stride,
               staged, valid);
  };

  // the first kStages - 1 tiles
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < tiles) load_tile(t);
    cp_async_commit();
  }

  // A fragments of Q, 16 rows x 64 dims = four 16 x 16 steps, as
  // ldmatrix.x4 would give them: a lane holds row lane / 4 (elements 0, 2)
  // and lane / 4 + 8 (1, 3), columns (lane & 3) * 2 + {0, 1} (+ 8 in
  // elements 2, 3); zero past len
  uint32_t qf[4][4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = q0 + wrow + (lane >> 2) + (e & 1) * 8;
      const int col = ks * 16 + (lane & 3) * 2 + (e >> 1) * 8;
      qf[ks][e] = row < len ? *reinterpret_cast<const uint32_t*>(
                                  qg + (size_t)row * in_stride + col)
                            : 0u;
    }
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

  for (int t = 0; t < tiles; ++t) {
    // tile t has landed (only the newest kStages - 2 groups may still be
    // in flight), and every warp is done with the slot the next copy fills
    // (that of tile t - 1)
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (t + kStages - 1 < tiles) load_tile(t + kStages - 1);
    cp_async_commit();
    if (!active) continue;

    const __nv_bfloat16* sk = ring + (t % kStages) * kSlotElems;
    const __nv_bfloat16* sv = sk + kTileElems;
    const int kt = t * kKTile;
    const int chunks = min(4, (len - kt + 15) / 16);   // 16-key steps

    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    }
    // S = Q K^T, 16 keys (two 8-wide tiles) at a time
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      if (np < chunks) {
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          uint32_t kf[4];
          ldmatrix_x4(kf, sk + (np * 16 + (lane & 7) + (lane >> 4) * 8) *
                                   kRow +
                              ks * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(s[2 * np], qf[ks], kf[0], kf[1]);
          mma_bf16(s[2 * np + 1], qf[ks], kf[2], kf[3]);
        }
      }
    }
    // scale; keys past `len` (padding, or steps not computed) score -inf
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
      if (kk < chunks) {
        const uint32_t a[4] = {pf[2 * kk][0], pf[2 * kk][1],
                               pf[2 * kk + 1][0], pf[2 * kk + 1][1]};
#pragma unroll
        for (int dp = 0; dp < 4; ++dp) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, sv + (kk * 16 + (lane & 7) +
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

  // each warp stages its 16 x 64 outputs in its own rows of a slot no tile
  // used, or, where every slot held a tile, of the first slot once every
  // warp is done with the ring; then writes whole 16-byte vectors
  if (tiles >= kStages) __syncthreads();
  if (!active) return;
  __nv_bfloat16* so =
      ring + (tiles < kStages ? tiles * kSlotElems : 0) + wrow * kRow;
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
