// Per-head attention for Hopper (sm_90a) on (BH, L, hd) tensors, any L and
// any head_dim.
//
// Replaces the TPU kernel `_attn_kernel` in gridmm_tpu/ops/pallas/attention.py
// :26 (wrapper fused_attention :52): o = softmax(q k^T / sqrt(hd)) v for each
// of the BH (sequence x head) slices, over the L true keys. The port sends
// every ViT tower whose head_dim is not 64 here (head_dim 64 goes to
// attention_qkv_fwd.cu), e.g. the width-64, 4-head preprocess tower (hd 16)
// or a ViT-H/14-width tower (hd 80).
//
// Bound: bytes at the towers' short sequences: q, k, v read once and o
// written once, 4 * BH * L * hd elements; at long L the products, 4 * BH *
// L^2 * hd operations over the type's peak.
//
// The Pallas wrapper pads hd to the TPU's 128 lanes and L to 8 sublanes in
// device memory; here nothing is padded outside the chip. K and V pass
// through a ring of key tiles in shared memory whose size depends on hd and
// the type alone, under an online softmax, so any L runs. Two bodies up to
// hd 256, each padding hd on chip:
//   * bf16: attention_head_mma.cuh, both products as mma.sync bf16
//     tensor-core instructions, a persistent grid over the slices; a slice
//     whose tiles fit in the ring is staged once for all its queries, else
//     its tiles stream through the ring;
//   * f32: attention_head_f32.cuh, exact f32 on the CUDA cores, a warp per
//     four query rows with one key a lane, the tiles always streamed.
// Above hd 256 (which the JAX wrapper pads to a multiple of 128), a kernel
// for each type takes 128 output columns a work item and streams K in
// 128-column chunks.

#include "attention_head_f32.cuh"
#include "attention_head_mma.cuh"

#include <algorithm>

namespace {

constexpr int kMaxDevices = 16;

cudaError_t sm_count(int* out) {
  static int per_device[kMaxDevices] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (per_device[dev] == 0) {
    err = cudaDeviceGetAttribute(&per_device[dev],
                                 cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  *out = per_device[dev];
  return cudaSuccess;
}

// the widest piece (16, 8, 4 or 2 bytes) that divides a row of hd bf16
int piece_bytes(int hd) {
  const int row = hd * 2;
  return row % 16 == 0 ? 16 : row % 8 == 0 ? 8 : row % 4 == 0 ? 4 : 2;
}

// A persistent grid for `kernel`: as many blocks as fit on the card at
// once, and no more than `items` (the units of work its blocks walk). Sets
// the kernel's shared memory first.
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, int threads, size_t smem,
                            long long items, unsigned* grid) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  long long g = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (g > items) g = items;
  *grid = (unsigned)g;
  return cudaSuccess;
}

template <int kHdP>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int bh,
                int len, int hd, float scale, cudaStream_t s) {
  namespace hm = gridmm_head_mma;
  const size_t smem = hm::smem_bytes(kHdP);
  const long long items = (long long)bh * (kHdP / hm::out_width(kHdP));
  // where an item's tiles outgrow the ring, 64 query rows of an item a unit
  constexpr int kRows = hm::kWarps * 16;
  const int tiles = (hm::padded_len(len) + hm::kKTile - 1) / hm::kKTile;
  const long long units = tiles <= hm::ring_slots(kHdP)
                              ? items
                              : items * ((len + kRows - 1) / kRows);
  if (items >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  auto kernel = hm::attention_head_mma_kernel<kHdP>;
  unsigned grid = 0;
  cudaError_t err = persistent_grid(kernel, hm::kThreads, smem, units,
                                    &grid);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, hm::kThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      (int)items, len, hd, piece_bytes(hd), hm::ring_slots(kHdP),
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

int launch_bf16_wide(const void* q, const void* k, const void* v, void* o,
                     int bh, int len, int hd, float scale, cudaStream_t s) {
  namespace hm = gridmm_head_mma;
  const long long items = (long long)bh *
                          ((hd + hm::kChunk - 1) / hm::kChunk) *
                          ((len + hm::kKTile - 1) / hm::kKTile);
  unsigned grid = 0;
  cudaError_t err = persistent_grid(hm::attention_head_wide_kernel,
                                    hm::kThreads, hm::kWideSmemBytes, items,
                                    &grid);
  if (err != cudaSuccess) return (int)err;
  hm::attention_head_wide_kernel<<<grid, hm::kThreads, hm::kWideSmemBytes,
                                   s>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      items, len, hd, piece_bytes(hd), scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

template <int kHdP>
int launch_f32(const void* q, const void* k, const void* v, void* o, int bh,
               int len, int hd, float scale, cudaStream_t s) {
  namespace hf = gridmm_head_f32;
  const size_t smem = hf::smem_bytes(kHdP);
  // a warp for every kQ query rows of a slice, up to max_warps a block
  const int groups = (len + hf::kQ - 1) / hf::kQ;
  const int warps = std::min(groups, hf::max_warps(kHdP));
  auto kernel = hf::attention_head_f32_kernel<kHdP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long grid = (long long)bh * ((groups + warps - 1) / warps);
  if (grid >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)grid, 32 * warps, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), len, hd,
      hf::ring_slots(kHdP), scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

int launch_f32_wide(const void* q, const void* k, const void* v, void* o,
                    int bh, int len, int hd, float scale, cudaStream_t s) {
  namespace hf = gridmm_head_f32;
  constexpr int kRows = hf::kQ * hf::kWideWarps;
  const long long items = (long long)bh *
                          ((hd + hf::kChunk - 1) / hf::kChunk) *
                          ((len + kRows - 1) / kRows);
  unsigned grid = 0;
  cudaError_t err = persistent_grid(hf::attention_head_f32_wide_kernel,
                                    32 * hf::kWideWarps, hf::kWideSmemBytes,
                                    items, &grid);
  if (err != cudaSuccess) return (int)err;
  hf::attention_head_f32_wide_kernel<<<grid, 32 * hf::kWideWarps,
                                       hf::kWideSmemBytes, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), items, len, hd,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

int dispatch_bf16(const void* q, const void* k, const void* v, void* o,
                  int bh, int len, int hd, float scale, cudaStream_t s) {
  if (hd > 256) return launch_bf16_wide(q, k, v, o, bh, len, hd, scale, s);
  switch (gridmm_head_mma::padded_hd(hd)) {
#define HEAD_BF16(P) \
  case P: return launch_bf16<P>(q, k, v, o, bh, len, hd, scale, s);
    HEAD_BF16(16) HEAD_BF16(32) HEAD_BF16(48) HEAD_BF16(64) HEAD_BF16(80)
    HEAD_BF16(96) HEAD_BF16(112) HEAD_BF16(128) HEAD_BF16(160)
    HEAD_BF16(192) HEAD_BF16(224) HEAD_BF16(256)
#undef HEAD_BF16
    default: return (int)cudaErrorInvalidValue;
  }
}

int dispatch_f32(const void* q, const void* k, const void* v, void* o,
                 int bh, int len, int hd, float scale, cudaStream_t s) {
  if (hd > 256) return launch_f32_wide(q, k, v, o, bh, len, hd, scale, s);
  switch (gridmm_head_f32::padded_hd(hd)) {
#define HEAD_F32(P) \
  case P: return launch_f32<P>(q, k, v, o, bh, len, hd, scale, s);
    HEAD_F32(16) HEAD_F32(32) HEAD_F32(64) HEAD_F32(96) HEAD_F32(128)
    HEAD_F32(160) HEAD_F32(192) HEAD_F32(224) HEAD_F32(256)
#undef HEAD_F32
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Shared memory in bytes of one block of the launch for this type (0 = f32,
// 1 = bf16) and hd, as the launchers set it: the ring's, the same at every
// len (-1 for another type or hd < 1).
extern "C" int gridmm_attention_fwd_smem(int dtype, int hd) {
  namespace hf = gridmm_head_f32;
  namespace hm = gridmm_head_mma;
  if (hd < 1) return -1;
  if (dtype == 0) {
    return (int)(hd > 256 ? hf::kWideSmemBytes
                          : hf::smem_bytes(hf::padded_hd(hd)));
  }
  if (dtype == 1) {
    return (int)(hd > 256 ? hm::kWideSmemBytes
                          : hm::smem_bytes(hm::padded_hd(hd)));
  }
  return -1;
}

// Plain C entry point for ctypes. q, k, v and o are (bh, len, hd),
// contiguous, 16-byte aligned, in one type (dtype 0 = f32, 1 = bf16);
// hd >= 1. Returns the launch's cudaError_t (0 = success).
extern "C" int gridmm_attention_fwd(const void* q, const void* k,
                                    const void* v, int dtype, void* o, int bh,
                                    int len, int hd, float scale,
                                    void* stream) {
  if (bh < 1 || len < 1 || hd < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_f32(q, k, v, o, bh, len, hd, scale, s);
  if (dtype == 1) return dispatch_bf16(q, k, v, o, bh, len, hd, scale, s);
  return (int)cudaErrorInvalidValue;
}
