// Per-head attention for Hopper (sm_90a) on (BH, L, hd) tensors, any head_dim
// from 1 to 256.
//
// Replaces the TPU kernel `_attn_kernel` in gridmm_tpu/ops/pallas/attention.py
// :26 (wrapper fused_attention :52): o = softmax(q k^T / sqrt(hd)) v for each
// of the BH (sequence x head) slices, over the L true keys. The port sends
// every ViT tower whose head_dim is not 64 here (head_dim 64 goes to
// attention_qkv_fwd.cu), e.g. the width-64, 4-head preprocess tower (hd 16)
// or a ViT-H/14-width tower (hd 80).
//
// Bound: bytes at the towers' short sequences: q, k, v read once and o
// written once, 4 * BH * L * hd elements, against 4 * BH * L^2 * hd flops.
//
// The Pallas wrapper pads hd to the TPU's 128 lanes and L to 8 sublanes in
// device memory; here nothing is padded outside the chip. Two bodies, each
// padding hd on chip while it stages a slice, each staging a slice's K and
// V once for all its queries:
//   * bf16: attention_head_mma.cuh, both products as mma.sync bf16
//     tensor-core instructions, a persistent grid over the slices;
//   * f32: attention_head_f32.cuh, exact f32 on the CUDA cores, a warp per
//     four query rows with the score rows spread over its lanes, Q staged
//     with K and V.

#include "attention_head_f32.cuh"
#include "attention_head_mma.cuh"

namespace {

constexpr int kMaxSmem = 232448;       // bytes a block may use on sm_90
constexpr int kTwoBlockSmem = 115712;  // bytes a block may use, two an SM
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

template <int kHdP>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int bh,
                int len, int hd, float scale, cudaStream_t s) {
  namespace hm = gridmm_head_mma;
  const size_t one = hm::q_bytes(kHdP) + hm::stage_bytes(len, kHdP);
  const size_t two = one + hm::stage_bytes(len, kHdP);
  if (one > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const int stages = two <= (size_t)kTwoBlockSmem ? 2 : 1;
  const size_t smem = stages == 2 ? two : one;
  auto kernel = hm::attention_head_mma_kernel<kHdP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int sms = 0, per_sm = 0;
  err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, hm::kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const long long items = (long long)bh * (kHdP / hm::out_width(kHdP));
  if (items >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  long long grid = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (grid > items) grid = items;
  kernel<<<(unsigned)grid, hm::kThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      (int)items, len, hd, piece_bytes(hd), stages,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

template <int kHdP>
int launch_f32(const void* q, const void* k, const void* v, void* o, int bh,
               int len, int hd, float scale, cudaStream_t s) {
  namespace hf = gridmm_head_f32;
  // a warp for every kQ query rows of the block's slices, up to kMaxWarps;
  // several slices a block at short L
  const int groups = (len + hf::kQ - 1) / hf::kQ;
  int nsl = (hf::kMaxWarps + groups - 1) / groups;
  if (nsl > hf::kMaxSlices) nsl = hf::kMaxSlices;
  if (nsl > bh) nsl = bh;
  auto warps_for = [&](int slices) {
    const int w = slices * groups;
    return w < hf::kMaxWarps ? w : hf::kMaxWarps;
  };
  while (nsl > 1 && hf::smem_bytes(warps_for(nsl), len, kHdP, nsl, len) >
                        (size_t)kMaxSmem) {
    --nsl;
  }
  int warps = warps_for(nsl), kc = len;
  if (hf::smem_bytes(warps, len, kHdP, nsl, len) > (size_t)kMaxSmem) {
    // one slice streamed: the largest chunk of keys below len, a multiple
    // of 32, that fits beside as many warps as leave room for 32 keys
    nsl = 1;
    while (warps > 1 &&
           hf::smem_bytes(warps, len, kHdP, 0, 32) > (size_t)kMaxSmem) {
      --warps;
    }
    kc = 0;
    while (kc + 32 < len && hf::smem_bytes(warps, len, kHdP, 0, kc + 32) <=
                                (size_t)kMaxSmem) {
      kc += 32;
    }
    if (kc == 0) return (int)cudaErrorInvalidValue;
  }
  const size_t smem =
      hf::smem_bytes(warps, len, kHdP, kc >= len ? nsl : 0, kc);
  auto kernel = hf::attention_head_f32_kernel<kHdP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (bh + nsl - 1) / nsl;
  kernel<<<grid, 32 * warps, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), bh, len, hd, nsl,
      kc, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

int dispatch_bf16(const void* q, const void* k, const void* v, void* o,
                  int bh, int len, int hd, float scale, cudaStream_t s) {
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

// Plain C entry point for ctypes. q, k, v and o are (bh, len, hd),
// contiguous, 16-byte aligned, in one type (dtype 0 = f32, 1 = bf16);
// 1 <= hd <= 256. Returns the launch's cudaError_t (0 = success).
extern "C" int gridmm_attention_fwd(const void* q, const void* k,
                                    const void* v, int dtype, void* o, int bh,
                                    int len, int hd, float scale,
                                    void* stream) {
  if (bh < 1 || len < 1 || hd < 1 || hd > 256) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_f32(q, k, v, o, bh, len, hd, scale, s);
  if (dtype == 1) return dispatch_bf16(q, k, v, o, bh, len, hd, scale, s);
  return (int)cudaErrorInvalidValue;
}
