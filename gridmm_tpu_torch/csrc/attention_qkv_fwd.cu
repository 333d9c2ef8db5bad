// Packed-qkv multi-head attention for Hopper (sm_90a), head_dim 64.
//
// Replaces the TPU kernel `_attn_qkv_kernel` in
// gridmm_tpu/ops/pallas/attention_qkv.py:37 (wrapper fused_attention_qkv
// :90). Input is the ViT block's qkv projection (B, L, 3W), W = heads * 64,
// laid out [q | k | v] along the last axis with head h in columns
// h*64 .. h*64+63 of each third; output is the context (B, L, W) with head h
// in the same columns. Full bidirectional attention over the L tokens.
//
// Bound: bytes at CLIP B/32 (L = 50): the qkv read plus the context write,
// ~59 MB for 192 images in bf16 (~17.6 us at 3.35 TB/s), against 1.5 GFLOP.
// At B/16 (L = 197) the scores dominate: 23 GFLOP for 192 images.
//
// The block reads its head's q, k and v with strided 16-byte loads straight
// from the packed projection and writes its 64 output columns in place, so
// no head transpose or relayout copy exists on either side. The Pallas
// kernel pairs two heads into a block-diagonal product only to fill the
// TPU's 128-lane tiles; that pairing has no purpose here and is not carried
// over. The shared body is attention_core.cuh: one block per (image, head,
// tile of 64 queries), K and V staged in shared memory, online softmax in f32.

#include "attention_core.cuh"

namespace {

using gridmm_attn::kThreads;
constexpr int kHd = 64;

template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_qkv_kernel(const T* __restrict__ qkv, T* __restrict__ out, int len,
                     int heads, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int seq = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const long width = (long)heads * kHd;
  const T* q = qkv + (size_t)seq * len * 3 * width + h * kHd;
  gridmm_attn::attend<T, kHd>(q, q + width, q + 2 * width,
                              out + (size_t)seq * len * width + h * kHd, len,
                              3 * width, width, scale, smem_raw);
}

template <typename T>
int launch(const void* qkv, void* out, int batch, int len, int heads,
           float scale, cudaStream_t s) {
  const size_t smem = gridmm_attn::smem_bytes<T, kHd>(len);
  if (smem > (size_t)gridmm_attn::kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      attention_qkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  constexpr int kQueries = gridmm_attn::Shape<T, kHd>::kQueries;
  const dim3 grid(batch * heads, (len + kQueries - 1) / kQueries);
  attention_qkv_kernel<T><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), len, heads, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. qkv (batch, len, 3 * heads * 64) and out
// (batch, len, heads * 64), contiguous, 16-byte aligned, in one type
// (dtype 0 = f32, 1 = bf16). Returns the launch's cudaError_t (0 = success).
extern "C" int gridmm_attention_qkv_fwd(const void* qkv, int dtype, void* out,
                                        int batch, int len, int heads,
                                        float scale, void* stream) {
  if (batch < 1 || len < 1 || heads < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(qkv, out, batch, len, heads, scale, s);
  if (dtype == 1) {
    return launch<__nv_bfloat16>(qkv, out, batch, len, heads, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
