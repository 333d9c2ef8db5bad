// Packed-qkv multi-head attention for Hopper (sm_90a), head_dim 64.
//
// Replaces the TPU kernel `_attn_qkv_kernel` in
// gridmm_tpu/ops/pallas/attention_qkv.py:37 (wrapper fused_attention_qkv
// :90). Input is the ViT block's qkv projection (B, L, 3W), W = heads * 64,
// laid out [q | k | v] along the last axis with head h in columns
// h*64 .. h*64+63 of each third; output is the context (B, L, W) with head h
// in the same columns. Full bidirectional attention over the L tokens.
//
// Bound: bytes at the towers' lengths: the qkv read once and the context
// written once, 4 * B * L * W elements (~59 MB for 192 clip_b32 images in
// bf16, ~17.6 us at 3.35 TB/s; at L = 197, 48 images, ~17.3 us). At long L
// the products bound it: 4 * B * heads * L^2 * 64 operations over the
// type's peak (bf16 on the tensor cores; in f32 on the CUDA cores, whose
// 67 TFLOP/s this body does not approach).
//
// A block reads its head's q, k and v with strided 16-byte copies straight
// from the packed projection and writes its 64 output columns in place, so
// no head transpose or relayout copy exists on either side. The Pallas
// kernel pairs two heads into a block-diagonal product only to fill the
// TPU's 128-lane tiles; that pairing has no purpose here and is not carried
// over. In both bodies K and V stream through a ring of key tiles in shared
// memory, so any L runs and a block's shared memory is the same at every L;
// one block per (image, head, block of query rows):
//   * bf16 (every main path): attention_qkv_mma.cuh, both products as
//     mma.sync bf16 tensor-core instructions, the score tile in registers,
//     up to 128 query rows a block sharing each staged tile;
//   * f32: attention_core.cuh, two threads per query row on the CUDA cores
//     with an online softmax. It holds 2e-5 against the plain version, which
//     TF32 products (10 mantissa bits) would not, and no main path runs the
//     tower in f32.

#include "attention_core.cuh"
#include "attention_qkv_mma.cuh"

namespace {

constexpr int kHd = 64;

__global__ void __launch_bounds__(gridmm_attn::kThreads)
attention_qkv_f32_kernel(const float* __restrict__ qkv, float* __restrict__ out,
                         int len, int heads, float scale) {
  extern __shared__ __align__(16) float ring[];
  constexpr int kRows = gridmm_attn::kQueries;
  const int qblocks = (len + kRows - 1) / kRows;
  const int head = blockIdx.x / qblocks;      // image * heads + head
  const int seq = head / heads;
  const int h = head % heads;
  const long width = (long)heads * kHd;
  const float* q = qkv + (size_t)seq * len * 3 * width + h * kHd;
  gridmm_attn::attend(q, q + width, q + 2 * width,
                      out + (size_t)seq * len * width + h * kHd, len,
                      3 * width, width, scale,
                      (blockIdx.x % qblocks) * kRows, ring);
}

// f32: the CUDA-core body
int launch_f32(const void* qkv, void* out, int batch, int len, int heads,
               float scale, cudaStream_t s) {
  namespace core = gridmm_attn;
  cudaError_t err = cudaFuncSetAttribute(
      attention_qkv_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)core::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const long long grid =
      (long long)batch * heads * ((len + core::kQueries - 1) / core::kQueries);
  if (grid >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  attention_qkv_f32_kernel<<<(unsigned)grid, core::kThreads, core::kSmemBytes,
                             s>>>(
      static_cast<const float*>(qkv), static_cast<float*>(out), len, heads,
      scale);
  return (int)cudaGetLastError();
}

// bf16: the tensor-core body
int launch_bf16(const void* qkv, void* out, int batch, int len, int heads,
                float scale, cudaStream_t s) {
  namespace mma = gridmm_attn_mma;
  cudaError_t err = cudaFuncSetAttribute(
      mma::attention_qkv_mma_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)mma::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int warps = mma::warps_for(len);
  const long long grid =
      (long long)batch * heads * ((len + 16 * warps - 1) / (16 * warps));
  if (grid >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  mma::attention_qkv_mma_kernel<<<(unsigned)grid, 32 * warps,
                                  mma::kSmemBytes, s>>>(
      static_cast<const __nv_bfloat16*>(qkv),
      static_cast<__nv_bfloat16*>(out), len, heads,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory in bytes of one block of the launch for this type (0 = f32,
// 1 = bf16), as the launchers set it: the ring's, the same at every len
// (-1 for another type).
extern "C" int gridmm_attention_qkv_fwd_smem(int dtype) {
  if (dtype == 0) return (int)gridmm_attn::kSmemBytes;
  if (dtype == 1) return (int)gridmm_attn_mma::kSmemBytes;
  return -1;
}

// Plain C entry point for ctypes. qkv (batch, len, 3 * heads * 64) and out
// (batch, len, heads * 64), contiguous, 16-byte aligned, in one type
// (dtype 0 = f32, 1 = bf16). Returns the launch's cudaError_t (0 = success).
extern "C" int gridmm_attention_qkv_fwd(const void* qkv, int dtype, void* out,
                                        int batch, int len, int heads,
                                        float scale, void* stream) {
  if (batch < 1 || len < 1 || heads < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_f32(qkv, out, batch, len, heads, scale, s);
  if (dtype == 1) return launch_bf16(qkv, out, batch, len, heads, scale, s);
  return (int)cudaErrorInvalidValue;
}
