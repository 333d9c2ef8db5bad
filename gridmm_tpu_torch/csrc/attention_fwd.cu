// Per-head attention for Hopper (sm_90a) on (BH, L, hd) tensors.
//
// Replaces the TPU kernel `_attn_kernel` in gridmm_tpu/ops/pallas/attention.py
// :26 (wrapper fused_attention :52): o = softmax(q k^T / sqrt(hd)) v for each
// of the BH (sequence x head) slices, over the L true keys. The port sends
// every ViT tower whose head_dim is not 64 here (head_dim 64 goes to
// attention_qkv_fwd.cu), e.g. the width-64, 4-head preprocess tower (hd 16).
//
// Bound: bytes at the towers' short sequences: q, k, v read once and o
// written once, 4 * BH * L * hd elements, against 4 * BH * L^2 * hd flops.
//
// The Pallas wrapper pads hd to the TPU's 128 lanes and L to 8 sublanes;
// here hd stays as it is (a template constant: 16, 32, 64 or 128) and L
// needs no padding, because the block walks exactly `len` keys. The body is
// attention_core.cuh: one block per (slice, tile of queries), K and V staged
// in shared memory, online softmax in f32, two threads per query at hd 128.

#include "attention_core.cuh"

namespace {

using gridmm_attn::kThreads;

template <typename T, int kHd>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int len,
                 float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const size_t base = (size_t)blockIdx.x * len * kHd;
  gridmm_attn::attend<T, kHd>(q + base, k + base, v + base, o + base, len,
                              kHd, kHd, scale, smem_raw);
}

template <typename T, int kHd>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int len, float scale, cudaStream_t s) {
  const size_t smem = gridmm_attn::smem_bytes<T, kHd>(len);
  if (smem > (size_t)gridmm_attn::kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<T, kHd>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  constexpr int kQueries = gridmm_attn::Shape<T, kHd>::kQueries;
  const dim3 grid(bh, (len + kQueries - 1) / kQueries);
  attention_kernel<T, kHd><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), len, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v, void* o, int bh,
                int len, int hd, float scale, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, bh, len, scale, s);
    case 32: return launch<T, 32>(q, k, v, o, bh, len, scale, s);
    case 64: return launch<T, 64>(q, k, v, o, bh, len, scale, s);
    case 128: return launch<T, 128>(q, k, v, o, bh, len, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point for ctypes. q, k, v and o are (bh, len, hd),
// contiguous, 16-byte aligned, in one type (dtype 0 = f32, 1 = bf16);
// hd in {16, 32, 64, 128}. Returns the launch's cudaError_t (0 = success).
extern "C" int gridmm_attention_fwd(const void* q, const void* k,
                                    const void* v, int dtype, void* o, int bh,
                                    int len, int hd, float scale,
                                    void* stream) {
  if (bh < 1 || len < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_hd<float>(q, k, v, o, bh, len, hd, scale, s);
  if (dtype == 1) {
    return dispatch_hd<__nv_bfloat16>(q, k, v, o, bh, len, hd, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
