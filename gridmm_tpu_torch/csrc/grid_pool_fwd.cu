// Grid-pool forward for Hopper (sm_90a): per-cell segment-softmax sums.
//
// Replaces the TPU kernel `_pool_kernel` in
// gridmm_tpu/ops/pallas/grid_pool_kernel.py:30 (wrapper pallas_grid_pool_raw
// :92). For every batch row b and point i with cell c_i in [0, num_cells):
//     e_i         = exp(w_i - cmax[b, c_i])
//     numer[b, c] = sum_{i in c} e_i * g[b, i, :]      (B, num_cells, D) f32
//     denom[b, c] = sum_{i in c} e_i                   (B, 256) f32
// Points with any other id (-1 = invalid) vanish. The per-cell max `cmax`
// comes in precomputed and the final numer/denom divide happens outside,
// exactly as around the Pallas body (_prep_inputs :65-87, :135-141).
//
// Bound: bytes. Each point's D features are read once and multiplied once;
// at B=8, N=8832, D=768 the f32 feature read is ~217 MB (~65 us at
// 3.35 TB/s), ~109 MB in bf16, against ~0.1 GFLOP of work. The Pallas body
// builds a (256 x chunk) one-hot and runs a matrix product to reach the TPU's
// matrix unit, 256x the useful FLOPs; here the op stays a segmented
// reduction:
//   * one block per (D tile of 128 columns, batch row, N slice); the slices
//     give the card enough blocks at small B;
//   * each thread owns one column of the tile, so a warp reads one point's
//     128 columns as consecutive addresses (coalesced) and its shared-memory
//     adds land in 32 distinct banks;
//   * the (num_cells x 128) f32 accumulator lives in dynamic shared memory
//     (100 KB for 196 cells, so two blocks fit on one SM);
//   * e_i and the cell id are computed once per 256-point chunk into shared
//     memory; invalid points are skipped and their features never read;
//   * each thread keeps UNROLL independent feature loads in flight before
//     its shared-memory adds, to cover device-memory latency;
//   * the four thread rows of a block add into the same accumulator with
//     shared-memory atomics, and the slices combine with global f32 atomics.
//     The order of those adds varies from run to run: results agree with a
//     sequential f32 sum to a few ulp (the wrapper's tests use 1e-5 relative).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTileD = 128;    // feature columns per block, one per thread
constexpr int kRows = 4;       // thread rows: kTileD * kRows threads
constexpr int kChunk = 256;    // points staged in shared memory at a time
constexpr int kUnroll = 8;     // feature loads in flight per thread
constexpr int kCellPad = 256;  // denominator row length (and max num_cells)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(kTileD * kRows)
grid_pool_fwd_kernel(const T* __restrict__ g, const int* __restrict__ cells,
                     const float* __restrict__ w,
                     const float* __restrict__ cmax,
                     float* __restrict__ numer, float* __restrict__ denom,
                     int n, int d, int num_cells, int slice_len) {
  extern __shared__ float smem[];
  float* acc = smem;                            // num_cells * kTileD
  float* s_den = acc + num_cells * kTileD;      // kCellPad
  float* s_cmax = s_den + kCellPad;             // kCellPad
  float* s_e = s_cmax + kCellPad;               // kChunk
  int* s_c = reinterpret_cast<int*>(s_e + kChunk);  // kChunk

  const int d0 = blockIdx.x * kTileD;
  const int b = blockIdx.y;
  const int n_begin = blockIdx.z * slice_len;
  const int n_end = min(n, n_begin + slice_len);
  const int tid = threadIdx.x;
  const int col = tid % kTileD;
  const int row = tid / kTileD;
  const bool col_ok = d0 + col < d;

  for (int i = tid; i < num_cells * kTileD; i += blockDim.x) acc[i] = 0.f;
  for (int i = tid; i < kCellPad; i += blockDim.x) {
    s_den[i] = 0.f;
    s_cmax[i] = i < num_cells ? cmax[(size_t)b * num_cells + i] : 0.f;
  }
  __syncthreads();

  const size_t row_base = (size_t)b * n;
  const T* gcol = g + row_base * d + d0 + col;
  for (int base = n_begin; base < n_end; base += kChunk) {
    const int count = min(kChunk, n_end - base);
    for (int i = tid; i < kChunk; i += blockDim.x) {
      int c = -1;
      float e = 0.f;
      if (i < count) {
        const int ci = cells[row_base + base + i];
        if (ci >= 0 && ci < num_cells) {
          c = ci;
          e = expf(w[row_base + base + i] - s_cmax[ci]);
          atomicAdd(&s_den[ci], e);
        }
      }
      s_c[i] = c;
      s_e[i] = e;
    }
    __syncthreads();

    if (col_ok) {
      for (int k0 = 0; k0 < kChunk / kRows; k0 += kUnroll) {
        int cc[kUnroll];
        float v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int p = row + kRows * (k0 + u);
          cc[u] = s_c[p];
          v[u] = cc[u] >= 0
                     ? to_f32(gcol[(size_t)(base + p) * d]) * s_e[p]
                     : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (cc[u] >= 0) atomicAdd(&acc[cc[u] * kTileD + col], v[u]);
        }
      }
    }
    __syncthreads();
  }

  // flush this slice's partial sums; cells the slice never touched add 0
  for (int i = tid; i < num_cells * kTileD; i += blockDim.x) {
    const int c = i / kTileD;
    const int cl = i % kTileD;
    if (s_den[c] != 0.f && d0 + cl < d) {
      atomicAdd(&numer[((size_t)b * num_cells + c) * d + d0 + cl], acc[i]);
    }
  }
  if (blockIdx.x == 0) {
    for (int c = tid; c < num_cells; c += blockDim.x) {
      if (s_den[c] != 0.f) atomicAdd(&denom[(size_t)b * kCellPad + c], s_den[c]);
    }
  }
}

template <typename T>
int launch(const void* g, const int* cells, const float* w, const float* cmax,
           float* numer, float* denom, int b, int n, int d, int num_cells,
           int n_slices, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)num_cells * kTileD +
                                       2 * kCellPad + kChunk) +
                      sizeof(int) * kChunk;
  cudaError_t err = cudaFuncSetAttribute(
      grid_pool_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int slice_len = ((n + n_slices - 1) / n_slices + kChunk - 1) /
                        kChunk * kChunk;
  const int slices = (n + slice_len - 1) / slice_len;
  const dim3 grid((d + kTileD - 1) / kTileD, b, slices);
  grid_pool_fwd_kernel<T><<<grid, kTileD * kRows, smem, stream>>>(
      static_cast<const T*>(g), cells, w, cmax, numer, denom, n, d, num_cells,
      slice_len);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. numer (b, num_cells, d) and denom
// (b, 256) must be zero-filled by the caller. feature_dtype: 0 = f32,
// 1 = bf16. Returns the launch's cudaError_t (0 = success).
extern "C" int gridmm_grid_pool_fwd(const void* g, int feature_dtype,
                                    const int* cells, const float* w,
                                    const float* cmax, float* numer,
                                    float* denom, int b, int n, int d,
                                    int num_cells, int n_slices,
                                    void* stream) {
  if (num_cells < 1 || num_cells > kCellPad || n_slices < 1 || b < 1 ||
      n < 1 || d < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (feature_dtype == 1) {
    return launch<__nv_bfloat16>(g, cells, w, cmax, numer, denom, b, n, d,
                                 num_cells, n_slices, s);
  }
  if (feature_dtype == 0) {
    return launch<float>(g, cells, w, cmax, numer, denom, b, n, d, num_cells,
                         n_slices, s);
  }
  return (int)cudaErrorInvalidValue;
}
