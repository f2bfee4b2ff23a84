// Per-cell field gather of the unfused (six-call) gather, for Hopper.
//
// Replaces the Pallas TPU kernel bin_gather_pallas (_gather_kernel) of
// src/repro/kernels/gather/kernel.py:
//   e[c][p] = sum_m wx[c][p][m] * (sum_n byz[c][p][n] * g[c][m][n])
// wx (C, cap, M), byz (C, cap, N), g (C, M, N) and e (C, cap), float32.
//
// What bounds it on the H100: device memory. Per cell it reads
// cap * (M + N) + M * N floats and writes cap for 2 * cap * M * (N + 1)
// flops: at the main path's shapes (order 3, cap 32, M 4-5, N 16-20)
// about 2.6 flop/B, under the fp32 CUDA-core ridge of ~20 flop/B.
// Design: a block takes as many cells as one warp-rounded slot row each
// fills in 256 threads (8 cells at cap 32; the wrapper chooses), so an SM
// keeps 64 warps in flight where one 32-thread block per cell allowed 32.
// The block stages its cells' neighbourhoods g_c (M x N) and their slots'
// wx and byz rows in shared memory with coalesced loads (rows padded to an
// odd stride, so a warp's threads, one slot each, read distinct banks),
// then each thread owns one slot: H over n in ascending order, then the
// wx-weighted sum over m, as the plain version sums.
#include <cuda_runtime.h>

namespace {

constexpr size_t kDefaultSmem = 48 * 1024;

// the smallest odd stride >= k
__host__ __device__ __forceinline__ int odd(int k) { return k | 1; }

__global__ void bin_gather_kernel(const float* __restrict__ wx, const float* __restrict__ byz,
                                  const float* __restrict__ g, float* __restrict__ out, int n_cells, int cap,
                                  int m, int n, int cells_per_block, int row_threads) {
  extern __shared__ float smem[];
  const int ms = odd(m), ns = odd(n);
  const long long c0 = static_cast<long long>(blockIdx.x) * cells_per_block;
  const int cells = static_cast<int>(min(static_cast<long long>(cells_per_block), n_cells - c0));
  float* gs = smem;                                                     // (cells, m, n)
  float* ws = gs + static_cast<size_t>(cells_per_block) * m * n;        // (cells * cap, ms)
  float* bs = ws + static_cast<size_t>(cells_per_block) * cap * ms;     // (cells * cap, ns)
  const float* gc = g + c0 * m * n;
  const float* wc = wx + c0 * cap * m;
  const float* bc = byz + c0 * cap * n;
  for (int i = threadIdx.x; i < cells * m * n; i += blockDim.x) gs[i] = gc[i];
  for (int i = threadIdx.x; i < cells * cap * m; i += blockDim.x) ws[(i / m) * ms + i % m] = wc[i];
  for (int i = threadIdx.x; i < cells * cap * n; i += blockDim.x) bs[(i / n) * ns + i % n] = bc[i];
  __syncthreads();
  const int lc = threadIdx.x / row_threads;
  if (lc >= cells) return;
  const float* ga0 = gs + static_cast<size_t>(lc) * m * n;
  for (int p = threadIdx.x % row_threads; p < cap; p += row_threads) {
    const size_t row = static_cast<size_t>(lc) * cap + p;
    const float* bp = bs + row * ns;
    const float* wp = ws + row * ms;
    float e = 0.0f;
    for (int a = 0; a < m; ++a) {
      const float* ga = ga0 + a * n;
      float h = 0.0f;
      for (int k = 0; k < n; ++k) h = fmaf(bp[k], ga[k], h);
      e = fmaf(wp[a], h, e);
    }
    out[(c0 + lc) * cap + p] = e;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched). A block takes
// cells_per_block cells with row_threads threads each (a multiple of 32),
// cells_per_block * row_threads <= 1024.
extern "C" int mpic_bin_gather(const float* wx, const float* byz, const float* g, float* out, int n_cells,
                               int cap, int m, int n, int cells_per_block, int row_threads, int device,
                               cudaStream_t stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (cells_per_block < 1 || row_threads < 32 || cells_per_block * row_threads > 1024) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(cells_per_block)
                      * (static_cast<size_t>(m) * n + static_cast<size_t>(cap) * (odd(m) + odd(n))) * sizeof(float);
  if (smem > kDefaultSmem) {
    e = cudaFuncSetAttribute(bin_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int blocks = (n_cells + cells_per_block - 1) / cells_per_block;
  bin_gather_kernel<<<blocks, cells_per_block * row_threads, smem, stream>>>(wx, byz, g, out, n_cells, cap, m, n,
                                                                              cells_per_block, row_threads);
  return cudaGetLastError();
}
