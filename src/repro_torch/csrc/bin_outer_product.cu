// Per-cell outer-product contraction of the unfused deposition, for Hopper.
//
// Replaces the Pallas TPU kernel bin_outer_product_pallas (_mxu_kernel /
// _vpu_kernel) of src/repro/kernels/deposition/kernel.py:
//   out[c][m][n] = sum_p a[c][p][m] * b[c][p][n]
// a (C, cap, M) and b (C, cap, N) in float32 or bfloat16, out (C, M, N)
// float32, accumulated in float32. The TPU kernel's `mode` picks its matrix
// unit (MXU dot) or its vector unit (broadcast sum); this kernel has one
// route, so the mode has no counterpart.
//
// What bounds it on the H100: device memory. Per cell it reads
// cap * (M + N) inputs and writes M * N floats for 2 * cap * M * N flops:
// at the main path's shapes (order 3, cap 32, M 4-5, N 16-20) about 2.7
// flop/B, far under the fp32 CUDA-core ridge of ~20 flop/B.
// Design: a block takes as many whole cells as their M x N tiles fill in
// 256 threads (2 cells at M x N = 125, 32 at 8), fewer where the cells'
// operands would not fit in shared memory (the wrapper chooses); it stages
// the cells' contiguous a and b rows in shared memory (coalesced loads,
// bfloat16 widened to float there), then each thread owns one output
// element and sums over the slots in ascending order in a register, so the
// output is written once, coalesced.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr size_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename In>
__global__ void bin_outer_product_kernel(const In* __restrict__ a, const In* __restrict__ b,
                                         float* __restrict__ out, int n_cells, int cap, int m, int n,
                                         int cells_per_block) {
  extern __shared__ float smem[];
  const int mn = m * n;
  const long long c0 = static_cast<long long>(blockIdx.x) * cells_per_block;
  const int cells = static_cast<int>(min(static_cast<long long>(cells_per_block), n_cells - c0));
  float* as = smem;                                     // (cells, cap, m)
  float* bs = smem + static_cast<size_t>(cells_per_block) * cap * m;  // (cells, cap, n)
  const In* ag = a + c0 * cap * m;
  const In* bg = b + c0 * cap * n;
  for (int i = threadIdx.x; i < cells * cap * m; i += blockDim.x) as[i] = widen(ag[i]);
  for (int i = threadIdx.x; i < cells * cap * n; i += blockDim.x) bs[i] = widen(bg[i]);
  __syncthreads();
  const int lc = threadIdx.x / mn, e = threadIdx.x % mn;
  if (lc >= cells) return;
  const int row = e / n, col = e % n;
  const float* ac = as + static_cast<size_t>(lc) * cap * m + row;
  const float* bc = bs + static_cast<size_t>(lc) * cap * n + col;
  float acc = 0.0f;
  for (int p = 0; p < cap; ++p) acc = fmaf(ac[p * m], bc[p * n], acc);
  out[(c0 + lc) * mn + e] = acc;
}

template <typename In>
int launch(const void* a, const void* b, float* out, int n_cells, int cap, int m, int n, int cells_per_block,
           cudaStream_t s) {
  const int mn = m * n;
  const int threads = ((cells_per_block * mn + 31) / 32) * 32;
  const size_t smem = static_cast<size_t>(cells_per_block) * cap * (m + n) * sizeof(float);
  if (smem > kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(bin_outer_product_kernel<In>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int blocks = (n_cells + cells_per_block - 1) / cells_per_block;
  bin_outer_product_kernel<In><<<blocks, threads, smem, s>>>(
      static_cast<const In*>(a), static_cast<const In*>(b), out, n_cells, cap, m, n, cells_per_block);
  return cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched). A block
// takes cells_per_block cells, cells_per_block * m * n <= 1024 threads.
// bf16 != 0: a and b are bfloat16, else float32.
extern "C" int mpic_bin_outer_product(const void* a, const void* b, float* out, int n_cells, int cap, int m,
                                      int n, int cells_per_block, int bf16, int device, cudaStream_t stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (m < 1 || n < 1 || cells_per_block < 1 || cells_per_block * m * n > 1024) return cudaErrorInvalidValue;
  return bf16 ? launch<__nv_bfloat16>(a, b, out, n_cells, cap, m, n, cells_per_block, stream)
              : launch<float>(a, b, out, n_cells, cap, m, n, cells_per_block, stream);
}
