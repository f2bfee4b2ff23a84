// Weighted segment accumulation over binned items (stage 2 of the
// generalized Matrix-PIC scatter, core/matrix_scatter.py), for Hopper.
//
// Replaces the Pallas TPU kernel segment_accumulate_pallas
// (_segment_accum_kernel) of src/repro/kernels/scatter_matrix/kernel.py:
//   out[v][d] = sum_c w[v][c] * u[v][c][d]
// w (V, cap) and u (V, cap, D) in float32 or bfloat16; out (V, D) in u's
// type, accumulated in float32 and rounded once at the end.
//
// What bounds it on the H100: device memory. Every element of u is read
// once for one multiply-add: 2 flops per 2 or 4 bytes.
// Design: the grid tiles (bins x features) as the Pallas grid does, one
// bin and up to 1024 features per block; the block stages the bin's cap
// weights in shared memory, then each thread owns features d (neighbouring
// threads on neighbouring d, so every read of a u row is coalesced) and
// sums over the slots in ascending order. Each product and each add rounds
// on its own (no fused multiply-add), as the plain version's tensor ops
// do, so the float32 sums, and therefore the rounded bfloat16 results,
// agree to the bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kColsPerThread = 4;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void narrow(float x, float* out) { *out = x; }
__device__ __forceinline__ void narrow(float x, __nv_bfloat16* out) { *out = __float2bfloat16_rn(x); }

template <typename T>
__global__ void segment_accumulate_kernel(const T* __restrict__ w, const T* __restrict__ u, T* __restrict__ out,
                                          int cap, int dim) {
  extern __shared__ float ws[];
  const size_t v = blockIdx.x;
  for (int c = threadIdx.x; c < cap; c += blockDim.x) ws[c] = widen(w[v * cap + c]);
  __syncthreads();
  const int d0 = blockIdx.y * (blockDim.x * kColsPerThread);
  const T* uv = u + v * cap * dim;
#pragma unroll
  for (int j = 0; j < kColsPerThread; ++j) {
    const int d = d0 + j * blockDim.x + threadIdx.x;
    if (d >= dim) break;
    float acc = 0.0f;
    for (int c = 0; c < cap; ++c) acc = __fadd_rn(acc, __fmul_rn(ws[c], widen(uv[static_cast<size_t>(c) * dim + d])));
    narrow(acc, out + v * dim + d);
  }
}

template <typename T>
int launch(const void* w, const void* u, void* out, int n_bins, int cap, int dim, cudaStream_t s) {
  const int threads = dim >= kThreads ? kThreads : ((dim + 31) / 32) * 32;
  const int tiles = (dim + threads * kColsPerThread - 1) / (threads * kColsPerThread);
  if (tiles > 65535) return cudaErrorInvalidValue;
  const dim3 grid(n_bins, tiles);
  segment_accumulate_kernel<T><<<grid, threads, cap * sizeof(float), s>>>(
      static_cast<const T*>(w), static_cast<const T*>(u), static_cast<T*>(out), cap, dim);
  return cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched). bf16 != 0:
// w, u and out are bfloat16, else float32.
extern "C" int mpic_segment_accumulate(const void* w, const void* u, void* out, int n_bins, int cap, int dim,
                                       int bf16, int device, cudaStream_t stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  return bf16 ? launch<__nv_bfloat16>(w, u, out, n_bins, cap, dim, stream)
              : launch<float>(w, u, out, n_bins, cap, dim, stream);
}
