// Fused six-component field gather for Hopper.
//
// Replaces the Pallas TPU kernel fused_gather_pallas
// (_make_fused_gather_kernel) of src/repro/kernels/gather/kernel.py.
//
// For every slot p of cell c, with the six 1-D weight sets of the slot's
// offset d[c][p] on the unified tap window, and each field component k
// (Ex, Ey, Ez, Bx, By, Bz on their Yee staggers):
//   H[a]       = sum_{b,c'} (wy[b] * wz[c']) * G_k[a][b][c']
//   out[c][p][k] = sum_a wx[a] * H[a]
// where G_k is the cell's (T, T, T) neighbourhood of component k.
//
// The TPU kernel reads G from a packed (C, 6, T, T*T) tensor that the
// caller builds in device memory: 6.3 GB at order 3 on a 128^3 grid, for
// 55 MB of field data. This kernel reads the six guard-padded grids
// directly, stacked as (6, nx+2g, ny+2g, nz+2g), and stages each cell's
// six neighbourhoods in shared memory (3 KB at order 3), so the packed
// tensor never exists.
//
// What bounds it on the H100: device memory. Per slot it reads 12 B of
// offsets and writes 24 B of fields; at the main path's occupancy (order 3,
// 8 particles in 32 slots) a cell moves ~1.2 KB for ~16 kflop, ~14 flop/B,
// under the data sheet's fp32 CUDA-core ridge of ~20 flop/B. The
// neighbourhood reads hit L2: adjacent cells share most of their taps and
// the padded grids (55 MB) are about the size of the 50 MB L2.
// Design: one block per cell; the block loads the six neighbourhoods into
// shared memory, then each thread owns one slot, writes its six weight sets
// to its own column of shared memory (in registers, with the loops fully
// unrolled, they spilled at order 3) and its six values to device memory. Summation
// order follows the plain version: H over the (b, c') taps in ascending
// order, then the wx-weighted sum over a.
#include "shape.cuh"

using namespace mpic;

namespace {

// EB_STAGGERS: E_k is staggered on axis k, B_k on the two other axes.
__host__ __device__ constexpr int staggered(int comp, int axis) {
  return comp < 3 ? (comp == axis) : (comp - 3 != axis);
}

template <int ORDER>
__global__ void fused_gather_kernel(const float* __restrict__ d, const float* __restrict__ padded,
                                    float* __restrict__ out, int nx, int ny, int nz, int cap, int guard) {
  constexpr int T = Window<ORDER>::T, BASE = Window<ORDER>::BASE, T3 = T * T * T;
  __shared__ float G[6 * T3];
  const size_t cell = blockIdx.x;
  const int iz = static_cast<int>(cell % nz);
  const int iy = static_cast<int>((cell / nz) % ny);
  const int ix = static_cast<int>(cell / (static_cast<size_t>(ny) * nz));
  const size_t X = nx + 2 * guard, Y = ny + 2 * guard, Z = nz + 2 * guard;
  const int o = guard + BASE;
  for (int i = threadIdx.x; i < 6 * T3; i += blockDim.x) {
    const int comp = i / T3, r = i % T3;
    const int a = r / (T * T), b = (r / T) % T, c = r % T;
    G[i] = padded[((comp * X + (o + a + ix)) * Y + (o + b + iy)) * Z + (o + c + iz)];
  }
  __syncthreads();
  // each thread's six weight sets, W[set * T + j][thread] (set = 2 * axis +
  // staggered): in shared memory, not registers, so the loops below index
  // them freely without spilling
  extern __shared__ float W[];
  const int nt = blockDim.x, tid = threadIdx.x;
  for (int p = tid; p < cap; p += nt) {
    const float* dp = d + (cell * cap + p) * 3;
#pragma unroll
    for (int set = 0; set < 6; ++set) {
      float w[T];
      weights<ORDER>(dp[set >> 1], set & 1, w);
#pragma unroll
      for (int j = 0; j < T; ++j) W[(set * T + j) * nt + tid] = w[j];
    }
    float* op = out + (cell * cap + p) * 6;
#pragma unroll
    for (int comp = 0; comp < 6; ++comp) {
      const float* wx = W + (0 + staggered(comp, 0)) * T * nt + tid;
      float wy[T], wz[T];
#pragma unroll
      for (int j = 0; j < T; ++j) {
        wy[j] = W[((2 + staggered(comp, 1)) * T + j) * nt + tid];
        wz[j] = W[((4 + staggered(comp, 2)) * T + j) * nt + tid];
      }
      const float* g = G + comp * T3;
      float e = 0.0f;
#pragma unroll 1
      for (int a = 0; a < T; ++a) {
        float h = 0.0f;
#pragma unroll
        for (int b = 0; b < T; ++b) {
#pragma unroll
          for (int c = 0; c < T; ++c) h = fmaf(wy[b] * wz[c], g[(a * T + b) * T + c], h);
        }
        e = fmaf(wx[a * nt], h, e);
      }
      op[comp] = e;
    }
  }
}

template <int ORDER>
int launch(const float* d, const float* padded, float* out, int nx, int ny, int nz, int cap, int guard,
           cudaStream_t s) {
  constexpr int T = Window<ORDER>::T;
  const int n_cells = nx * ny * nz;
  const int threads = block_threads(cap, 256);
  const size_t smem = static_cast<size_t>(6 * T) * threads * sizeof(float);
  fused_gather_kernel<ORDER><<<n_cells, threads, smem, s>>>(d, padded, out, nx, ny, nz, cap, guard);
  return cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int mpic_fused_gather(const float* d, const float* padded, float* out, int nx, int ny, int nz,
                                 int cap, int order, int guard, int device, cudaStream_t stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  switch (order) {
    case 1: return launch<1>(d, padded, out, nx, ny, nz, cap, guard, stream);
    case 2: return launch<2>(d, padded, out, nx, ny, nz, cap, guard, stream);
    case 3: return launch<3>(d, padded, out, nx, ny, nz, cap, guard, stream);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* mpic_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
