// Fused three-component current deposition (paper Alg. 2) for Hopper.
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/deposition/kernel.py:
//   fused_deposit_kernel          <- fused_deposition_pallas (_make_fused_kernel)
//   fused_deposit_reduced_kernel  <- fused_deposition_reduced_pallas
//                                    (_make_fused_reduced_kernel)
//
// Both read the step's bin slab, d and val (C, cap, 3) float32: fractional
// in-cell offsets and q*w*v per component, val exactly 0 on gap slots. Per
// cell they evaluate the six 1-D weight sets (axis x staggered) on the
// unified tap window and form, for each component k (staggered on axis k),
//   rho_k[a][b][c] = sum_p (wx[p][a] * val[p][k]) * (wy[p][b] * wz[p][c]).
//
// What bounds them on the H100: device memory. At the main path's occupancy
// (order 3, 8 particles in 32 slots) a cell reads 768 B of slab and does
// about 9 kflop (3*T^3 = 375 multiply-adds per particle plus the weights),
// ~12 flop/B, under the fp32 CUDA-core ridge of 67 TFLOP/s / 3.35 TB/s
// = 20 flop/B of the data sheet; the packed kernel also writes 3*T^3 floats
// per cell (1.5 KB), more than it reads. The design answers with staging:
//   - one block per cell (packed) or per (x, y) column (reduced); the
//     cell's slots and its six weight sets are staged in shared memory
//     once, and each thread owns output elements, summing over the slots
//     in ascending order in a register;
//   - the reduced kernel walks its column's nz cells and adds every cell's
//     tile into a shared (3, nz+2g, T, T) accumulator: the rhocell z pass
//     happens on chip, each output float is written once (0.65 GB instead
//     of the packed 3.1 GB at order 3, 128^3), and one block owning the
//     column keeps the sums free of atomics and deterministic. Cells are
//     walked from the top of the column down, so each accumulator element
//     receives its taps in ascending tap order, as the plain version adds
//     them.
// wgmma, TMA and warp specialisation are left for later work.
#include "shape.cuh"

using namespace mpic;

namespace {

// Stage one cell: v[p][k] = val, w[set][p][j] the six weight sets
// (set = 2 * axis + staggered).
template <int ORDER>
__device__ __forceinline__ void stage_cell(const float* __restrict__ dc, const float* __restrict__ vc,
                                           int cap, float* w, float* v) {
  constexpr int T = Window<ORDER>::T;
  for (int i = threadIdx.x; i < 3 * cap; i += blockDim.x) v[i] = vc[i];
  for (int i = threadIdx.x; i < 6 * cap; i += blockDim.x) {
    const int set = i / cap, p = i % cap;
    weights<ORDER>(dc[3 * p + (set >> 1)], set & 1, w + (set * cap + p) * T);
  }
}

// One element of component comp's tile, summed over the slots in order.
template <int ORDER>
__device__ __forceinline__ float tile_element(const float* w, const float* v, int cap,
                                              int comp, int a, int b, int c) {
  constexpr int T = Window<ORDER>::T;
  const float* wx = w + (0 + (comp == 0)) * cap * T;
  const float* wy = w + (2 + (comp == 1)) * cap * T;
  const float* wz = w + (4 + (comp == 2)) * cap * T;
  float acc = 0.0f;
  for (int p = 0; p < cap; ++p) {
    const float av = wx[p * T + a] * v[3 * p + comp];
    const float byz = wy[p * T + b] * wz[p * T + c];
    acc = fmaf(av, byz, acc);
  }
  return acc;
}

// out: (C, 3, T, T*T) packed rhocell tiles; one block per cell.
template <int ORDER>
__global__ void fused_deposit_kernel(const float* __restrict__ d, const float* __restrict__ val,
                                     float* __restrict__ out, int cap) {
  constexpr int T = Window<ORDER>::T, T3 = T * T * T, NOUT = 3 * T3;
  extern __shared__ float smem[];
  float* w = smem;               // 6 * cap * T
  float* v = w + 6 * cap * T;    // 3 * cap
  const size_t cell = blockIdx.x;
  stage_cell<ORDER>(d + cell * cap * 3, val + cell * cap * 3, cap, w, v);
  __syncthreads();
  float* oc = out + cell * NOUT;
  for (int o = threadIdx.x; o < NOUT; o += blockDim.x) {
    const int comp = o / T3, r = o % T3;
    oc[o] = tile_element<ORDER>(w, v, cap, comp, r / (T * T), (r / T) % T, r % T);
  }
}

// out: (nx*ny, 3, nz+2g, T, T) z-reduced column accumulators; one block per
// (x, y) column, whose nz cells are consecutive (cells are z-fastest).
template <int ORDER>
__global__ void fused_deposit_reduced_kernel(const float* __restrict__ d, const float* __restrict__ val,
                                             float* __restrict__ out, int nz, int cap, int guard) {
  constexpr int T = Window<ORDER>::T, BASE = Window<ORDER>::BASE, T3 = T * T * T, NOUT = 3 * T3;
  const int zp = nz + 2 * guard;
  const int acc_n = 3 * zp * T * T;
  extern __shared__ float smem[];
  float* acc = smem;             // (3, zp, T, T)
  float* w = acc + acc_n;        // 6 * cap * T
  float* v = w + 6 * cap * T;    // 3 * cap
  for (int i = threadIdx.x; i < acc_n; i += blockDim.x) acc[i] = 0.0f;
  const size_t col = blockIdx.x;
  for (int z = nz - 1; z >= 0; --z) {
    __syncthreads();  // the previous cell's adds are done, its staging is free
    const size_t cell = col * nz + z;
    stage_cell<ORDER>(d + cell * cap * 3, val + cell * cap * 3, cap, w, v);
    __syncthreads();
    // within one cell, (comp, a, b, c) -> (comp, z + c, a, b) is one to one
    for (int o = threadIdx.x; o < NOUT; o += blockDim.x) {
      const int comp = o / T3, r = o % T3;
      const int a = r / (T * T), b = (r / T) % T, c = r % T;
      const float s = tile_element<ORDER>(w, v, cap, comp, a, b, c);
      acc[((comp * zp + guard + BASE + c + z) * T + a) * T + b] += s;
    }
  }
  __syncthreads();
  float* oc = out + col * acc_n;
  for (int i = threadIdx.x; i < acc_n; i += blockDim.x) oc[i] = acc[i];
}

constexpr size_t kDefaultSmem = 48 * 1024;

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
}

template <int ORDER>
int launch_packed(const float* d, const float* val, float* out, int n_cells, int cap, cudaStream_t s) {
  constexpr int T = Window<ORDER>::T;
  const size_t smem = static_cast<size_t>(6 * T + 3) * cap * sizeof(float);
  cudaError_t e = allow_smem(fused_deposit_kernel<ORDER>, smem);
  if (e != cudaSuccess) return e;
  fused_deposit_kernel<ORDER><<<n_cells, block_threads(3 * T * T * T, 512), smem, s>>>(d, val, out, cap);
  return cudaGetLastError();
}

template <int ORDER>
int launch_reduced(const float* d, const float* val, float* out, int n_cols, int nz, int cap,
                   int guard, cudaStream_t s) {
  constexpr int T = Window<ORDER>::T;
  const size_t smem = (static_cast<size_t>(3) * (nz + 2 * guard) * T * T
                       + static_cast<size_t>(6 * T + 3) * cap) * sizeof(float);
  cudaError_t e = allow_smem(fused_deposit_reduced_kernel<ORDER>, smem);
  if (e != cudaSuccess) return e;
  fused_deposit_reduced_kernel<ORDER><<<n_cols, block_threads(3 * T * T * T, 512), smem, s>>>(
      d, val, out, nz, cap, guard);
  return cudaGetLastError();
}

}  // namespace

// Each entry point returns cudaGetLastError() after its launch (0 = launched).
extern "C" int mpic_fused_deposit(const float* d, const float* val, float* out, int n_cells, int cap,
                                  int order, int device, cudaStream_t stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  switch (order) {
    case 1: return launch_packed<1>(d, val, out, n_cells, cap, stream);
    case 2: return launch_packed<2>(d, val, out, n_cells, cap, stream);
    case 3: return launch_packed<3>(d, val, out, n_cells, cap, stream);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int mpic_fused_deposit_reduced(const float* d, const float* val, float* out, int n_cols, int nz,
                                          int cap, int order, int guard, int device, cudaStream_t stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  switch (order) {
    case 1: return launch_reduced<1>(d, val, out, n_cols, nz, cap, guard, stream);
    case 2: return launch_reduced<2>(d, val, out, n_cols, nz, cap, guard, stream);
    case 3: return launch_reduced<3>(d, val, out, n_cols, nz, cap, guard, stream);
    default: return cudaErrorInvalidValue;
  }
}
