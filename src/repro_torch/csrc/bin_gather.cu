// Per-cell field gather of the unfused (six-call) gather, for Hopper.
//
// Replaces the Pallas TPU kernel bin_gather_pallas (_gather_kernel) of
// src/repro/kernels/gather/kernel.py:
//   e[c][p] = sum_m wx[c][p][m] * (sum_n byz[c][p][n] * g[c][m][n])
// wx (C, cap, M), byz (C, cap, N), g (C, M, N) and e (C, cap), float32.
//
// What bounds it on the H100: device memory. Per cell it reads
// cap * (M + N) + M * N floats and writes cap for 2 * cap * M * (N + 1)
// flops: at the main path's shapes (order 3, cap 32, M 4-5, N 16-25)
// about 2.6 flop/B, under the fp32 CUDA-core ridge of ~20 flop/B. Its
// first version reached half the bandwidth: each block loaded its cells
// with scalar loads (a division and a remainder per element, to pad the
// rows), waited, computed and exited, so no copy overlapped compute and
// too few bytes were in flight to cover the memory's latency. The design:
//   - a persistent grid (`bin_gather_geometry` in kernels/gather/ops.py:
//     as many blocks as fit on the SMs, two at order 3) walks groups of
//     `group` consecutive cells, block b taking groups b, b + grid, ...;
//   - a group's operands are three contiguous runs (its wx rows, its byz
//     rows, its g tiles), 16-byte aligned and a multiple of 16 bytes long
//     whenever the group's first cell and cell count are multiples of 4
//     (the group is, so every group but a ragged last one). One thread
//     copies them with three TMA bulk copies (cp.async.bulk) that complete
//     on the stage's mbarrier, into a ring of `stages` stages (up to ~115
//     KB a block): while the block computes one group, the next ones are
//     in flight, and the copies cost no thread an instruction per element;
//   - a group that is not so aligned (the ragged last group, a capacity
//     the group size leaves unaligned, operands not 16-byte aligned) is
//     copied by the block's threads in 4-byte loads, in the same kernel;
//   - a thread takes one slot: it reads its byz row into registers once
//     (the rows are unpadded; lane l starts its walk over n at
//     l / (32 / gcd(N, 32)), so a warp's 32 rows fall on 32 banks, and the
//     g reads of lanes of one cell then fall on distinct words of one row),
//     then sums H over n and the wx-weighted sum over m. N is a template
//     parameter for the (M <= 5, N) pairs of orders 1-3, a run-time value
//     otherwise.
// The summation order over n differs from the plain version's; the result
// agrees within float32 rounding.
#include <cuda_runtime.h>

#include <cstdint>

#include "tma_bulk.cuh"

namespace {

using mpic::bulk_copy;
using mpic::mbar_expect;
using mpic::mbar_init;
using mpic::mbar_wait;

constexpr int kMaxThreads = 512;
constexpr int kRingHeader = 128;  // bytes before the ring: one mbarrier a stage
constexpr int kMaxM = 5;          // most M of the templated sums

__host__ __device__ constexpr int round4(long long k) { return static_cast<int>((k + 3) / 4 * 4); }

// The ring's layout: a stage holds the group's wx rows, byz rows and g
// tiles, each padded to a multiple of 4 floats. kernels/gather/ops.py
// mirrors it (bin_gather_stage_floats).
struct Ring {
  int cap, m, n, group, stages;
  __host__ __device__ int wx_floats() const { return round4(static_cast<long long>(group) * cap * m); }
  __host__ __device__ int bz_floats() const { return round4(static_cast<long long>(group) * cap * n); }
  __host__ __device__ int g_floats() const { return round4(static_cast<long long>(group) * m * n); }
  __host__ __device__ int stage_floats() const { return wx_floats() + bz_floats() + g_floats(); }
  __host__ __device__ size_t smem() const {
    return kRingHeader + static_cast<size_t>(stages) * stage_floats() * sizeof(float);
  }
};

__host__ __device__ constexpr int low_bits(int n) {  // log2 gcd(n, 32)
  return (n & 1) ? 0 : (n & 2) ? 1 : (n & 4) ? 2 : (n & 8) ? 3 : (n & 16) ? 4 : 5;
}

// where this lane starts its walk over n: rows of stride N fall on
// gcd(N, 32) banks apart, so lanes a period of 32 / gcd apart start one
// column further on
__device__ __forceinline__ int lane_shift(int n) { return (threadIdx.x & 31) >> (5 - low_bits(n)); }

// one slot's sum from its byz row bz, its cell's g tile gc and its wx row w
template <int N>
__device__ __forceinline__ float slot_sum(const float* bz, const float* gc, const float* w, int m, int n) {
  if constexpr (N > 0) {
    const int r = lane_shift(N);
    float bv[N];
    int col[N];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int j = k + r;
      col[k] = j >= N ? j - N : j;
      bv[k] = bz[col[k]];
    }
    float e = 0.0f;
#pragma unroll
    for (int a = 0; a < kMaxM; ++a) {
      if (a < m) {
        const float* ga = gc + a * N;
        float h = 0.0f;
#pragma unroll
        for (int k = 0; k < N; ++k) h = fmaf(bv[k], ga[col[k]], h);
        e = fmaf(w[a], h, e);
      }
    }
    return e;
  } else {
    const int r = lane_shift(n);
    float e = 0.0f;
    for (int a = 0; a < m; ++a) {
      const float* ga = gc + a * n;
      float h = 0.0f;
      for (int k = 0, j = r; k < n; ++k, j = (j + 1 == n) ? 0 : j + 1) h = fmaf(bz[j], ga[j], h);
      e = fmaf(w[a], h, e);
    }
    return e;
  }
}

template <int N>
__global__ void __launch_bounds__(kMaxThreads)
bin_gather_kernel(const float* __restrict__ wx, const float* __restrict__ byz, const float* __restrict__ g,
                  float* __restrict__ out, int n_cells, Ring ring) {
  extern __shared__ __align__(128) unsigned char ring_smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(ring_smem);
  float* stage0 = reinterpret_cast<float*>(ring_smem + kRingHeader);
  const int cap = ring.cap, m = ring.m, n = ring.n, group = ring.group, stages = ring.stages;
  const int wx_f = ring.wx_floats(), bz_f = ring.bz_floats(), stage_f = ring.stage_floats();
  const int n_groups = (n_cells + group - 1) / group;
  const bool aligned = ((reinterpret_cast<size_t>(wx) | reinterpret_cast<size_t>(byz) |
                         reinterpret_cast<size_t>(g)) & 15) == 0;

  // whether group gi's three runs start and end on 16-byte boundaries
  auto bulk = [&](int gi) {
    const long long c0 = static_cast<long long>(gi) * group, nc = min(static_cast<long long>(group), n_cells - c0);
    return aligned && ((c0 * cap * m) & 3) == 0 && ((nc * cap * m) & 3) == 0 && ((c0 * cap * n) & 3) == 0 &&
           ((nc * cap * n) & 3) == 0 && ((c0 * m * n) & 3) == 0 && ((nc * m * n) & 3) == 0;
  };
  auto issue = [&](int gi, int st) {
    const long long c0 = static_cast<long long>(gi) * group, nc = min(static_cast<long long>(group), n_cells - c0);
    float* ws = stage0 + static_cast<size_t>(st) * stage_f;
    const unsigned bw = 4 * nc * cap * m, bb = 4 * nc * cap * n, bg = 4 * nc * m * n;
    mbar_expect(full + st, bw + bb + bg);
    bulk_copy(ws, wx + c0 * cap * m, bw, full + st);
    bulk_copy(ws + wx_f, byz + c0 * cap * n, bb, full + st);
    bulk_copy(ws + wx_f + bz_f, g + c0 * m * n, bg, full + st);
  };

  if (threadIdx.x == 0) {
    for (int st = 0; st < stages; ++st) mbar_init(full + st);
    mpic::mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int st = 0; st < stages; ++st) {
      const long long gi = blockIdx.x + static_cast<long long>(st) * gridDim.x;
      if (gi < n_groups && bulk(static_cast<int>(gi))) issue(static_cast<int>(gi), st);
    }
  }

  unsigned phases = 0;  // bit st: parity of stage st's next phase
  int st = 0;
  for (int gi = blockIdx.x; gi < n_groups; gi += gridDim.x) {
    float* ws = stage0 + static_cast<size_t>(st) * stage_f;
    float* bs = ws + wx_f;
    float* gs = bs + bz_f;
    const long long c0 = static_cast<long long>(gi) * group;
    const int nc = static_cast<int>(min(static_cast<long long>(group), n_cells - c0));
    if (bulk(gi)) {
      mbar_wait(full + st, (phases >> st) & 1u);
      phases ^= 1u << st;
    } else {
      for (int i = threadIdx.x; i < nc * cap * m; i += blockDim.x) ws[i] = wx[c0 * cap * m + i];
      for (int i = threadIdx.x; i < nc * cap * n; i += blockDim.x) bs[i] = byz[c0 * cap * n + i];
      for (int i = threadIdx.x; i < nc * m * n; i += blockDim.x) gs[i] = g[c0 * m * n + i];
      // order these writes before any later bulk copy into the stage
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
    }
    for (int s = threadIdx.x; s < nc * cap; s += blockDim.x) {
      const int lc = s / cap;
      out[c0 * cap + s] = slot_sum<N>(bs + static_cast<size_t>(s) * n, gs + static_cast<size_t>(lc) * m * n,
                                      ws + static_cast<size_t>(s) * m, m, n);
    }
    __syncthreads();  // every thread is done with the stage
    if (threadIdx.x == 0) {
      const long long next = gi + static_cast<long long>(stages) * gridDim.x;
      if (next < n_groups && bulk(static_cast<int>(next))) issue(static_cast<int>(next), st);
    }
    st = st + 1 == stages ? 0 : st + 1;
  }
}

template <int N>
cudaError_t launch(const float* wx, const float* byz, const float* g, float* out, int n_cells, const Ring& ring,
                   int threads, int blocks, cudaStream_t stream) {
  const size_t smem = ring.smem();
  cudaError_t e = cudaFuncSetAttribute(bin_gather_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  bin_gather_kernel<N><<<blocks, threads, smem, stream>>>(wx, byz, g, out, n_cells, ring);
  return cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched). The geometry
// (`bin_gather_geometry`): `blocks` persistent blocks of `threads` threads
// walk groups of `group` cells through a ring of `stages` stages of `smem`
// bytes in all; the kernel refuses any other layout.
extern "C" int mpic_bin_gather(const float* wx, const float* byz, const float* g, float* out, int n_cells,
                               int cap, int m, int n, int group, int stages, int threads, size_t smem, int blocks,
                               int device, cudaStream_t stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const Ring ring{cap, m, n, group, stages};
  if (group < 1 || stages < 1 || stages > kRingHeader / 8 || threads % 32 != 0 || threads < 32 ||
      threads > kMaxThreads || blocks < 1 || smem != ring.smem())
    return cudaErrorInvalidValue;
  if (m <= kMaxM) {
    switch (n) {
      case 4: return launch<4>(wx, byz, g, out, n_cells, ring, threads, blocks, stream);
      case 6: return launch<6>(wx, byz, g, out, n_cells, ring, threads, blocks, stream);
      case 9: return launch<9>(wx, byz, g, out, n_cells, ring, threads, blocks, stream);
      case 12: return launch<12>(wx, byz, g, out, n_cells, ring, threads, blocks, stream);
      case 16: return launch<16>(wx, byz, g, out, n_cells, ring, threads, blocks, stream);
      case 20: return launch<20>(wx, byz, g, out, n_cells, ring, threads, blocks, stream);
      case 25: return launch<25>(wx, byz, g, out, n_cells, ring, threads, blocks, stream);
      default: break;
    }
  }
  return launch<0>(wx, byz, g, out, n_cells, ring, threads, blocks, stream);
}
