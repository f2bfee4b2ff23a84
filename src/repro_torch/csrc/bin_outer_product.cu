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
// flop/B, far under the fp32 CUDA-core ridge of ~20 flop/B. Its first
// version reached half the bandwidth: a block loaded its few cells with
// scalar loads, waited, computed one output a thread and exited, so no copy
// overlapped compute and too few bytes were in flight. The design, that of
// the unfused gather (csrc/bin_gather.cu):
//   - a persistent grid (`bin_outer_product_geometry` in
//     kernels/deposition/ops.py: as many blocks as fit on the SMs, two at
//     order 3) walks groups of `group` consecutive cells, block b taking
//     groups b, b + grid, ...;
//   - a group's operands are two contiguous runs, its cells' cap x M a
//     rows and their cap x N b rows, 16-byte aligned and a multiple of 16
//     bytes long whenever one cell's are (cap * M and cap * N a multiple
//     of 4 in float32, of 8 in bfloat16: every capacity the binning
//     chooses, a multiple of 8), a ragged last group included. One thread
//     copies them with two TMA bulk copies (cp.async.bulk) that complete
//     on the stage's mbarrier, into a ring of up to four stages (~115 KB a
//     block): while the block computes one group, the next ones are in
//     flight, and the copies cost no thread an instruction per element;
//   - operands not so aligned (a capacity that leaves a cell's runs off 16
//     bytes, operands off a 16-byte boundary, bfloat16 runs of odd length)
//     are copied by the block's threads one element at a time, in the same
//     kernel, into the same layout;
//   - bfloat16 travels as bfloat16 through the copies and is widened with
//     __bfloat162float where it is read, so a stage holds half the bytes;
//   - a thread owns one column n of one cell and keeps its M sums in
//     registers: per slot it reads b[p][n] once (consecutive n on
//     consecutive banks) and a[p][0..M-1] as a broadcast within the cell,
//     then stores its column straight from registers. M is a template
//     parameter for M in 2..5 (every stagger of orders 1-3), a run-time
//     value otherwise, taken kMaxM sums at a time. The two or three cells
//     that share a warp read the same banks (two- or three-way conflicts):
//     a ring padded to spread them measured 2.6% slower on the H100
//     (PERF.md), the shared loads having room to spare beside the bytes.
// Each output is a chain of fmaf from +0 over ascending p, as in the first
// version, so the two versions, and the two copy routes, agree bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tma_bulk.cuh"

namespace {

using mpic::bulk_copy;
using mpic::mbar_expect;
using mpic::mbar_init;
using mpic::mbar_wait;

constexpr int kMaxThreads = 256;
constexpr int kRingHeader = 128;  // bytes before the ring: one mbarrier a stage
constexpr int kMaxM = 5;          // most M of the templated sums
constexpr long long kSmemLimit = 232448;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

// The ring's layout: a stage holds the group's a rows, then its b rows,
// both unpadded. kernels/deposition/ops.py mirrors it
// (bin_outer_product_geometry).
struct Ring {
  int cap, m, n, esize, group, stages;
  __host__ __device__ long long a_run() const { return static_cast<long long>(cap) * m * esize; }
  __host__ __device__ long long b_run() const { return static_cast<long long>(cap) * n * esize; }
  // whether the stages are filled by bulk copies (given 16-byte aligned
  // operands): a cell's runs are 16-byte multiples and the barriers fit
  __host__ __device__ bool bulk() const {
    return a_run() % 16 == 0 && b_run() % 16 == 0 && kRingHeader + a_run() + b_run() <= kSmemLimit;
  }
  __host__ __device__ long long stage_bytes() const { return group * (a_run() + b_run()); }
  __host__ __device__ int header() const { return bulk() ? kRingHeader : 0; }
  __host__ __device__ size_t smem() const { return header() + static_cast<size_t>(stages) * stage_bytes(); }
};

// one column: oc[k * n] = sum_p ac[p * m + k] * bc[p * n], each a chain of
// fmaf from +0 over ascending p
template <typename In, int M>
__device__ __forceinline__ void column_sums(const In* ac, const In* bc, float* oc, int cap, int m, int n) {
  if constexpr (M > 0) {
    float acc[M];
#pragma unroll
    for (int k = 0; k < M; ++k) acc[k] = 0.0f;
#pragma unroll 4
    for (int p = 0; p < cap; ++p) {
      const float bv = widen(bc[p * n]);
#pragma unroll
      for (int k = 0; k < M; ++k) acc[k] = fmaf(widen(ac[p * M + k]), bv, acc[k]);
    }
#pragma unroll
    for (int k = 0; k < M; ++k) oc[k * n] = acc[k];
  } else {
    for (int m0 = 0; m0 < m; m0 += kMaxM) {
      float acc[kMaxM];
#pragma unroll
      for (int k = 0; k < kMaxM; ++k) acc[k] = 0.0f;
      for (int p = 0; p < cap; ++p) {
        const float bv = widen(bc[p * n]);
#pragma unroll
        for (int k = 0; k < kMaxM; ++k) {
          if (m0 + k < m) acc[k] = fmaf(widen(ac[p * m + m0 + k]), bv, acc[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < kMaxM; ++k) {
        if (m0 + k < m) oc[(m0 + k) * n] = acc[k];
      }
    }
  }
}

template <typename In, int M>
__global__ void __launch_bounds__(kMaxThreads)
bin_outer_product_kernel(const In* __restrict__ a, const In* __restrict__ b, float* __restrict__ out, int n_cells,
                         Ring ring) {
  extern __shared__ __align__(128) unsigned char ring_smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(ring_smem);
  unsigned char* stage0 = ring_smem + ring.header();
  const int cap = ring.cap, m = M > 0 ? M : ring.m, n = ring.n, group = ring.group, stages = ring.stages;
  const int run_a = cap * m, run_b = cap * n;  // elements of a cell's runs
  const long long stage_bytes = ring.stage_bytes();
  const int n_groups = (n_cells + group - 1) / group;
  const bool bulk = ring.bulk() && ((reinterpret_cast<size_t>(a) | reinterpret_cast<size_t>(b)) & 15) == 0;

  auto stage_a = [&](int st) { return reinterpret_cast<In*>(stage0 + st * stage_bytes); };
  // thread 0: arm stage st for group gi and copy its two runs
  auto issue = [&](int gi, int st) {
    const long long c0 = static_cast<long long>(gi) * group;
    const int nc = static_cast<int>(min(static_cast<long long>(group), n_cells - c0));
    In* as = stage_a(st);
    const unsigned ba = nc * run_a * sizeof(In), bb = nc * run_b * sizeof(In);
    mbar_expect(full + st, ba + bb);
    bulk_copy(as, a + c0 * run_a, ba, full + st);
    bulk_copy(as + static_cast<size_t>(group) * run_a, b + c0 * run_b, bb, full + st);
  };

  if (bulk) {
    if (threadIdx.x == 0) {
      for (int st = 0; st < stages; ++st) mbar_init(full + st);
      mpic::mbar_init_fence();
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int st = 0; st < stages; ++st) {
        const long long gi = blockIdx.x + static_cast<long long>(st) * gridDim.x;
        if (gi < n_groups) issue(static_cast<int>(gi), st);
      }
    }
  }

  unsigned phases = 0;  // bit st: parity of stage st's next phase
  int st = 0;
  for (int gi = blockIdx.x; gi < n_groups; gi += gridDim.x) {
    In* as = stage_a(st);
    In* bs = as + static_cast<size_t>(group) * run_a;
    const long long c0 = static_cast<long long>(gi) * group;
    const int nc = static_cast<int>(min(static_cast<long long>(group), n_cells - c0));
    if (bulk) {
      mbar_wait(full + st, (phases >> st) & 1u);
      phases ^= 1u << st;
    } else {
      for (int i = threadIdx.x; i < nc * run_a; i += blockDim.x) as[i] = a[c0 * run_a + i];
      for (int i = threadIdx.x; i < nc * run_b; i += blockDim.x) bs[i] = b[c0 * run_b + i];
      __syncthreads();
    }
    for (int s = threadIdx.x; s < nc * n; s += blockDim.x) {
      const int lc = s / n, col = s - lc * n;
      column_sums<In, M>(as + static_cast<size_t>(lc) * run_a, bs + static_cast<size_t>(lc) * run_b + col,
                         out + (c0 + lc) * m * n + col, cap, m, n);
    }
    __syncthreads();  // every thread is done with the stage
    if (bulk && threadIdx.x == 0) {
      const long long next = gi + static_cast<long long>(stages) * gridDim.x;
      if (next < n_groups) issue(static_cast<int>(next), st);
    }
    st = st + 1 == stages ? 0 : st + 1;
  }
}

template <typename In, int M>
cudaError_t launch(const void* a, const void* b, float* out, int n_cells, const Ring& ring, int threads, int blocks,
                   cudaStream_t stream) {
  const size_t smem = ring.smem();
  cudaError_t e = cudaFuncSetAttribute(bin_outer_product_kernel<In, M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  bin_outer_product_kernel<In, M><<<blocks, threads, smem, stream>>>(static_cast<const In*>(a),
                                                                     static_cast<const In*>(b), out, n_cells, ring);
  return cudaGetLastError();
}

template <typename In>
cudaError_t launch_m(const void* a, const void* b, float* out, int n_cells, const Ring& ring, int threads, int blocks,
                     cudaStream_t stream) {
  switch (ring.m) {
    case 2: return launch<In, 2>(a, b, out, n_cells, ring, threads, blocks, stream);
    case 3: return launch<In, 3>(a, b, out, n_cells, ring, threads, blocks, stream);
    case 4: return launch<In, 4>(a, b, out, n_cells, ring, threads, blocks, stream);
    case 5: return launch<In, 5>(a, b, out, n_cells, ring, threads, blocks, stream);
    default: return launch<In, 0>(a, b, out, n_cells, ring, threads, blocks, stream);
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched). The geometry
// (`bin_outer_product_geometry`): `blocks` persistent blocks of `threads`
// threads walk groups of `group` cells through a ring of `stages` stages of
// `smem` bytes in all; the kernel refuses any other layout. bf16 != 0: a
// and b are bfloat16, else float32.
extern "C" int mpic_bin_outer_product(const void* a, const void* b, float* out, int n_cells, int cap, int m, int n,
                                      int group, int stages, int threads, size_t smem, int blocks, int bf16,
                                      int device, cudaStream_t stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const Ring ring{cap, m, n, bf16 ? 2 : 4, group, stages};
  if (n_cells < 1 || cap < 1 || m < 1 || n < 1 || m * n > 1024 || group < 1 || stages < 1 ||
      stages > kRingHeader / 8 || threads % 32 != 0 || threads < 32 || threads > kMaxThreads || blocks < 1 ||
      smem != ring.smem() || static_cast<long long>(smem) > kSmemLimit)
    return cudaErrorInvalidValue;
  return bf16 ? launch_m<__nv_bfloat16>(a, b, out, n_cells, ring, threads, blocks, stream)
              : launch_m<float>(a, b, out, n_cells, ring, threads, blocks, stream);
}
