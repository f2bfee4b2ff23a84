// Fused six-component field gather for Hopper.
//
// Replaces the Pallas TPU kernel fused_gather_pallas
// (_make_fused_gather_kernel) of src/repro/kernels/gather/kernel.py.
//
// For every slot p of cell c, with the six 1-D weight sets of the slot's
// offset d[c][p] on the unified tap window, and each field component k
// (Ex, Ey, Ez, Bx, By, Bz on their Yee staggers):
//   out[c][p][k] = sum_{a,b,c'} wx[a] * wy[b] * wz[c'] * G_k[a][b][c']
// where G_k is the cell's (T, T, T) neighbourhood of component k.
//
// The TPU kernel reads G from a packed (C, 6, T, T*T) tensor that the
// caller builds in device memory: 6.3 GB at order 3 on a 128^3 grid, for
// 55 MB of field data. This kernel reads the six guard-padded grids
// directly, stacked as (6, nx+2g, ny+2g, nz+2g), so the packed tensor never
// exists.
//
// What bounds it on the H100: device memory. Per slot it reads 12 B of
// offsets and writes 24 B of fields (1.6 GB of output alone at the main
// path's 2.1 M cells x 32 slots), for ~2 kflop per occupied slot: ~8 flop/B
// at the main path's occupancy (8 particles in 32 slots), under the fp32
// CUDA-core ridge of ~20 flop/B. Its first version, one 32-thread block per
// cell, left half the SM's warp slots empty, loaded every neighbourhood
// once per cell (T times per column), computed every gap slot and made one
// shared load per multiply-add. The design:
//   - a block takes a run of `run` consecutive z cells of one (x, y)
//     column (a pure function of the grid and capacity, chosen by the
//     wrapper) and copies the six components' T x T rows of the padded
//     grids along the run into shared memory once, row by row along z,
//     with the run's slab of offsets (cp.async, all in flight at once);
//   - a slot whose weights on some axis are all zero for both staggers
//     gets exactly 0 in all six outputs (for finite fields), so the block
//     classifies every slot first, writes those zeros, and compacts the
//     other slots of each cell into a list (gap slots alias particle 0 and
//     fall in that class almost everywhere);
//   - every thread then takes two listed slots of one cell: each shared
//     load of G feeds both, and the sum is factored as
//     sum_a wx[a] sum_b wy[b] sum_c' wz[c'] G[a][b][c'], T^3 + T^2 + T
//     multiply-adds a component, no products formed; the weights are
//     evaluated without branches, with fused multiply-adds. With the loops
//     fully unrolled the weights stay in registers (no spills: ptxas -v),
//     and at most 96 registers keep four 160-thread blocks on an SM;
//   - an item takes a thread for its whole length, so the block has 160
//     threads for the ~136 pairs of a 32-cell run at the main path's
//     occupancy (8 particles a cell on average, unevenly spread once the
//     plasma moves). Pairs go in whole rounds of one a thread; a last round
//     of only a few is split into one-component pieces, so it costs a
//     fraction of an item's time.
//   - an ensemble bucket (the reference vmaps this kernel over a member
//     axis) is one launch: blocks run over the members' columns one
//     member after another, and a block decodes its member and offsets
//     into that member's grids and slab, so each slot's outputs are those
//     of a launch over its member alone.
// The summation order and the weights' rounding differ from the plain
// version's (whose einsum order is not fixed either); the result agrees
// within float32 rounding.
#include "cp_async.cuh"
#include "shape.cuh"

using namespace mpic;

namespace {

constexpr int kGatherThreads = 160;

// EB_STAGGERS: E_k is staggered on axis k, B_k on the two other axes.
__host__ __device__ constexpr int staggered(int comp, int axis) {
  return comp < 3 ? (comp == axis) : (comp - 3 != axis);
}

// Whether some tap of either stagger of one axis can be non-zero. The
// B-spline of ORDER vanishes where |u| >= H = (ORDER + 1) / 2, and the tap
// centres BASE + j + s/2 (j < T, s in {0, 1}) lie 0.5 apart, so every tap
// is at least H away (in rounded arithmetic too: rounding is monotonic and
// H exact) unless d lies strictly inside (BASE - H, BASE + T - 1/2 + H).
// NaN counts as possibly non-zero.
template <int ORDER>
__device__ __forceinline__ bool axis_live(float d) {
  constexpr int T = Window<ORDER>::T, BASE = Window<ORDER>::BASE;
  constexpr float H = 0.5f * (ORDER + 1);
  return !(d <= BASE - H || d >= BASE + T - 0.5f + H);
}

// One 1-D weight set on the unified window, w[j] = B(d - (BASE + j + s/2)),
// without branches and with fused multiply-adds: within a rounding or two
// of `weights` (the gather's tolerance is 1e-5; the deposition kernels keep
// `weights` for their bit identity).
template <int ORDER>
__device__ __forceinline__ void gather_weights(float d, int staggered, float* w) {
  constexpr int T = Window<ORDER>::T, BASE = Window<ORDER>::BASE;
  const float shift = staggered ? 0.5f : 0.0f;
#pragma unroll
  for (int j = 0; j < T; ++j) {
    const float a = fabsf(d - (static_cast<float>(BASE + j) + shift));
    if constexpr (ORDER == 1) {
      w[j] = fmaxf(1.0f - a, 0.0f);
    } else if constexpr (ORDER == 2) {
      const float t = 1.5f - a;
      w[j] = a < 0.5f ? fmaf(-a, a, 0.75f) : (a < 1.5f ? 0.5f * t * t : 0.0f);
    } else {
      const float t = 2.0f - a;
      const float inner = fmaf(a * a, fmaf(0.5f, a, -1.0f), 2.0f / 3.0f);
      w[j] = a < 1.0f ? inner : (a < 2.0f ? t * t * t * (1.0f / 6.0f) : 0.0f);
    }
  }
}

// sum_a wx[a] sum_b wy[b] sum_c wz[c] g[a][b][c] for two slots at once
// (each shared load of g feeds both): g one component's window in the
// staged rows (row stride lw), w0/w1 the slots' x, y and z weight sets.
template <int ORDER>
__device__ __forceinline__ float2 contract(const float* g, int lw, const float* wx0, const float* wy0,
                                           const float* wz0, const float* wx1, const float* wy1,
                                           const float* wz1) {
  constexpr int T = Window<ORDER>::T;
  float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
  for (int a = 0; a < T; ++a) {
    float h0 = 0.0f, h1 = 0.0f;
#pragma unroll
    for (int b = 0; b < T; ++b) {
      const float* row = g + (a * T + b) * lw;
      float q0 = 0.0f, q1 = 0.0f;
#pragma unroll
      for (int c = 0; c < T; ++c) {
        const float v = row[c];
        q0 = fmaf(wz0[c], v, q0);
        q1 = fmaf(wz1[c], v, q1);
      }
      h0 = fmaf(wy0[b], q0, h0);
      h1 = fmaf(wy1[b], q1, h1);
    }
    s0 = fmaf(wx0[a], h0, s0);
    s1 = fmaf(wx1[a], h1, s1);
  }
  return make_float2(s0, s1);
}

// The six outputs of two slots of one cell: dp0/dp1 their offsets, g the
// cell's window in the staged rows (row stride lw), op1 null if the second
// slot is a stand-in.
template <int ORDER>
__device__ __forceinline__ void gather_pair(const float* g, int lw, const float* dp0, const float* dp1,
                                            float* op0, float* op1) {
  constexpr int T = Window<ORDER>::T;
  float w0[6][T], w1[6][T];  // set = 2 * axis + staggered
#pragma unroll
  for (int set = 0; set < 6; ++set) {
    gather_weights<ORDER>(dp0[set >> 1], set & 1, w0[set]);
    gather_weights<ORDER>(dp1[set >> 1], set & 1, w1[set]);
  }
#pragma unroll
  for (int comp = 0; comp < 6; ++comp) {
    const int sx = staggered(comp, 0), sy = 2 + staggered(comp, 1), sz = 4 + staggered(comp, 2);
    const float2 e = contract<ORDER>(g + comp * T * T * lw, lw, w0[sx], w0[sy], w0[sz], w1[sx], w1[sy], w1[sz]);
    op0[comp] = e.x;  // stored at once: six sums held to the end would cost registers
    if (op1 != nullptr) op1[comp] = e.y;
  }
}

// One component of the same two slots: the same sums, a sixth of the work.
template <int ORDER>
__device__ __forceinline__ void gather_pair_component(const float* g, int lw, const float* dp0, const float* dp1,
                                                      float* op0, float* op1, int comp) {
  constexpr int T = Window<ORDER>::T;
  float w0[3][T], w1[3][T];
#pragma unroll
  for (int axis = 0; axis < 3; ++axis) {
    gather_weights<ORDER>(dp0[axis], staggered(comp, axis), w0[axis]);
    gather_weights<ORDER>(dp1[axis], staggered(comp, axis), w1[axis]);
  }
  const float2 e = contract<ORDER>(g + comp * T * T * lw, lw, w0[0], w0[1], w0[2], w1[0], w1[1], w1[2]);
  op0[comp] = e.x;
  if (op1 != nullptr) op1[comp] = e.y;
}

// One block per run of `run` z cells of one column; runs = ceil(nz / run)
// blocks per column, the columns of `members` grids one after another (d,
// out and padded each hold the members' blocks one after another).
// Shared memory (kernels/gather/ops.py mirrors it,
// gather_smem): G[6][T][T][run + T - 1] floats padded to a multiple of 4,
// the run's offsets D[run][cap][3], then ints live[run][cap], n_live[run],
// first[run + 1].
template <int ORDER>
__global__ void __launch_bounds__(kGatherThreads, 4)
fused_gather_kernel(const float* __restrict__ d, const float* __restrict__ padded, float* __restrict__ out,
                    int nx, int ny, int nz, int cap, int guard, int run) {
  constexpr int T = Window<ORDER>::T, BASE = Window<ORDER>::BASE;
  extern __shared__ __align__(16) float gather_smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, n_warps = blockDim.x >> 5;
  const int runs = (nz + run - 1) / run;
  // the block's column counts over the members' columns one after another
  const int column = blockIdx.x / runs, z0 = (blockIdx.x % runs) * run;
  const int member = column / (nx * ny), ix = (column / ny) % nx, iy = column % ny;
  const int len = min(run, nz - z0), lw = run + T - 1, span = len + T - 1;
  const size_t cell0 = static_cast<size_t>(column) * nz + z0;
  float* G = gather_smem;
  float* D = G + (6 * T * T * lw + 3) / 4 * 4;  // 16-byte aligned
  int* live = reinterpret_cast<int*>(D + 3 * run * cap);
  int* n_live = live + run * cap;
  int* first = n_live + run;

  for (int i = tid; i < len; i += blockDim.x) n_live[i] = 0;

  // copy the run's rows of the six padded grids and the run's slab of
  // offsets (one contiguous span) into shared memory, all in flight at once
  const size_t X = nx + 2 * guard, Y = ny + 2 * guard, Z = nz + 2 * guard;
  const float* grids = padded + member * 6 * X * Y * Z;  // the member's six padded grids
  const int o = guard + BASE;
  for (int i = tid; i < 6 * T * T * span; i += blockDim.x) {
    const int row = i / span, zz = i % span;
    const int comp = row / (T * T), a = (row / T) % T, b = row % T;
    cp_async<4>(G + row * lw + zz, grids + ((comp * X + (o + ix + a)) * Y + (o + iy + b)) * Z + (o + z0 + zz));
  }
  const float* dsrc = d + cell0 * cap * 3;
  const int n_d = 3 * len * cap;
  if ((reinterpret_cast<size_t>(dsrc) & 15) == 0) {
    for (int i = 4 * tid; i + 3 < n_d; i += 4 * blockDim.x) cp_async<16>(D + i, dsrc + i);
    for (int i = (n_d & ~3) + tid; i < n_d; i += blockDim.x) cp_async<4>(D + i, dsrc + i);
  } else {
    for (int i = tid; i < n_d; i += blockDim.x) cp_async<4>(D + i, dsrc + i);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // classify: zeros out, the rest listed per cell (in any order: each
  // slot's outputs depend on its own offsets alone); a warp takes 32-slot
  // chunks
  const int n_chunks = (cap + 31) / 32;
  for (int wc = warp; wc < len * n_chunks; wc += n_warps) {
    const int zl = wc / n_chunks, p = (wc % n_chunks) * 32 + lane;
    bool is_live = false;
    if (p < cap) {
      const float* dp = D + (zl * cap + p) * 3;
      is_live = axis_live<ORDER>(dp[0]) && axis_live<ORDER>(dp[1]) && axis_live<ORDER>(dp[2]);
      if (!is_live) {
        float2* op = reinterpret_cast<float2*>(out + ((cell0 + zl) * cap + p) * 6);
        op[0] = op[1] = op[2] = make_float2(0.0f, 0.0f);
      }
    }
    const unsigned mask = __ballot_sync(0xffffffffu, is_live);
    int base = 0;
    if (lane == 0 && mask != 0u) base = atomicAdd(&n_live[zl], __popc(mask));
    base = __shfl_sync(0xffffffffu, base, 0);
    if (is_live) live[zl * cap + base + __popc(mask & ((1u << lane) - 1u))] = p;
  }
  __syncthreads();

  // work items: pairs of listed slots of one cell; first[zl] = items before cell zl
  if (warp == 0) {
    int total = 0;
    for (int zb = 0; zb < len; zb += 32) {
      const int zl = zb + lane;
      const int items = zl < len ? (n_live[zl] + 1) / 2 : 0;
      int incl = items;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += up;
      }
      if (zl < len) first[zl] = total + incl - items;
      total += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (lane == 0) first[len] = total;
  }
  __syncthreads();

  // Items (pairs) are taken in whole rounds of one per thread; a last,
  // partial round of a few items would hold the block for a whole item's
  // time, so its items are split into one-component pieces where those
  // fit in two rounds.
  const int total = first[len], nt = blockDim.x;
  const int leftover = total % nt;
  const bool split = 6 * leftover <= 2 * nt;
  const int whole = split ? total - leftover : total;
  for (int piece = tid; piece < whole + (split ? 6 * leftover : 0); piece += nt) {
    const int it = piece < whole ? piece : whole + (piece - whole) / 6;
    int lo = 0, hi = len - 1;  // the last cell whose items start at or before it
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (first[mid] <= it) lo = mid;
      else hi = mid - 1;
    }
    const int zl = lo, k = 2 * (it - first[zl]);
    const int p0 = live[zl * cap + k];
    const bool pair = k + 1 < n_live[zl];
    const int p1 = pair ? live[zl * cap + k + 1] : p0;
    const float* dp0 = D + (zl * cap + p0) * 3;
    const float* dp1 = D + (zl * cap + p1) * 3;
    float* op0 = out + ((cell0 + zl) * cap + p0) * 6;
    float* op1 = pair ? out + ((cell0 + zl) * cap + p1) * 6 : nullptr;
    if (piece < whole) gather_pair<ORDER>(G + zl, lw, dp0, dp1, op0, op1);
    else gather_pair_component<ORDER>(G + zl, lw, dp0, dp1, op0, op1, (piece - whole) % 6);
  }
}

template <int ORDER>
int launch(const float* d, const float* padded, float* out, int members, int nx, int ny, int nz, int cap, int guard,
           int run, int threads, size_t smem, cudaStream_t s) {
  constexpr int T = Window<ORDER>::T;
  // the wrapper's geometry must be one this kernel takes
  const size_t g_floats = (static_cast<size_t>(6) * T * T * (run + T - 1) + 3) / 4 * 4;
  const size_t want = (g_floats + static_cast<size_t>(4) * run * cap + 2 * run + 1) * sizeof(float);
  if (members < 1 || run < 1 || run > nz || threads != kGatherThreads || smem != want) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(fused_gather_kernel<ORDER>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const long long blocks = static_cast<long long>(members) * nx * ny * ((nz + run - 1) / run);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  fused_gather_kernel<ORDER><<<static_cast<unsigned>(blocks), threads, smem, s>>>(d, padded, out, nx, ny, nz, cap,
                                                                                 guard, run);
  return cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int mpic_fused_gather(const float* d, const float* padded, float* out, int members, int nx, int ny,
                                 int nz, int cap, int order, int guard, int run, int threads, size_t smem, int device,
                                 cudaStream_t stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  switch (order) {
    case 1: return launch<1>(d, padded, out, members, nx, ny, nz, cap, guard, run, threads, smem, stream);
    case 2: return launch<2>(d, padded, out, members, nx, ny, nz, cap, guard, run, threads, smem, stream);
    case 3: return launch<3>(d, padded, out, members, nx, ny, nz, cap, guard, run, threads, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* mpic_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
