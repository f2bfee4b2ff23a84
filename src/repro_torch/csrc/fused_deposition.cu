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
//   rho_k[a][b][c] = sum_p (wx[p][a] * val[p][k]) * (wy[p][b] * wz[p][c]),
// each product rounded once and the sum a chain of fmaf over the slots in
// ascending order, starting from +0.
//
// What bounds them on the H100: device memory. The slab is 768 B a cell at
// capacity 32; the useful work at the main path's occupancy (order 3, 8
// particles in 32 slots) is ~6 kflop a cell, ~8 flop/B, under the fp32
// CUDA-core ridge of 67 TFLOP/s / 3.35 TB/s = 20 flop/B.
//
// fused_deposit_kernel (packed, (C, 3, T, T*T) out): one block per cell; the
// cell's slots and its six weight sets are staged in shared memory, and each
// thread owns output elements, summing over every slot in a register. Its
// inner loop issues four shared loads per multiply-add: it is bound by load
// instructions, far from its byte bound (a later redesign).
//
// fused_deposit_reduced_kernel ((nx*ny, 3, nz+2g, T, T) out, the rhocell z
// pass done on chip) was bound the same way, and its first version kept the
// z accumulator in shared memory, capping the column height. Its design:
//   - one owner per (x, y) column keeps the z sums free of atomics and
//     deterministic; a block takes several columns (a pure function of the
//     grid, `cols_per_block`), walking them in lockstep;
//   - a thread owns one (comp, a, b) of a column and holds, in registers,
//     the cell's tile sums t[c] and the running row sums r[c] of rows
//     z + c. The column is walked from its top cell down, so each row
//     receives its taps in ascending c, as the plain z pass adds them
//     (bit-identical with the packed kernel followed by the plain pass);
//     after each cell the finished row goes straight to device memory, the
//     T*T (a, b) of one (comp, row) contiguous, so nothing limits nz;
//   - the column is walked in 32-slot chunks, as a pipeline with one
//     barrier a chunk: while the owners contract chunk s, they also form
//     their column's weight records of chunk s + 1, one warp per column lists the
//     kept slots of chunk s + 2 (a ballot keeps the slots with a non-zero
//     val, in order: a skipped slot only ever adds fmaf(0, w, acc) = acc,
//     and acc never becomes -0), and cp.async copies the raw d and val of
//     chunk s + 4 (16-byte pieces where aligned; four raw buffers a
//     column, two of records);
//   - a kept slot's weights are formed once, as a record av[comp][a] =
//     wx*v, wy[stagger][b], wz[stagger][c] (wz rows padded for 16-byte
//     loads). An owner then makes 1 + 1 + 2 shared loads and T products
//     and T multiply-adds per kept slot, where the first version made four
//     shared loads and two products per multiply-add.
// No tensor cores: the sums are float32 under a 1e-5 tolerance (TF32 keeps
// ~3 digits), and the useful flops take ~0.2 ms of the CUDA cores at the
// main path's shapes, below the bytes' 0.67 ms.
#include "cp_async.cuh"
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

// ---- the reduced kernel --------------------------------------------------

constexpr int kChunk = 32;           // slots one compaction warp takes at a time
constexpr int kRawStages = 4;        // raw chunks in flight or in use per column
constexpr int kReducedThreads = 384; // most threads of a reduced block

// Shared memory of one column, in floats: two buffers of kept-slot records,
// kRawStages raw chunks (d then val), two lists of kept slots, four counts.
// A record holds wz[2][WZP] (16-byte aligned), av[3][T] and wy[2][T].
// kernels/deposition/ops.py mirrors these numbers (reduced_column_floats).
template <int ORDER> struct Reduced {
  static constexpr int T = Window<ORDER>::T;
  static constexpr int WZP = (T + 3) / 4 * 4;
  static constexpr int AV = 2 * WZP, WY = AV + 3 * T;
  static constexpr int SLOT = (WY + 2 * T + 3) / 4 * 4;
  static constexpr int RAW = 6 * kChunk;
  static constexpr int RECORDS = 2 * kChunk * SLOT;
  static constexpr int KEPT = RECORDS + kRawStages * RAW;
  static constexpr int COLUMN = KEPT + 2 * kChunk + 4;
  static constexpr int OWNERS = 3 * T * T;
};

// The block's columns and their walk: step s is chunk s % n_chunks of cell
// nz - 1 - s / n_chunks (top cell first).
struct ColumnWalk {
  const float* d;
  const float* val;
  float* smem;
  int col0, n_here, nz, cap, n_chunks;
  bool vec;
  __device__ int z(int step) const { return nz - 1 - step / n_chunks; }
  __device__ int chunk(int step) const { return step % n_chunks; }
  __device__ int slots(int step) const { return min(kChunk, cap - chunk(step) * kChunk); }
  template <int ORDER> __device__ float* column(int j) const { return smem + j * Reduced<ORDER>::COLUMN; }
  template <int ORDER> __device__ float* raw(int j, int step) const {
    return column<ORDER>(j) + Reduced<ORDER>::RECORDS + (step % kRawStages) * Reduced<ORDER>::RAW;
  }
  template <int ORDER> __device__ int* kept(int j, int step) const {
    return reinterpret_cast<int*>(column<ORDER>(j) + Reduced<ORDER>::KEPT) + (step & 1) * kChunk;
  }
  template <int ORDER> __device__ int* count(int j, int step) const {
    return reinterpret_cast<int*>(column<ORDER>(j) + Reduced<ORDER>::KEPT) + 2 * kChunk + (step & 3);
  }
};

// Copy step `step`'s chunk of every column of the block into its raw
// buffer (all threads; lands by a later cp_async_wait). With `vec` (the
// capacity a multiple of 4, d and val 16-byte aligned) in 16-byte pieces.
template <int ORDER>
__device__ __forceinline__ void issue_chunk(const ColumnWalk& w, int step) {
  using L = Reduced<ORDER>;
  const int z = w.z(step), m3 = 3 * w.slots(step);
  const size_t first = static_cast<size_t>(w.chunk(step)) * kChunk * 3;
  if (w.vec) {
    constexpr int Q = 3 * kChunk / 4;  // 16-byte pieces of one half (d or val)
    for (int i = threadIdx.x; i < w.n_here * 2 * Q; i += blockDim.x) {
      const int j = i / (2 * Q), half = (i / Q) & 1, k = 4 * (i % Q);
      if (k >= m3) continue;
      const size_t cell = static_cast<size_t>(w.col0 + j) * w.nz + z;
      cp_async<16>(w.raw<ORDER>(j, step) + half * 3 * kChunk + k, (half ? w.val : w.d) + cell * w.cap * 3 + first + k);
    }
    return;
  }
  for (int i = threadIdx.x; i < w.n_here * L::RAW; i += blockDim.x) {
    const int j = i / L::RAW, e = i % L::RAW, half = e / (3 * kChunk), k = e % (3 * kChunk);
    if (k >= m3) continue;
    const size_t cell = static_cast<size_t>(w.col0 + j) * w.nz + z;
    cp_async<4>(w.raw<ORDER>(j, step) + half * 3 * kChunk + k, (half ? w.val : w.d) + cell * w.cap * 3 + first + k);
  }
}

// List the chunk's slots with a non-zero val, in order (one warp a column).
template <int ORDER>
__device__ __forceinline__ void compact_chunk(const ColumnWalk& w, int step) {
  const int lane = threadIdx.x & 31, m = w.slots(step);
  for (int j = threadIdx.x >> 5; j < w.n_here; j += blockDim.x >> 5) {
    const float* rv = w.raw<ORDER>(j, step) + 3 * kChunk;
    const bool keep = lane < m && (rv[3 * lane] != 0.0f || rv[3 * lane + 1] != 0.0f || rv[3 * lane + 2] != 0.0f);
    const unsigned mask = __ballot_sync(0xffffffffu, keep);
    if (keep) w.kept<ORDER>(j, step)[__popc(mask & ((1u << lane) - 1u))] = lane;
    if (lane == 0) *w.count<ORDER>(j, step) = __popc(mask);
  }
}

// Form the listed slots' records of column j, by the column's OWNERS
// threads (e is this thread's index among them): six tasks a kept slot,
// one per weight set (axis x stagger): wz and wy rows as they are, the
// staggered x set times v[0] (av of Jx), the unstaggered one times v[1]
// and v[2] (av of Jy and Jz).
template <int ORDER>
__device__ __forceinline__ void weigh_chunk(const ColumnWalk& w, int step, int j, int e) {
  using L = Reduced<ORDER>;
  constexpr int T = L::T;
  const int n = *w.count<ORDER>(j, step);
  const int* kept = w.kept<ORDER>(j, step);
  const float* rd = w.raw<ORDER>(j, step);
  float* records = w.column<ORDER>(j) + (step & 1) * kChunk * L::SLOT;
  for (int r = e; r < 6 * n; r += L::OWNERS) {
    const int k = r / 6, set = r % 6, p = kept[k];
    const int axis = set >> 1, stag = set & 1;
    const float* rv = rd + 3 * kChunk + 3 * p;
    float wt[T];
    weights<ORDER>(rd[3 * p + axis], stag, wt);
    float* rec = records + k * L::SLOT;
    if (axis == 0) {
      // av[comp][a] = wx[a] * v[comp], comp 0 from the staggered set
      const int comp = stag ? 0 : 1;
      const float v0 = rv[comp], v1 = rv[2];
#pragma unroll
      for (int a = 0; a < T; ++a) rec[L::AV + comp * T + a] = __fmul_rn(wt[a], v0);
      if (!stag) {
#pragma unroll
        for (int a = 0; a < T; ++a) rec[L::AV + 2 * T + a] = __fmul_rn(wt[a], v1);
      }
    } else {
      float* row = rec + (axis == 2 ? stag * L::WZP : L::WY + stag * T);
#pragma unroll
      for (int c = 0; c < T; ++c) row[c] = wt[c];
    }
  }
}

// out: (nx*ny, 3, nz+2g, T, T) z-reduced column sums; a block owns
// columns [blockIdx.x * cols_per_block, +cols_per_block), whose nz cells
// are consecutive (cells are z-fastest). Iteration s contracts step s,
// forms the records of step s + 1, lists the kept slots of step s + 2 and
// copies the raw chunk of step s + 4: each stage reads only what the one
// before wrote an iteration earlier, so one barrier an iteration suffices.
template <int ORDER>
__global__ void __launch_bounds__(kReducedThreads)
fused_deposit_reduced_kernel(const float* __restrict__ d, const float* __restrict__ val, float* __restrict__ out,
                             int n_cols, int nz, int cap, int guard, int cols_per_block) {
  using L = Reduced<ORDER>;
  constexpr int T = L::T, BASE = Window<ORDER>::BASE;
  extern __shared__ __align__(16) float column_smem[];
  const int col0 = static_cast<int>(blockIdx.x) * cols_per_block;
  const bool vec = (cap & 3) == 0 && (reinterpret_cast<size_t>(d) & 15) == 0 &&
                   (reinterpret_cast<size_t>(val) & 15) == 0;
  const ColumnWalk w{d, val, column_smem, col0, min(cols_per_block, n_cols - col0), nz, cap,
                     (cap + kChunk - 1) / kChunk, vec};
  const int steps = nz * w.n_chunks, zp = nz + 2 * guard, o = guard + BASE;

  // this thread's element: (comp, a, b) of column j
  const int j = threadIdx.x / L::OWNERS, e = threadIdx.x % L::OWNERS;
  const bool owner = j < w.n_here;
  const int comp = e / (T * T), a = (e / T) % T, b = e % T;
  const int sy = comp == 1, sz = comp == 2;
  float* el = out + (static_cast<size_t>(owner ? col0 + j : 0) * 3 + comp) * zp * T * T + a * T + b;
  if (owner) {  // rows no tap reaches
    for (int z = 0; z < o; ++z) el[static_cast<size_t>(z) * T * T] = 0.0f;
    for (int z = o + nz + T - 1; z < zp; ++z) el[static_cast<size_t>(z) * T * T] = 0.0f;
  }

  // at the top of iteration s, step s + 2's raw chunk has landed and step
  // s + 3's is in flight
  issue_chunk<ORDER>(w, 0);
  cp_async_commit();
  if (steps > 1) issue_chunk<ORDER>(w, 1);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  float tile[T], rows[T];
#pragma unroll
  for (int c = 0; c < T; ++c) tile[c] = rows[c] = 0.0f;
  for (int s = -2; s < steps; ++s) {
    if (s + 4 < steps) issue_chunk<ORDER>(w, s + 4);
    cp_async_commit();
    if (s >= 0 && owner) {
      const float* rec = w.column<ORDER>(j) + (s & 1) * kChunk * L::SLOT;
      const int n = *w.count<ORDER>(j, s);
#pragma unroll 2
      for (int k = 0; k < n; ++k) {
        const float* r = rec + k * L::SLOT;
        const float av = r[L::AV + comp * T + a];
        const float wy = r[L::WY + sy * T + b];
        float wz[L::WZP];
#pragma unroll
        for (int q = 0; q < L::WZP / 4; ++q) {
          const float4 f = reinterpret_cast<const float4*>(r + sz * L::WZP)[q];
          wz[4 * q] = f.x, wz[4 * q + 1] = f.y, wz[4 * q + 2] = f.z, wz[4 * q + 3] = f.w;
        }
#pragma unroll
        for (int c = 0; c < T; ++c) tile[c] = fmaf(av, __fmul_rn(wy, wz[c]), tile[c]);
      }
      if (w.chunk(s) == w.n_chunks - 1) {
        // the cell is done: add its tile, store the row no later cell
        // reaches (z + T - 1), slide the window down one row
        const int z = w.z(s);
#pragma unroll
        for (int c = 0; c < T; ++c) rows[c] = __fadd_rn(rows[c], tile[c]), tile[c] = 0.0f;
        el[static_cast<size_t>(z + o + T - 1) * T * T] = rows[T - 1];
#pragma unroll
        for (int c = T - 1; c > 0; --c) rows[c] = rows[c - 1];
        rows[0] = 0.0f;
      }
    }
    if (owner && s + 1 >= 0 && s + 1 < steps) weigh_chunk<ORDER>(w, s + 1, j, e);
    if (s + 2 < steps) compact_chunk<ORDER>(w, s + 2);
    cp_async_wait<1>();
    __syncthreads();
  }
  if (owner) {
#pragma unroll
    for (int c = 1; c < T; ++c) el[static_cast<size_t>(o + c - 1) * T * T] = rows[c];
  }
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
int launch_reduced(const float* d, const float* val, float* out, int n_cols, int nz, int cap, int guard,
                   int cols_per_block, int threads, size_t smem, cudaStream_t s) {
  using L = Reduced<ORDER>;
  // the wrapper's geometry must be one this kernel takes
  if (cols_per_block < 1 || threads % 32 != 0 || threads < cols_per_block * L::OWNERS ||
      threads > kReducedThreads || smem != static_cast<size_t>(cols_per_block) * L::COLUMN * sizeof(float))
    return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(fused_deposit_reduced_kernel<ORDER>, smem);
  if (e != cudaSuccess) return e;
  const int blocks = (n_cols + cols_per_block - 1) / cols_per_block;
  fused_deposit_reduced_kernel<ORDER><<<blocks, threads, smem, s>>>(d, val, out, n_cols, nz, cap, guard,
                                                                     cols_per_block);
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
                                          int cap, int order, int guard, int cols_per_block, int threads,
                                          size_t smem, int device, cudaStream_t stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  switch (order) {
    case 1: return launch_reduced<1>(d, val, out, n_cols, nz, cap, guard, cols_per_block, threads, smem, stream);
    case 2: return launch_reduced<2>(d, val, out, n_cols, nz, cap, guard, cols_per_block, threads, smem, stream);
    case 3: return launch_reduced<3>(d, val, out, n_cols, nz, cap, guard, cols_per_block, threads, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}
