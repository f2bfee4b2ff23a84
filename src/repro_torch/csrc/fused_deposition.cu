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
// What bounds them on the H100: not the bytes. The slab is 768 B a cell at
// capacity 32; the useful work at the main path's occupancy (order 3, 8
// particles in 32 slots) is ~6 kflop a cell, ~8 flop/B, under the fp32
// CUDA-core ridge of 67 TFLOP/s / 3.35 TB/s = 20 flop/B, so the bytes bound
// them (0.67 ms for the reduced kernel's output, 1.42 ms for the packed
// kernel's 1500 B a cell). Both are held back by instruction issue and
// latency instead: weights, a barrier per chunk, and two operations per
// product element per kept slot.
//
// Both kernels run one pipeline (`deposit_walk`) and differ in what they do
// with a finished cell:
//   - a block takes several lanes of consecutive cells (the reduced kernel:
//     whole (x, y) columns, top cell first; the packed kernel: runs of
//     cells, a pure function of order and capacity), walking them in
//     lockstep, one 32-slot chunk a step;
//   - a thread owns one (comp, a, b) of a lane and holds, in registers, the
//     cell's tile sums t[c], c < T;
//   - the walk is a pipeline with one barrier a chunk: while the owners
//     contract chunk s, they also form their lane's weight records of chunk
//     s + 1, one warp per lane lists the kept slots of chunk s + 2 (a
//     ballot keeps the slots with a non-zero val, in order: a skipped slot
//     only ever adds fmaf(0, w, acc) = acc, and acc never becomes -0), and
//     cp.async copies the raw d and val of chunk s + 4 (16-byte pieces
//     where aligned; four raw buffers a lane, two of records);
//   - a kept slot's weights are formed once, as a record av[comp][a] =
//     wx*v, wy[stagger][b], wz[stagger][c] (wz rows padded for 16-byte
//     loads). An owner then makes 1 + 1 + 2 shared loads and T products
//     and T multiply-adds per kept slot.
// At the end of a cell:
//   - fused_deposit_kernel ((C, 3, T, T*T) out): each owner stores its T
//     sums, which are contiguous in the packed layout, so a warp's stores
//     cover consecutive addresses. Its first version (one block per cell,
//     one thread per output element re-walking every slot, gap slots
//     included, with four shared loads per multiply-add) was bound by
//     load issue at 10x its byte bound;
//   - fused_deposit_reduced_kernel ((nx*ny, 3, nz+2g, T, T) out, the
//     rhocell z pass done on chip): each owner also holds the running row
//     sums r[c] of rows z + c, adds the tile to them and stores the row no
//     later cell reaches. The column is walked from its top cell down, so
//     each row receives its taps in ascending c, as the plain z pass adds
//     them (bit-identical with the packed kernel followed by the plain
//     pass), and nothing limits nz.
// No tensor cores: the sums are float32 under a 1e-5 tolerance (TF32 keeps
// ~3 digits), and the useful flops take ~0.2 ms of the CUDA cores at the
// main path's shapes, below the bytes.
#include "cp_async.cuh"
#include "shape.cuh"

using namespace mpic;

namespace {

constexpr int kChunk = 32;           // slots one compaction warp takes at a time
constexpr int kRawStages = 4;        // raw chunks in flight or in use per lane
constexpr int kDepositThreads = 384; // most threads of a deposition block

// Shared memory of one lane, in floats: two buffers of kept-slot records,
// kRawStages raw chunks (d then val), two lists of kept slots, four counts.
// A record holds wz[2][WZP] (16-byte aligned), av[3][T] and wy[2][T].
// kernels/deposition/ops.py mirrors these numbers (lane_floats).
template <int ORDER> struct Lane {
  static constexpr int T = Window<ORDER>::T;
  static constexpr int WZP = (T + 3) / 4 * 4;
  static constexpr int AV = 2 * WZP, WY = AV + 3 * T;
  static constexpr int SLOT = (WY + 2 * T + 3) / 4 * 4;
  static constexpr int RAW = 6 * kChunk;
  static constexpr int RECORDS = 2 * kChunk * SLOT;
  static constexpr int KEPT = RECORDS + kRawStages * RAW;
  static constexpr int FLOATS = KEPT + 2 * kChunk + 4;
  static constexpr int OWNERS = 3 * T * T;
};

// The block's lanes and their walk: lane j holds cells first(j) ..
// first(j) + len - 1 and step s is chunk s % n_chunks of its cell
// first(j) + len - 1 - s / n_chunks (last cell first). A cell at or past
// n_cells (in the packed kernel's last lane) is skipped: the functions
// below test for it only where RAGGED (the reduced kernel's columns are
// whole, and the test costs it 1%).
struct LaneWalk {
  const float* d;
  const float* val;
  float* smem;
  int lane0, n_here, len, n_cells, cap, n_chunks;
  bool vec;
  __device__ int z(int step) const { return len - 1 - step / n_chunks; }
  __device__ int first(int j) const { return (lane0 + j) * len; }
  __device__ int cell(int j, int step) const { return first(j) + z(step); }
  __device__ bool live(int j, int step) const { return cell(j, step) < n_cells; }
  __device__ int chunk(int step) const { return step % n_chunks; }
  __device__ int slots(int step) const { return min(kChunk, cap - chunk(step) * kChunk); }
  template <int ORDER> __device__ float* lane(int j) const { return smem + j * Lane<ORDER>::FLOATS; }
  template <int ORDER> __device__ float* raw(int j, int step) const {
    return lane<ORDER>(j) + Lane<ORDER>::RECORDS + (step % kRawStages) * Lane<ORDER>::RAW;
  }
  template <int ORDER> __device__ int* kept(int j, int step) const {
    return reinterpret_cast<int*>(lane<ORDER>(j) + Lane<ORDER>::KEPT) + (step & 1) * kChunk;
  }
  template <int ORDER> __device__ int* count(int j, int step) const {
    return reinterpret_cast<int*>(lane<ORDER>(j) + Lane<ORDER>::KEPT) + 2 * kChunk + (step & 3);
  }
};

// Copy step `step`'s chunk of every lane of the block into its raw
// buffer (all threads; lands by a later cp_async_wait). With `vec` (the
// capacity a multiple of 4, d and val 16-byte aligned) in 16-byte pieces.
template <int ORDER, bool RAGGED>
__device__ __forceinline__ void issue_chunk(const LaneWalk& w, int step) {
  using L = Lane<ORDER>;
  const int z = w.z(step), m3 = 3 * w.slots(step);
  const size_t first = static_cast<size_t>(w.chunk(step)) * kChunk * 3;
  if (w.vec) {
    constexpr int Q = 3 * kChunk / 4;  // 16-byte pieces of one half (d or val)
    for (int i = threadIdx.x; i < w.n_here * 2 * Q; i += blockDim.x) {
      const int j = i / (2 * Q), half = (i / Q) & 1, k = 4 * (i % Q), cell = w.first(j) + z;
      if (k >= m3 || (RAGGED && cell >= w.n_cells)) continue;
      cp_async<16>(w.raw<ORDER>(j, step) + half * 3 * kChunk + k,
                   (half ? w.val : w.d) + static_cast<size_t>(cell) * w.cap * 3 + first + k);
    }
    return;
  }
  for (int i = threadIdx.x; i < w.n_here * L::RAW; i += blockDim.x) {
    const int j = i / L::RAW, e = i % L::RAW, half = e / (3 * kChunk), k = e % (3 * kChunk);
    const int cell = w.first(j) + z;
    if (k >= m3 || (RAGGED && cell >= w.n_cells)) continue;
    cp_async<4>(w.raw<ORDER>(j, step) + half * 3 * kChunk + k,
                (half ? w.val : w.d) + static_cast<size_t>(cell) * w.cap * 3 + first + k);
  }
}

// List the chunk's slots with a non-zero val, in order (one warp a lane;
// none for a cell that is skipped).
template <int ORDER, bool RAGGED>
__device__ __forceinline__ void compact_chunk(const LaneWalk& w, int step) {
  const int lane = threadIdx.x & 31, m = w.slots(step);
  for (int j = threadIdx.x >> 5; j < w.n_here; j += blockDim.x >> 5) {
    const float* rv = w.raw<ORDER>(j, step) + 3 * kChunk;
    const bool keep = (!RAGGED || w.live(j, step)) && lane < m &&
                      (rv[3 * lane] != 0.0f || rv[3 * lane + 1] != 0.0f || rv[3 * lane + 2] != 0.0f);
    const unsigned mask = __ballot_sync(0xffffffffu, keep);
    if (keep) w.kept<ORDER>(j, step)[__popc(mask & ((1u << lane) - 1u))] = lane;
    if (lane == 0) *w.count<ORDER>(j, step) = __popc(mask);
  }
}

// Form the listed slots' records of lane j, by the lane's OWNERS threads
// (e is this thread's index among them): six tasks a kept slot, one per
// weight set (axis x stagger): wz and wy rows as they are, the staggered x
// set times v[0] (av of Jx), the unstaggered one times v[1] and v[2] (av of
// Jy and Jz).
template <int ORDER>
__device__ __forceinline__ void weigh_chunk(const LaneWalk& w, int step, int j, int e) {
  using L = Lane<ORDER>;
  constexpr int T = L::T;
  const int n = *w.count<ORDER>(j, step);
  const int* kept = w.kept<ORDER>(j, step);
  const float* rd = w.raw<ORDER>(j, step);
  float* records = w.lane<ORDER>(j) + (step & 1) * kChunk * L::SLOT;
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

// The pipeline both kernels run. Iteration s contracts step s, forms the
// records of step s + 1, lists the kept slots of step s + 2 and copies the
// raw chunk of step s + 4: each stage reads only what the one before wrote
// an iteration earlier, so one barrier an iteration suffices. After a
// cell's last chunk, the owner (comp, a, b) of lane j calls
// cell_done(step, tile) with its T sums, then starts the next cell from +0.
template <int ORDER, bool RAGGED, typename CellDone>
__device__ __forceinline__ void deposit_walk(const LaneWalk& w, CellDone&& cell_done) {
  using L = Lane<ORDER>;
  constexpr int T = L::T;
  const int steps = w.len * w.n_chunks;
  const int j = threadIdx.x / L::OWNERS, e = threadIdx.x % L::OWNERS;
  const bool owner = j < w.n_here;
  const int comp = e / (T * T), a = (e / T) % T, b = e % T;
  const int sy = comp == 1, sz = comp == 2;

  // at the top of iteration s, step s + 2's raw chunk has landed and step
  // s + 3's is in flight
  issue_chunk<ORDER, RAGGED>(w, 0);
  cp_async_commit();
  if (steps > 1) issue_chunk<ORDER, RAGGED>(w, 1);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  float tile[T];
#pragma unroll
  for (int c = 0; c < T; ++c) tile[c] = 0.0f;
  for (int s = -2; s < steps; ++s) {
    if (s + 4 < steps) issue_chunk<ORDER, RAGGED>(w, s + 4);
    cp_async_commit();
    if (s >= 0 && owner) {
      const float* rec = w.lane<ORDER>(j) + (s & 1) * kChunk * L::SLOT;
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
        cell_done(s, tile);
#pragma unroll
        for (int c = 0; c < T; ++c) tile[c] = 0.0f;
      }
    }
    if (owner && s + 1 >= 0 && s + 1 < steps) weigh_chunk<ORDER>(w, s + 1, j, e);
    if (s + 2 < steps) compact_chunk<ORDER, RAGGED>(w, s + 2);
    cp_async_wait<1>();
    __syncthreads();
  }
}

__device__ __forceinline__ bool aligned_slab(const float* d, const float* val, int cap) {
  return (cap & 3) == 0 && (reinterpret_cast<size_t>(d) & 15) == 0 && (reinterpret_cast<size_t>(val) & 15) == 0;
}

// out: (C, 3, T, T*T) packed tiles; a block owns lanes [blockIdx.x *
// lanes_per_block, +lanes_per_block) of cells_per_lane consecutive cells
// (the last lane may run past C). Owner (comp, a, b) = e stores its T sums
// at out[cell][e * T + c].
template <int ORDER>
__global__ void __launch_bounds__(kDepositThreads)
fused_deposit_kernel(const float* __restrict__ d, const float* __restrict__ val, float* __restrict__ out,
                     int n_cells, int cap, int cells_per_lane, int lanes_per_block) {
  using L = Lane<ORDER>;
  constexpr int T = L::T;
  extern __shared__ __align__(16) float lane_smem[];
  const int n_lanes = (n_cells + cells_per_lane - 1) / cells_per_lane;
  const int lane0 = static_cast<int>(blockIdx.x) * lanes_per_block;
  const LaneWalk w{d, val, lane_smem, lane0, min(lanes_per_block, n_lanes - lane0), cells_per_lane, n_cells, cap,
                   (cap + kChunk - 1) / kChunk, aligned_slab(d, val, cap)};
  const int j = threadIdx.x / L::OWNERS, e = threadIdx.x % L::OWNERS;
  deposit_walk<ORDER, true>(w, [&](int s, const float* tile) {
    if (!w.live(j, s)) return;
    float* o = out + static_cast<size_t>(w.cell(j, s)) * L::OWNERS * T + e * T;
#pragma unroll
    for (int c = 0; c < T; ++c) o[c] = tile[c];
  });
}

// out: (nx*ny, 3, nz+2g, T, T) z-reduced column sums; a block owns
// columns [blockIdx.x * cols_per_block, +cols_per_block), whose nz cells
// are consecutive (cells are z-fastest).
template <int ORDER>
__global__ void __launch_bounds__(kDepositThreads)
fused_deposit_reduced_kernel(const float* __restrict__ d, const float* __restrict__ val, float* __restrict__ out,
                             int n_cols, int nz, int cap, int guard, int cols_per_block) {
  using L = Lane<ORDER>;
  constexpr int T = L::T, BASE = Window<ORDER>::BASE;
  extern __shared__ __align__(16) float lane_smem[];
  const int col0 = static_cast<int>(blockIdx.x) * cols_per_block;
  const LaneWalk w{d, val, lane_smem, col0, min(cols_per_block, n_cols - col0), nz, n_cols * nz, cap,
                   (cap + kChunk - 1) / kChunk, aligned_slab(d, val, cap)};
  const int zp = nz + 2 * guard, o = guard + BASE;

  // this thread's element: (comp, a, b) of column j
  const int j = threadIdx.x / L::OWNERS, e = threadIdx.x % L::OWNERS;
  const bool owner = j < w.n_here;
  const int comp = e / (T * T), a = (e / T) % T, b = e % T;
  float* el = out + (static_cast<size_t>(owner ? col0 + j : 0) * 3 + comp) * zp * T * T + a * T + b;
  if (owner) {  // rows no tap reaches
    for (int z = 0; z < o; ++z) el[static_cast<size_t>(z) * T * T] = 0.0f;
    for (int z = o + nz + T - 1; z < zp; ++z) el[static_cast<size_t>(z) * T * T] = 0.0f;
  }

  float rows[T];
#pragma unroll
  for (int c = 0; c < T; ++c) rows[c] = 0.0f;
  deposit_walk<ORDER, false>(w, [&](int s, const float* tile) {
    // add the cell's tile, store the row no later cell reaches (z + T - 1),
    // slide the window down one row
    const int z = w.z(s);
#pragma unroll
    for (int c = 0; c < T; ++c) rows[c] = __fadd_rn(rows[c], tile[c]);
    el[static_cast<size_t>(z + o + T - 1) * T * T] = rows[T - 1];
#pragma unroll
    for (int c = T - 1; c > 0; --c) rows[c] = rows[c - 1];
    rows[0] = 0.0f;
  });
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

// the wrapper's geometry must be one these kernels take
template <int ORDER>
bool lanes_fit(int lanes_per_block, int threads, size_t smem) {
  using L = Lane<ORDER>;
  return lanes_per_block >= 1 && threads % 32 == 0 && threads >= lanes_per_block * L::OWNERS &&
         threads <= kDepositThreads && smem == static_cast<size_t>(lanes_per_block) * L::FLOATS * sizeof(float);
}

template <int ORDER>
int launch_packed(const float* d, const float* val, float* out, int n_cells, int cap, int cells_per_lane,
                  int lanes_per_block, int threads, size_t smem, cudaStream_t s) {
  if (cells_per_lane < 1 || !lanes_fit<ORDER>(lanes_per_block, threads, smem)) return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(fused_deposit_kernel<ORDER>, smem);
  if (e != cudaSuccess) return e;
  const long long cells_per_block = static_cast<long long>(cells_per_lane) * lanes_per_block;
  const int blocks = static_cast<int>((n_cells + cells_per_block - 1) / cells_per_block);
  fused_deposit_kernel<ORDER><<<blocks, threads, smem, s>>>(d, val, out, n_cells, cap, cells_per_lane,
                                                             lanes_per_block);
  return cudaGetLastError();
}

template <int ORDER>
int launch_reduced(const float* d, const float* val, float* out, int n_cols, int nz, int cap, int guard,
                   int cols_per_block, int threads, size_t smem, cudaStream_t s) {
  if (!lanes_fit<ORDER>(cols_per_block, threads, smem)) return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(fused_deposit_reduced_kernel<ORDER>, smem);
  if (e != cudaSuccess) return e;
  const int blocks = (n_cols + cols_per_block - 1) / cols_per_block;
  fused_deposit_reduced_kernel<ORDER><<<blocks, threads, smem, s>>>(d, val, out, n_cols, nz, cap, guard,
                                                                     cols_per_block);
  return cudaGetLastError();
}

}  // namespace

// Each entry point returns cudaGetLastError() after its launch (0 = launched).
extern "C" int mpic_fused_deposit(const float* d, const float* val, float* out, int n_cells, int cap, int order,
                                  int cells_per_lane, int lanes_per_block, int threads, size_t smem, int device,
                                  cudaStream_t stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  switch (order) {
    case 1: return launch_packed<1>(d, val, out, n_cells, cap, cells_per_lane, lanes_per_block, threads, smem, stream);
    case 2: return launch_packed<2>(d, val, out, n_cells, cap, cells_per_lane, lanes_per_block, threads, smem, stream);
    case 3: return launch_packed<3>(d, val, out, n_cells, cap, cells_per_lane, lanes_per_block, threads, smem, stream);
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
