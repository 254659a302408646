// Batched SPD solve x = A^-1 b by Gauss-Jordan elimination without
// pivoting, for Hopper (sm_90a).
//
// Replaces: predictionio_tpu/ops/solve.py::_gj_kernel (reached through
// gj_solve_pallas / spd_solve), the only Pallas kernel on the ALS
// training path. Every ALS normal matrix carries the ALS-WR ridge
// lambda*max(n,1)*I, so the diagonal pivots stay bounded away from zero
// and no pivoting is needed (the same argument the TPU kernel rests on).
//
// K <= 64 (gj_solve_warp_kernel<K>): point Gauss-Jordan. The pivot row is
// never normalised. At pivot p every row i != p takes
//   f = M[i][p] * (1 / M[p][p]),  M[i][j] = fmaf(-f, M[p][j], M[i][j])
// for j = p+1..K (column K holds b), which reads only column p and row p,
// neither of which is written in that step. After K pivots the matrix is
// diagonal and x[i] = M[i][K] / M[i][i].
//
// What bounds it on the H100: the least work is reading A and b once and
// writing x once. At the ALS chunk shape [32768, 64, 64] that is ~0.55
// GB, ~0.165 ms at 3.35 TB/s, against ~3.1 GFLOP of Cholesky-equivalent
// arithmetic (~0.05 ms at 67 TFLOP/s f32), so the bound is bytes. The
// elimination itself executes ~K^3/2 FMAs a system (131k at K = 64),
// about as much time as the copy when every FMA is a register
// instruction, so the copy has to overlap the arithmetic.
//
// K <= 64 (the ALS path: rank 64): one warp per system, [A | b] in
// registers (gj_solve_warp_kernel<K>).
// * Lane l holds rows l and l + 32 (R = ceil(K/32) rows of K + 1 floats;
//   130 at K = 64). K is a template parameter and the pivots are a
//   compile-time recursion with every inner loop unrolled, so every
//   register index is a compile-time constant. Lanes whose row
//   index reaches K hold a copy of row K - 1 and store nothing.
// * Per pivot p, lane p % 32 writes row p (columns p..K) from its register
//   slot p / 32 into one of two per-warp pivot buffers in shared memory;
//   one __syncwarp(), then every lane reads it back as 16-byte broadcasts,
//   takes inv = 1 / M[p][p] itself and updates its rows with register
//   FMAs (the pivot row's own lane takes f = 0). Alternating two buffers
//   makes one __syncwarp() a pivot enough: nothing else synchronises, no
//   block barrier at all. About 4.2k FMA, 1.2k shared-memory and 0.6k
//   reciprocal instructions a system at K = 64.
// * Loading overlaps the elimination: each warp has one staging buffer
//   (K rows at a stride of K + 4 floats, 272 B at K = 64, so the 8 lanes
//   of a quarter-warp LDS.128 hit 8 distinct bank groups; then b), filled
//   by coalesced 16-byte cp.async. Once its lanes have moved a system into
//   registers, the warp issues the copy of its next system into the same
//   buffer, and that copy runs under this system's elimination.
// * A persistent grid of 4-warp blocks, as many as the occupancy query
//   says fit (2 a SM at K = 64: 18.2 KB of shared memory a warp, 72.8 KB
//   a block; __launch_bounds__(128, 2) lets a thread have 255 registers,
//   and ptxas gives it 182 at K = 64 without a spill, where (128, 3) caps
//   it at 168, spills and runs slower), at most ceil(B / 4) blocks; warp w
//   walks systems w, w + W, ...
// * Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W): 0.54 ms at
//   [32768, 64, 64], against 5.9 ms for the first port's one-block kernel
//   and the 0.165 ms byte bound. What bounds it now is shared memory's
//   data path (128 bytes a clock a SM): every lane reads all K - p + 1
//   values of pivot row p, 2,144 values a system at K = 64, each delivered
//   to 32 lanes (~2.1k clocks a system a SM as 544 LDS.128 and 64 LDS.32),
//   and the owner's 608 stores take ~0.6k more: ~0.36 ms at
//   [32768, 64, 64] at 1.98 GHz, before any latency. The elimination
//   without the loads takes most of the kernel's time (gj_solve_split.py,
//   PERF.md section 6).
//
// 64 < K <= 256 (gj_solve_tile_kernel<K>): blocked Gauss-Jordan with the
// TPU kernel's pivot blocks, whose plain version is
// gj_solve_wide_reference. Per block of P = 8 pivots at columns s..s+7:
// D = the pivot rows' diagonal block, Di = D^-1 by an 8-step Gauss-Jordan
// with normalised pivot rows (the TPU kernel's), F = C Di for C = columns
// s..s+7 of every row; every other row takes [A | b] -= F R for R = the
// pivot rows as they were, and the pivot rows become Di R. After K / 8
// blocks A is the identity and column K holds x. The TPU kernel instead
// takes the pivot rows to R - (D Di - Di) R, which cancels: where the
// pivots are large, R and (D Di - Di) R agree in their leading digits.
// On the item Gramians of one ALS sweep of ml20m_shaped(200000) at rank
// 32 (the most-rated item has 15,381 ratings, condition numbers near 50)
// that form is up to 1e-2 off a float64 solve (relative), the library
// Cholesky 2e-6 and this kernel's form 4e-6.
// Columns left of s + 8 are dead after block s (nothing reads them
// again), so the update covers columns s + 8..K only: K^3/2 FMAs a
// system, as in point GJ.
// * What bounds it: at [4096, 128, 128] the bytes take 0.081 ms and GJ's
//   K^3/2 FMAs 0.128 ms at 67 TFLOP/s f32 (Cholesky's K^3/6, the row's
//   bound, 0.045 ms); at [64, 256, 256] the FMAs lead (8.4M a system:
//   0.016 ms on all 132 SMs, Cholesky's 0.005 ms), few systems have to
//   fill the card, and [A | b] (263 KB) fits no single SM's shared
//   memory (227 KB).
//   The first port's kernel did a shared- (K <= 128) or device-memory
//   (K > 128) read-modify-write for every FMA, a block barrier for every
//   pivot, and left 68 of 132 SMs idle at B = 64.
// * A lives in registers for the whole solve. A thread holds 8 rows (one
//   row tile) by Q columns spread cyclically (columns g, g + NG, g + 2 NG,
//   ... of column group g of NG = 16, 32 in a cluster), so as the live
//   columns move right every thread keeps about as many of them as any
//   other: no thread idles as the elimination narrows. Q = ceil(K / NG):
//   64 floats a thread at K = 128 and at K = 256. b lives in shared
//   memory, thread i of a block updating row i's (a b column in registers
//   would take a ninth slot at K = 128 and K = 256, and ptxas spills at
//   K = 256).
// * Per block, a thread reads its 8 rows of G and its Q columns of R from
//   shared memory (broadcasts and 32 consecutive words, no bank
//   conflict) and does 8 x 8 x Q register FMAs: about 4 FMAs a float
//   read at K = 128 rather than the first port's read-modify-write a FMA,
//   so shared memory's data path (32 floats a clock a SM) and the FMA
//   pipes (128 a clock) are about even. Three barriers a block of 8 pivots,
//   not one a pivot: the column block and Di (one warp, shuffles) are
//   written, then G, then the next pivot rows are published.
// * K <= 128: one block of 2K threads a system (16 column groups, K/8
//   row tiles), ~17 KB of shared memory at K = 128, and __launch_bounds__
//   keeping registers to 128 a thread so that two blocks share a SM: one
//   loads its system while the other eliminates.
// * 128 < K <= 256: a cluster of two blocks a system (four above K =
//   224), each holding its share of the row tiles in its registers (32
//   column groups; 448 threads at K = 224, 256 at K = 256). The pivot
//   rows go from their owner's registers into every block's shared
//   memory (distributed shared memory, 32-bit shared::cluster stores),
//   and one cluster barrier a block of 8 pivots orders it. Four SMs'
//   registers hold the 263 KB system of K = 256.
// * Measured: see PERF.md section 6 (chip_smoke.py's [kernel] gj_solve
//   rows, NVIDIA H100 80GB HBM3, 700 W); the first port's kernel took 5.14 ms at
//   [4096, 128, 128] and 3.78 ms at [64, 256, 256].
//
// The kernels launch on the caller's stream, do not synchronise and
// allocate nothing; gj_solve_f32 returns cudaGetLastError() of the launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_sm90.cuh"

namespace {

using mma_sm90::cp_async16;
using mma_sm90::cp_async_commit;
using mma_sm90::cp_async_wait;

// ---------------------------------------------------------------- K <= 64
constexpr int kWarpMaxK = 64;
constexpr int kWarpsPerBlock = 4;
constexpr int kWarpThreads = 32 * kWarpsPerBlock;
// Two blocks a SM: at most 255 registers a thread. Three (168 registers)
// spill at K = 64 and run slower (gj_solve_split.py, PERF.md "PR 4").
constexpr int kWarpMinBlocks = 2;

// floats of one warp's shared memory at width K: the staged A (K rows at
// stride K + 4), the staged b (K), two pivot-row buffers (K + 4 each)
__host__ __device__ constexpr int warp_floats(int K) { return K * (K + 4) + K + 2 * (K + 4); }

// cp.async of system `sys` into a warp's staging buffer, as one group
template <int K>
__device__ __forceinline__ void stage_system(float* stage, const float* __restrict__ A,
                                             const float* __restrict__ b, long long sys, int lane) {
  constexpr int kLd = K + 4;
  constexpr int kRowChunks = K / 4;           // 16-byte chunks of a row
  constexpr int kChunks = K * kRowChunks;
  const float* As = A + sys * (K * K);
#pragma unroll 1  // a rolled loop: the addresses would hold registers the elimination needs
  for (int i = 0; i < (kChunks + 31) / 32; ++i) {
    const int c = lane + 32 * i;               // neighbouring lanes, neighbouring chunks
    if (c < kChunks) cp_async16(stage + (c / kRowChunks) * kLd + (c % kRowChunks) * 4, As + 4 * c);
  }
  if (lane < kRowChunks) cp_async16(stage + K * kLd + 4 * lane, b + sys * K + 4 * lane);
  cp_async_commit();
}

// Pivot P of a warp's system and, by recursion, every pivot after it.
// M[s] is row lane + 32 s of [A | b]; P is a compile-time constant, so
// every register index below is one.
template <int K, int P>
__device__ __forceinline__ void eliminate(float (&M)[(K + 31) / 32][K + 1], float (&diag)[(K + 31) / 32],
                                          float* pivot_rows, int lane) {
  if constexpr (P < K) {
    constexpr int kR = (K + 31) / 32;
    constexpr int ps = P / 32;  // the pivot row's register slot
    constexpr int pl = P % 32;  // and lane
    float* prow = pivot_rows + (P & 1) * (K + 4);
    if (lane == pl) {
#pragma unroll
      for (int c = P / 4; c < K / 4; ++c) {
        *reinterpret_cast<float4*>(prow + 4 * c) =
            make_float4(M[ps][4 * c], M[ps][4 * c + 1], M[ps][4 * c + 2], M[ps][4 * c + 3]);
      }
      prow[K] = M[ps][K];
      diag[ps] = M[ps][P];
    }
    __syncwarp();

    const float4* pv4 = reinterpret_cast<const float4*>(prow);
    const float4 head = pv4[P / 4];
    const float head_v[4] = {head.x, head.y, head.z, head.w};
    const float inv = 1.0f / head_v[P % 4];
    float f[kR];
#pragma unroll
    for (int s = 0; s < kR; ++s) f[s] = (s == ps && lane == pl) ? 0.0f : M[s][P] * inv;
#pragma unroll
    for (int c = P / 4; c < K / 4; ++c) {
      const float4 v = c == P / 4 ? head : pv4[c];
      const float pv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (4 * c + q > P) {
#pragma unroll
          for (int s = 0; s < kR; ++s) M[s][4 * c + q] = fmaf(-f[s], pv[q], M[s][4 * c + q]);
        }
      }
    }
    const float pk = prow[K];
#pragma unroll
    for (int s = 0; s < kR; ++s) M[s][K] = fmaf(-f[s], pk, M[s][K]);

    eliminate<K, P + 1>(M, diag, pivot_rows, lane);
  }
}

template <int K>
__global__ void __launch_bounds__(kWarpThreads, kWarpMinBlocks)
gj_solve_warp_kernel(const float* __restrict__ A, const float* __restrict__ b,
                     float* __restrict__ x, long long B) {
  constexpr int kLd = K + 4;
  constexpr int kR = (K + 31) / 32;  // rows a lane holds
  extern __shared__ __align__(16) float warp_smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* stage = warp_smem + warp * warp_floats(K);
  const float* stage_b = stage + K * kLd;
  float* pivot_rows = stage + K * kLd + K;
  const long long stride = static_cast<long long>(gridDim.x) * kWarpsPerBlock;
  long long sys = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + warp;
  if (sys >= B) return;  // warp-uniform
  stage_system<K>(stage, A, b, sys, lane);

  for (; sys < B; sys += stride) {
    cp_async_wait<0>();
    __syncwarp();  // every lane's copies of this system are visible

    float M[kR][K + 1];
#pragma unroll
    for (int s = 0; s < kR; ++s) {
      const int row = min(lane + 32 * s, K - 1);
      const float4* src = reinterpret_cast<const float4*>(stage + row * kLd);
#pragma unroll
      for (int c = 0; c < K / 4; ++c) {
        const float4 v = src[c];
        M[s][4 * c] = v.x;
        M[s][4 * c + 1] = v.y;
        M[s][4 * c + 2] = v.z;
        M[s][4 * c + 3] = v.w;
      }
      M[s][K] = stage_b[row];
    }
    __syncwarp();  // the staging buffer is free: copy the next system under this one's elimination
    if (sys + stride < B) stage_system<K>(stage, A, b, sys + stride, lane);

    float diag[kR];  // M[row][row], final once its pivot is reached
#pragma unroll
    for (int s = 0; s < kR; ++s) diag[s] = 1.0f;
    eliminate<K, 0>(M, diag, pivot_rows, lane);

#pragma unroll
    for (int s = 0; s < kR; ++s) {
      const int row = lane + 32 * s;
      if (row < K) x[sys * K + row] = M[s][K] / diag[s];
    }
  }
}

// ------------------------------------------------------- 64 < K <= 256
constexpr int kTileMaxK = 256;
constexpr int kPivots = 8;  // the pivot block: the TPU kernel's _PIVOT_BLOCK

// The launch shape of gj_solve_tile_kernel<K>.
template <int K>
struct TileShape {
  // blocks a system: above K = 224 two blocks would take 464..512
  // threads, whose 128 registers ptxas overfills (spills)
  static constexpr int kCluster = K <= 128 ? 1 : K <= 224 ? 2 : 4;
  static constexpr int kGroups = K <= 128 ? 16 : 32;          // column groups (threads across a row tile)
  static constexpr int kTiles = K / kPivots;                   // 8-row tiles of the system
  static constexpr int kTiles0 = (kTiles + kCluster - 1) / kCluster;  // tiles of block 0, the most a block holds
  static constexpr int kRows = kTiles0 * kPivots;
  static constexpr int kThreads = kTiles0 * kGroups;
  static constexpr int kQ = (K + kGroups - 1) / kGroups;      // columns of A a thread holds of each of its rows
  static constexpr int kLd = K + 4;                           // stride of a pivot-row buffer's rows
  // at least 128 registers a thread; in a cluster of four as many as the
  // block needs (a cluster's blocks gain little from sharing a SM)
  static constexpr int kMinBlocks =
      kCluster < 4 && 65536 / (kThreads * 128) > 0 ? 65536 / (kThreads * 128) : 1;
};

// Di = D^-1 for the 8 x 8 block D (row stride ld) by the TPU kernel's
// 8-step Gauss-Jordan with normalised pivot rows, on one warp: lane l
// holds row l % 8 of [D | I]; lanes 0..7 write Di row-major into out.
// Each element of the pivot row is fetched (shuffle) just before the
// lane's own element of that column is updated, so no copy of the pivot
// row is held.
__device__ __forceinline__ void invert_pivot_block(const float* D, int ld, float* out, int lane) {
  const int l = lane & 7;
  float m[kPivots], di[kPivots];
#pragma unroll
  for (int k = 0; k < kPivots; ++k) {
    m[k] = D[l * ld + k];
    di[k] = k == l ? 1.0f : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < kPivots; ++j) {
    const float inv = 1.0f / __shfl_sync(0xffffffffu, m[j], j);
    const float f = l == j ? 0.0f : m[j];
#pragma unroll
    for (int k = 0; k < kPivots; ++k) {
      const float pk = __shfl_sync(0xffffffffu, m[k], j) * inv;
      const float ik = __shfl_sync(0xffffffffu, di[k], j) * inv;
      m[k] = l == j ? pk : fmaf(-f, pk, m[k]);
      di[k] = l == j ? ik : fmaf(-f, ik, di[k]);
    }
  }
  if (lane < kPivots) {
#pragma unroll
    for (int k = 0; k < kPivots; ++k) out[lane * kPivots + k] = di[k];
  }
}

// 32-bit shared::cluster address of `p` (this block's shared memory) in
// the block of rank `rank` of the cluster
__device__ __forceinline__ uint32_t cluster_addr(const void* p, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(mma_sm90::smem_addr(p)), "r"(rank));
  return out;
}

__device__ __forceinline__ void st_cluster(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(addr), "f"(v) : "memory");
}

// Stores v at word `offset` of pivot-row buffer `dst` in every block of
// the cluster (32-bit shared::cluster stores: generic pointers would hold
// 64-bit addresses in registers).
template <int K>
__device__ __forceinline__ void store_all(float* dst, int offset, float v) {
  if constexpr (TileShape<K>::kCluster > 1) {
#pragma unroll
    for (int d = 0; d < TileShape<K>::kCluster; ++d) {
      st_cluster(cluster_addr(dst, static_cast<uint32_t>(d)) + 4u * static_cast<uint32_t>(offset), v);
    }
  } else {
    dst[offset] = v;
  }
}

// The pivot rows of block `blk` (columns blk * 8..K-1), from the registers
// of the row tile that holds them into pivot-row buffer `dst` of every
// block of the cluster. Called by every thread; only that tile's write.
// (Column K, b, is published by the thread that holds it.)
template <int K>
__device__ __forceinline__ void publish_pivot_rows(const float (&M)[kPivots][TileShape<K>::kQ], float* dst,
                                                   int blk, int rank, int tile, int group) {
  using S = TileShape<K>;
  if (rank != blk / S::kTiles0 || tile != blk % S::kTiles0) return;
#pragma unroll
  for (int q = 0; q < S::kQ; ++q) {
    const int c = group + S::kGroups * q;
    if (c >= blk * kPivots && c < K) {
#pragma unroll
      for (int r = 0; r < kPivots; ++r) store_all<K>(dst, r * S::kLd + c, M[r][q]);
    }
  }
}

// One pivot's part of the update: a thread's rows less G[row][p] times
// R[p] on the live columns s + 8..K-1 (g: G[row0..row0+7][p], r: R[p]).
// Where the column groups divide K, every load is issued before the
// first FMA (loads inside the branches wait on one another: 11 % slower
// at K = 128 and 15 % at K = 256). Where they do not, the last slot's
// test of column K stays and the loads stay in the branches: hoisted,
// ptxas spills at K = 120.
template <int K>
__device__ __forceinline__ void update_tile(float (&M)[kPivots][TileShape<K>::kQ], const float* g, const float* r,
                                            int s, int group) {
  using S = TileShape<K>;
  const float4 g_lo = *reinterpret_cast<const float4*>(g);
  const float4 g_hi = *reinterpret_cast<const float4*>(g + 4);
  const float gp[kPivots] = {g_lo.x, g_lo.y, g_lo.z, g_lo.w, g_hi.x, g_hi.y, g_hi.z, g_hi.w};
  if constexpr (K % S::kGroups == 0) {
    float rv[S::kQ];
#pragma unroll
    for (int q = 0; q < S::kQ; ++q) rv[q] = r[group + S::kGroups * q];
#pragma unroll
    for (int q = 0; q < S::kQ; ++q) {
      if (group + S::kGroups * q >= s + kPivots) {
#pragma unroll
        for (int i = 0; i < kPivots; ++i) M[i][q] = fmaf(-gp[i], rv[q], M[i][q]);
      }
    }
  } else {
#pragma unroll
    for (int q = 0; q < S::kQ; ++q) {
      const int c = group + S::kGroups * q;
      if (c >= s + kPivots && c < K) {
        const float rv = r[c];
#pragma unroll
        for (int i = 0; i < kPivots; ++i) M[i][q] = fmaf(-gp[i], rv, M[i][q]);
      }
    }
  }
}

template <int K>
__device__ __forceinline__ void sync_system() {
  if constexpr (TileShape<K>::kCluster > 1) {
    cooperative_groups::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

template <int K>
__global__ void __launch_bounds__(TileShape<K>::kThreads, TileShape<K>::kMinBlocks)
gj_solve_tile_kernel(const float* __restrict__ A, const float* __restrict__ b, float* __restrict__ x) {
  using S = TileShape<K>;
  constexpr int kG = S::kGroups;
  constexpr int kQ = S::kQ;
  constexpr int kLd = S::kLd;
  constexpr int kRows = S::kRows;
  __shared__ __align__(16) float pivot_rows[2][kPivots * kLd];  // R of even and odd blocks, b in column K
  __shared__ __align__(16) float col_block[kPivots * kRows];    // C, [p][row] of this block's rows
  __shared__ __align__(16) float gain[kPivots * kRows];         // G, [p][row]
  __shared__ __align__(16) float dinv[kPivots * kPivots];       // Di, row-major
  __shared__ float rhs[kRows];                                  // b of this block's rows

  int rank = 0;
  if constexpr (S::kCluster > 1) rank = static_cast<int>(cooperative_groups::this_cluster().block_rank());
  const long long sys = blockIdx.x / S::kCluster;
  const int tile0 = rank * S::kTiles0;                      // this block's first row tile
  const int ntiles = min(S::kTiles0, S::kTiles - tile0);    // and how many it holds
  const int nrows = ntiles * kPivots;
  const int t = threadIdx.x;
  const int tile = t / kG;                                  // my row tile, in this block
  const int group = t % kG;                                 // my column group
  const bool holds = tile < ntiles;
  const int row0 = (tile0 + tile) * kPivots;                // the system's index of my first row

  // rows row0..row0+7 of A, columns group + kG q; thread t < nrows holds
  // b of this block's row t in rhs
  float M[kPivots][kQ];
  if (holds) {
    const float* As = A + sys * K * K;
#pragma unroll
    for (int r = 0; r < kPivots; ++r) {
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const int c = group + kG * q;
        M[r][q] = c < K ? As[(row0 + r) * K + c] : 0.0f;
      }
    }
  }
  if (t < nrows) rhs[t] = b[sys * K + tile0 * kPivots + t];
  if constexpr (S::kCluster > 1) sync_system<K>();  // every block of the cluster runs before any remote store
  publish_pivot_rows<K>(M, pivot_rows[0], 0, rank, tile, group);
  if (rank == 0 && t < kPivots) store_all<K>(pivot_rows[0], t * kLd + K, rhs[t]);
  sync_system<K>();

  for (int blk = 0; blk < S::kTiles; ++blk) {
    const int s = blk * kPivots;
    const float* R = pivot_rows[blk & 1];
    // the column block: columns s..s+7 are slot s / kG of groups s % kG + 0..7
    const int cq = s / kG;
    const int cc = group - s % kG;
    if (holds && cc >= 0 && cc < kPivots) {
#pragma unroll
      for (int r = 0; r < kPivots; ++r) {
        float v = M[r][0];
#pragma unroll
        for (int q = 1; q < kQ; ++q) v = q == cq ? M[r][q] : v;
        col_block[cc * kRows + tile * kPivots + r] = v;
      }
    }
    if (t < 32) invert_pivot_block(R + s, kLd, dinv, t);
    __syncthreads();

    // G = C Di; on the pivot rows -Di, whose rows start from 0 below
    const int pivot_tile = blk - tile0;  // the pivot rows' tile in this block, if it holds them
    for (int e = t; e < nrows * kPivots; e += S::kThreads) {
      const int i = e / kPivots;
      const int j = e % kPivots;
      float g = 0.0f;
      if (i / kPivots == pivot_tile) {
        g = -dinv[(i % kPivots) * kPivots + j];
      } else {
#pragma unroll
        for (int p = 0; p < kPivots; ++p) g = fmaf(col_block[p * kRows + i], dinv[p * kPivots + j], g);
      }
      gain[j * kRows + i] = g;
    }
    __syncthreads();

    // [A | b] -= G R on the live columns s + 8..K; the pivot rows become
    // Di R
    if (holds) {
      if (tile == pivot_tile) {
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
#pragma unroll
          for (int r = 0; r < kPivots; ++r) M[r][q] = 0.0f;
        }
      }
      if constexpr (S::kCluster > 1) {
        // a rolled loop: unrolled, the next pivots' loads would hold
        // registers the floats of A need (ptxas spills)
#pragma unroll 1
        for (int p = 0; p < kPivots; ++p) update_tile<K>(M, gain + p * kRows + tile * kPivots, R + p * kLd, s, group);
      } else if constexpr (K % kG == 0) {
        // two pivots at a time: fully unrolled, their hoisted loads spill
#pragma unroll 2
        for (int p = 0; p < kPivots; ++p) update_tile<K>(M, gain + p * kRows + tile * kPivots, R + p * kLd, s, group);
      } else {
#pragma unroll
        for (int p = 0; p < kPivots; ++p) update_tile<K>(M, gain + p * kRows + tile * kPivots, R + p * kLd, s, group);
      }
    }
    if (t < nrows) {
      float v = t / kPivots == pivot_tile ? 0.0f : rhs[t];
#pragma unroll
      for (int p = 0; p < kPivots; ++p) v = fmaf(-gain[p * kRows + t], R[p * kLd + K], v);
      rhs[t] = v;
      if (t / kPivots == blk + 1 - tile0) store_all<K>(pivot_rows[(blk + 1) & 1], (t % kPivots) * kLd + K, v);
    }
    if (blk + 1 < S::kTiles) publish_pivot_rows<K>(M, pivot_rows[(blk + 1) & 1], blk + 1, rank, tile, group);
    sync_system<K>();
  }

  // A is the identity: b holds x
  if (t < nrows) x[sys * K + tile0 * kPivots + t] = rhs[t];
}

// ------------------------------------------------------------- launching
// What a launch at (B, K) runs with: shared bytes and threads per block,
// resident blocks per SM (the occupancy query), the grid, the blocks of a
// cluster (one system's) and the registers of a thread.
struct Plan {
  int smem_bytes;
  int threads;
  int blocks_per_sm;
  int grid;
  int cluster;
  int registers;
};

struct Args {
  const float* A;
  const float* b;
  float* x;
  cudaStream_t stream;
};

cudaError_t sms_of_current_device(int* sms) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  return e;
}

// The warp kernel at width K: fills *plan and, when args is given, launches.
template <int K>
cudaError_t warp_path(long long B, Plan* plan, const Args* args) {
  const auto kernel = gj_solve_warp_kernel<K>;
  plan->smem_bytes = static_cast<int>(sizeof(float)) * kWarpsPerBlock * warp_floats(K);
  plan->threads = kWarpThreads;
  plan->cluster = 1;
  cudaFuncAttributes attr{};
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan->smem_bytes);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  }
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
  plan->registers = attr.numRegs;
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&plan->blocks_per_sm, kernel, kWarpThreads, plan->smem_bytes);
  }
  int sms = 0;
  if (e == cudaSuccess) e = sms_of_current_device(&sms);
  if (e != cudaSuccess) return e;
  if (plan->blocks_per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const long long resident = static_cast<long long>(plan->blocks_per_sm) * sms;
  plan->grid = static_cast<int>(blocks < resident ? blocks : resident);
  if (args == nullptr || B <= 0) return cudaSuccess;
  kernel<<<plan->grid, kWarpThreads, plan->smem_bytes, args->stream>>>(args->A, args->b, args->x, B);
  return cudaGetLastError();
}

// The tile kernel at width K: fills *plan and, when args is given, launches.
template <int K>
cudaError_t tile_path(long long B, Plan* plan, const Args* args) {
  using S = TileShape<K>;
  const auto kernel = gj_solve_tile_kernel<K>;
  cudaFuncAttributes attr{};
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return e;
  plan->smem_bytes = static_cast<int>(attr.sharedSizeBytes);
  plan->threads = S::kThreads;
  plan->cluster = S::kCluster;
  plan->registers = attr.numRegs;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&plan->blocks_per_sm, kernel, S::kThreads, 0);
  if (e != cudaSuccess) return e;
  if (plan->blocks_per_sm < 1) return cudaErrorInvalidConfiguration;
  if (B * S::kCluster > 0x7fffffffLL) return cudaErrorInvalidValue;
  plan->grid = static_cast<int>(B * S::kCluster);  // one system a cluster
  if (args == nullptr || B <= 0) return cudaSuccess;
  cudaLaunchConfig_t config{};
  config.gridDim = dim3(plan->grid);
  config.blockDim = dim3(S::kThreads);
  config.dynamicSmemBytes = 0;
  config.stream = args->stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = S::kCluster;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  config.attrs = cluster;
  config.numAttrs = 1;
  e = cudaLaunchKernelEx(&config, kernel, args->A, args->b, args->x);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

cudaError_t dispatch(int K, long long B, Plan* plan, const Args* args) {
  switch (K) {
    case 8: return warp_path<8>(B, plan, args);
    case 16: return warp_path<16>(B, plan, args);
    case 24: return warp_path<24>(B, plan, args);
    case 32: return warp_path<32>(B, plan, args);
    case 40: return warp_path<40>(B, plan, args);
    case 48: return warp_path<48>(B, plan, args);
    case 56: return warp_path<56>(B, plan, args);
    case 64: return warp_path<64>(B, plan, args);
#define GJ_TILE_CASE(k) \
  case k: return tile_path<k>(B, plan, args);
    GJ_TILE_CASE(72) GJ_TILE_CASE(80) GJ_TILE_CASE(88) GJ_TILE_CASE(96)
    GJ_TILE_CASE(104) GJ_TILE_CASE(112) GJ_TILE_CASE(120) GJ_TILE_CASE(128)
    GJ_TILE_CASE(136) GJ_TILE_CASE(144) GJ_TILE_CASE(152) GJ_TILE_CASE(160)
    GJ_TILE_CASE(168) GJ_TILE_CASE(176) GJ_TILE_CASE(184) GJ_TILE_CASE(192)
    GJ_TILE_CASE(200) GJ_TILE_CASE(208) GJ_TILE_CASE(216) GJ_TILE_CASE(224)
    GJ_TILE_CASE(232) GJ_TILE_CASE(240) GJ_TILE_CASE(248) GJ_TILE_CASE(256)
#undef GJ_TILE_CASE
    default: return cudaErrorInvalidValue;
  }
}

bool bad_shape(long long B, int K) {
  return B < 0 || B > 0x7fffffffLL || K <= 0 || K % kPivots || K > kTileMaxK;
}

}  // namespace

extern "C" {

// The launch gj_solve_f32 makes at (B, K) on the current device, in
// plan[0..5]: shared bytes per block, threads per block, resident blocks
// per SM, grid blocks, blocks a cluster, registers a thread. Returns a
// cudaError_t.
int gj_solve_plan(long long B, int K, int* plan) {
  if (bad_shape(B, K) || plan == nullptr) return cudaErrorInvalidValue;
  Plan p{};
  const cudaError_t e = dispatch(K, B, &p, nullptr);
  plan[0] = p.smem_bytes;
  plan[1] = p.threads;
  plan[2] = p.blocks_per_sm;
  plan[3] = p.grid;
  plan[4] = p.cluster;
  plan[5] = p.registers;
  return e;
}

// A [B, K, K], b [B, K], x [B, K]: contiguous float32 on the current
// device; for K <= 64, A and b 16-byte aligned (the kernel copies them
// with 16-byte cp.async). Returns a cudaError_t (0 on a clean launch).
int gj_solve_f32(const float* A, const float* b, float* x, long long B, int K, void* stream) {
  if (B == 0) return cudaSuccess;
  if (bad_shape(B, K)) return cudaErrorInvalidValue;
  if (K <= kWarpMaxK && ((reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(b)) & 15)) {
    return cudaErrorMisalignedAddress;
  }
  cudaGetLastError();  // launch errors below are this launch's own
  Plan plan{};
  const Args args{A, b, x, static_cast<cudaStream_t>(stream)};
  return dispatch(K, B, &plan, &args);
}

}  // extern "C"
