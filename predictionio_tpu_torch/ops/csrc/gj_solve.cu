// Batched SPD solve x = A^-1 b by Gauss-Jordan elimination without
// pivoting, for Hopper (sm_90a).
//
// Replaces: predictionio_tpu/ops/solve.py::_gj_kernel (reached through
// gj_solve_pallas / spd_solve), the only Pallas kernel on the ALS
// training path. Every ALS normal matrix carries the ALS-WR ridge
// lambda*max(n,1)*I, so the diagonal pivots stay bounded away from zero
// and no pivoting is needed (the same argument the TPU kernel rests on).
// The TPU kernel's P=8 pivot blocks, rank-P MXU updates, VMEM block
// sizing and identity-system padding were TPU choices and are not carried
// over.
//
// The elimination (both kernels below): the pivot row is never
// normalised. At pivot p every row i != p takes
//   f = M[i][p] * (1 / M[p][p]),  M[i][j] = fmaf(-f, M[p][j], M[i][j])
// for j = p+1..K (column K holds b), which reads only column p and row p,
// neither of which is written in that step. After K pivots the matrix is
// diagonal and x[i] = M[i][K] / M[i][i]. Both kernels do exactly this
// arithmetic in this order, so they give the same bits.
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
//   [32768, 64, 64], against 5.9 ms for the one-block kernel below and the
//   0.165 ms byte bound. What bounds it now is shared memory's data path
//   (128 bytes a clock a SM): every lane reads all K - p + 1 values of
//   pivot row p, 2,144 values a system at K = 64, each delivered to 32
//   lanes (~2.1k clocks a system a SM as 544 LDS.128 and 64 LDS.32), and
//   the owner's 608 stores take ~0.6k more: ~0.36 ms at [32768, 64, 64]
//   at 1.98 GHz, before any latency. The elimination without the loads
//   takes most of the kernel's time (gj_solve_split.py, PERF.md "PR 4").
//
// 64 < K <= 256: one thread block of 8 warps per system
// (gj_solve_kernel), unchanged from the first port. [A | b] as K rows of
// stride K+1 floats (odd for K % 8 == 0, so a warp reading down column p
// touches 32 different banks) in shared memory up to K = 128 (66,048
// bytes at K = 128, above the 48 KB default, hence cudaFuncSetAttribute);
// 128 < K <= 256 (up to 263 KB per system, more than the 227 KB a block
// may use) runs the same code on a device-memory scratch copy that the
// caller allocates. Each multiply-add there reads and writes shared
// memory and each pivot takes a block barrier, so shared-memory bandwidth
// and barrier latency bound it, not device memory. gj_solve_f32 picks the
// kernel by K alone.
//
// The kernels launch on the caller's stream, do not synchronise and
// allocate nothing; gj_solve_f32 returns cudaGetLastError() of the launch.

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
constexpr int kThreadsX = 32;  // one warp across the columns of a row
constexpr int kThreadsY = 8;   // eight warps, rows strided by 8
constexpr int kMaxSharedK = 128;
constexpr int kMaxK = 256;     // x is written by one thread per row

template <bool kShared>
__global__ void __launch_bounds__(kThreadsX * kThreadsY)
gj_solve_kernel(const float* __restrict__ A, const float* __restrict__ b,
                float* __restrict__ x, float* scratch, int K) {
  extern __shared__ float smem[];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int ld = K + 1;
  const long long sys = blockIdx.x;
  float* M = kShared ? smem : scratch + sys * static_cast<long long>(K) * ld;
  const float* As = A + sys * static_cast<long long>(K) * K;
  const float* bs = b + sys * K;

  for (int i = ty; i < K; i += kThreadsY) {
    for (int j = tx; j < K; j += kThreadsX) {
      M[i * ld + j] = As[i * K + j];
    }
  }
  const int t = ty * kThreadsX + tx;
  if (t < K) M[t * ld + K] = bs[t];
  __syncthreads();

  for (int p = 0; p < K; ++p) {
    const float inv = 1.0f / M[p * ld + p];
    const float* prow = M + p * ld;
    for (int i = ty; i < K; i += kThreadsY) {
      if (i == p) continue;
      float* row = M + i * ld;
      const float f = row[p] * inv;
      for (int j = p + 1 + tx; j <= K; j += kThreadsX) {
        row[j] = fmaf(-f, prow[j], row[j]);
      }
    }
    __syncthreads();
  }

  if (t < K) x[sys * K + t] = M[t * ld + K] / M[t * ld + t];
}

// ------------------------------------------------------------- launching
// What a launch at (B, K) runs with: shared bytes and threads per block,
// resident blocks per SM (the occupancy query), and the grid.
struct Plan {
  int smem_bytes;
  int threads;
  int blocks_per_sm;
  int grid;
};

struct Args {
  const float* A;
  const float* b;
  float* x;
  float* scratch;
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
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan->smem_bytes);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  }
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

cudaError_t warp_dispatch(int K, long long B, Plan* plan, const Args* args) {
  switch (K) {
    case 8: return warp_path<8>(B, plan, args);
    case 16: return warp_path<16>(B, plan, args);
    case 24: return warp_path<24>(B, plan, args);
    case 32: return warp_path<32>(B, plan, args);
    case 40: return warp_path<40>(B, plan, args);
    case 48: return warp_path<48>(B, plan, args);
    case 56: return warp_path<56>(B, plan, args);
    case 64: return warp_path<64>(B, plan, args);
    default: return cudaErrorInvalidValue;
  }
}

// The block kernel at width K (64 < K <= 256): fills *plan and, when args
// is given, launches.
cudaError_t block_path(int K, long long B, Plan* plan, const Args* args) {
  const bool shared = K <= kMaxSharedK;
  const auto kernel = shared ? gj_solve_kernel<true> : gj_solve_kernel<false>;
  plan->smem_bytes = shared ? static_cast<int>(sizeof(float)) * K * (K + 1) : 0;
  plan->threads = kThreadsX * kThreadsY;
  plan->grid = static_cast<int>(B);
  cudaError_t e = cudaSuccess;
  if (plan->smem_bytes > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan->smem_bytes);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&plan->blocks_per_sm, kernel, plan->threads, plan->smem_bytes);
  }
  if (e != cudaSuccess || args == nullptr || B <= 0) return e;
  if (!shared && args->scratch == nullptr) return cudaErrorInvalidValue;
  const dim3 block(kThreadsX, kThreadsY);
  kernel<<<plan->grid, block, plan->smem_bytes, args->stream>>>(args->A, args->b, args->x, args->scratch, K);
  return cudaGetLastError();
}

cudaError_t dispatch(int K, long long B, Plan* plan, const Args* args) {
  return K <= kWarpMaxK ? warp_dispatch(K, B, plan, args) : block_path(K, B, plan, args);
}

bool bad_shape(long long B, int K) {
  return B < 0 || B > 0x7fffffffLL || K <= 0 || K % 8 || K > kMaxK;
}

}  // namespace

extern "C" {

// Floats of device scratch the caller must pass for a [B, K, K] batch:
// 0 where the system fits in shared memory or registers.
long long gj_solve_scratch_floats(long long B, int K) {
  return K <= kMaxSharedK ? 0 : B * static_cast<long long>(K) * (K + 1);
}

// The launch gj_solve_f32 makes at (B, K) on the current device, in
// plan[0..3]: shared bytes per block, threads per block, resident blocks
// per SM, grid blocks. Returns a cudaError_t.
int gj_solve_plan(long long B, int K, int* plan) {
  if (bad_shape(B, K) || plan == nullptr) return cudaErrorInvalidValue;
  Plan p{};
  const cudaError_t e = dispatch(K, B, &p, nullptr);
  plan[0] = p.smem_bytes;
  plan[1] = p.threads;
  plan[2] = p.blocks_per_sm;
  plan[3] = p.grid;
  return e;
}

// A [B, K, K], b [B, K], x [B, K]: contiguous float32 on the current
// device; for K <= 64, A and b 16-byte aligned (the kernel copies them
// with 16-byte cp.async). Returns a cudaError_t (0 on a clean launch).
int gj_solve_f32(const float* A, const float* b, float* x, float* scratch,
                 long long B, int K, void* stream) {
  if (B == 0) return cudaSuccess;
  if (bad_shape(B, K)) return cudaErrorInvalidValue;
  if (K <= kWarpMaxK && ((reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(b)) & 15)) {
    return cudaErrorMisalignedAddress;
  }
  cudaGetLastError();  // launch errors below are this launch's own
  Plan plan{};
  const Args args{A, b, x, scratch, static_cast<cudaStream_t>(stream)};
  return dispatch(K, B, &plan, &args);
}

}  // extern "C"
