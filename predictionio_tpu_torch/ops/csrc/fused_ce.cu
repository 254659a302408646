// Fused in-batch softmax cross-entropy of the Two-Tower loss, forward and
// backward, for Hopper (sm_90a). The [B, B] logits never reach device
// memory: each block recomputes its logit tiles from the towers.
//
// Replaces: predictionio_tpu/ops/fused_ce.py::_fwd_kernel (reached through
// _fwd_call) and ::_bwd_kernel (through _bwd_call), the two Pallas kernels
// of the Two-Tower training step (fused_inbatch_ce's forward and backward).
//
// What they compute, for towers a, b [B, D] (f32 in device memory):
//   L_ij = bf16( <bf16(a_i), bf16(b_j)> * inv_temp )   f32 accumulation
//   e_ij = bf16( exp(L_ij) )
//   forward : out_i = sum_j e_ij                                  [B]
//   backward: dL_ij = bf16( e_ij * (c / r_i) + e_ij * (c / s_j) ),
//             out_i = sum_j dL_ij * bf16(b_j)                     [B, D]
// with c = 0.5 * inv_temp / B. The TPU kernels also sum the tile down its
// columns (cs, d_ie) and carry that sum across their sequential grid. CUDA
// blocks run concurrently, so these kernels sum rows only, and the caller
// gets the column sums from a second launch with the towers swapped:
// cs = fwd(ie, ue), d_ie = bwd(ie, ue, cs, rs). The logit's dot product
// runs over d = 0..D-1 in one fmaf chain, and fmaf(x, y, acc) ==
// fmaf(y, x, acc), so the swapped launch sees the same logits bit for bit;
// dL's two products are added with __fadd_rn (never contracted into an
// FMA), so dL is symmetric under the swap too. No atomics: every block
// writes rows it owns, and the result is deterministic.
//
// What bounds them on the H100: at B=8192, D=64 the forward's least time
// is its B^2 exponentials on the MUFU (16 per SM per clock), the
// backward's its 6*B^2*D FLOP on the bf16 tensor cores (the TPU kernel's
// own CostEstimate); device-memory traffic is O(B*D) and far below both.
// This first design uses plain f32 FMAs on the CUDA cores (67 TFLOP/s, not
// the tensor cores' 989), so the FMA rate bounds it, and the swapped
// second launch doubles the forward's work; mma/wgmma, TMA and a one-pass
// column reduction are later work.
//
// Design: a block owns kRows = 64 rows of a, staged once in shared memory
// as bf16-rounded f32 (rounded while staged, so the inner loop has no
// conversions), and walks a contiguous run of kCols = 64-row tiles of b,
// each staged the same way. 256 threads each compute a 4x4 micro-tile of
// logits (rows ty + 16r, columns tx + 16c) with float4 shared-memory reads:
// row stride D + 4 floats is 4 mod 8, so eight threads reading eight rows
// hit eight distinct 16-byte bank groups. The backward writes its 64x64 dL
// tile to shared memory and each thread then accumulates a 4-row x 4-wide
// (per 64 columns of D) piece of out in registers. When B / 64 blocks
// cannot fill the card, the column tiles are split over gridDim.y blocks
// per row block, each writing its partial sums to a scratch slab, and a
// second kernel adds the slabs in split order.
//
// The kernels launch on the caller's stream, do not synchronise and
// allocate nothing; the C entries return cudaGetLastError() of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;       // rows of a owned by a block
constexpr int kCols = 64;       // rows of b per column tile
constexpr int kThreads = 256;   // 16 x 16
constexpr int kMaxD = 256;      // out's registers: 16 per 64 columns of D
constexpr int kDlStride = kRows + 4;  // dL tile [kCols][kRows + 4], float4 rows

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// e = bf16(exp(bf16(acc * inv_temp))): the product and both roundings as
// the TPU kernel takes them; exp by the MUFU (rounded to bf16 after).
__device__ __forceinline__ float exp_logit(float acc, float inv_temp) {
  return round_bf16(__expf(round_bf16(__fmul_rn(acc, inv_temp))));
}

// Rows [row0, row0 + 64) of x [B, D] into s (row stride ld), bf16-rounded.
__device__ __forceinline__ void stage_rows(const float* __restrict__ x, long long row0,
                                           int D, int ld, float* s) {
  const int per_row = D / 4;
  for (int v = threadIdx.x; v < kRows * per_row; v += kThreads) {
    const int i = v / per_row;
    const int d = (v - i * per_row) * 4;
    float4 t = *reinterpret_cast<const float4*>(x + (row0 + i) * D + d);
    t.x = round_bf16(t.x);
    t.y = round_bf16(t.y);
    t.z = round_bf16(t.z);
    t.w = round_bf16(t.w);
    *reinterpret_cast<float4*>(s + i * ld + d) = t;
  }
}

// acc[r][c] = <a_s[ty + 16r], b_s[tx + 16c]>, one fmaf chain over d in order.
__device__ __forceinline__ void logit_tile(const float* a_s, const float* b_s, int D, int ld,
                                           int tx, int ty, float acc[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
  for (int d = 0; d < D; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      av[r] = *reinterpret_cast<const float4*>(a_s + (ty + 16 * r) * ld + d);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      bv[c] = *reinterpret_cast<const float4*>(b_s + (tx + 16 * c) * ld + d);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float t = acc[r][c];
        t = fmaf(av[r].x, bv[c].x, t);
        t = fmaf(av[r].y, bv[c].y, t);
        t = fmaf(av[r].z, bv[c].z, t);
        t = fmaf(av[r].w, bv[c].w, t);
        acc[r][c] = t;
      }
    }
  }
}

// The column tiles [begin, end) of split blockIdx.y.
__device__ __forceinline__ void split_range(int B, int* begin, int* end) {
  const long long tiles = B / kCols;
  *begin = static_cast<int>(tiles * blockIdx.y / gridDim.y);
  *end = static_cast<int>(tiles * (blockIdx.y + 1) / gridDim.y);
}

__global__ void __launch_bounds__(kThreads)
fused_ce_fwd_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    float* __restrict__ out, int B, int D, float inv_temp) {
  extern __shared__ __align__(16) float smem[];
  const int ld = D + 4;
  float* a_s = smem;
  float* b_s = smem + kRows * ld;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  int t0, t1;
  split_range(B, &t0, &t1);

  stage_rows(a, row0, D, ld, a_s);
  float sum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int t = t0; t < t1; ++t) {
    __syncthreads();  // the previous tile's readers are done
    stage_rows(b, static_cast<long long>(t) * kCols, D, ld, b_s);
    __syncthreads();
    float acc[4][4];
    logit_tile(a_s, b_s, D, ld, tx, ty, acc);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) sum[r] += exp_logit(acc[r][c], inv_temp);
  }
  // the 16 threads of a row group are one half-warp: a fixed shuffle tree
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float v = sum[r];
    v += __shfl_xor_sync(0xffffffffu, v, 8);
    v += __shfl_xor_sync(0xffffffffu, v, 4);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    if (tx == 0) out[static_cast<long long>(blockIdx.y) * B + row0 + ty + 16 * r] = v;
  }
}

// kM = ceil(D / 64): the 64-wide column groups of out a thread keeps.
template <int kM>
__global__ void __launch_bounds__(kThreads)
fused_ce_bwd_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    const float* __restrict__ r, const float* __restrict__ s,
                    float* __restrict__ out, int B, int D, float inv_temp, float c) {
  extern __shared__ __align__(16) float smem[];
  const int ld = D + 4;
  float* a_s = smem;
  float* b_s = a_s + kRows * ld;
  float* dl_s = b_s + kCols * ld;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  int t0, t1;
  split_range(B, &t0, &t1);

  stage_rows(a, row0, D, ld, a_s);
  float cr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) cr[i] = __fdiv_rn(c, r[row0 + ty + 16 * i]);
  // out rows 4ty..4ty+3, columns 64m + 4tx .. +3
  float acc2[kM][4][4];
#pragma unroll
  for (int m = 0; m < kM; ++m)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc2[m][i][q] = 0.0f;

  for (int t = t0; t < t1; ++t) {
    __syncthreads();  // the previous tile's readers of b_s and dl_s are done
    const long long col0 = static_cast<long long>(t) * kCols;
    stage_rows(b, col0, D, ld, b_s);
    __syncthreads();
    float acc[4][4];
    logit_tile(a_s, b_s, D, ld, tx, ty, acc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float cs = __fdiv_rn(c, s[col0 + tx + 16 * j]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = exp_logit(acc[i][j], inv_temp);
        const float dl = round_bf16(__fadd_rn(__fmul_rn(e, cr[i]), __fmul_rn(e, cs)));
        dl_s[(tx + 16 * j) * kDlStride + ty + 16 * i] = dl;
      }
    }
    __syncthreads();
    for (int j = 0; j < kCols; ++j) {
      const float4 dv = *reinterpret_cast<const float4*>(dl_s + j * kDlStride + 4 * ty);
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        const int d = 64 * m + 4 * tx;
        if (d < D) {
          const float4 bv = *reinterpret_cast<const float4*>(b_s + j * ld + d);
          const float dr[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc2[m][i][0] = fmaf(dr[i], bv.x, acc2[m][i][0]);
            acc2[m][i][1] = fmaf(dr[i], bv.y, acc2[m][i][1]);
            acc2[m][i][2] = fmaf(dr[i], bv.z, acc2[m][i][2]);
            acc2[m][i][3] = fmaf(dr[i], bv.w, acc2[m][i][3]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    const int d = 64 * m + 4 * tx;
    if (d < D) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long long row = static_cast<long long>(blockIdx.y) * B + row0 + 4 * ty + i;
        *reinterpret_cast<float4*>(out + row * D + d) =
            make_float4(acc2[m][i][0], acc2[m][i][1], acc2[m][i][2], acc2[m][i][3]);
      }
    }
  }
}

// out[i] = sum over s of part[s * n + i], in split order.
__global__ void sum_splits_kernel(const float* __restrict__ part, float* __restrict__ out,
                                  long long n, int splits) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float v = part[i];
    for (int k = 1; k < splits; ++k) v += part[k * n + i];
    out[i] = v;
  }
}

size_t fwd_smem(int D) { return sizeof(float) * (kRows + kCols) * (D + 4); }
size_t bwd_smem(int D) { return fwd_smem(D) + sizeof(float) * kCols * kDlStride; }

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename Kernel>
int capacity_of(Kernel kernel, size_t bytes) {
  cudaError_t e = allow_smem(kernel, bytes);
  if (e != cudaSuccess) return -static_cast<int>(e);
  int per_sm = 0, device = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, bytes);
  if (e == cudaSuccess) e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return -static_cast<int>(e);
  return per_sm * sms;
}

bool bad_shape(int B, int D, int splits) {
  return B < kRows || B % kRows || D < 8 || D % 8 || D > kMaxD || splits < 1 ||
         splits > B / kCols;
}

cudaError_t sum_splits(const float* part, float* out, long long n, int splits, cudaStream_t s) {
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  sum_splits_kernel<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096), threads, 0, s>>>(
      part, out, n, splits);
  return cudaGetLastError();
}

template <int kM>
cudaError_t launch_bwd(const float* a, const float* b, const float* r, const float* s,
                       float* out, int B, int D, int splits, float inv_temp, float c,
                       cudaStream_t stream) {
  const size_t bytes = bwd_smem(D);
  cudaError_t e = allow_smem(fused_ce_bwd_kernel<kM>, bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid(static_cast<unsigned>(B / kRows), static_cast<unsigned>(splits));
  fused_ce_bwd_kernel<kM><<<grid, kThreads, bytes, stream>>>(a, b, r, s, out, B, D, inv_temp, c);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Blocks of one launch the current device holds at once (resident blocks
// per SM times SMs) for the forward (backward == 0) or backward kernel at
// width D; minus a cudaError_t on failure.
int fused_ce_capacity(int D, int backward) {
  if (D < 8 || D % 8 || D > kMaxD) return -static_cast<int>(cudaErrorInvalidValue);
  if (!backward) return capacity_of(fused_ce_fwd_kernel, fwd_smem(D));
  switch ((D + 63) / 64) {
    case 1: return capacity_of(fused_ce_bwd_kernel<1>, bwd_smem(D));
    case 2: return capacity_of(fused_ce_bwd_kernel<2>, bwd_smem(D));
    case 3: return capacity_of(fused_ce_bwd_kernel<3>, bwd_smem(D));
    default: return capacity_of(fused_ce_bwd_kernel<4>, bwd_smem(D));
  }
}

// a, b [B, D], out [B]: contiguous float32 on the current device; scratch
// holds splits * B floats when splits > 1 (else unused). Returns a
// cudaError_t (0 on a clean launch).
int fused_ce_fwd_f32(const float* a, const float* b, float* out, float* scratch, int B, int D,
                     int splits, float inv_temp, void* stream) {
  if (bad_shape(B, D, splits) || (splits > 1 && scratch == nullptr)) return cudaErrorInvalidValue;
  cudaGetLastError();  // launch errors below are this launch's own
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t bytes = fwd_smem(D);
  cudaError_t e = allow_smem(fused_ce_fwd_kernel, bytes);
  if (e != cudaSuccess) return e;
  float* dst = splits > 1 ? scratch : out;
  const dim3 grid(static_cast<unsigned>(B / kRows), static_cast<unsigned>(splits));
  fused_ce_fwd_kernel<<<grid, kThreads, bytes, st>>>(a, b, dst, B, D, inv_temp);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  return sum_splits(scratch, out, B, splits, st);
}

// a, b [B, D], r, s [B], out [B, D]: contiguous float32 on the current
// device; scratch holds splits * B * D floats when splits > 1. c is
// 0.5 * inv_temp / B. Returns a cudaError_t (0 on a clean launch).
int fused_ce_bwd_f32(const float* a, const float* b, const float* r, const float* s, float* out,
                     float* scratch, int B, int D, int splits, float inv_temp, float c,
                     void* stream) {
  if (bad_shape(B, D, splits) || (splits > 1 && scratch == nullptr)) return cudaErrorInvalidValue;
  cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* dst = splits > 1 ? scratch : out;
  cudaError_t e;
  switch ((D + 63) / 64) {
    case 1: e = launch_bwd<1>(a, b, r, s, dst, B, D, splits, inv_temp, c, st); break;
    case 2: e = launch_bwd<2>(a, b, r, s, dst, B, D, splits, inv_temp, c, st); break;
    case 3: e = launch_bwd<3>(a, b, r, s, dst, B, D, splits, inv_temp, c, st); break;
    default: e = launch_bwd<4>(a, b, r, s, dst, B, D, splits, inv_temp, c, st); break;
  }
  if (e != cudaSuccess || splits == 1) return e;
  return sum_splits(scratch, out, static_cast<long long>(B) * D, splits, st);
}

}  // extern "C"
