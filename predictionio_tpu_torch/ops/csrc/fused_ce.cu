// Fused in-batch softmax cross-entropy of the Two-Tower loss, forward and
// backward, on the bf16 tensor cores of Hopper (sm_90a). The [B, B] logits
// never reach device memory: each block recomputes its logit tiles from
// the towers.
//
// Replaces: predictionio_tpu/ops/fused_ce.py::_fwd_kernel (reached through
// _fwd_call) and ::_bwd_kernel (through _bwd_call), the two Pallas kernels
// of the Two-Tower training step (fused_inbatch_ce's forward and backward).
//
// What they compute, for towers a, b [B, D] (f32 in device memory):
//   L_ij = bf16( <bf16(a_i), bf16(b_j)> * inv_temp )   f32 accumulation
//   e_ij = bf16( exp(L_ij) )
//   forward : rs_i = sum_j e_ij,  cs_j = sum_i e_ij                [B], [B]
//   backward: dL_ij = bf16( e_ij * (c / r_i) + e_ij * (c / s_j) ),
//             out_i = sum_j dL_ij * bf16(b_j)                     [B, D]
// with c = 0.5 * inv_temp / B; dL's two products are added with __fadd_rn
// (never contracted into an FMA). No running max: the towers are
// L2-normalised and inv_temp <= 60.
//
// What bounds them on the H100 at B=8192, D=64: the forward's B^2
// exponentials on the MUFU (16 per SM per clock; 0.016 ms), since its
// logit product is 2*D = 128 FLOP per exponential against the card's
// balance of ~236 (989 TFLOP/s bf16 over 4.18 T exp/s); the backward's
// 6*B^2*D useful FLOP on the bf16 tensor cores, of which it executes
// 8*B^2*D, because d_ie comes from a second launch with the towers swapped
// (bwd(ie, ue, cs, rs)) that recomputes the logits. Device-memory traffic
// is O(B*D) and far below both.
//
// Design:
// * A staging kernel converts a and b to row-major bf16 copies [B, Dp]
//   once per call, Dp = D rounded up to 16 with zero columns (they change
//   no dot product), and the backward's quotients c / r and c / s. The
//   main kernels copy 16-byte chunks of those copies into shared memory
//   with cp.async, which cannot convert. The backward entry stages once
//   for both of its launches: the swapped launch takes the same copies and
//   quotients with the roles of a and b exchanged.
// * A block of 8 warps owns 128 rows of a; each warp keeps its 16 rows as
//   mma A fragments (ldmatrix, once per block). The block walks a run of
//   column tiles of b through a three-stage cp.async ring, copying the
//   next two tiles while it computes on this one; 128 rows a block read b
//   from L2 half as often as 64 would. Shared rows are padded by 8 bf16,
//   so a row's stride is an odd multiple of 16 bytes and the 8 row
//   addresses of an ldmatrix hit 8 distinct bank groups.
// * The logit tile is mma.sync.m16n8k16 bf16 -> f32. The scalar work per
//   element is the scale by inv_temp, two packed roundings to bf16 and the
//   exponential.
// * Forward, one pass for both sums: each thread adds its exponentials
//   into its two rows' partials in registers; the column partials go
//   through a fixed xor-shuffle reduce-scatter over the 8 lanes that share
//   a column, then over the 8 warps in order through shared memory, into
//   a [B/128, B] slab. A small kernel adds the row slab ([splits, B]) and the
//   column slab in index order. The B^2 exponentials are done once.
// * Backward, the FlashAttention-2 forward's shape: dL is formed in
//   registers from the logit tile's C fragments, and two adjacent n8
//   tiles of it, packed to bf16, are the A fragment of the second mma
//   (dL * b), whose B fragments come from the same shared tile by
//   ldmatrix.trans. Each warp keeps its [16, D] rows of out in f32
//   registers. Above D = 128 the A fragments are reread from shared
//   memory and the column tile is 32 rows, to stay in registers.
// * When B / 128 row blocks cannot fill the card, the column tiles are
//   split over gridDim.y blocks per row block; partial sums go to slabs
//   that a second kernel adds in split order.
//
// What it promises: no atomics and a fixed order of every sum, so two
// calls on the same input give bit-identical outputs. What it no longer
// promises: the tensor cores' accumulation order is not an fmaf chain, so
// the swapped launch's logits need not be bit-equal to the first launch's
// (they agree to f32 rounding of the dot product).
//
// The kernels launch on the caller's current device and stream, do not
// synchronise and allocate nothing: the caller passes a workspace of
// fused_ce_workspace() bytes. The C entries return cudaGetLastError() of
// the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_sm90.cuh"

namespace {

using namespace mma_sm90;
using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kRows = 16 * kWarps;  // rows of a a block owns, 16 per warp
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 64;           // rows of b per forward column tile
constexpr int kStages = 3;          // column tiles in flight in the cp.async ring
constexpr int kMaxD = 256;
constexpr int kPad = 8;             // bf16 padding per shared row

__host__ __device__ constexpr int padded_d(int D) { return (D + 15) / 16 * 16; }

// (bf16(exp(bf16(x * t))), the same of y) as f32: the TPU kernel's two
// roundings. The exponential is the accurate expf (ex2 on the MUFU plus a
// range reduction), as PyTorch's exp on the card: __expf's few ulps of
// error round e^6.84375 (= 938.0, a bf16 tie) to the other neighbour.
__device__ __forceinline__ float2 exp_logits(float x, float y, float t) {
  const uint32_t l = pack_bf16(__fmul_rn(x, t), __fmul_rn(y, t));
  const uint32_t e = pack_bf16(expf(bf16_lo(l)), expf(bf16_hi(l)));
  return make_float2(bf16_lo(e), bf16_hi(e));
}

// rows [row0, row0 + rows) of x16 [B, Dp] into s (row stride Dp + kPad)
__device__ __forceinline__ void load_tile(bf16* s, const bf16* __restrict__ x16, long long row0,
                                          int rows, int Dp) {
  const int chunks = Dp / 8;
  for (int v = threadIdx.x; v < rows * chunks; v += kThreads) {
    const int i = v / chunks;
    const int k = v - i * chunks;
    cp_async16(s + i * (Dp + kPad) + 8 * k, x16 + (row0 + i) * Dp + 8 * k);
  }
}

// One step of the column reduce-scatter over c[0, 2 kHalf): the lane keeps
// the half that its lane bit 2 kHalf selects and adds its partner's copy.
template <int kHalf>
__device__ __forceinline__ void scatter_step(float* c, int lane) {
  const bool upper = lane & (2 * kHalf);
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float keep = upper ? c[i + kHalf] : c[i];
    const float send = upper ? c[i] : c[i + kHalf];
    c[i] = keep + __shfl_xor_sync(0xffffffffu, send, 2 * kHalf);
  }
}

// The column tiles [begin, end) of split blockIdx.y.
__device__ __forceinline__ void split_range(int tiles, int* begin, int* end) {
  *begin = static_cast<int>(static_cast<long long>(tiles) * blockIdx.y / gridDim.y);
  *end = static_cast<int>(static_cast<long long>(tiles) * (blockIdx.y + 1) / gridDim.y);
}

// a, b [B, D] f32 -> a16, b16 [B, Dp] bf16 (columns D.. zero), in 16-byte
// chunks; with r non-null also qr = c / r and qs = c / s.
__global__ void stage_kernel(const float* __restrict__ a, const float* __restrict__ b,
                             uint4* __restrict__ a16, uint4* __restrict__ b16,
                             const float* __restrict__ r, const float* __restrict__ s,
                             float* __restrict__ qr, float* __restrict__ qs, int B, int D, float c) {
  const int chunks = padded_d(D) / 8;
  const long long n = static_cast<long long>(B) * chunks;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (long long v = first; v < 2 * n; v += stride) {
    const bool second = v >= n;
    const long long w = second ? v - n : v;
    const long long i = w / chunks;
    const int d = static_cast<int>(w - i * chunks) * 8;
    uint4 out = make_uint4(0u, 0u, 0u, 0u);
    if (d < D) {  // D % 8 == 0: a chunk is all data or all padding
      const float* src = (second ? b : a) + i * D + d;
      const float4 lo = *reinterpret_cast<const float4*>(src);
      const float4 hi = *reinterpret_cast<const float4*>(src + 4);
      out = make_uint4(pack_bf16(lo.x, lo.y), pack_bf16(lo.z, lo.w), pack_bf16(hi.x, hi.y),
                       pack_bf16(hi.z, hi.w));
    }
    (second ? b16 : a16)[w] = out;
  }
  if (r == nullptr) return;
  for (long long i = first; i < B; i += stride) {
    qr[i] = __fdiv_rn(c, r[i]);
    qs[i] = __fdiv_rn(c, s[i]);
  }
}

// kMaxK: the k16 steps the A fragments in registers cover, Dp <= 16 kMaxK.
template <int kMaxK>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const bf16* __restrict__ a16, const bf16* __restrict__ b16, float* __restrict__ row_part,
           float* __restrict__ col_part, int B, int D, float inv_temp) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Dp = padded_d(D), ks_n = Dp / 16, ld = Dp + kPad;
  bf16* a_s = reinterpret_cast<bf16*>(smem);
  bf16* b_s = a_s + kRows * ld;                                         // kStages of kCols rows
  float* col_s = reinterpret_cast<float*>(b_s + kStages * kCols * ld);  // [kWarps][kCols]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  int t0, t1;
  split_range(B / kCols, &t0, &t1);

  load_tile(a_s, a16, row0, kRows, Dp);
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {  // one group per stage, empty past t1
    if (t0 + k < t1) load_tile(b_s + k * kCols * ld, b16, static_cast<long long>(t0 + k) * kCols, kCols, Dp);
    cp_async_commit();
  }

  // this lane's ldmatrix row: A over rows 16 warp.., B over a pair of n8 tiles
  const bf16* a_row = a_s + (16 * warp + (lane & 15)) * ld + (lane >> 4) * 8;
  const int b_off = ((lane & 7) + ((lane >> 4) << 3)) * ld + ((lane >> 3) & 1) * 8;
  uint32_t af[kMaxK][4];
  float rsum0 = 0.0f, rsum1 = 0.0f;  // rows g and g + 8 of this warp

  for (int t = t0; t < t1; ++t) {
    const int stage = (t - t0) % kStages;
    cp_async_wait<kStages - 2>();  // tile t has landed
    __syncthreads();               // and every warp is done with tile t - 1
    {
      const int next = t + kStages - 1;
      if (next < t1)
        load_tile(b_s + ((next - t0) % kStages) * kCols * ld, b16, static_cast<long long>(next) * kCols, kCols, Dp);
      cp_async_commit();
    }
    if (t == t0) {
#pragma unroll
      for (int ks = 0; ks < kMaxK; ++ks)
        if (ks < ks_n) ldmatrix_x4(af[ks], a_row + 16 * ks);
    }
    const bf16* bt = b_s + stage * kCols * ld + b_off;
    float acc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < kMaxK; ++ks) {
      if (ks < ks_n) {
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          uint32_t bf[4];
          ldmatrix_x4(bf, bt + 16 * p * ld + 16 * ks);
          mma_bf16(acc[2 * p], af[ks], bf[0], bf[1]);
          mma_bf16(acc[2 * p + 1], af[ks], bf[2], bf[3]);
        }
      }
    }
    float c[16];  // c[2n + h]: column 8n + 2q + h over rows g, g + 8
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 e0 = exp_logits(acc[n][0], acc[n][1], inv_temp);  // row g
      const float2 e1 = exp_logits(acc[n][2], acc[n][3], inv_temp);  // row g + 8
      rsum0 += e0.x;
      rsum0 += e0.y;
      rsum1 += e1.x;
      rsum1 += e1.y;
      c[2 * n] = e0.x + e1.x;
      c[2 * n + 1] = e0.y + e1.y;
    }
    // Reduce-scatter over the 8 lanes of this q (lane bits 4, 3, 2 = bits
    // 2, 1, 0 of g): each step a lane keeps the half of its values its bit
    // selects and adds its partner's copy of that half. After three steps
    // c[0], c[1] hold columns 8g + 2q, + 1 over the warp's 16 rows: 14
    // shuffles where a tree per column takes 48.
    scatter_step<8>(c, lane);
    scatter_step<4>(c, lane);
    scatter_step<2>(c, lane);
    *reinterpret_cast<float2*>(col_s + warp * kCols + 8 * g + 2 * q) = make_float2(c[0], c[1]);
    __syncthreads();  // col_s is whole
    if (threadIdx.x < kCols) {
      float v = col_s[threadIdx.x];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) v += col_s[w * kCols + threadIdx.x];
      col_part[static_cast<long long>(blockIdx.x) * B + static_cast<long long>(t) * kCols + threadIdx.x] = v;
    }
  }
  rsum0 += __shfl_xor_sync(0xffffffffu, rsum0, 1);
  rsum0 += __shfl_xor_sync(0xffffffffu, rsum0, 2);
  rsum1 += __shfl_xor_sync(0xffffffffu, rsum1, 1);
  rsum1 += __shfl_xor_sync(0xffffffffu, rsum1, 2);
  if (q == 0) {
    float* dst = row_part + static_cast<long long>(blockIdx.y) * B + row0 + 16 * warp + g;
    dst[0] = rsum0;
    dst[8] = rsum1;
  }
}

constexpr int kSumCols = 32;  // columns of the slab sum per block
constexpr int kSumParts = 8;  // row groups of the slab a block's threads split

// rs[i] = sum over splits of row_part[s][i], in split order; cs[j] = the sum
// over row blocks k of col_part[k][j], as kSumParts groups of consecutive k,
// each summed in order, then the groups in order. Block x sums columns
// [32x, 32x + 32) and the row sums of the same indices.
__global__ void __launch_bounds__(kSumCols * kSumParts)
reduce_fwd_kernel(const float* __restrict__ row_part, const float* __restrict__ col_part,
                  float* __restrict__ rs, float* __restrict__ cs, int B, int splits) {
  __shared__ float part[kSumParts][kSumCols];
  const int col = threadIdx.x % kSumCols, grp = threadIdx.x / kSumCols;
  const int j = blockIdx.x * kSumCols + col;
  const int blocks = B / kRows;
  const int k0 = blocks * grp / kSumParts, k1 = blocks * (grp + 1) / kSumParts;
  float x = 0.0f;
#pragma unroll 4
  for (int k = k0; k < k1; ++k) x += col_part[static_cast<long long>(k) * B + j];
  part[grp][col] = x;
  __syncthreads();
  if (grp == 0) {
#pragma unroll
    for (int k = 1; k < kSumParts; ++k) x += part[k][col];
    cs[j] = x;
  } else if (grp == 1) {
    float y = row_part[j];
    for (int k = 1; k < splits; ++k) y += row_part[static_cast<long long>(k) * B + j];
    rs[j] = y;
  }
}

// kMaxK as in fwd_kernel; kN rows of b per column tile. Up to kMaxK = 8
// the A fragments stay in registers; above, they are reread each tile.
template <int kMaxK, int kN>
__global__ void __launch_bounds__(kThreads)
bwd_kernel(const bf16* __restrict__ a16, const bf16* __restrict__ b16, const float* __restrict__ qr,
           const float* __restrict__ qs, float* __restrict__ out, int B, int D, float inv_temp) {
  constexpr bool kHoldA = kMaxK <= 8;
  constexpr int kNT = kN / 8;  // n8 tiles of the logit tile
  extern __shared__ __align__(16) unsigned char smem[];
  const int Dp = padded_d(D), ks_n = Dp / 16, ld = Dp + kPad;
  bf16* a_s = reinterpret_cast<bf16*>(smem);
  bf16* b_s = a_s + kRows * ld;                                    // kStages of kN rows
  float* q_s = reinterpret_cast<float*>(b_s + kStages * kN * ld);  // kStages of kN quotients
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  int t0, t1;
  split_range(B / kN, &t0, &t1);

  auto load_stage = [&](int t, int stage) {
    load_tile(b_s + stage * kN * ld, b16, static_cast<long long>(t) * kN, kN, Dp);
    if (threadIdx.x < kN / 4) cp_async16(q_s + stage * kN + 4 * threadIdx.x, qs + t * kN + 4 * threadIdx.x);
  };
  load_tile(a_s, a16, row0, kRows, Dp);
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (t0 + k < t1) load_stage(t0 + k, k);
    cp_async_commit();
  }

  const bf16* a_row = a_s + (16 * warp + (lane & 15)) * ld + (lane >> 4) * 8;
  const int b_off = ((lane & 7) + ((lane >> 4) << 3)) * ld + ((lane >> 3) & 1) * 8;
  const int bt_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8;  // .trans
  const float qr0 = qr[row0 + 16 * warp + g], qr1 = qr[row0 + 16 * warp + g + 8];
  uint32_t af[kHoldA ? kMaxK : 1][4];
  float o[2 * kMaxK][4];
#pragma unroll
  for (int n = 0; n < 2 * kMaxK; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;

  for (int t = t0; t < t1; ++t) {
    const int stage = (t - t0) % kStages;
    cp_async_wait<kStages - 2>();  // tile t has landed
    __syncthreads();               // and every warp is done with tile t - 1
    if (t + kStages - 1 < t1) load_stage(t + kStages - 1, (t - t0 + kStages - 1) % kStages);
    cp_async_commit();
    if constexpr (kHoldA) {
      if (t == t0) {
#pragma unroll
        for (int ks = 0; ks < kMaxK; ++ks)
          if (ks < ks_n) ldmatrix_x4(af[ks], a_row + 16 * ks);
      }
    }
    const bf16* bt = b_s + stage * kN * ld;
    const float* qt = q_s + stage * kN;
    float acc[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < kMaxK; ++ks) {
      if (ks < ks_n) {
        const int ia = kHoldA ? ks : 0;
        if constexpr (!kHoldA) ldmatrix_x4(af[0], a_row + 16 * ks);
#pragma unroll
        for (int p = 0; p < kNT / 2; ++p) {
          uint32_t bf[4];
          ldmatrix_x4(bf, bt + b_off + 16 * p * ld + 16 * ks);
          mma_bf16(acc[2 * p], af[ia], bf[0], bf[1]);
          mma_bf16(acc[2 * p + 1], af[ia], bf[2], bf[3]);
        }
      }
    }
    // dL for 16 columns at a time is the A fragment of one k16 step of dL * b
#pragma unroll
    for (int kk = 0; kk < kNT / 2; ++kk) {
      uint32_t dl[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = 2 * kk + h;
        const float2 e0 = exp_logits(acc[n][0], acc[n][1], inv_temp);  // row g
        const float2 e1 = exp_logits(acc[n][2], acc[n][3], inv_temp);  // row g + 8
        const float2 qc = *reinterpret_cast<const float2*>(qt + 8 * n + 2 * q);
        dl[2 * h] = pack_bf16(__fadd_rn(__fmul_rn(e0.x, qr0), __fmul_rn(e0.x, qc.x)),
                              __fadd_rn(__fmul_rn(e0.y, qr0), __fmul_rn(e0.y, qc.y)));
        dl[2 * h + 1] = pack_bf16(__fadd_rn(__fmul_rn(e1.x, qr1), __fmul_rn(e1.x, qc.x)),
                                  __fadd_rn(__fmul_rn(e1.y, qr1), __fmul_rn(e1.y, qc.y)));
      }
#pragma unroll
      for (int dp = 0; dp < kMaxK; ++dp) {
        if (dp < ks_n) {  // n8 tiles 2 dp, 2 dp + 1 of out
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, bt + bt_off + 16 * kk * ld + 16 * dp);
          mma_bf16(o[2 * dp], dl, bf[0], bf[1]);
          mma_bf16(o[2 * dp + 1], dl, bf[2], bf[3]);
        }
      }
    }
  }
  float* dst = out + static_cast<long long>(blockIdx.y) * B * D + (row0 + 16 * warp + g) * D + 2 * q;
#pragma unroll
  for (int n = 0; n < 2 * kMaxK; ++n) {
    if (8 * n < D) {
      *reinterpret_cast<float2*>(dst + 8 * n) = make_float2(o[n][0], o[n][1]);
      *reinterpret_cast<float2*>(dst + 8 * D + 8 * n) = make_float2(o[n][2], o[n][3]);
    }
  }
}

// out[i] = sum over s of part[s * n + i], in split order.
__global__ void sum_splits_kernel(const float* __restrict__ part, float* __restrict__ out, long long n,
                                  int splits) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n; i += stride) {
    float v = part[i];
    for (int k = 1; k < splits; ++k) v += part[k * n + i];
    out[i] = v;
  }
}

// ---------------------------------------------------------------- host side

int max_k(int D) {
  const int ks = padded_d(D) / 16;
  return ks <= 4 ? 4 : ks <= 8 ? 8 : 16;
}

size_t fwd_smem(int D) {
  return sizeof(bf16) * (kRows + kStages * kCols) * (padded_d(D) + kPad) + sizeof(float) * kWarps * kCols;
}

size_t bwd_smem(int D, int n) {
  return sizeof(bf16) * (kRows + kStages * n) * (padded_d(D) + kPad) + sizeof(float) * kStages * n;
}

size_t align256(size_t bytes) { return (bytes + 255) / 256 * 256; }

// The workspace: a16, b16 [B, Dp] bf16; forward: row slab [splits, B] and
// column slab [B / 128, B]; backward: qr, qs [B] and, with splits > 1, the
// partial outputs [splits, B, D] (of one launch, then of the next).
struct Workspace {
  bf16 *a16, *b16;
  float *p0, *p1, *p2;
};

size_t workspace_bytes(int B, int D, int splits, bool backward, Workspace* w, char* base) {
  const size_t n16 = align256(sizeof(bf16) * static_cast<size_t>(B) * padded_d(D));
  const size_t sizes[3] = {
      align256(sizeof(float) * (backward ? B : static_cast<size_t>(splits) * B)),
      align256(sizeof(float) * (backward ? B : static_cast<size_t>(B / kRows) * B)),
      backward && splits > 1 ? align256(sizeof(float) * static_cast<size_t>(splits) * B * D) : 0,
  };
  if (w != nullptr) {
    w->a16 = reinterpret_cast<bf16*>(base);
    w->b16 = reinterpret_cast<bf16*>(base + n16);
    w->p0 = reinterpret_cast<float*>(base + 2 * n16);
    w->p1 = reinterpret_cast<float*>(base + 2 * n16 + sizes[0]);
    w->p2 = reinterpret_cast<float*>(base + 2 * n16 + sizes[0] + sizes[1]);
  }
  return 2 * n16 + sizes[0] + sizes[1] + sizes[2];
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
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
  return B < kRows || B % kRows || D < 8 || D % 8 || D > kMaxD || splits < 1 || splits > B / kCols;
}

cudaError_t stage(const float* a, const float* b, const float* r, const float* s, const Workspace& w,
                  int B, int D, float c, cudaStream_t st) {
  const long long work = 2LL * B * (padded_d(D) / 8);
  const long long blocks = (work + 255) / 256;
  stage_kernel<<<static_cast<unsigned>(blocks < 2048 ? blocks : 2048), 256, 0, st>>>(
      a, b, reinterpret_cast<uint4*>(w.a16), reinterpret_cast<uint4*>(w.b16), r, s, w.p0, w.p1, B, D, c);
  return cudaGetLastError();
}

template <int kMaxK>
cudaError_t launch_fwd(const Workspace& w, int B, int D, int splits, float inv_temp, cudaStream_t st) {
  const size_t bytes = fwd_smem(D);
  cudaError_t e = allow_smem(fwd_kernel<kMaxK>, bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid(static_cast<unsigned>(B / kRows), static_cast<unsigned>(splits));
  fwd_kernel<kMaxK><<<grid, kThreads, bytes, st>>>(w.a16, w.b16, w.p0, w.p1, B, D, inv_temp);
  return cudaGetLastError();
}

template <int kMaxK, int kN>
cudaError_t launch_bwd(const bf16* a16, const bf16* b16, const float* qr, const float* qs, float* out,
                       int B, int D, int splits, float inv_temp, cudaStream_t st) {
  const size_t bytes = bwd_smem(D, kN);
  cudaError_t e = allow_smem(bwd_kernel<kMaxK, kN>, bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid(static_cast<unsigned>(B / kRows), static_cast<unsigned>(splits));
  bwd_kernel<kMaxK, kN><<<grid, kThreads, bytes, st>>>(a16, b16, qr, qs, out, B, D, inv_temp);
  return cudaGetLastError();
}

// out = dL * b for the staged a16, b16 and quotients qr, qs: the backward
// kernel, then with splits > 1 the sum of its partial outputs (in part).
cudaError_t backward_pass(const bf16* a16, const bf16* b16, const float* qr, const float* qs, float* part,
                          float* out, int B, int D, int splits, float inv_temp, cudaStream_t st) {
  float* dst = splits > 1 ? part : out;
  cudaError_t e;
  switch (max_k(D)) {
    case 4: e = launch_bwd<4, 64>(a16, b16, qr, qs, dst, B, D, splits, inv_temp, st); break;
    case 8: e = launch_bwd<8, 64>(a16, b16, qr, qs, dst, B, D, splits, inv_temp, st); break;
    default: e = launch_bwd<16, 32>(a16, b16, qr, qs, dst, B, D, splits, inv_temp, st); break;
  }
  if (e != cudaSuccess || splits == 1) return e;
  const long long n = static_cast<long long>(B) * D;
  const long long blocks = (n + 255) / 256;
  sum_splits_kernel<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096), 256, 0, st>>>(part, out, n, splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of the workspace one call of the forward (backward == 0) or
// backward takes at [B, D] with `splits` column splits.
size_t fused_ce_workspace(int B, int D, int splits, int backward) {
  return workspace_bytes(B, D, splits, backward != 0, nullptr, nullptr);
}

// Blocks of one launch the current device holds at once (resident blocks
// per SM times SMs) for the forward (backward == 0) or backward kernel at
// width D; minus a cudaError_t on failure.
int fused_ce_capacity(int D, int backward) {
  if (D < 8 || D % 8 || D > kMaxD) return -static_cast<int>(cudaErrorInvalidValue);
  switch (max_k(D) + (backward ? 100 : 0)) {
    case 4: return capacity_of(fwd_kernel<4>, fwd_smem(D));
    case 8: return capacity_of(fwd_kernel<8>, fwd_smem(D));
    case 16: return capacity_of(fwd_kernel<16>, fwd_smem(D));
    case 104: return capacity_of(bwd_kernel<4, 64>, bwd_smem(D, 64));
    case 108: return capacity_of(bwd_kernel<8, 64>, bwd_smem(D, 64));
    default: return capacity_of(bwd_kernel<16, 32>, bwd_smem(D, 32));
  }
}

// a, b [B, D] -> sums [2, B] (rs, then cs): contiguous float32 on the
// current device; work holds fused_ce_workspace(B, D, splits, 0) bytes,
// 256-byte aligned. Three launches on `stream`: staging, the kernel, the
// slab sums. Returns a cudaError_t (0 on clean launches).
int fused_ce_fwd(const float* a, const float* b, float* sums, void* work, int B, int D, int splits,
                 float inv_temp, void* stream) {
  if (bad_shape(B, D, splits) || work == nullptr) return cudaErrorInvalidValue;
  cudaGetLastError();  // launch errors below are this call's own
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Workspace w;
  workspace_bytes(B, D, splits, false, &w, static_cast<char*>(work));
  cudaError_t e = stage(a, b, nullptr, nullptr, w, B, D, 0.0f, st);
  if (e != cudaSuccess) return e;
  switch (max_k(D)) {
    case 4: e = launch_fwd<4>(w, B, D, splits, inv_temp, st); break;
    case 8: e = launch_fwd<8>(w, B, D, splits, inv_temp, st); break;
    default: e = launch_fwd<16>(w, B, D, splits, inv_temp, st); break;
  }
  if (e != cudaSuccess) return e;
  reduce_fwd_kernel<<<B / kSumCols, kSumCols * kSumParts, 0, st>>>(w.p0, w.p1, sums, sums + B, B, splits);
  return cudaGetLastError();
}

// a, b [B, D], r, s [B] -> d_a, d_b [B, D]: contiguous float32 on the
// current device; work holds fused_ce_workspace(B, D, splits, 1) bytes.
// c is 0.5 * inv_temp / B. One staging, then the kernel twice on `stream`:
// d_a = bwd(a, b, r, s), and d_b = bwd(b, a, s, r) on the same staged
// copies. Returns a cudaError_t (0 on clean launches).
int fused_ce_bwd(const float* a, const float* b, const float* r, const float* s, float* d_a, float* d_b,
                 void* work, int B, int D, int splits, float inv_temp, float c, void* stream) {
  if (bad_shape(B, D, splits) || work == nullptr) return cudaErrorInvalidValue;
  cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Workspace w;
  workspace_bytes(B, D, splits, true, &w, static_cast<char*>(work));
  cudaError_t e = stage(a, b, r, s, w, B, D, c, st);
  if (e != cudaSuccess) return e;
  e = backward_pass(w.a16, w.b16, w.p0, w.p1, w.p2, d_a, B, D, splits, inv_temp, st);
  if (e != cudaSuccess) return e;
  return backward_pass(w.b16, w.a16, w.p1, w.p0, w.p2, d_b, B, D, splits, inv_temp, st);
}

}  // extern "C"
