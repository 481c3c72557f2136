// B1: unmasked encoder self-attention, q/k/v [B*H, T, 64] bf16 -> bf16.
//
// Replaces whisper_tpu/ops/attention.py:fused_attention (_attn_kernel).
// Contract (the JAX kernel's): q arrives pre-scaled by 64^-0.5; scores and
// softmax in fp32; probabilities normalised and THEN cast to bf16; P.V
// accumulated in fp32 and written in bf16.
//
// What bounds it on the H100: at whisper-base bucket 16 (B*H = 128,
// T = 1500) one call is 4*128*1500^2*64 = 74 GFLOP of bf16 matmul against
// 4*128*1500*64*2 = 98 MB of q/k/v/out, so it is compute-bound (the
// scores never leave the chip).  Design: one block per (b*h, 64-query
// tile), 4 warps of 16 query rows each; K/V tiles of 64 keys are staged
// through shared memory and both products run on the bf16 tensor cores
// (wmma 16x16x16, fp32 accumulate).  It is TWO-PASS so that it rounds
// exactly where the JAX kernel does: pass 1 computes each row's max m and
// sum l = sum exp(s - m) (online over key tiles); pass 2 recomputes the
// scores, forms p = bf16(exp(s - m) / l) and accumulates p.V in fp32.  An
// online-softmax (flash) kernel would cast un-normalised probabilities
// instead.  The second QK^T is the price: 1.5x the minimum flops.
//
// Ragged T (1500 is no multiple of 64): query rows >= T are loaded as zero
// and never written; key rows >= T are loaded as zero and masked to -inf.
#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int DH = 64;     // head dim
constexpr int BQ = 64;     // query rows per block
constexpr int BK = 64;     // keys per tile
constexpr int NT = 128;    // threads: 4 warps x 16 query rows
constexpr int SLD = BK + 4;  // fp32 score tile row stride

// rows [r0, r0+64) of a [T, 64] bf16 matrix into smem; rows >= T are zero.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int r0,
                                          int T) {
  const uint4 zero = make_uint4(0, 0, 0, 0);
#pragma unroll
  for (int i = 0; i < (BQ * DH / 8) / NT; ++i) {
    const int idx = threadIdx.x + i * NT;  // one uint4 = 8 bf16
    const int row = idx / (DH / 8), c8 = idx % (DH / 8);
    uint4 v = zero;
    if (r0 + row < T)
      v = reinterpret_cast<const uint4*>(src + (size_t)(r0 + row) * DH)[c8];
    reinterpret_cast<uint4*>(dst + row * DH)[c8] = v;
  }
}

// S[16 x 64] = Q[16 x 64] . K^T for this warp's rows, into sS (fp32).
__device__ __forceinline__ void score_tile(
    const wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>* qa,
    const bf16* sK, float* sSw) {
#pragma unroll
  for (int j = 0; j < BK / 16; ++j) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      // K stored [key][d] row-major == K^T [d][key] column-major.
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
      wmma::load_matrix_sync(kb, sK + j * 16 * DH + kk * 16, DH);
      wmma::mma_sync(acc, qa[kk], kb, acc);
    }
    wmma::store_matrix_sync(sSw + j * 16, acc, SLD, wmma::mem_row_major);
  }
}

__global__ void __launch_bounds__(NT)
attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, bf16* __restrict__ out, int T) {
  __shared__ __align__(128) bf16 sQP[BQ * DH];  // Q tile, later P tile
  __shared__ __align__(128) bf16 sK[BK * DH];
  __shared__ __align__(128) bf16 sV[BK * DH];
  __shared__ __align__(128) float sS[BQ * SLD];

  const int q0 = blockIdx.x * BQ;
  const size_t base = (size_t)blockIdx.y * T * DH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // Softmax bookkeeping: lanes 2r and 2r+1 own row r of this warp's 16,
  // each 32 of the tile's 64 columns.
  const int my_row = warp * 16 + lane / 2;
  const int c_lo = (lane % 2) * 32;
  float* sSw = sS + warp * 16 * SLD;
  bf16* sPw = sQP + warp * 16 * DH;

  load_tile(sQP, q + base, q0, T);
  __syncthreads();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa[DH / 16];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    wmma::load_matrix_sync(qa[kk], sQP + warp * 16 * DH + kk * 16, DH);

  // ---- pass 1: row max m and l = sum exp(s - m) ----
  float m = -INFINITY, l = 0.0f;
  for (int k0 = 0; k0 < T; k0 += BK) {
    __syncthreads();  // previous tile fully consumed
    load_tile(sK, k + base, k0, T);
    __syncthreads();
    score_tile(qa, sK, sSw);
    __syncwarp();
    const float* srow = sS + my_row * SLD + c_lo;
    float tmax = -INFINITY;
#pragma unroll 8
    for (int c = 0; c < 32; ++c)
      if (k0 + c_lo + c < T) tmax = fmaxf(tmax, srow[c]);
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m, tmax);
    float part = 0.0f;
#pragma unroll 8
    for (int c = 0; c < 32; ++c)
      if (k0 + c_lo + c < T) part += expf(srow[c] - m_new);
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    l = l * expf(m - m_new) + part;
    m = m_new;
  }

  // ---- pass 2: p = bf16(exp(s - m) / l), O += p . V ----
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc[DH / 16];
#pragma unroll
  for (int j = 0; j < DH / 16; ++j) wmma::fill_fragment(oacc[j], 0.0f);
  for (int k0 = 0; k0 < T; k0 += BK) {
    __syncthreads();
    load_tile(sK, k + base, k0, T);
    load_tile(sV, v + base, k0, T);
    __syncthreads();
    score_tile(qa, sK, sSw);
    __syncwarp();
    const float* srow = sS + my_row * SLD + c_lo;
    bf16* prow = sQP + my_row * DH + c_lo;
#pragma unroll 8
    for (int c = 0; c < 32; ++c) {
      const float p = (k0 + c_lo + c < T) ? expf(srow[c] - m) / l : 0.0f;
      prow[c] = __float2bfloat16_rn(p);
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
      wmma::load_matrix_sync(pa, sPw + kk * 16, DH);
#pragma unroll
      for (int j = 0; j < DH / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
        wmma::load_matrix_sync(vb, sV + kk * 16 * DH + j * 16, DH);
        wmma::mma_sync(oacc[j], pa, vb, oacc[j]);
      }
    }
    __syncwarp();  // P tile read before the next tile overwrites it
  }

  // ---- epilogue: O (fp32) -> bf16, rows < T only ----
#pragma unroll
  for (int j = 0; j < DH / 16; ++j)
    wmma::store_matrix_sync(sSw + j * 16, oacc[j], SLD, wmma::mem_row_major);
  __syncwarp();
  if (q0 + my_row < T) {
    const float* orow = sS + my_row * SLD + c_lo;
    bf16* dst = out + base + (size_t)(q0 + my_row) * DH + c_lo;
#pragma unroll 8
    for (int c = 0; c < 32; c += 2)
      *reinterpret_cast<__nv_bfloat162*>(dst + c) =
          __floats2bfloat162_rn(orow[c], orow[c + 1]);
  }
}

}  // namespace

WT_EXPORT int wt_fused_attention(const void* q, const void* k, const void* v,
                                 void* out, int bh, int T, void* stream) {
  dim3 grid((T + BQ - 1) / BQ, bh);
  attn_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, T);
  return (int)cudaGetLastError();
}
