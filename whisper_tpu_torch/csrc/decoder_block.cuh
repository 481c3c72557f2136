// The two products around the attention of a fused decoder-step block, shared
// by B10a (decoder_self_block.cu) and B10b (decoder_cross_block.cu):
//
//   ln_gemm_kernel:  LN(x) -> r . W + bias for the <= 16 rows of a decode
//                    step; q columns kept in fp32 (times head_dim^-0.5), k
//                    and v columns rounded to bf16 into a row of the
//                    time-major self cache.
//   out_proj_kernel: bf16(ctx . W_o + b_o + x).
//
// Numerics of ln_gemm_kernel.  What B10a writes into the cache is held
// bitwise against the plain PyTorch version, so every value on the way to a
// cached k or v must not depend on the order of a sum.  The LayerNorm
// statistics and the product are therefore accumulated in fp64 and rounded
// to fp32 once: the products of bf16 values are exact in fp64 and a sum of
// a few hundred of them carries an error near 1e-15, so any order rounds to
// the same fp32 value (except where the exact sum lies within 1e-15 of a
// rounding boundary, once in ~1e7 values).  The steps between are single
// IEEE operations: mean32 = fp32(sum / d), rstd32 = fp32(1 / sqrt(var +
// 1e-5)), y = (x - mean32) * rstd32, r = bf16(y * scale + bias), each
// rounded once.  At <= 16 rows the product is 25 MFLOP, which the fp64 units
// do in microseconds; the weights (1.5 MB at d = 512) are the bytes.
#pragma once

#include "common.cuh"

using namespace nvcuda;

namespace {  // one copy per source file that includes this header

constexpr int BLK_RT = 16;      // rows per tile (the batch, padded)
constexpr int BLK_GC = 32;      // output columns per ln_gemm block
constexpr int BLK_GT = 128;     // threads per ln_gemm block: 32 columns x 4
constexpr int BLK_OW = 8;       // K splits (warps) of an out_proj block

__device__ __forceinline__ double warp_sum_f64(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// grid (N / 32, row tiles), 128 threads, dynamic shared memory 16 * D
// doubles.  Column c < D is a q column: qbuf[row, c] = (acc + bias) * qscale
// in fp32.  Columns [D, 2D) and [2D, 3D) (N = 3D only) are k and v: rounded
// to bf16 into k_row / v_row, the [B, D] rows of the time-major cache at the
// step's position.
__global__ void __launch_bounds__(BLK_GT)
ln_gemm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ ln,
               const bf16* __restrict__ w, const bf16* __restrict__ bias,
               float* __restrict__ qbuf, bf16* __restrict__ k_row,
               bf16* __restrict__ v_row, int B, int D, int N, float qscale) {
  extern __shared__ __align__(16) unsigned char blk_smem[];
  double* sR = reinterpret_cast<double*>(blk_smem);   // [BLK_RT][D]
  const int row0 = blockIdx.y * BLK_RT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bf16* lns = ln;
  const bf16* lnb = ln + D;

  for (int r = warp; r < BLK_RT; r += BLK_GT / 32) {
    const int g = row0 + r;
    double* dst = sR + (size_t)r * D;
    if (g < B) {
      const bf16* xr = x + (size_t)g * D;
      double s = 0.0;
      for (int c = lane; c < D; c += 32) s += (double)__bfloat162float(xr[c]);
      const double mean = warp_sum_f64(s) / (double)D;
      double s2 = 0.0;
      for (int c = lane; c < D; c += 32) {
        const double dv = (double)__bfloat162float(xr[c]) - mean;
        s2 += dv * dv;
      }
      const double var = warp_sum_f64(s2) / (double)D;
      const float mean32 = (float)mean;
      const float rstd32 = (float)(1.0 / sqrt(var + 1e-5));
      for (int c = lane; c < D; c += 32) {
        const float y = __fmul_rn(
            __fsub_rn(__bfloat162float(xr[c]), mean32), rstd32);
        const bf16 rv = __float2bfloat16_rn(__fadd_rn(
            __fmul_rn(y, __bfloat162float(lns[c])), __bfloat162float(lnb[c])));
        dst[c] = (double)__bfloat162float(rv);
      }
    } else {
      for (int c = lane; c < D; c += 32) dst[c] = 0.0;
    }
  }
  __syncthreads();

  const int col = blockIdx.x * BLK_GC + lane;
  const int r0 = warp * 4;                  // this thread's four rows
  double acc[4] = {0.0, 0.0, 0.0, 0.0};
  const bf16* wc = w + col;
  for (int k = 0; k < D; ++k) {
    const double wv = (double)__bfloat162float(wc[(size_t)k * N]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      acc[i] = fma(sR[(size_t)(r0 + i) * D + k], wv, acc[i]);
  }
  const float bv = __bfloat162float(bias[col]);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int g = row0 + r0 + i;
    if (g >= B) continue;
    const float v = __fadd_rn((float)acc[i], bv);
    if (col < D)
      qbuf[(size_t)g * D + col] = __fmul_rn(v, qscale);
    else if (col < 2 * D)
      k_row[(size_t)g * D + col - D] = __float2bfloat16_rn(v);
    else
      v_row[(size_t)g * D + col - 2 * D] = __float2bfloat16_rn(v);
  }
}

// out[:, c0:c0+16] = bf16((ctx . W[:, c0:c0+16] + b) + x): a block per 16
// output columns, the D-long sum split over 8 warps (bf16 tensor cores, fp32
// accumulation), the 8 partial tiles added in a fixed order.  ctx has
// ceil(B / 16) * 16 rows; D is a multiple of 128.
__global__ void __launch_bounds__(BLK_OW * 32)
out_proj_kernel(const bf16* __restrict__ ctx, const bf16* __restrict__ w,
                const bf16* __restrict__ bias, const bf16* __restrict__ x,
                bf16* __restrict__ out, int B, int D) {
  __shared__ __align__(128) float sPart[BLK_OW][256];
  const int row0 = blockIdx.y * BLK_RT;
  const int col0 = blockIdx.x * 16;
  const int warp = threadIdx.x / 32;
  const int kper = D / BLK_OW;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  wmma::fill_fragment(acc, 0.0f);
  for (int k = warp * kper; k < (warp + 1) * kper; k += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
    wmma::load_matrix_sync(a, ctx + (size_t)row0 * D + k, D);
    wmma::load_matrix_sync(b, w + (size_t)k * D + col0, D);
    wmma::mma_sync(acc, a, b, acc);
  }
  wmma::store_matrix_sync(sPart[warp], acc, 16, wmma::mem_row_major);
  __syncthreads();
  const int e = threadIdx.x;               // 256 threads, 256 elements
  const int g = row0 + e / 16, col = col0 + e % 16;
  if (g < B) {
    float z = sPart[0][e];
#pragma unroll
    for (int i = 1; i < BLK_OW; ++i) z = __fadd_rn(z, sPart[i][e]);
    z = __fadd_rn(z, __bfloat162float(bias[col]));
    out[(size_t)g * D + col] = __float2bfloat16_rn(
        __fadd_rn(z, __bfloat162float(x[(size_t)g * D + col])));
  }
}

// Launch ln_gemm_kernel; N is D (q only) or 3D (q | k | v).
inline int launch_ln_gemm(const void* x, const void* ln, const void* w,
                          const void* bias, void* qbuf, void* k_row,
                          void* v_row, int B, int D, int N, float qscale,
                          cudaStream_t s) {
  const size_t smem = (size_t)BLK_RT * D * sizeof(double);
  if (smem > 48 * 1024) {
    cudaError_t rc = cudaFuncSetAttribute(
        (const void*)ln_gemm_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  const int row_tiles = (B + BLK_RT - 1) / BLK_RT;
  ln_gemm_kernel<<<dim3(N / BLK_GC, row_tiles), BLK_GT, smem, s>>>(
      (const bf16*)x, (const bf16*)ln, (const bf16*)w, (const bf16*)bias,
      (float*)qbuf, (bf16*)k_row, (bf16*)v_row, B, D, N, qscale);
  return (int)cudaGetLastError();
}

inline int launch_out_proj(const void* ctx, const void* w, const void* bias,
                           const void* x, void* out, int B, int D,
                           cudaStream_t s) {
  const int row_tiles = (B + BLK_RT - 1) / BLK_RT;
  out_proj_kernel<<<dim3(D / 16, row_tiles), BLK_OW * 32, 0, s>>>(
      (const bf16*)ctx, (const bf16*)w, (const bf16*)bias, (const bf16*)x,
      (bf16*)out, B, D);
  return (int)cudaGetLastError();
}

}  // namespace
