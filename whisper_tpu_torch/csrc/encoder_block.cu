// B9a and B9b: the two kernels of the fused encoder block.
//
// B9a, wt_fused_ln_qkv, replaces whisper_tpu/ops/encoder_block.py:
// fused_ln_qkv (_ln_qkv_kernel), whole and column-chunked alike (the
// columns are independent, so one kernel gives both variants' values).
// Contract: x [N, d] bf16 -> LayerNorm (fp32 statistics, eps 1e-5) cast to
// bf16 -> one [d, 3d] product accumulated in fp32 -> + bias in fp32 ->
// bf16 out [N, 3d].
//
// What bounds it on the H100: at whisper-base bucket 16 (N = 24,000,
// d = 512) one call is 2*N*d*3d = 37.7 GFLOP against 24.6 MB of x, 73.7 MB
// of output and 1.6 MB of weights: 38 us of bf16 tensor-core time against
// 30 us of memory time, so neither alone; the output write is the larger
// stream.  Design: a block owns 64 rows; LayerNorm runs once per row into
// a bf16 tile in shared memory, then the block walks its share of the
// 128-column output tiles (gridDim.y blocks share one row tile, so that a
// call of few rows, one 1,500-row chunk, still fills the card), each of 8
// warps holding a 16 x 64 fp32 accumulator (wmma), the weight fragments
// read from global memory (L2).  Rows past N are computed as zeros and
// never stored.
//
// B9b, wt_fused_out_mlp, replaces fused_out_mlp (_out_mlp_kernel).
// Contract: y32 = x + (ctx . O + o_b) in fp32; LayerNorm on the UNROUNDED
// y32 (fp32 statistics), cast to bf16; FC1 + b1 in fp32; tanh GELU -> bf16;
// FC2 + b2 in fp32; out = bf16(float(bf16(y32)) + z): the final residual
// adds the ROUNDED y, as the JAX kernel does.
//
// What bounds it: at the same shapes 2*N*d*(d + 2f) = 113 GFLOP against
// ~78 MB: compute-bound (0.11 ms at the bf16 peak).  Design: B2's (a block
// of 8 warps per 32 rows, the FFN walked in 64-column chunks through
// encoder_ffn.cuh) with the O-projection in front: the ctx tile sits where
// the LN tile will, the fp32 y32 tile stays in shared memory from the
// O-projection to the final residual (66 KB at d = 512), so x and ctx are
// read once and the output written once.
#include "encoder_ffn.cuh"

using namespace nvcuda;
using namespace ffn;

namespace {

// ---------------------------------------------------------------------------
// B9a
// ---------------------------------------------------------------------------

constexpr int QR = 64;         // rows per block
constexpr int QC = 128;        // output columns per tile

template <int D>
__global__ void __launch_bounds__(NT)
ln_qkv_kernel(const bf16* __restrict__ x, const bf16* __restrict__ lns,
              const bf16* __restrict__ lnb, const bf16* __restrict__ w,
              const bf16* __restrict__ bias, bf16* __restrict__ out, int N,
              int C) {
  constexpr int RLD = D + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sR = reinterpret_cast<bf16*>(smem);                      // [QR][RLD]
  float* sStage = reinterpret_cast<float*>(smem + QR * RLD * 2);  // 8 x 256

  const int row0 = blockIdx.x * QR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // ---- LayerNorm: warp w normalises rows 8w .. 8w+7 ----
  for (int rr = 0; rr < QR / 8; ++rr) {
    const int r = warp * (QR / 8) + rr;
    const int g = row0 + r;
    bf16* dst = sR + r * RLD;
    if (g < N) {
      const bf16* xr = x + (size_t)g * D;
      float xv[D / 32];
#pragma unroll
      for (int i = 0; i < D / 32; ++i) xv[i] = __bfloat162float(xr[lane + 32 * i]);
      ln_row<D>(xv, lns, lnb, dst, lane);
    } else {
#pragma unroll
      for (int i = 0; i < D / 32; ++i) dst[lane + 32 * i] = __float2bfloat16_rn(0.0f);
    }
  }
  __syncthreads();

  const int rt = warp / 2;            // this warp's 16-row tile (0..3)
  const int ch = warp % 2;            // its 64-column half of the tile
  float* stage = sStage + warp * 256;
  for (int ct = blockIdx.y; ct < C / QC; ct += gridDim.y) {
    const int col0 = ct * QC + ch * 64;
    acc_frag acc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.0f);
#pragma unroll 2
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, sR + rt * 16 * RLD + kk * 16, RLD);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, w + (size_t)kk * 16 * C + col0 + j * 16, C);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(stage, acc[j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int g = row0 + rt * 16 + e / 16;
        const int col = col0 + j * 16 + e % 16;
        if (g < N)
          out[(size_t)g * C + col] = __float2bfloat16_rn(
              __fadd_rn(stage[e], __bfloat162float(bias[col])));
      }
      __syncwarp();
    }
  }
}

template <int D>
int launch_qkv(const void* x, const void* lns, const void* lnb, const void* w,
               const void* bias, void* out, int N, int C,
               cudaStream_t stream) {
  const size_t smem = (size_t)QR * (D + 8) * 2 + 8 * 256 * 4;
  cudaFuncSetAttribute(ln_qkv_kernel<D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const int row_tiles = (N + QR - 1) / QR;
  // Column groups: enough blocks for two waves of the 132 SMs.
  int groups = (264 + row_tiles - 1) / row_tiles;
  if (groups > C / QC) groups = C / QC;
  if (groups < 1) groups = 1;
  ln_qkv_kernel<D><<<dim3(row_tiles, groups), NT, smem, stream>>>(
      (const bf16*)x, (const bf16*)lns, (const bf16*)lnb, (const bf16*)w,
      (const bf16*)bias, (bf16*)out, N, C);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// B9b
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t out_mlp_smem() {
  return (size_t)R * (D + 4) * 4 + (size_t)R * (D + 8) * 2 +
         (size_t)R * HLD * 4 + (size_t)R * HBLD * 2;
}

template <int D>
__global__ void __launch_bounds__(NT)
out_mlp_kernel(const bf16* __restrict__ x, const bf16* __restrict__ ctx,
               const bf16* __restrict__ ow, const bf16* __restrict__ ob,
               const bf16* __restrict__ lns, const bf16* __restrict__ lnb,
               const bf16* __restrict__ w1, const bf16* __restrict__ b1,
               const bf16* __restrict__ w2, const bf16* __restrict__ b2,
               bf16* __restrict__ out, int N, int F) {
  constexpr int RLD = D + 8;     // bf16 ctx / LN tile row stride
  constexpr int YLD = D + 4;     // fp32 y32 tile row stride
  constexpr int NY = D / 64;     // fp32 accumulator fragments per warp
  extern __shared__ __align__(128) unsigned char smem[];
  float* sY = reinterpret_cast<float*>(smem);                       // [R][YLD]
  bf16* sR = reinterpret_cast<bf16*>(smem + R * YLD * 4);           // [R][RLD]
  float* sH = reinterpret_cast<float*>(smem + R * YLD * 4 + R * RLD * 2);
  bf16* sHb = reinterpret_cast<bf16*>(smem + R * YLD * 4 + R * RLD * 2 +
                                      R * HLD * 4);

  const int row0 = blockIdx.x * R;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rt = warp / 4, ycol0 = (warp % 4) * (D / 4);

  // ---- the ctx tile, where the LN tile will be; rows past N are zeros ----
  for (int e = threadIdx.x; e < R * D; e += NT) {
    const int r = e / D, c = e % D;
    const int g = row0 + r;
    sR[r * RLD + c] = g < N ? ctx[(size_t)g * D + c] : __float2bfloat16_rn(0.0f);
  }
  __syncthreads();

  // ---- y32 = x + (ctx . O + o_b), fp32, into sY ----
  {
    acc_frag o[NY];
#pragma unroll
    for (int j = 0; j < NY; ++j) wmma::fill_fragment(o[j], 0.0f);
#pragma unroll 2
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, sR + rt * 16 * RLD + kk * 16, RLD);
#pragma unroll
      for (int j = 0; j < NY; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, ow + (size_t)kk * 16 * D + ycol0 + j * 16, D);
        wmma::mma_sync(o[j], a, b, o[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < NY; ++j)
      wmma::store_matrix_sync(sY + rt * 16 * YLD + ycol0 + j * 16, o[j], YLD,
                              wmma::mem_row_major);
  }
  __syncthreads();   // sY holds ctx . O; every warp is done reading sR
  for (int e = threadIdx.x; e < R * D; e += NT) {
    const int r = e / D, c = e % D;
    const int g = row0 + r;
    const float xv = g < N ? __bfloat162float(x[(size_t)g * D + c]) : 0.0f;
    sY[r * YLD + c] = __fadd_rn(
        xv, __fadd_rn(sY[r * YLD + c], __bfloat162float(ob[c])));
  }
  __syncthreads();

  // ---- LayerNorm on the unrounded y32: warp w takes rows 4w .. 4w+3 ----
  for (int rr = 0; rr < R / 8; ++rr) {
    const int r = warp * (R / 8) + rr;
    float yv[D / 32];
#pragma unroll
    for (int i = 0; i < D / 32; ++i) yv[i] = sY[r * YLD + lane + 32 * i];
    ln_row<D>(yv, lns, lnb, sR + r * RLD, lane);
  }
  __syncthreads();

  acc_frag z[NY];
  ffn_walk<D>(sR, sH, sHb, w1, b1, w2, F, z);

  // ---- epilogue: out = bf16(float(bf16(y32)) + (z + b2)) ----
  float* stage = sH + warp * 256;
#pragma unroll
  for (int j = 0; j < NY; ++j) {
    wmma::store_matrix_sync(stage, z[j], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = rt * 16 + e / 16;
      const int g = row0 + r;
      const int col = ycol0 + j * 16 + e % 16;
      if (g < N) {
        const float zv = __fadd_rn(stage[e], __bfloat162float(b2[col]));
        const float yb =
            __bfloat162float(__float2bfloat16_rn(sY[r * YLD + col]));
        out[(size_t)g * D + col] = __float2bfloat16_rn(__fadd_rn(yb, zv));
      }
    }
    __syncwarp();
  }
}

template <int D>
int launch_out_mlp(const void* x, const void* ctx, const void* ow,
                   const void* ob, const void* lns, const void* lnb,
                   const void* w1, const void* b1, const void* w2,
                   const void* b2, void* out, int N, int F,
                   cudaStream_t stream) {
  const size_t smem = out_mlp_smem<D>();
  cudaFuncSetAttribute(out_mlp_kernel<D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  out_mlp_kernel<D><<<(N + R - 1) / R, NT, smem, stream>>>(
      (const bf16*)x, (const bf16*)ctx, (const bf16*)ow, (const bf16*)ob,
      (const bf16*)lns, (const bf16*)lnb, (const bf16*)w1, (const bf16*)b1,
      (const bf16*)w2, (const bf16*)b2, (bf16*)out, N, F);
  return (int)cudaGetLastError();
}

}  // namespace

WT_EXPORT int wt_fused_ln_qkv(const void* x, const void* lns, const void* lnb,
                              const void* w, const void* bias, void* out,
                              int n, int d, int c, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (c % QC != 0 || n < 1) return (int)cudaErrorInvalidValue;
  switch (d) {
    case 128: return launch_qkv<128>(x, lns, lnb, w, bias, out, n, c, s);
    case 384: return launch_qkv<384>(x, lns, lnb, w, bias, out, n, c, s);
    case 512: return launch_qkv<512>(x, lns, lnb, w, bias, out, n, c, s);
    case 768: return launch_qkv<768>(x, lns, lnb, w, bias, out, n, c, s);
    case 1024: return launch_qkv<1024>(x, lns, lnb, w, bias, out, n, c, s);
    case 1280: return launch_qkv<1280>(x, lns, lnb, w, bias, out, n, c, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

WT_EXPORT int wt_fused_out_mlp(const void* x, const void* ctx, const void* ow,
                               const void* ob, const void* lns,
                               const void* lnb, const void* w1, const void* b1,
                               const void* w2, const void* b2, void* out,
                               int n, int d, int f, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (f % FC != 0 || n < 1) return (int)cudaErrorInvalidValue;
  switch (d) {
    case 128:
      return launch_out_mlp<128>(x, ctx, ow, ob, lns, lnb, w1, b1, w2, b2, out,
                                 n, f, s);
    case 384:
      return launch_out_mlp<384>(x, ctx, ow, ob, lns, lnb, w1, b1, w2, b2, out,
                                 n, f, s);
    case 512:
      return launch_out_mlp<512>(x, ctx, ow, ob, lns, lnb, w1, b1, w2, b2, out,
                                 n, f, s);
    case 768:
      return launch_out_mlp<768>(x, ctx, ow, ob, lns, lnb, w1, b1, w2, b2, out,
                                 n, f, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
