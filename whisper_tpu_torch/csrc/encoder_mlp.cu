// B2: fused encoder MLP, x [N, d] bf16 -> x + FC2(GELU_tanh(FC1(LN(x)))).
//
// Replaces whisper_tpu/ops/encoder_mlp.py:fused_encoder_mlp (_mlp_kernel),
// and by design its FFN-chunked twin _fused_mlp_chunked (_mlp_kernel_
// chunked): this kernel always streams the FFN in chunks of 64 columns,
// so it has no VMEM-style budget and takes any d in the instantiated set.
// Contract (the JAX kernel's): LayerNorm with fp32 statistics (eps 1e-5),
// its output cast to bf16; FC1 + b1 accumulated in fp32; tanh GELU in
// fp32, cast to bf16; FC2 + b2 accumulated in fp32; + x in fp32; bf16 out.
// The weights arrive dense (int8 weights are dequantized by the caller,
// q.bf16 * s.bf16, as the JAX model does).
//
// What bounds it on the H100: at whisper-base bucket 16 (N = 24,000 rows,
// d = 512, f = 2048) one call is 4*N*d*f = 101 GFLOP against ~53 MB of
// activations and weights: compute-bound.  Design: one block per 32 rows
// (750 blocks), 8 warps.  LN runs once per row into a bf16 tile in shared
// memory; the FFN is walked in 64-column chunks: h = r.W1[:, c] on the
// bf16 tensor cores (wmma, fp32 accumulate), bias + GELU in fp32 into a
// bf16 tile, then y += h.W2[c, :] into fp32 accumulators that stay in
// registers for the whole walk, so the [N, f] intermediate never touches
// device memory.  Weight fragments are read straight from global memory
// (both matrices, 4 MB, stay in the 50 MB L2).  The fp32 adds and
// multiplies outside the matmuls use __fadd_rn/__fmul_rn so that the
// compiler does not contract them into FMAs the JAX kernel does not use.
#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int R = 32;          // rows per block
constexpr int FC = 64;         // FFN columns per chunk
constexpr int NT = 256;        // 8 warps: 2 row tiles x 4 column quarters
constexpr int HLD = FC + 4;    // fp32 h tile row stride
constexpr int HBLD = FC + 8;   // bf16 h tile row stride

__device__ __forceinline__ float gelu_tanh(float x) {
  // 0.5 * x * (1 + tanh(sqrt(2/pi) * (x + 0.044715 * x * x * x))), in the
  // JAX expression's evaluation order.
  float u = __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, x), x), x);
  u = __fmul_rn(0.7978845608028654f, __fadd_rn(x, u));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.0f, tanhf(u)));
}

template <int D>
constexpr size_t smem_bytes() {
  return (size_t)R * (D + 8) * 2 + (size_t)R * HLD * 4 + (size_t)R * HBLD * 2;
}

template <int D>
__global__ void __launch_bounds__(NT)
mlp_kernel(const bf16* __restrict__ x, const bf16* __restrict__ lns,
           const bf16* __restrict__ lnb, const bf16* __restrict__ w1,
           const bf16* __restrict__ b1, const bf16* __restrict__ w2,
           const bf16* __restrict__ b2, bf16* __restrict__ out, int N, int F) {
  constexpr int RLD = D + 8;     // bf16 LN tile row stride
  constexpr int NY = D / 64;     // fp32 accumulator fragments per warp
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sR = reinterpret_cast<bf16*>(smem);                         // [R][RLD]
  float* sH = reinterpret_cast<float*>(smem + R * RLD * 2);         // [R][HLD]
  bf16* sHb = reinterpret_cast<bf16*>(smem + R * RLD * 2 + R * HLD * 4);

  const int row0 = blockIdx.x * R;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // ---- LayerNorm: warp w normalises rows 4w .. 4w+3 ----
  for (int rr = 0; rr < R / 8; ++rr) {
    const int r = warp * (R / 8) + rr;
    const int g = row0 + r;
    bf16* dst = sR + r * RLD;
    if (g < N) {
      const bf16* xr = x + (size_t)g * D;
      float xv[D / 32];
      float s = 0.0f;
#pragma unroll
      for (int i = 0; i < D / 32; ++i) {
        xv[i] = __bfloat162float(xr[lane + 32 * i]);
        s += xv[i];
      }
      const float mean = warp_sum(s) / (float)D;
      float s2 = 0.0f;
#pragma unroll
      for (int i = 0; i < D / 32; ++i) {
        const float dv = xv[i] - mean;
        s2 = __fadd_rn(s2, __fmul_rn(dv, dv));
      }
      const float var = warp_sum(s2) / (float)D;
      const float rstd = 1.0f / sqrtf(var + 1e-5f);
#pragma unroll
      for (int i = 0; i < D / 32; ++i) {
        const int c = lane + 32 * i;
        const float y = __fmul_rn(xv[i] - mean, rstd);
        dst[c] = __float2bfloat16_rn(__fadd_rn(
            __fmul_rn(y, __bfloat162float(lns[c])), __bfloat162float(lnb[c])));
      }
    } else {
#pragma unroll
      for (int i = 0; i < D / 32; ++i) dst[lane + 32 * i] = __float2bfloat16_rn(0.0f);
    }
  }
  __syncthreads();

  const int rt = warp / 4;            // this warp's 16-row tile
  const int cq = warp % 4;            // this warp's quarter of the d columns
  const int ycol0 = cq * (D / 4);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> y[NY];
#pragma unroll
  for (int j = 0; j < NY; ++j) wmma::fill_fragment(y[j], 0.0f);

  for (int c0 = 0; c0 < F; c0 += FC) {
    // FC1: this warp's 16x16 tile (rt, cq) of h = r . W1[:, c0:c0+64].
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> h;
    wmma::fill_fragment(h, 0.0f);
#pragma unroll 4
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(a, sR + rt * 16 * RLD + kk * 16, RLD);
      wmma::load_matrix_sync(b, w1 + (size_t)kk * 16 * F + c0 + cq * 16, F);
      wmma::mma_sync(h, a, b, h);
    }
    wmma::store_matrix_sync(sH + rt * 16 * HLD + cq * 16, h, HLD,
                            wmma::mem_row_major);
    __syncthreads();
    for (int e = threadIdx.x; e < R * FC; e += NT) {
      const int r = e / FC, c = e % FC;
      const float hv = __fadd_rn(sH[r * HLD + c], __bfloat162float(b1[c0 + c]));
      sHb[r * HBLD + c] = __float2bfloat16_rn(gelu_tanh(hv));
    }
    __syncthreads();
    // FC2: y[16 x D/4] += h[16 x 64] . W2[c0:c0+64, ycol0 : ycol0 + D/4].
#pragma unroll
    for (int kk = 0; kk < FC / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, sHb + rt * 16 * HBLD + kk * 16, HBLD);
#pragma unroll
      for (int j = 0; j < NY; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(
            b, w2 + (size_t)(c0 + kk * 16) * D + ycol0 + j * 16, D);
        wmma::mma_sync(y[j], a, b, y[j]);
      }
    }
  }

  // ---- epilogue: out = bf16(x + (y + b2)); sH is free after the last
  // barrier, each warp stages one 16x16 fragment at a time in it ----
  float* stage = sH + warp * 256;
#pragma unroll
  for (int j = 0; j < NY; ++j) {
    wmma::store_matrix_sync(stage, y[j], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int g = row0 + rt * 16 + e / 16;
      const int col = ycol0 + j * 16 + e % 16;
      if (g < N) {
        const size_t o = (size_t)g * D + col;
        const float yv = __fadd_rn(stage[e], __bfloat162float(b2[col]));
        out[o] = __float2bfloat16_rn(__fadd_rn(__bfloat162float(x[o]), yv));
      }
    }
    __syncwarp();
  }
}

template <int D>
int launch(const void* x, const void* lns, const void* lnb, const void* w1,
           const void* b1, const void* w2, const void* b2, void* out, int N,
           int F, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaFuncSetAttribute(mlp_kernel<D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  mlp_kernel<D><<<(N + R - 1) / R, NT, smem, stream>>>(
      (const bf16*)x, (const bf16*)lns, (const bf16*)lnb, (const bf16*)w1,
      (const bf16*)b1, (const bf16*)w2, (const bf16*)b2, (bf16*)out, N, F);
  return (int)cudaGetLastError();
}

}  // namespace

WT_EXPORT int wt_fused_encoder_mlp(const void* x, const void* lns,
                                   const void* lnb, const void* w1,
                                   const void* b1, const void* w2,
                                   const void* b2, void* out, int n, int d,
                                   int f, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (f % FC != 0) return (int)cudaErrorInvalidValue;
  switch (d) {
    case 128: return launch<128>(x, lns, lnb, w1, b1, w2, b2, out, n, f, s);
    case 384: return launch<384>(x, lns, lnb, w1, b1, w2, b2, out, n, f, s);
    case 512: return launch<512>(x, lns, lnb, w1, b1, w2, b2, out, n, f, s);
    case 768: return launch<768>(x, lns, lnb, w1, b1, w2, b2, out, n, f, s);
    case 1024: return launch<1024>(x, lns, lnb, w1, b1, w2, b2, out, n, f, s);
    case 1280: return launch<1280>(x, lns, lnb, w1, b1, w2, b2, out, n, f, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
