// The LayerNorm of a row and the tanh GELU shared by the encoder MLP (B2,
// encoder_mlp.cu) and the fused encoder block (B9a and B9b,
// encoder_block.cu): their LN kernels run `ln_row` a warp a row, their
// products' epilogues `gelu_tanh` on the accumulators.
//
// `ln_row` turns one row, held as D/32 fp32 values per lane, into bf16
// LayerNorm output (fp32 statistics, eps 1e-5).  The fp32 adds and
// multiplies use __fadd_rn/__fmul_rn so that the compiler does not contract
// them into FMAs the JAX kernels do not use.
#pragma once

#include "common.cuh"

namespace ffn {

__device__ __forceinline__ float gelu_tanh(float x) {
  // 0.5 * x * (1 + tanh(sqrt(2/pi) * (x + 0.044715 * x * x * x))), in the
  // JAX expression's evaluation order.
  float u = __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, x), x), x);
  u = __fmul_rn(0.7978845608028654f, __fadd_rn(x, u));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.0f, tanhf(u)));
}

// LayerNorm of one row of D values, lane `lane` holding columns lane + 32*i
// in xv[i]; the whole warp calls it.  dst: the row's bf16 output.
template <int D>
__device__ __forceinline__ void ln_row(const float (&xv)[D / 32],
                                       const bf16* __restrict__ lns,
                                       const bf16* __restrict__ lnb, bf16* dst,
                                       int lane) {
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < D / 32; ++i) s += xv[i];
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
}

}  // namespace ffn
