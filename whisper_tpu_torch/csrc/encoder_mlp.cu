// B2: fused encoder MLP, x [N, d] bf16 -> x + FC2(GELU_tanh(FC1(LN(x)))).
//
// Replaces whisper_tpu/ops/encoder_mlp.py:fused_encoder_mlp (_mlp_kernel),
// and by design its FFN-chunked twin _fused_mlp_chunked (_mlp_kernel_
// chunked): the same kernels take every d in the instantiated set, so there
// is no VMEM-style budget.
// Contract (the JAX kernel's): LayerNorm with fp32 statistics (eps 1e-5),
// its output cast to bf16; FC1 + b1 accumulated in fp32; tanh GELU in
// fp32, cast to bf16; FC2 + b2 accumulated in fp32; + x in fp32; bf16 out.
// The weights arrive dense (int8 weights are dequantized by the caller,
// q.bf16 * s.bf16, as the JAX model does).
//
// What bounds it on the H100: at whisper-base bucket 16 (N = 24,000 rows,
// d = 512, f = 2048) one call is 4*N*d*f = 101 GFLOP against ~53 MB of
// activations and weights: operations bound it, 0.102 ms at 989 TFLOP/s.
// The TPU kernel keeps y = h.W2 on the chip for the whole FFN walk so that
// h [N, f] never reaches device memory.  Here that costs M*d*4 bytes of
// accumulators a block: with wgmma's 64-row tiles half the register file
// at d = 512 and all of it at d = 1024, and 64 rows a block still read the
// 4 MB of weights 375 times a call.  So the function is three kernels on
// the stream, launched by the one entry point:
//   1. mlp_ln_kernel: r = bf16(LN(x)), a warp a row (ln_row of
//      encoder_ffn.cuh, which the fused encoder block's LN kernels share).
//   2. h = bf16(gelu_tanh(r.W1 + b1)) and
//   3. out = bf16(x + (h.W2 + b2)): the tiled wgmma product of
//      gemm_sm90.cuh (TMA-fed ring, two consumer warpgroups, 128 x 128
//      tiles, two blocks an SM where the grid is large enough), bias and
//      GELU, or bias and residual, on the accumulator registers.
// r [N, d] and h [N, f] are scratch of the call (the caller allocates them):
// h is written and read once, 2*N*f*2 = 196 MB at bucket 16, 0.06 ms of
// device-memory time that the products partly hide.  The fp32 adds and
// multiplies outside the products use __fadd_rn/__fmul_rn so that the
// compiler does not contract them into FMAs the JAX kernel does not use,
// and GELU's tanh is tanhf.
#include "encoder_ffn.cuh"
#include "gemm_sm90.cuh"

namespace {

constexpr int LN_WARPS = 8;  // rows a block of mlp_ln_kernel

template <int D>
__global__ void __launch_bounds__(32 * LN_WARPS)
mlp_ln_kernel(const bf16* __restrict__ x, const bf16* __restrict__ lns,
              const bf16* __restrict__ lnb, bf16* __restrict__ r, int N) {
  const int row = blockIdx.x * LN_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= N) return;
  const bf16* xr = x + (size_t)row * D;
  float xv[D / 32];
#pragma unroll
  for (int i = 0; i < D / 32; ++i) xv[i] = __bfloat162float(xr[lane + 32 * i]);
  ffn::ln_row<D>(xv, lns, lnb, r + (size_t)row * D, lane);
}

// h[row, col .. col + 1] = bf16(gelu_tanh(v + b1))
struct BiasGelu {
  const bf16* bias;
  bf16* out;
  int ld;
  __device__ __forceinline__ void operator()(int row, int col, float v0,
                                             float v1) const {
    const __nv_bfloat162 b =
        *reinterpret_cast<const __nv_bfloat162*>(bias + col);
    *reinterpret_cast<uint32_t*>(out + (size_t)row * ld + col) = pack_bf16(
        ffn::gelu_tanh(__fadd_rn(v0, __low2float(b))),
        ffn::gelu_tanh(__fadd_rn(v1, __high2float(b))));
  }
};

// out[row, col .. col + 1] = bf16(x + (v + b2))
struct BiasResidual {
  const bf16* bias;
  const bf16* x;
  bf16* out;
  int ld;
  __device__ __forceinline__ void operator()(int row, int col, float v0,
                                             float v1) const {
    const size_t o = (size_t)row * ld + col;
    const __nv_bfloat162 b =
        *reinterpret_cast<const __nv_bfloat162*>(bias + col);
    const __nv_bfloat162 xr = *reinterpret_cast<const __nv_bfloat162*>(x + o);
    *reinterpret_cast<uint32_t*>(out + o) = pack_bf16(
        __fadd_rn(__low2float(xr), __fadd_rn(v0, __low2float(b))),
        __fadd_rn(__high2float(xr), __fadd_rn(v1, __high2float(b))));
  }
};

template <int D>
int launch_ln(const void* x, const void* lns, const void* lnb, void* r, int N,
              cudaStream_t stream) {
  mlp_ln_kernel<D><<<(N + LN_WARPS - 1) / LN_WARPS, 32 * LN_WARPS, 0, stream>>>(
      (const bf16*)x, (const bf16*)lns, (const bf16*)lnb, (bf16*)r, N);
  return (int)cudaGetLastError();
}

}  // namespace

WT_EXPORT int wt_fused_encoder_mlp(const void* x, const void* lns,
                                   const void* lnb, const void* w1,
                                   const void* b1, const void* w2,
                                   const void* b2, void* r, void* h, void* out,
                                   int n, int d, int f, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n < 1 || f < 64 || f % 64 != 0) return (int)cudaErrorInvalidValue;
  int rc;
  switch (d) {
    case 128: rc = launch_ln<128>(x, lns, lnb, r, n, s); break;
    case 384: rc = launch_ln<384>(x, lns, lnb, r, n, s); break;
    case 512: rc = launch_ln<512>(x, lns, lnb, r, n, s); break;
    case 768: rc = launch_ln<768>(x, lns, lnb, r, n, s); break;
    case 1024: rc = launch_ln<1024>(x, lns, lnb, r, n, s); break;
    case 1280: rc = launch_ln<1280>(x, lns, lnb, r, n, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  rc = gemm::run(r, w1, n, f, d, BiasGelu{(const bf16*)b1, (bf16*)h, f}, s);
  if (rc != 0) return rc;
  return gemm::run(h, w2, n, d, f,
                   BiasResidual{(const bf16*)b2, (const bf16*)x, (bf16*)out, d},
                   s);
}
