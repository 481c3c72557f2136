// B9a and B9b: the two calls of the fused encoder block, each a short
// sequence of kernels on the stream built from what the encoder MLP (B2,
// encoder_mlp.cu) runs: a LayerNorm kernel a warp a row (ln_row of
// encoder_ffn.cuh) and the tiled wgmma product of gemm_sm90.cuh (TMA-fed
// ring, 128 x 128 tiles) with the call's arithmetic in its epilogue.  Every
// kernel and epilogue has a name of its own, so that a trace tells B9's time
// from B2's (profile_ladder.KERNELS).
//
// B9a, wt_fused_ln_qkv, replaces whisper_tpu/ops/encoder_block.py:
// fused_ln_qkv (its Pallas kernel), whole and column-chunked alike (the
// columns are independent, so one product gives both variants' values).
// Contract: x [N, d] bf16 -> LayerNorm (fp32 statistics, eps 1e-5) cast to
// bf16 -> one [d, 3d] product accumulated in fp32 -> + bias in fp32 ->
// bf16 out [N, 3d].  Two kernels:
//   1. qkv_ln_kernel: r = bf16(LN1(x)) into the caller's scratch r [N, d];
//   2. the product r . W_qkv, epilogue QkvBias: out = bf16(v + b_qkv).
// What bounds it on the H100: at whisper-base bucket 16 (N = 24,000,
// d = 512) 2*N*d*3d = 37.7 GFLOP against 24.6 MB of x, 73.7 MB of output
// and 1.6 MB of weights: 38 us of bf16 tensor-core time against 30 us of
// memory time; r adds 49 MB of traffic.
//
// B9b, wt_fused_out_mlp, replaces fused_out_mlp (its Pallas kernel).
// Contract: y32 = x + (ctx . O + o_b) in fp32; LayerNorm on the UNROUNDED
// y32 (fp32 statistics), cast to bf16; FC1 + b1 in fp32; tanh GELU -> bf16;
// FC2 + b2 in fp32; out = bf16(float(bf16(y32)) + z): the final residual
// adds the ROUNDED y, as the JAX kernel does.  Four kernels:
//   1. the product ctx . O, epilogue OutProjResidual: y32 = x + (v + o_b),
//      written in fp32 into the caller's scratch y32 [N, d];
//   2. out_ln_kernel: r = bf16(LN2(y32)) into the scratch r [N, d];
//   3. the product r . W1, epilogue OutFc1Gelu: h = bf16(gelu_tanh(v + b1))
//      into the scratch h [N, f];
//   4. the product h . W2, epilogue OutFc2Residual:
//      out = bf16(float(bf16(y32)) + (v + b2)), y32 read and rounded there,
//      so that no bf16 copy of y exists.
// What bounds it: at the same shapes 2*N*d*(d + 2f) = 113 GFLOP against
// ~78 MB of operands: operations, 0.11 ms at the bf16 peak; the scratch
// adds ~0.4 GB of traffic (y32 written and read twice, r, h), 0.12 ms at
// 3.35 TB/s, which the products partly hide.
//
// The fp32 adds outside the products use __fadd_rn so that the compiler
// does not contract them into FMAs the JAX kernels do not use.
#include "encoder_ffn.cuh"
#include "gemm_sm90.cuh"

namespace {

constexpr int LN_WARPS = 8;  // rows a block of the LayerNorm kernels

__device__ __forceinline__ float as_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float as_f32(float v) { return v; }

// r[row] = bf16(LN(in[row])), a warp a row; the whole block calls it.
template <int D, class In>
__device__ __forceinline__ void ln_rows(const In* __restrict__ in,
                                        const bf16* __restrict__ lns,
                                        const bf16* __restrict__ lnb,
                                        bf16* __restrict__ r, int N) {
  const int row = blockIdx.x * LN_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= N) return;
  const In* xr = in + (size_t)row * D;
  float xv[D / 32];
#pragma unroll
  for (int i = 0; i < D / 32; ++i) xv[i] = as_f32(xr[lane + 32 * i]);
  ffn::ln_row<D>(xv, lns, lnb, r + (size_t)row * D, lane);
}

// B9a's LN1 over bf16 x.
template <int D>
__global__ void __launch_bounds__(32 * LN_WARPS)
qkv_ln_kernel(const bf16* __restrict__ x, const bf16* __restrict__ lns,
              const bf16* __restrict__ lnb, bf16* __restrict__ r, int N) {
  ln_rows<D>(x, lns, lnb, r, N);
}

// B9b's LN2 over the unrounded fp32 y32.
template <int D>
__global__ void __launch_bounds__(32 * LN_WARPS)
out_ln_kernel(const float* __restrict__ y32, const bf16* __restrict__ lns,
              const bf16* __restrict__ lnb, bf16* __restrict__ r, int N) {
  ln_rows<D>(y32, lns, lnb, r, N);
}

template <class In>
using LnKernel = void (*)(const In*, const bf16*, const bf16*, bf16*, int);

template <class In>
int launch_ln(LnKernel<In> kernel, const void* in, const void* lns,
              const void* lnb, void* r, int N, cudaStream_t stream) {
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  kernel<<<(N + LN_WARPS - 1) / LN_WARPS, 32 * LN_WARPS, 0, stream>>>(
      (const In*)in, (const bf16*)lns, (const bf16*)lnb, (bf16*)r, N);
  return (int)cudaGetLastError();
}

LnKernel<bf16> qkv_ln_of(int d) {
  switch (d) {
    case 128: return qkv_ln_kernel<128>;
    case 384: return qkv_ln_kernel<384>;
    case 512: return qkv_ln_kernel<512>;
    case 768: return qkv_ln_kernel<768>;
    case 1024: return qkv_ln_kernel<1024>;
    case 1280: return qkv_ln_kernel<1280>;
    default: return nullptr;
  }
}

LnKernel<float> out_ln_of(int d) {
  switch (d) {
    case 128: return out_ln_kernel<128>;
    case 384: return out_ln_kernel<384>;
    case 512: return out_ln_kernel<512>;
    case 768: return out_ln_kernel<768>;
    default: return nullptr;
  }
}

__device__ __forceinline__ float2 bias2(const bf16* bias, int col) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + col));
}

// B9a: out[row, col .. col + 1] = bf16(v + b_qkv)
struct QkvBias {
  const bf16* bias;
  bf16* out;
  int ld;
  __device__ __forceinline__ void operator()(int row, int col, float v0,
                                             float v1) const {
    const float2 b = bias2(bias, col);
    *reinterpret_cast<uint32_t*>(out + (size_t)row * ld + col) =
        pack_bf16(__fadd_rn(v0, b.x), __fadd_rn(v1, b.y));
  }
};

// B9b's O product: y32[row, col .. col + 1] = x + (v + o_b), in fp32
struct OutProjResidual {
  const bf16* bias;
  const bf16* x;
  float* y32;
  int ld;
  __device__ __forceinline__ void operator()(int row, int col, float v0,
                                             float v1) const {
    const size_t o = (size_t)row * ld + col;
    const float2 b = bias2(bias, col);
    const float2 xv =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + o));
    *reinterpret_cast<float2*>(y32 + o) = make_float2(
        __fadd_rn(xv.x, __fadd_rn(v0, b.x)), __fadd_rn(xv.y, __fadd_rn(v1, b.y)));
  }
};

// B9b's FC1: h[row, col .. col + 1] = bf16(gelu_tanh(v + b1))
struct OutFc1Gelu {
  const bf16* bias;
  bf16* out;
  int ld;
  __device__ __forceinline__ void operator()(int row, int col, float v0,
                                             float v1) const {
    const float2 b = bias2(bias, col);
    *reinterpret_cast<uint32_t*>(out + (size_t)row * ld + col) =
        pack_bf16(ffn::gelu_tanh(__fadd_rn(v0, b.x)),
                  ffn::gelu_tanh(__fadd_rn(v1, b.y)));
  }
};

// B9b's FC2: out[row, col .. col + 1] = bf16(float(bf16(y32)) + (v + b2))
struct OutFc2Residual {
  const bf16* bias;
  const float* y32;
  bf16* out;
  int ld;
  __device__ __forceinline__ void operator()(int row, int col, float v0,
                                             float v1) const {
    const size_t o = (size_t)row * ld + col;
    const float2 b = bias2(bias, col);
    const float2 y = __bfloat1622float2(
        __float22bfloat162_rn(*reinterpret_cast<const float2*>(y32 + o)));
    *reinterpret_cast<uint32_t*>(out + o) =
        pack_bf16(__fadd_rn(y.x, __fadd_rn(v0, b.x)),
                  __fadd_rn(y.y, __fadd_rn(v1, b.y)));
  }
};

}  // namespace

WT_EXPORT int wt_fused_ln_qkv(const void* x, const void* lns, const void* lnb,
                              const void* w, const void* bias, void* r,
                              void* out, int n, int d, int c, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n < 1 || c % gemm::BN != 0) return (int)cudaErrorInvalidValue;
  const int rc = launch_ln(qkv_ln_of(d), x, lns, lnb, r, n, s);
  if (rc != 0) return rc;
  return gemm::run(r, w, n, c, d, QkvBias{(const bf16*)bias, (bf16*)out, c},
                   s);
}

WT_EXPORT int wt_fused_out_mlp(const void* x, const void* ctx, const void* ow,
                               const void* ob, const void* lns,
                               const void* lnb, const void* w1, const void* b1,
                               const void* w2, const void* b2, void* y32,
                               void* r, void* h, void* out, int n, int d,
                               int f, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n < 1 || f < 64 || f % 64 != 0 || out_ln_of(d) == nullptr)
    return (int)cudaErrorInvalidValue;
  int rc = gemm::run(ctx, ow, n, d, d,
                     OutProjResidual{(const bf16*)ob, (const bf16*)x,
                                     (float*)y32, d}, s);
  if (rc != 0) return rc;
  rc = launch_ln(out_ln_of(d), y32, lns, lnb, r, n, s);
  if (rc != 0) return rc;
  rc = gemm::run(r, w1, n, f, d, OutFc1Gelu{(const bf16*)b1, (bf16*)h, f}, s);
  if (rc != 0) return rc;
  return gemm::run(h, w2, n, d, f,
                   OutFc2Residual{(const bf16*)b2, (const float*)y32,
                                  (bf16*)out, d}, s);
}
