// B6: one-token decoder cross-attention against the int8 cross cache of
// layer `layer`, dequantized inside the kernel (rung x4).
//
// Replaces whisper_tpu/ops/cross_attention.py:cross_attend_step_packed with
// int8_mxu=False (_kernel).  Contract, as there (q bf16, pre-scaled by
// 64^-0.5, widened to fp32):
//   scores = (q . fp32(K8)) * k_scale[layer]   (fp32 dot);
//   columns >= s_valid masked;  e = exp(s - max);
//   p = bf16(e / sum e)          (normalized BEFORE the cast);
//   ctx = sum_s fp32(bf16(p * bf16(V8)))   (each product rounded to bf16,
//         as the JAX kernel's bf16 VPU multiply, the sum in fp32);
//   out = bf16(ctx * v_scale[layer]).
//
// Layout: the prefill layout [L, B, H, S, 64] int8 for K and V, as B4 reads
// it (no head-pair packing, no transposed K); the scales stay [L, B, H]
// fp32 and the kernel indexes the layer itself, so the wrapper runs no
// torch op besides allocating the output.
//
// What bounds it on the H100: per call it streams one layer's K and V, at
// whisper-base bucket 16 16*8*1500*64*2 = 24.6 MB (7.3 us at 3.35 TB/s),
// for 2*16*8*1500*64*2 = 49 MFLOP of fp32 work, so bytes bound it.
// Design: B4's skeleton, one block of 256 threads per (b, h): q is held in
// registers; each thread owns whole K rows (four 16-byte loads, 64 FMAs);
// block reductions give the max and the sum; the bf16 probabilities sit in
// shared memory; for P.V each thread owns one of the 64 columns for a
// quarter of the rows, so a warp reads 32 consecutive bytes of a V row.
// As with B4, 128 blocks leave each SM one block; more blocks per (b, h)
// with a second reduction pass is the next step.
#include "common.cuh"

namespace {

constexpr int DH = 64;
constexpr int NT = 256;

// Byte j (0..3) of a packed word, sign-extended, as fp32 (exact).
__device__ __forceinline__ float s8(int w, int j) {
  return (float)((int)((unsigned)w << (24 - 8 * j)) >> 24);
}

__global__ void __launch_bounds__(NT)
cross_dequant_kernel(const bf16* __restrict__ q,
                     const float* __restrict__ k_scale,
                     const float* __restrict__ v_scale,
                     const int8_t* __restrict__ k8,
                     const int8_t* __restrict__ v8, bf16* __restrict__ out,
                     int B, int H, int S, int layer, int s_valid) {
  extern __shared__ float sS[];                   // [S] scores, then e
  bf16* sP = reinterpret_cast<bf16*>(sS + S);     // [S] bf16 probabilities
  __shared__ float sq[DH];
  __shared__ float sred[NT / 32];
  __shared__ float sacc[NT];

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const size_t row = (size_t)b * H + h;
  const size_t lrow = ((size_t)layer * B + b) * H + h;
  const int8_t* kc = k8 + lrow * (size_t)S * DH;
  const int8_t* vc = v8 + lrow * (size_t)S * DH;
  const int tid = threadIdx.x;

  if (tid < DH) sq[tid] = __bfloat162float(q[row * DH + tid]);
  __syncthreads();
  float qr[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) qr[d] = sq[d];
  const float ks = k_scale[lrow];

  float lmax = -FLT_MAX;
  for (int s = tid; s < S; s += NT) {
    const int4* kr = reinterpret_cast<const int4*>(kc + (size_t)s * DH);
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < DH / 16; ++i) {
      const int4 w = kr[i];
      const int ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc = __fmaf_rn(qr[16 * i + 4 * j + c], s8(ws[j], c), acc);
    }
    const float sc = s < s_valid ? __fmul_rn(acc, ks) : -FLT_MAX;
    sS[s] = sc;
    lmax = fmaxf(lmax, sc);
  }
  const float m = block_reduce<NT>(lmax, sred, true);

  float lsum = 0.0f;
  for (int s = tid; s < S; s += NT) {
    const float e = expf(sS[s] - m);  // masked columns give exactly 0
    sS[s] = e;
    lsum += e;
  }
  const float denom = block_reduce<NT>(lsum, sred, false);
  for (int s = tid; s < S; s += NT)
    sP[s] = __float2bfloat16_rn(__fdiv_rn(sS[s], denom));
  __syncthreads();

  const int d = tid % DH, grp = tid / DH;
  float acc = 0.0f;
  for (int s = grp; s < S; s += NT / DH) {
    const bf16 v = __float2bfloat16_rn((float)vc[(size_t)s * DH + d]);
    acc = __fadd_rn(acc, __bfloat162float(__hmul(sP[s], v)));
  }
  sacc[tid] = acc;
  __syncthreads();
  if (tid < DH) {
    float ctx = sacc[tid];
#pragma unroll
    for (int g = 1; g < NT / DH; ++g) ctx = __fadd_rn(ctx, sacc[g * DH + tid]);
    out[row * DH + tid] = __float2bfloat16_rn(__fmul_rn(ctx, v_scale[lrow]));
  }
}

}  // namespace

WT_EXPORT int wt_cross_attend_step_dequant(const void* q, const void* k_scale,
                                           const void* v_scale, const void* k8,
                                           const void* v8, void* out, int B,
                                           int H, int S, int layer,
                                           int s_valid, void* stream) {
  const size_t smem = (size_t)S * (sizeof(float) + sizeof(bf16));
  cross_dequant_kernel<<<B * H, NT, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const float*)k_scale, (const float*)v_scale,
      (const int8_t*)k8, (const int8_t*)v8, (bf16*)out, B, H, S, layer,
      s_valid);
  return (int)cudaGetLastError();
}
