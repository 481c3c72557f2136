// The per-(b, h) arithmetic of the decode cross-attention kernels against
// the int8 cross cache, shared by the single-token kernels (B4
// cross_attention.cu, B6 cross_attention_dequant.cu) and the multi-query
// kernels of the speculative verify pass (B7 cross_attention_multi.cu).
//
// A multi-query kernel must give, for each of its T queries, bit for bit
// what the single-token kernel gives for that query: speculative decoding
// is lossless only then.  The int32 dots are exact in any order; the fp32
// max, sums, softmax and P.V are not.  So both kernels call the device
// functions below with the same block size (CROSS_NT threads), and every
// reduction in them has one fixed order: a thread's strided partial, the
// warp's xor tree, the warps in sequence.
//
// `kc`/`vc` point at the [S, 64] int8 K and V of one (layer, b, h), in
// device memory (single token) or in shared memory (the multi kernels stage
// the tile once and run every query against it).
#pragma once

#include "common.cuh"

constexpr int CROSS_DH = 64;
constexpr int CROSS_NT = 256;

// Scratch in static shared memory that one call of a head function uses.
struct CrossScratch {
  float red[CROSS_NT / 32];
  float accf[CROSS_NT];
  int acci[CROSS_NT];
  int q8[CROSS_DH / 4];
  float qf[CROSS_DH];
};

// Byte j (0..3) of a packed word, sign-extended, as fp32 (exact).
__device__ __forceinline__ float cross_s8(int w, int j) {
  return (float)((int)((unsigned)w << (24 - 8 * j)) >> 24);
}

// int8 x int8 (B4, B7-i8).  sc.q8 holds the head's quantized query.
//   scores = (q8 . K8 as int32) * qk_scale; columns >= s_valid masked;
//   e = exp(s - max); p8 = rint(127 e);
//   out = bf16((p8 . V8 as int32) * (v_scale / (127 sum e))).
// sS: [S] floats, sP8: [S] bytes, both in shared memory.
__device__ __forceinline__ void cross_head_int8(
    CrossScratch& sc, float qk_scale, float v_scale,
    const int8_t* __restrict__ kc, const int8_t* __restrict__ vc,
    bf16* __restrict__ out, int S, int s_valid, float* sS, int8_t* sP8) {
  const int tid = threadIdx.x;
  float lmax = -FLT_MAX;
  for (int s = tid; s < S; s += CROSS_NT) {
    const int4* kr = reinterpret_cast<const int4*>(kc + (size_t)s * CROSS_DH);
    int acc = 0;
#pragma unroll
    for (int i = 0; i < CROSS_DH / 16; ++i) {
      const int4 w = kr[i];
      acc = __dp4a(w.x, sc.q8[4 * i + 0], acc);
      acc = __dp4a(w.y, sc.q8[4 * i + 1], acc);
      acc = __dp4a(w.z, sc.q8[4 * i + 2], acc);
      acc = __dp4a(w.w, sc.q8[4 * i + 3], acc);
    }
    const float v = s < s_valid ? __fmul_rn((float)acc, qk_scale) : -FLT_MAX;
    sS[s] = v;
    lmax = fmaxf(lmax, v);
  }
  const float m = block_reduce<CROSS_NT>(lmax, sc.red, true);

  float lsum = 0.0f;
  for (int s = tid; s < S; s += CROSS_NT) {
    const float e = expf(__fsub_rn(sS[s], m));  // masked columns give exactly 0
    lsum = __fadd_rn(lsum, e);
    sP8[s] = (int8_t)__float2int_rn(__fmul_rn(e, 127.0f));
  }
  const float denom = block_reduce<CROSS_NT>(lsum, sc.red, false);  // syncs sP8

  const int d = tid % CROSS_DH, grp = tid / CROSS_DH;
  int acc = 0;
  for (int s = grp; s < S; s += CROSS_NT / CROSS_DH)
    acc += (int)sP8[s] * (int)vc[(size_t)s * CROSS_DH + d];
  sc.acci[tid] = acc;
  __syncthreads();
  if (tid < CROSS_DH) {
    int ctx = 0;
#pragma unroll
    for (int g = 0; g < CROSS_NT / CROSS_DH; ++g)
      ctx += sc.acci[g * CROSS_DH + tid];
    const float scale = __fdiv_rn(v_scale, __fmul_rn(127.0f, denom));
    out[tid] = __float2bfloat16_rn(__fmul_rn((float)ctx, scale));
  }
}

// Dequantizing (B6, B7-dq).  sc.qf holds the head's query widened to fp32.
//   scores = (q . fp32(K8)) * k_scale (fp32 dot); columns >= s_valid masked;
//   p = bf16(exp(s - max) / sum); ctx = sum_s fp32(bf16(p * bf16(V8)));
//   out = bf16(ctx * v_scale).
// sS: [S] floats, sP: [S] bf16, both in shared memory.
__device__ __forceinline__ void cross_head_dequant(
    CrossScratch& sc, float k_scale, float v_scale,
    const int8_t* __restrict__ kc, const int8_t* __restrict__ vc,
    bf16* __restrict__ out, int S, int s_valid, float* sS, bf16* sP) {
  const int tid = threadIdx.x;
  float qr[CROSS_DH];
#pragma unroll
  for (int d = 0; d < CROSS_DH; ++d) qr[d] = sc.qf[d];

  float lmax = -FLT_MAX;
  for (int s = tid; s < S; s += CROSS_NT) {
    const int4* kr = reinterpret_cast<const int4*>(kc + (size_t)s * CROSS_DH);
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < CROSS_DH / 16; ++i) {
      const int4 w = kr[i];
      const int ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc = __fmaf_rn(qr[16 * i + 4 * j + c], cross_s8(ws[j], c), acc);
    }
    const float v = s < s_valid ? __fmul_rn(acc, k_scale) : -FLT_MAX;
    sS[s] = v;
    lmax = fmaxf(lmax, v);
  }
  const float m = block_reduce<CROSS_NT>(lmax, sc.red, true);

  float lsum = 0.0f;
  for (int s = tid; s < S; s += CROSS_NT) {
    const float e = expf(__fsub_rn(sS[s], m));  // masked columns give exactly 0
    sS[s] = e;
    lsum = __fadd_rn(lsum, e);
  }
  const float denom = block_reduce<CROSS_NT>(lsum, sc.red, false);
  for (int s = tid; s < S; s += CROSS_NT)
    sP[s] = __float2bfloat16_rn(__fdiv_rn(sS[s], denom));
  __syncthreads();

  const int d = tid % CROSS_DH, grp = tid / CROSS_DH;
  float acc = 0.0f;
  for (int s = grp; s < S; s += CROSS_NT / CROSS_DH) {
    const bf16 v = __float2bfloat16_rn((float)vc[(size_t)s * CROSS_DH + d]);
    acc = __fadd_rn(acc, __bfloat162float(__hmul(sP[s], v)));
  }
  sc.accf[tid] = acc;
  __syncthreads();
  if (tid < CROSS_DH) {
    float ctx = sc.accf[tid];
#pragma unroll
    for (int g = 1; g < CROSS_NT / CROSS_DH; ++g)
      ctx = __fadd_rn(ctx, sc.accf[g * CROSS_DH + tid]);
    out[tid] = __float2bfloat16_rn(__fmul_rn(ctx, v_scale));
  }
}
