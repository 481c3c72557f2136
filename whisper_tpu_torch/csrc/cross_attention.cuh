// The per-(b, h) arithmetic of the decode cross-attention kernels against
// the int8 cross cache, shared by the single-token kernels (B4
// cross_attention.cu, B6 cross_attention_dequant.cu) and the multi-query
// kernels of the speculative verify pass (B7 cross_attention_multi.cu).
//
// A multi-query kernel must give, for each of its T queries, bit for bit
// what the single-token kernel gives for that query: speculative decoding
// is lossless only then.  The int32 dots and the max are exact in any order;
// the fp32 sums are not, so their order is fixed here.
//
// int8 x int8 (B4, B7-i8).  B4 splits a head's S rows over the blocks of a
// cluster, B7 walks them in one block, and both must reach the same
// denominator.  So the order of sum e is a function of S alone, not of the
// launch: rows fall into groups of 32 (one warp: the xor tree), six groups
// make a segment of CROSS_SEG = 192 rows (added in sequence from 0), and
// the segments are added in sequence from 0.  p8 = rint(127 e) depends only
// on the global max, so splitting changes no p8.
//
// Dequantizing (B6, B7-dq): both kernels call cross_head_dequant with the
// same block size (CROSS_NT threads); every reduction in it has one fixed
// order: a thread's strided partial, the warp's xor tree, the warps in
// sequence.
//
// `kc`/`vc` point at [rows, 64] int8 K and V of one (layer, b, h), in
// device memory or in shared memory.
#pragma once

#include "common.cuh"

constexpr int CROSS_DH = 64;
constexpr int CROSS_NT = 256;
constexpr int CROSS_SEG = 192;               // rows a segment
constexpr int CROSS_SEG_GROUPS = CROSS_SEG / 32;

// Scratch in static shared memory that one call of a head function uses.
struct CrossScratch {
  float red[CROSS_NT / 32];
  float accf[CROSS_NT];
  int q8[CROSS_DH / 4];
  float qf[CROSS_DH];
  int pv[CROSS_NT / 32][CROSS_DH];
  float q_scale;
};

// Byte j (0..3) of a packed word, sign-extended, as fp32 (exact).
__device__ __forceinline__ float cross_s8(int w, int j) {
  return (float)((int)((unsigned)w << (24 - 8 * j)) >> 24);
}

// ---- int8 x int8 ------------------------------------------------------------

// Per-head symmetric quantization of one query (64 bf16), by one whole warp:
// scale = max(absmax, 1e-12) / 127, q8 = clip(rint(x / scale)), both true
// fp32 divisions.  Writes the 64 bytes to `dst8`; every lane gets the scale.
__device__ __forceinline__ float cross_quantize_q(const bf16* __restrict__ q,
                                                  int8_t* dst8) {
  const int lane = threadIdx.x % 32;
  const float2 x = __bfloat1622float2(
      reinterpret_cast<const __nv_bfloat162*>(q)[lane]);
  const float amax = warp_max(fmaxf(fabsf(x.x), fabsf(x.y)));
  const float sc = __fdiv_rn(fmaxf(amax, 1e-12f), 127.0f);
  dst8[2 * lane] =
      (int8_t)fminf(fmaxf(rintf(__fdiv_rn(x.x, sc)), -127.0f), 127.0f);
  dst8[2 * lane + 1] =
      (int8_t)fminf(fmaxf(rintf(__fdiv_rn(x.y, sc)), -127.0f), 127.0f);
  return sc;
}

// Scores of rows [0, rows) of a K tile, by a block of NT threads: four
// threads a row, 16 bytes each, the quad's int32 partials added by
// shuffles.  Row r is column row0 + r of the head; columns >= s_valid are
// masked.  Writes sS[r]; returns the thread's max.
template <int NT>
__device__ __forceinline__ float cross_scores(const int* q8, float qk_scale,
                                              const int8_t* __restrict__ kc,
                                              int rows, int row0, int s_valid,
                                              float* sS) {
  const int c = threadIdx.x % 4;
  const int4 qv = reinterpret_cast<const int4*>(q8)[c];
  float lmax = -FLT_MAX;
  for (int rb = 0; rb < rows; rb += NT / 4) {  // bounds uniform in a warp
    const int r = rb + threadIdx.x / 4;
    int acc = 0;
    if (r < rows) {
      const int4 w = reinterpret_cast<const int4*>(kc + (size_t)r * CROSS_DH)[c];
      acc = __dp4a(w.x, qv.x, acc);
      acc = __dp4a(w.y, qv.y, acc);
      acc = __dp4a(w.z, qv.z, acc);
      acc = __dp4a(w.w, qv.w, acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (r < rows) {
      const float v =
          row0 + r < s_valid ? __fmul_rn((float)acc, qk_scale) : -FLT_MAX;
      if (c == 0) sS[r] = v;
      lmax = fmaxf(lmax, v);
    }
  }
  return lmax;
}

// One group of 32 rows, by one whole warp: e = exp(s - m) (masked columns
// give exactly 0), p8 = rint(127 e), and the group's sum of e by the xor
// tree.  `left` rows of the group exist (<= 0: none); the others count as 0.
__device__ __forceinline__ float cross_group_softmax(const float* sS, int left,
                                                     float m, int8_t* sP8) {
  const int lane = threadIdx.x % 32;
  float e = 0.0f;
  if (lane < left) {
    e = expf(__fsub_rn(sS[lane], m));
    sP8[lane] = (int8_t)__float2int_rn(__fmul_rn(e, 127.0f));
  }
  return warp_sum(e);
}

// A segment's sum from its groups' sums, in sequence from 0.
__device__ __forceinline__ float cross_segment_sum(const float* gsum, int n) {
  float seg = 0.0f;
  for (int w = 0; w < n; ++w) seg = __fadd_rn(seg, gsum[w]);
  return seg;
}

// Columns j of four rows' words (bytes j of a, b, c, d) against the four
// packed p8: acc[j] += p . (a_j, b_j, c_j, d_j).
__device__ __forceinline__ void cross_dot4x4(int a, int b, int c, int d, int p,
                                             int* acc) {
  const int ab_lo = __byte_perm(a, b, 0x5140), cd_lo = __byte_perm(c, d, 0x5140);
  const int ab_hi = __byte_perm(a, b, 0x7362), cd_hi = __byte_perm(c, d, 0x7362);
  acc[0] = __dp4a((int)__byte_perm(ab_lo, cd_lo, 0x5410), p, acc[0]);
  acc[1] = __dp4a((int)__byte_perm(ab_lo, cd_lo, 0x7632), p, acc[1]);
  acc[2] = __dp4a((int)__byte_perm(ab_hi, cd_hi, 0x5410), p, acc[2]);
  acc[3] = __dp4a((int)__byte_perm(ab_hi, cd_hi, 0x7632), p, acc[3]);
}

// ctx[64] = sum over rows [0, rows) of p8[r] * V8[r, :] as int32, by a block
// of NT threads, V read in 16-byte vectors.  A thread takes 16 columns
// (c = tid % 4) of four rows of a unit of eight (base + 2i + h, h = tid / 4
// % 2, so that eight neighbouring threads read 128 contiguous bytes),
// transposes the 4 x 4 bytes and sums with __dp4a.  The threads' partials
// meet through shuffles and `part` ([NT / 32][64] ints in shared memory);
// on return threads 0..63 hold their column's sum, the others 0.  sP8 is
// 8-byte aligned and readable up to the next multiple of 8 past `rows`.
template <int NT>
__device__ __forceinline__ int cross_pv(const int8_t* sP8,
                                        const int8_t* __restrict__ vc, int rows,
                                        int (*part)[CROSS_DH]) {
  const int tid = threadIdx.x, c = tid % 4, h = (tid / 4) % 2;
  int acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0;
  for (int base = 8 * (tid / 8); base < rows; base += NT) {
    const int2 pw = *reinterpret_cast<const int2*>(sP8 + base);
    const int p = __byte_perm(pw.x, pw.y, h ? 0x7531 : 0x6420);
    int4 w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = base + 2 * i + h;
      w[i] = r < rows
                 ? reinterpret_cast<const int4*>(vc + (size_t)r * CROSS_DH)[c]
                 : make_int4(0, 0, 0, 0);
    }
    cross_dot4x4(w[0].x, w[1].x, w[2].x, w[3].x, p, acc);
    cross_dot4x4(w[0].y, w[1].y, w[2].y, w[3].y, p, acc + 4);
    cross_dot4x4(w[0].z, w[1].z, w[2].z, w[3].z, p, acc + 8);
    cross_dot4x4(w[0].w, w[1].w, w[2].w, w[3].w, p, acc + 12);
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
#pragma unroll
    for (int o = 4; o < 32; o <<= 1)
      acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], o);
  }
  if (tid % 32 < 4) {
#pragma unroll
    for (int i = 0; i < 16; ++i) part[tid / 32][16 * c + i] = acc[i];
  }
  __syncthreads();
  int ctx = 0;
  if (tid < CROSS_DH) {
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) ctx += part[w][tid];
  }
  return ctx;
}

// out = bf16(ctx * (v_scale / (127 * denom))).
__device__ __forceinline__ bf16 cross_finish(int ctx, float v_scale,
                                             float denom) {
  const float scale = __fdiv_rn(v_scale, __fmul_rn(127.0f, denom));
  return __float2bfloat16_rn(__fmul_rn((float)ctx, scale));
}

// One query against a whole head's K and V, by one block of CROSS_NT threads
// (B7-i8): what B4's cluster computes, in the same order.
//   q8, q_scale = quantize(q);  scores = (q8 . K8 as int32) * (q_scale *
//   k_scale); columns >= s_valid masked;  e = exp(s - max); p8 = rint(127 e);
//   out = bf16((p8 . V8 as int32) * (v_scale / (127 sum e))).
// In shared memory: sS [S] floats, gsum [ceil(S / 32)] floats, sP8 [S
// rounded up to 8] bytes, 8-byte aligned.
__device__ __forceinline__ void cross_head_int8(
    CrossScratch& sc, const bf16* __restrict__ q, float k_scale, float v_scale,
    const int8_t* __restrict__ kc, const int8_t* __restrict__ vc,
    bf16* __restrict__ out, int S, int s_valid, float* sS, float* gsum,
    int8_t* sP8) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (warp == 0) {
    const float qs = cross_quantize_q(q, reinterpret_cast<int8_t*>(sc.q8));
    if (lane == 0) sc.q_scale = qs;
  }
  __syncthreads();
  const float qk_scale = __fmul_rn(sc.q_scale, k_scale);
  const float lmax =
      cross_scores<CROSS_NT>(sc.q8, qk_scale, kc, S, 0, s_valid, sS);
  const float m = block_reduce<CROSS_NT>(lmax, sc.red, true);  // syncs sS

  const int n_groups = (S + 31) / 32;
  for (int g = warp; g < n_groups; g += CROSS_NT / 32) {
    const float gs =
        cross_group_softmax(sS + 32 * g, S - 32 * g, m, sP8 + 32 * g);
    if (lane == 0) gsum[g] = gs;
  }
  __syncthreads();
  float denom = 0.0f;
  for (int g0 = 0; g0 < n_groups; g0 += CROSS_SEG_GROUPS)
    denom = __fadd_rn(denom, cross_segment_sum(
        gsum + g0, min(CROSS_SEG_GROUPS, n_groups - g0)));

  const int ctx = cross_pv<CROSS_NT>(sP8, vc, S, sc.pv);
  if (tid < CROSS_DH) out[tid] = cross_finish(ctx, v_scale, denom);
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
