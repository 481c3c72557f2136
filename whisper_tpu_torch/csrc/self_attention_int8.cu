// B8: one-token decoder self-attention for layer `layer` against the int8
// self cache with per-row scales, the new K/V row quantized and written
// into the cache and its scale planes IN PLACE.
//
// Replaces whisper_tpu/ops/self_attention.py:self_attend_step_packed_int8
// (_kernel_int8).  Contract, each line one of the JAX kernel's:
//   q, k_new, v_new (bf16, q pre-scaled by 64^-0.5) are quantized per head
//   here: scale = max(absmax, 1e-12) / 127, x8 = clip(rint(x / scale)) with
//   a true fp32 DIVISION (not a product with a reciprocal);
//   row `pos` of k_cache/v_cache[layer, b, h] and of k_scale/v_scale[layer,
//   b, h] becomes the new row and its scale, and is attended in this call;
//   scores = (q8 . K8 as int32) * q_scale * k_scale[row], rows outside
//   [pad_count[b], pos] masked (their e is exactly 0, so they are skipped
//   whatever stale bytes they hold);  e = exp(s - max), denom = sum e;
//   p = e * v_scale[row];  ps = max(max p, 1e-30) / 127;  p8 = rint(p / ps);
//   ctx = (p8 . V8 as int32) * (ps / denom), written in bf16.
// The int32 sums are exact, so their order does not matter.
//
// Layout: the prefill layout [L, B, H, S, 64] int8 with [L, B, H, S] fp32
// scale planes (no head-pair packing, no padding of S: those existed for
// Mosaic).
//
// What bounds it on the H100: per call it reads one layer's int8 rows
// [0, pos] and their scales for every (b, h): at whisper-base bucket 16 at
// most 16*8*132*(64+4)*2 = 2.3 MB, under 1 us of bandwidth, with
// 4*B*H*S*64 int8 operations.  So launch latency and the dependent block
// reductions bound it, not bytes or operations.  Design: B3's, one block of
// 128 threads per (b, h): warps 0-2 quantize q, k_new, v_new (a warp max
// each); a thread takes a K row (16 __dp4a); block reductions give the
// max, the sum and the largest p; p8 sits in shared memory; for P.V thread
// (d, half) sums every other row.  The new row is used from shared memory,
// so no thread reads back a global write made in the same launch.
#include "common.cuh"

namespace {

constexpr int DH = 64;
constexpr int NT = 128;

__global__ void __launch_bounds__(NT)
self_step_int8_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k_new,
                      const bf16* __restrict__ v_new, int8_t* k_cache,
                      int8_t* v_cache, float* k_scale, float* v_scale,
                      const int* __restrict__ pad_count, bf16* __restrict__ out,
                      int B, int H, int S, int layer, int pos) {
  extern __shared__ float sP[];                    // [S] scores, then p
  int8_t* sP8 = reinterpret_cast<int8_t*>(sP + S);  // [S] p8
  __shared__ __align__(16) int8_t s8[3][DH];       // q8, k_new8, v_new8
  __shared__ float sscale[3];                      // their scales
  __shared__ float sred[NT / 32];
  __shared__ int sacc[NT];

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const size_t row = (size_t)b * H + h;
  const size_t plane = ((size_t)layer * B + b) * H + h;
  int8_t* kc = k_cache + plane * (size_t)S * DH;
  int8_t* vc = v_cache + plane * (size_t)S * DH;
  float* ksc = k_scale + plane * (size_t)S;
  float* vsc = v_scale + plane * (size_t)S;
  const int pad = pad_count[b];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // ---- quantize q (warp 0), k_new (warp 1), v_new (warp 2) per head ----
  if (warp < 3) {
    const bf16* src = (warp == 0 ? q : warp == 1 ? k_new : v_new) + row * DH;
    const float x0 = __bfloat162float(src[2 * lane]);
    const float x1 = __bfloat162float(src[2 * lane + 1]);
    const float amax = warp_max(fmaxf(fabsf(x0), fabsf(x1)));
    const float sc = __fdiv_rn(fmaxf(amax, 1e-12f), 127.0f);
    const float q0 = fminf(fmaxf(rintf(__fdiv_rn(x0, sc)), -127.0f), 127.0f);
    const float q1 = fminf(fmaxf(rintf(__fdiv_rn(x1, sc)), -127.0f), 127.0f);
    s8[warp][2 * lane] = (int8_t)q0;
    s8[warp][2 * lane + 1] = (int8_t)q1;
    if (lane == 0) sscale[warp] = sc;
    if (warp > 0) {                                // in-place cache insert
      int8_t* dst = (warp == 1 ? kc : vc) + (size_t)pos * DH;
      dst[2 * lane] = (int8_t)q0;
      dst[2 * lane + 1] = (int8_t)q1;
      if (lane == 0) (warp == 1 ? ksc : vsc)[pos] = sc;
    }
  }
  __syncthreads();
  const float q_scale = sscale[0];
  const int* sq = reinterpret_cast<const int*>(s8[0]);

  // ---- scores over rows [pad, pos]: a thread per row ----
  float lmax = -FLT_MAX;
  for (int s = pad + tid; s <= pos; s += NT) {
    const int4* kr = reinterpret_cast<const int4*>(
        s == pos ? s8[1] : kc + (size_t)s * DH);
    int acc = 0;
#pragma unroll
    for (int i = 0; i < DH / 16; ++i) {
      const int4 w = kr[i];
      acc = __dp4a(w.x, sq[4 * i + 0], acc);
      acc = __dp4a(w.y, sq[4 * i + 1], acc);
      acc = __dp4a(w.z, sq[4 * i + 2], acc);
      acc = __dp4a(w.w, sq[4 * i + 3], acc);
    }
    const float krs = s == pos ? sscale[1] : ksc[s];
    const float sc = __fmul_rn(__fmul_rn((float)acc, q_scale), krs);
    sP[s] = sc;
    lmax = fmaxf(lmax, sc);
  }
  const float m = block_reduce<NT>(lmax, sred, true);

  // ---- e, its sum, p = e * v_scale[row] and the largest p ----
  float lsum = 0.0f, lpm = 0.0f;
  for (int s = pad + tid; s <= pos; s += NT) {
    const float e = expf(sP[s] - m);
    lsum += e;
    const float p = __fmul_rn(e, s == pos ? sscale[2] : vsc[s]);
    sP[s] = p;
    lpm = fmaxf(lpm, fabsf(p));
  }
  const float denom = block_reduce<NT>(lsum, sred, false);
  const float pm = block_reduce<NT>(lpm, sred, true);
  const float ps = __fdiv_rn(fmaxf(pm, 1e-30f), 127.0f);
  for (int s = pad + tid; s <= pos; s += NT)
    sP8[s] = (int8_t)rintf(__fdiv_rn(sP[s], ps));
  __syncthreads();

  // ---- ctx[d] = sum_s p8[s] * v8[s, d]: thread (d, half) sums every other
  // row, the halves are added at the end ----
  const int d = tid % DH, half = tid / DH;
  int acc = 0;
  for (int s = pad + half; s <= pos; s += 2) {
    const int vv = s == pos ? (int)s8[2][d] : (int)vc[(size_t)s * DH + d];
    acc += (int)sP8[s] * vv;
  }
  sacc[tid] = acc;
  __syncthreads();
  if (tid < DH) {
    const float scale = __fdiv_rn(ps, denom);
    out[row * DH + tid] =
        __float2bfloat16_rn(__fmul_rn((float)(sacc[tid] + sacc[tid + DH]), scale));
  }
}

}  // namespace

WT_EXPORT int wt_self_attend_step_int8(const void* q, const void* k_new,
                                       const void* v_new, void* k_cache,
                                       void* v_cache, void* k_scale,
                                       void* v_scale, const void* pad_count,
                                       void* out, int B, int H, int S,
                                       int layer, int pos, void* stream) {
  const size_t smem = (size_t)S * (sizeof(float) + 1);
  self_step_int8_kernel<<<B * H, NT, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k_new, (const bf16*)v_new, (int8_t*)k_cache,
      (int8_t*)v_cache, (float*)k_scale, (float*)v_scale,
      (const int*)pad_count, (bf16*)out, B, H, S, layer, pos);
  return (int)cudaGetLastError();
}
