// B4: one-token decoder cross-attention against the int8 cross cache of
// layer `layer`, with both attention dots as int8 x int8 -> int32.
//
// Replaces whisper_tpu/ops/cross_attention.py:cross_attend_step_packed with
// int8_mxu=True (_kernel_int8_mxu).  Contract: q is quantized per head by
// the wrapper (absmax/127, round half to even, clip +-127), as in JAX;
//   scores = (q8 . K8 as int32) * (q_scale * k_scale[layer]);
//   columns >= s_valid masked;  e = exp(s - max);
//   p8 = round_half_even(127 * e)  (rintf, NOT floor(x + 0.5));
//   ctx = (p8 . V8 as int32) * (v_scale / (127 * sum e)), written in bf16.
// The int32 sums are exact, so their order does not matter.
//
// Layout: the port keeps the prefill layout [L, B, H, S, 64] int8 for both
// K and V (no head-pair packing onto 128 lanes, no transposed K: those
// existed for Mosaic).  Row s of K is 64 contiguous bytes, read as four
// 16-byte vectors and reduced with __dp4a.
//
// What bounds it on the H100: per call it streams one layer's K and V:
// at whisper-base bucket 16, 16*8*1500*64*2 = 24.6 MB (7.3 us at
// 3.35 TB/s) for 4*16*8*1500*64 = 49 M int8 ops, so bytes bound it.
// Design: one block of 256 threads per (b, h), 128 blocks; K rows are
// spread over the threads (one dp4a chain of 16 per row), block
// reductions give the max and the sum, p8 is kept in shared memory, and
// for P.V each thread owns one of the 64 columns for a quarter of the
// rows, so a warp reads 32 consecutive bytes of a V row.  128 blocks on
// 132 SMs leave each SM one block, which caps the bandwidth one block can
// pull: more blocks per (b, h) with a second reduction pass is the next
// step.
#include "common.cuh"

namespace {

constexpr int DH = 64;
constexpr int NT = 256;

__global__ void __launch_bounds__(NT)
cross_step_kernel(const int8_t* __restrict__ q8, const float* __restrict__ qks,
                  const float* __restrict__ vds, const int8_t* __restrict__ k8,
                  const int8_t* __restrict__ v8, bf16* __restrict__ out, int B,
                  int H, int S, int layer, int s_valid) {
  extern __shared__ float sS[];                 // [S] scores, then e
  int8_t* sP8 = reinterpret_cast<int8_t*>(sS + S);  // [S] p8
  __shared__ int sq[DH / 4];
  __shared__ float sred[NT / 32];
  __shared__ int sacc[NT];

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const size_t row = (size_t)b * H + h;
  const size_t cbase = (((size_t)layer * B + b) * H + h) * (size_t)S * DH;
  const int8_t* kc = k8 + cbase;
  const int8_t* vc = v8 + cbase;
  const int tid = threadIdx.x;

  if (tid < DH / 4) sq[tid] = reinterpret_cast<const int*>(q8 + row * DH)[tid];
  __syncthreads();
  const float qk_scale = qks[row];

  float lmax = -FLT_MAX;
  for (int s = tid; s < S; s += NT) {
    const int4* kr = reinterpret_cast<const int4*>(kc + (size_t)s * DH);
    int acc = 0;
#pragma unroll
    for (int i = 0; i < DH / 16; ++i) {
      const int4 w = kr[i];
      acc = __dp4a(w.x, sq[4 * i + 0], acc);
      acc = __dp4a(w.y, sq[4 * i + 1], acc);
      acc = __dp4a(w.z, sq[4 * i + 2], acc);
      acc = __dp4a(w.w, sq[4 * i + 3], acc);
    }
    const float sc = s < s_valid ? (float)acc * qk_scale : -FLT_MAX;
    sS[s] = sc;
    lmax = fmaxf(lmax, sc);
  }
  const float m = block_reduce<NT>(lmax, sred, true);

  float lsum = 0.0f;
  for (int s = tid; s < S; s += NT) {
    const float e = expf(sS[s] - m);   // masked columns give exactly 0
    lsum += e;
    sP8[s] = (int8_t)__float2int_rn(e * 127.0f);
  }
  const float denom = block_reduce<NT>(lsum, sred, false);  // syncs sP8

  const int d = tid % DH, grp = tid / DH;
  int acc = 0;
  for (int s = grp; s < S; s += NT / DH)
    acc += (int)sP8[s] * (int)vc[(size_t)s * DH + d];
  sacc[tid] = acc;
  __syncthreads();
  if (tid < DH) {
    int ctx = 0;
#pragma unroll
    for (int g = 0; g < NT / DH; ++g) ctx += sacc[g * DH + tid];
    const float scale = vds[row] / (127.0f * denom);
    out[row * DH + tid] = __float2bfloat16_rn((float)ctx * scale);
  }
}

}  // namespace

WT_EXPORT int wt_cross_attend_step(const void* q8, const void* qk_scale,
                                   const void* v_scale, const void* k8,
                                   const void* v8, void* out, int B, int H,
                                   int S, int layer, int s_valid,
                                   void* stream) {
  const size_t smem = (size_t)S * (sizeof(float) + 1);
  cross_step_kernel<<<B * H, NT, smem, (cudaStream_t)stream>>>(
      (const int8_t*)q8, (const float*)qk_scale, (const float*)v_scale,
      (const int8_t*)k8, (const int8_t*)v8, (bf16*)out, B, H, S, layer,
      s_valid);
  return (int)cudaGetLastError();
}
