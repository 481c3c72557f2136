// B3: one-token decoder self-attention for layer `layer`, with the new K/V
// row written into the cache IN PLACE.
//
// Replaces whisper_tpu/ops/self_attention.py:self_attend_step_packed
// (_kernel).  The JAX kernel donates the cache through
// input_output_aliases={4: 1, 5: 2}; here the cache tensors are written
// where they lie: row `pos` of k_cache[layer, b, h] and v_cache[layer, b,
// h] becomes k_new[b, h] / v_new[b, h].  Contract: q (bf16, pre-scaled by
// 64^-0.5) is widened to fp32; scores q.k in fp32; rows outside
// [pad_count[b], pos] masked; softmax in fp32; probabilities cast to bf16
// and each p*v product ROUNDED TO BF16 before the fp32 sum (the JAX
// kernel's bf16 VPU multiply); context written in bf16.
//
// Layout: the port keeps the prefill layout [L, B, H, S, 64] for the cache
// (no head-pair packing onto 128 lanes: that existed for Mosaic).
//
// What bounds it on the H100: per call it reads one layer's cache rows
// [0, pos] for every (b, h): at whisper-base bucket 16 at most
// 16*8*132*64*2*2 = 4.3 MB, ~1.3 us of bandwidth, with 2*B*H*S*64 flops.
// So launch latency and the three dependent block reductions bound it,
// not bytes or flops.  Design: one block of 128 threads per (b, h); the
// new K/V row is also kept in shared memory and used for row `pos`, so no
// thread reads back a global write made in the same launch.
#include "common.cuh"

namespace {

constexpr int DH = 64;
constexpr int NT = 128;

__global__ void __launch_bounds__(NT)
self_step_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k_new,
                 const bf16* __restrict__ v_new, bf16* k_cache, bf16* v_cache,
                 const int* __restrict__ pad_count, bf16* __restrict__ out,
                 int B, int H, int S, int layer, int pos) {
  extern __shared__ float sP[];      // [S] scores, then probabilities
  __shared__ float sq[DH];
  __shared__ bf16 skn[DH], svn[DH];
  __shared__ float sred[NT / 32];
  __shared__ float sacc[NT];

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const size_t row = (size_t)b * H + h;
  const size_t cbase = (((size_t)layer * B + b) * H + h) * (size_t)S * DH;
  bf16* kc = k_cache + cbase;
  bf16* vc = v_cache + cbase;
  const int pad = pad_count[b];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid < DH) {
    sq[tid] = __bfloat162float(q[row * DH + tid]);
    skn[tid] = k_new[row * DH + tid];
    svn[tid] = v_new[row * DH + tid];
    kc[(size_t)pos * DH + tid] = skn[tid];   // in-place cache insert
    vc[(size_t)pos * DH + tid] = svn[tid];
  }
  __syncthreads();

  // Only rows [pad, pos] are attended; the masked rows' probabilities are
  // exactly 0 in the JAX kernel, so they are skipped here.
  // scores: warp w takes rows pad+w, pad+w+4, ...; lanes split the dims.
  float lmax = -FLT_MAX;
  for (int s = pad + warp; s <= pos; s += NT / 32) {
    const bf16* kr = (s == pos) ? skn : kc + (size_t)s * DH;
    float part = sq[2 * lane] * __bfloat162float(kr[2 * lane]) +
                 sq[2 * lane + 1] * __bfloat162float(kr[2 * lane + 1]);
    part = warp_sum(part);
    if (lane == 0) sP[s] = part;
    lmax = fmaxf(lmax, part);
  }
  const float m = block_reduce<NT>(lmax, sred, true);  // syncs: sP complete

  float lsum = 0.0f;
  for (int s = pad + tid; s <= pos; s += NT) {
    const float e = expf(sP[s] - m);
    sP[s] = e;
    lsum += e;
  }
  const float denom = block_reduce<NT>(lsum, sred, false);

  // ctx[d] = sum_s float(bf16(bf16(p_s) * v[s, d])): thread (d, half) sums
  // every other row, the halves are added at the end.
  const int d = tid % DH, half = tid / DH;
  float acc = 0.0f;
  for (int s = pad + half; s <= pos; s += 2) {
    const bf16 p = __float2bfloat16_rn(sP[s] / denom);
    const bf16 vv = (s == pos) ? svn[d] : vc[(size_t)s * DH + d];
    acc += __bfloat162float(__hmul(p, vv));
  }
  sacc[tid] = acc;
  __syncthreads();
  if (tid < DH) out[row * DH + tid] = __float2bfloat16_rn(sacc[tid] + sacc[tid + DH]);
}

}  // namespace

WT_EXPORT int wt_self_attend_step(const void* q, const void* k_new,
                                  const void* v_new, void* k_cache,
                                  void* v_cache, const void* pad_count,
                                  void* out, int B, int H, int S, int layer,
                                  int pos, void* stream) {
  self_step_kernel<<<B * H, NT, (size_t)S * sizeof(float),
                     (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k_new, (const bf16*)v_new, (bf16*)k_cache,
      (bf16*)v_cache, (const int*)pad_count, (bf16*)out, B, H, S, layer, pos);
  return (int)cudaGetLastError();
}
