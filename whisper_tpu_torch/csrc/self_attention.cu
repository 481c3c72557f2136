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
// kernel's bf16 VPU multiply); context written in bf16.  `pos` arrives as
// an argument or, as the JAX kernel's scalar prefetch, is read from device
// memory, so that every step of a decode loop is the same launch.
//
// Layout: the port keeps the prefill layout [L, B, H, S, 64] for the cache
// (no head-pair packing onto 128 lanes: that existed for Mosaic).
//
// What bounds it on the H100: per call it reads one layer's cache rows
// [pad, pos] for every (b, h): at whisper-base bucket 16 at most
// 16*8*132*64*2*2 = 4.3 MB, ~1.3 us of bandwidth, with 4*B*H*S*64 flops.
// So latency bounds it, not bytes or flops: the launch, one trip to device
// memory and a handful of block barriers.  Design: one block of 128 threads
// per (b, h).
//   * Rows [pad, pos) of K and of V are contiguous, 128 bytes a row: thread
//     0 asks for each as one bulk asynchronous copy on an mbarrier at entry
//     (at most 2 * 447 * 128 bytes), so every byte is in flight at once
//     while q, k_new and v_new are read and the insert is written.  The new
//     row goes to shared memory behind the copied rows as well, so no
//     thread reads back a global write made in the same launch.
//   * Everything after the wait reads shared memory.  Scores: eight lanes a
//     row, 16 bytes a lane (a warp reads four whole rows, 512 contiguous
//     bytes: no bank conflict), three shuffles a row.  One max, one sum;
//     p = bf16(e / denom) is formed once per row; P.V with a lane on two
//     neighbouring dims and the four warps on every fourth row, their
//     partial sums added in warp order.
//   * A `pos` outside [0, S) can only come from device memory (the wrapper
//     checks an int): the block writes NaN to its outputs, touches no
//     cache row and returns.
#include "hopper.cuh"

namespace {

constexpr int DH = 64;
constexpr int NT = 128;
constexpr int NW = NT / 32;
constexpr int ROW_BYTES = DH * 2;

__global__ void __launch_bounds__(NT)
self_step_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k_new,
                 const bf16* __restrict__ v_new, bf16* k_cache, bf16* v_cache,
                 const int* __restrict__ pad_count, bf16* __restrict__ out,
                 int B, int H, int S, int layer, int pos_arg,
                 const int* __restrict__ pos_ptr, int max_rows) {
  // [K rows][V rows][scores, then e][p]: max_rows rows each
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + (size_t)max_rows * DH;
  float* sS = reinterpret_cast<float*>(sV + (size_t)max_rows * DH);
  bf16* sP = reinterpret_cast<bf16*>(sS + max_rows);
  __shared__ float red[2][NW];
  __shared__ float part[NW][DH];
  __shared__ __align__(8) uint64_t bar_mem;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const size_t row = (size_t)b * H + h;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int pos = pos_ptr ? *pos_ptr : pos_arg;
  if (pos < 0 || pos >= S) {
    if (tid < DH) out[row * DH + tid] = __float2bfloat16_rn(NAN);
    return;
  }
  const size_t cbase = (((size_t)layer * B + b) * H + h) * (size_t)S * DH;
  bf16* kc = k_cache + cbase;
  bf16* vc = v_cache + cbase;
  const int pad = pad_count ? min(max(pad_count[b], 0), pos) : 0;
  const int n_old = pos - pad;      // cached rows [pad, pos)
  const int n = n_old + 1;          // and the new one
  const uint32_t bar = smem_u32(&bar_mem);

  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
    const uint32_t bytes = (uint32_t)n_old * ROW_BYTES;
    mbar_arrive_expect_tx(bar, 2 * bytes);
    if (bytes) {
      bulk_load_1d(smem_u32(sK), kc + (size_t)pad * DH, bytes, bar);
      bulk_load_1d(smem_u32(sV), vc + (size_t)pad * DH, bytes, bar);
    }
  }
  // the new row: into the cache (the in-place insert) and behind the copied
  // rows; threads 0-7 carry K, 8-15 V, 16 bytes each
  if (tid < 16) {
    const int c = tid % 8;
    const bf16* src = (tid < 8 ? k_new : v_new) + row * DH;
    const uint4 val = reinterpret_cast<const uint4*>(src)[c];
    reinterpret_cast<uint4*>((tid < 8 ? kc : vc) + (size_t)pos * DH)[c] = val;
    reinterpret_cast<uint4*>((tid < 8 ? sK : sV) + (size_t)n_old * DH)[c] = val;
  }
  // q: lane c of every group of eight holds dims 8c .. 8c + 7 in fp32
  float qv[8];
  {
    const uint4 raw = reinterpret_cast<const uint4*>(q + row * DH)[lane % 8];
    const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[2 * i] = __low2float(p2[i]);
      qv[2 * i + 1] = __high2float(p2[i]);
    }
  }
  __syncthreads();  // the barrier and the new row are visible
  mbar_wait(bar, 0);

  // ---- scores: a group of eight lanes a row, sixteen rows a pass ----
  float lmax = -FLT_MAX;
  for (int s0 = 0; s0 < n; s0 += NT / 8) {
    const int s = s0 + tid / 8;
    float acc = 0.0f;
    if (s < n) {
      const uint4 raw =
          reinterpret_cast<const uint4*>(sK + (size_t)s * DH)[lane % 8];
      const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc = fmaf(qv[2 * i], __low2float(p2[i]), acc);
        acc = fmaf(qv[2 * i + 1], __high2float(p2[i]), acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    acc += __shfl_xor_sync(0xffffffffu, acc, 4);
    if (s < n) {
      if (lane % 8 == 0) sS[s] = acc;
      lmax = fmaxf(lmax, acc);
    }
  }
  lmax = warp_max(lmax);
  if (lane == 0) red[0][warp] = lmax;
  __syncthreads();  // the scores and the warps' maxima are written
  float m = red[0][0];
#pragma unroll
  for (int w = 1; w < NW; ++w) m = fmaxf(m, red[0][w]);

  // ---- e = exp(s - m) and its sum ----
  float lsum = 0.0f;
  for (int s = tid; s < n; s += NT) {
    const float e = expf(sS[s] - m);
    sS[s] = e;
    lsum += e;
  }
  lsum = warp_sum(lsum);
  if (lane == 0) red[1][warp] = lsum;
  __syncthreads();
  float denom = red[1][0];
#pragma unroll
  for (int w = 1; w < NW; ++w) denom += red[1][w];

  // ---- p = bf16(e / denom), once per row (each thread its own rows) ----
  for (int s = tid; s < n; s += NT)
    sP[s] = __float2bfloat16_rn(__fdiv_rn(sS[s], denom));
  __syncthreads();

  // ---- ctx[d] = sum_s float(bf16(p_s * v[s, d])): lane on dims 2 lane and
  // 2 lane + 1, warp w on rows w, w + 4, ... ----
  float a0 = 0.0f, a1 = 0.0f;
  for (int s = warp; s < n; s += NW) {
    const __nv_bfloat162 v2 =
        reinterpret_cast<const __nv_bfloat162*>(sV + (size_t)s * DH)[lane];
    const __nv_bfloat162 pv = __hmul2(__bfloat162bfloat162(sP[s]), v2);
    a0 += __low2float(pv);
    a1 += __high2float(pv);
  }
  part[warp][2 * lane] = a0;
  part[warp][2 * lane + 1] = a1;
  __syncthreads();
  if (tid < DH) {
    float acc = part[0][tid];
#pragma unroll
    for (int w = 1; w < NW; ++w) acc += part[w][tid];
    out[row * DH + tid] = __float2bfloat16_rn(acc);
  }
}

// The dynamic shared memory allowed so far; 0 sets the limit at the first
// call, since the kernel's static shared memory counts against the 48 KB a
// launch gets unasked (without it pos 183-186 failed to launch).
size_t step_allowed = 0;

}  // namespace

// `pos_ptr`: one int32 in device memory that holds pos, or null, and then
// `pos` is it.  `pad_count` may be null: no row is padded.
WT_EXPORT int wt_self_attend_step(const void* q, const void* k_new,
                                  const void* v_new, void* k_cache,
                                  void* v_cache, const void* pad_count,
                                  void* out, int B, int H, int S, int layer,
                                  int pos, const void* pos_ptr, void* stream) {
  if (B < 1 || H < 1 || S < 1) return (int)cudaErrorInvalidValue;
  // shared memory for the rows this launch can need: [0, pos], or with pos
  // on the device all S
  const int max_rows = pos_ptr ? S : pos + 1;
  const size_t smem = (size_t)max_rows * (2 * ROW_BYTES + 4 + 2) + 16;
  const cudaError_t rc =
      allow_smem((const void*)self_step_kernel, smem, step_allowed);
  if (rc != cudaSuccess) return (int)rc;
  self_step_kernel<<<B * H, NT, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k_new, (const bf16*)v_new, (bf16*)k_cache,
      (bf16*)v_cache, (const int*)pad_count, (bf16*)out, B, H, S, layer, pos,
      (const int*)pos_ptr, max_rows);
  return (int)cudaGetLastError();
}
