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
//   scores = (q8 . K8 as int32) * q_scale * k_scale[row] over rows
//   [pad_count[b], pos] (the others are never read, so whatever stale bytes
//   they hold weigh nothing);  e = exp(s - max), denom = sum e;
//   p = e * v_scale[row];  ps = max(max p, 1e-30) / 127;  p8 = rint(p / ps);
//   ctx = (p8 . V8 as int32) * (ps / denom), written in bf16.
// The int32 sums are exact, so their order does not matter; sum e is taken
// in one fixed order (a thread's rows in sequence, the xor tree of a warp,
// the warps in sequence), a function of the rows alone.
//
// Layout: the prefill layout [L, B, H, S, 64] int8 with [L, B, H, S] fp32
// scale planes (no head-pair packing, no padding of S: those existed for
// Mosaic).
//
// What bounds it on the H100: per call it reads one layer's int8 rows
// [pad, pos] and their scales for every (b, h): at whisper-base bucket 16
// at most 16*8*132*(64+4)*2 = 2.3 MB, under 1 us of bandwidth, with
// 4*B*H*S*64 int8 operations.  So latency bounds it: the launch, one trip
// to device memory and the block barriers.  Design: B3's
// (self_attention.cu), one block of 128 threads per (b, h).
//   * Rows [pad, pos) of K8 and V8 are contiguous, 64 bytes a row: thread 0
//     asks for each as one bulk asynchronous copy on an mbarrier at entry,
//     so every byte is in flight at once while warps 0-2 quantize q, k_new
//     and v_new (cross_quantize_q) and every thread loads the rows' scales
//     (a scale plane starts on a 16-byte boundary only when S % 4 == 0, so
//     the scales come by plain coalesced loads).  The new row and its
//     scales go to shared memory behind the copied rows as well, so no
//     thread reads back a global write made in the same launch.
//   * Everything after the wait reads shared memory.  Scores: four lanes a
//     row, a 16-byte word and four __dp4a each, two shuffles.  Two
//     reductions: the max, then the sum of e with the largest p.  P.V:
//     cross_pv (cross_attention.cuh), p8 and V8 in 4-byte words through
//     __dp4a against four rows transposed in registers.
//   * `pos` arrives as an argument or is read from device memory, so that
//     every step of a decode loop is the same launch (a CUDA graph replays
//     it).  Outside [0, S) (only from device memory: the wrapper checks an
//     int) the block writes NaN to its outputs, touches no cache row or
//     scale and returns.
#include "cross_attention.cuh"

namespace {

constexpr int DH = 64;
constexpr int NT = 128;
constexpr int NW = NT / 32;

// Bytes of dynamic shared memory for `rows` rows: K8 and V8 rows, p8 padded
// to 8 rows (cross_pv reads it in 8-byte words), then the scores (later p)
// and the K and V scales.
__host__ __device__ constexpr size_t step_smem(int rows) {
  return (size_t)rows * (2 * DH + 3 * sizeof(float)) + (rows + 7) / 8 * 8;
}

__global__ void __launch_bounds__(NT)
self_step_int8_kernel(const bf16* __restrict__ q,
                      const bf16* __restrict__ k_new,
                      const bf16* __restrict__ v_new, int8_t* k_cache,
                      int8_t* v_cache, float* k_scale, float* v_scale,
                      const int* __restrict__ pad_count, bf16* __restrict__ out,
                      int B, int H, int S, int layer, int pos_arg,
                      const int* __restrict__ pos_ptr, int max_rows) {
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* sK = reinterpret_cast<int8_t*>(smem);
  int8_t* sV = sK + (size_t)max_rows * DH;
  int8_t* sP8 = sV + (size_t)max_rows * DH;
  float* sS = reinterpret_cast<float*>(sP8 + (max_rows + 7) / 8 * 8);
  float* sKs = sS + max_rows;
  float* sVs = sKs + max_rows;
  __shared__ __align__(16) int8_t sQ8[DH];
  __shared__ float sQs;
  __shared__ float red[3][NW];
  __shared__ int part[NW][DH];
  __shared__ __align__(8) uint64_t bar_mem;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const size_t row = (size_t)b * H + h;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int pos = pos_ptr ? *pos_ptr : pos_arg;
  if (pos < 0 || pos >= S) {
    if (tid < DH) out[row * DH + tid] = __float2bfloat16_rn(NAN);
    return;
  }
  const size_t plane = ((size_t)layer * B + b) * H + h;
  int8_t* kc = k_cache + plane * (size_t)S * DH;
  int8_t* vc = v_cache + plane * (size_t)S * DH;
  float* ksc = k_scale + plane * (size_t)S;
  float* vsc = v_scale + plane * (size_t)S;
  const int pad = pad_count ? min(max(pad_count[b], 0), pos) : 0;
  const int n_old = pos - pad;      // cached rows [pad, pos)
  const int n = n_old + 1;          // and the new one
  const uint32_t bar = smem_u32(&bar_mem);

  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
    const uint32_t bytes = (uint32_t)n_old * DH;
    mbar_arrive_expect_tx(bar, 2 * bytes);
    if (bytes) {
      bulk_load_1d(smem_u32(sK), kc + (size_t)pad * DH, bytes, bar);
      bulk_load_1d(smem_u32(sV), vc + (size_t)pad * DH, bytes, bar);
    }
  }
  // q (warp 0), k_new (warp 1), v_new (warp 2) quantized per head; the new
  // rows behind the copied ones in shared memory, then into the cache
  if (warp < 3) {
    const bf16* src = (warp == 0 ? q : warp == 1 ? k_new : v_new) + row * DH;
    int8_t* dst = warp == 0 ? sQ8 : (warp == 1 ? sK : sV) + (size_t)n_old * DH;
    const float sc = cross_quantize_q(src, dst);
    __syncwarp();
    if (warp == 0) {
      if (lane == 0) sQs = sc;
    } else {
      int8_t* row_pos = (warp == 1 ? kc : vc) + (size_t)pos * DH;
      if (lane < DH / 16)
        reinterpret_cast<int4*>(row_pos)[lane] =
            reinterpret_cast<const int4*>(dst)[lane];
      if (lane == 0) {
        (warp == 1 ? sKs : sVs)[n_old] = sc;
        (warp == 1 ? ksc : vsc)[pos] = sc;
      }
    }
  }
  for (int s = tid; s < n_old; s += NT) {
    sKs[s] = ksc[pad + s];
    sVs[s] = vsc[pad + s];
  }
  __syncthreads();  // the barrier, q8, the new rows and the scales
  mbar_wait(bar, 0);

  // ---- scores: a quad of lanes a row, 32 rows a pass ----
  const float q_scale = sQs;
  const int c = tid % 4;
  const int4 qv = reinterpret_cast<const int4*>(sQ8)[c];
  float lmax = -FLT_MAX;
  for (int r0 = 0; r0 < n; r0 += NT / 4) {  // bounds uniform in a warp
    const int r = r0 + tid / 4;
    int acc = 0;
    if (r < n) {
      const int4 w = reinterpret_cast<const int4*>(sK + (size_t)r * DH)[c];
      acc = __dp4a(w.x, qv.x, acc);
      acc = __dp4a(w.y, qv.y, acc);
      acc = __dp4a(w.z, qv.z, acc);
      acc = __dp4a(w.w, qv.w, acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (r < n) {
      const float sc = __fmul_rn(__fmul_rn((float)acc, q_scale), sKs[r]);
      if (c == 0) sS[r] = sc;
      lmax = fmaxf(lmax, sc);
    }
  }
  lmax = warp_max(lmax);
  if (lane == 0) red[0][warp] = lmax;
  __syncthreads();  // the scores and the warps' maxima
  float m = red[0][0];
#pragma unroll
  for (int w = 1; w < NW; ++w) m = fmaxf(m, red[0][w]);

  // ---- e, p = e * v_scale[row]: the sum of e and the largest p together --
  float lsum = 0.0f, lpm = 0.0f;
  for (int s = tid; s < n; s += NT) {
    const float e = expf(__fsub_rn(sS[s], m));
    const float p = __fmul_rn(e, sVs[s]);
    lsum = __fadd_rn(lsum, e);
    lpm = fmaxf(lpm, fabsf(p));
    sS[s] = p;
  }
  lsum = warp_sum(lsum);
  lpm = warp_max(lpm);
  if (lane == 0) {
    red[1][warp] = lsum;
    red[2][warp] = lpm;
  }
  __syncthreads();
  float denom = red[1][0], pm = red[2][0];
#pragma unroll
  for (int w = 1; w < NW; ++w) {
    denom = __fadd_rn(denom, red[1][w]);
    pm = fmaxf(pm, red[2][w]);
  }
  const float ps = __fdiv_rn(fmaxf(pm, 1e-30f), 127.0f);
  for (int s = tid; s < n; s += NT)  // each thread its own rows of p
    sP8[s] = (int8_t)rintf(__fdiv_rn(sS[s], ps));
  __syncthreads();

  // ---- ctx = (p8 . V8) * (ps / denom) ----
  const int ctx = cross_pv<NT>(sP8, sV, n, part);
  if (tid < DH)
    out[row * DH + tid] =
        __float2bfloat16_rn(__fmul_rn((float)ctx, __fdiv_rn(ps, denom)));
}

// The dynamic shared memory allowed so far; 0 sets the limit at the first
// call: the static shared memory counts against the 48 KB unasked.
size_t step_allowed = 0;

}  // namespace

// `pos_ptr`: one int32 in device memory that holds pos, or null, and then
// `pos` is it.  `pad_count` may be null: no row is padded.
WT_EXPORT int wt_self_attend_step_int8(const void* q, const void* k_new,
                                       const void* v_new, void* k_cache,
                                       void* v_cache, void* k_scale,
                                       void* v_scale, const void* pad_count,
                                       void* out, int B, int H, int S,
                                       int layer, int pos, const void* pos_ptr,
                                       void* stream) {
  if (B < 1 || H < 1 || S < 1) return (int)cudaErrorInvalidValue;
  // shared memory for the rows this launch can need: [0, pos], or with pos
  // on the device all S
  const int max_rows = pos_ptr ? S : pos + 1;
  const size_t smem = step_smem(max_rows);
  const cudaError_t rc =
      allow_smem((const void*)self_step_int8_kernel, smem, step_allowed);
  if (rc != cudaSuccess) return (int)rc;
  self_step_int8_kernel<<<B * H, NT, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k_new, (const bf16*)v_new, (int8_t*)k_cache,
      (int8_t*)v_cache, (float*)k_scale, (float*)v_scale,
      (const int*)pad_count, (bf16*)out, B, H, S, layer, pos,
      (const int*)pos_ptr, max_rows);
  return (int)cudaGetLastError();
}
