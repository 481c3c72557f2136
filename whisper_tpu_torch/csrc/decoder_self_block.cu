// B10a: the decoder's self-attention block for one decode step,
// x [B, d] bf16 -> x + O(attention(LN(x))), with the step's k and v rows
// written in place into the time-major self cache [S, B, d] at `pos`.
//
// Replaces whisper_tpu/ops/decoder_kernels.py:self_attn_block (_self_kernel).
// Contract, as there: LayerNorm (eps 1e-5) cast to bf16; one [d, 3d] QKV
// product + bias in fp32; k and v rounded to bf16 into rows `pos` of the
// cache (rows > pos untouched); per head q * Dh^-0.5 kept in fp32, fp32
// scores over the cache rows <= pos, softmax as p / sum(p), p . V in fp32
// with V widened from bf16; ctx rounded to bf16; the O product accumulated
// in fp32, + bias, + x, one rounding to bf16.  What lands in the cache is
// bitwise the plain version's (decoder_block.cuh says how).  `pos` is an
// int or one int32 in device memory (the JAX kernel's SMEM scalar), so a
// captured CUDA graph replays every step; a `pos` outside [0, S) writes no
// cache row and gives NaN.
//
// What bounds it on the H100: at whisper-base bucket 16 it reads 2.1 MB of
// weights and (pos + 1) * 2 * 16 KB of cache for 34 MFLOP: about a
// microsecond of device memory, less from L2.  Three kernels on one stream
// inside one call, each the programmatic dependent of the one before, so
// each fetches what its predecessor does not write while that one runs:
// (1) ln_gemm_kernel (decoder_block.cuh: 24 clusters of 8 blocks, W by
// cp.async, the LN statistics shared in the cluster, fp64 mma) writes q
// (fp32 scratch) and the cache rows; (2) a block of 256 threads per (b, h):
// the head's cache rows [0, pos) by cp.async into shared memory while (1)
// runs, then row pos; a thread per row for the scores, block reductions for
// the max and the sum, then each thread owns one of the 64 columns for a
// quarter of the rows; rows > pos are never read; (3) out_proj_kernel, a
// cluster of 4 blocks per 16 columns.  No atomics: a call's sums have one
// order.  The cache stays time-major because that is the function's
// contract (what cache_to_time_major feeds); a Hopper kernel has no use for
// it.
#include "decoder_block.cuh"

namespace {

constexpr int DH = 64;
constexpr int NT = 256;
constexpr int MAX_S = 768;   // a head's K and V rows in shared memory: 192 KB

// ctx[b, h*64:(h+1)*64] = softmax(q_h . K^T over rows <= pos) . V, bf16; a
// block per (b, h), NaN where `pos` lies outside [0, S).  Launched as
// ln_gemm's programmatic dependent: it copies the head's cache rows [0,
// pos) (which ln_gemm does not write) into shared memory while ln_gemm
// runs, and row `pos` and q after it.  Dynamic shared memory: [S][64] K,
// [S][64] V, [S] fp32 scores.
__global__ void __launch_bounds__(NT)
self_attn_kernel(const float* __restrict__ qbuf, const bf16* __restrict__ ck,
                 const bf16* __restrict__ cv, bf16* __restrict__ ctx, int B,
                 int H, int S, int pos_arg, const int* __restrict__ pos_ptr) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + (size_t)S * DH;
  float* sS = reinterpret_cast<float*>(sV + (size_t)S * DH);
  __shared__ float sq[DH];
  __shared__ float sred[NT / 32];
  __shared__ float sacc[NT];
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int D = H * DH;
  const int tid = threadIdx.x;
  const size_t head = (size_t)b * D + h * DH;    // offset inside a cache row
  const size_t stride = (size_t)B * D;           // one time step
  grid_launch_dependents();  // the O product may fetch its weights
  const int pos = pos_ptr ? *pos_ptr : pos_arg;
  const bool valid = pos >= 0 && pos < S;
  // rows [0, pos) of K, then of V: 8 words of 16 bytes a row
  for (int i = tid; valid && i < 16 * pos; i += NT) {
    const int kv = i / (8 * pos), r = i / 8 % pos, c = i % 8;
    cp_async16(smem_u32((kv ? sV : sK) + r * DH + 8 * c),
               (kv ? cv : ck) + r * stride + head + 8 * c);
  }
  cp_async_commit();
  grid_dependency_wait();  // ln_gemm has written q and the cache rows
  if (!valid) {
    if (tid < DH)
      ctx[head + tid] = __float2bfloat16_rn(__int_as_float(0x7fc00000));
    return;  // NaN: no row was copied
  }
  if (tid < 16) {
    const int kv = tid / 8, c = tid % 8;
    cp_async16(smem_u32((kv ? sV : sK) + pos * DH + 8 * c),
               (kv ? cv : ck) + pos * stride + head + 8 * c);
  }
  cp_async_commit();
  if (tid < DH) sq[tid] = qbuf[head + tid];
  cp_async_wait<0>();
  __syncthreads();

  // a thread a row; each starts its row at another 16-byte word (rot), so a
  // quarter warp reads 8 different banks; q in registers in that order
  const int rot = tid & 7;
  float qr[DH];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int e = 0; e < 8; ++e) qr[8 * j + e] = sq[8 * ((j + rot) & 7) + e];
  float lmax = -FLT_MAX;
  for (int s = tid; s <= pos; s += NT) {         // s % 8 == rot
    const uint4* kr = reinterpret_cast<const uint4*>(sK + s * DH);
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      const uint4 w = kr[(j + rot) & 7];
      const unsigned ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        // two bf16 values a word: the low half first
        acc = __fmaf_rn(qr[8 * j + 2 * c], __uint_as_float(ws[c] << 16), acc);
        acc = __fmaf_rn(qr[8 * j + 2 * c + 1],
                        __uint_as_float(ws[c] & 0xffff0000u), acc);
      }
    }
    sS[s] = acc;
    lmax = fmaxf(lmax, acc);
  }
  const float m = block_reduce<NT>(lmax, sred, true);
  float lsum = 0.0f;
  for (int s = tid; s <= pos; s += NT) {
    const float e = expf(sS[s] - m);
    sS[s] = e;
    lsum += e;
  }
  const float denom = block_reduce<NT>(lsum, sred, false);
  for (int s = tid; s <= pos; s += NT) sS[s] = __fdiv_rn(sS[s], denom);
  __syncthreads();

  const int d = tid % DH, grp = tid / DH;
  float acc = 0.0f;
  for (int s = grp; s <= pos; s += NT / DH)
    acc = __fmaf_rn(sS[s], __bfloat162float(sV[s * DH + d]), acc);
  sacc[tid] = acc;
  __syncthreads();
  if (tid < DH) {
    float c = sacc[tid];
#pragma unroll
    for (int g = 1; g < NT / DH; ++g) c = __fadd_rn(c, sacc[g * DH + tid]);
    ctx[head + tid] = __float2bfloat16_rn(c);
  }
}

size_t attn_allowed = 0;   // set at the first call: past static memory

}  // namespace

// qbuf: scratch of ceil(B / 16) * 16 rows of D floats; ctx: the same rows of
// D bf16 values.  cache_k, cache_v: [S, B, D] bf16, rows `pos` written.
// `pos_ptr`: one int32 in device memory that holds pos, or null, and then
// `pos` is it.
WT_EXPORT int wt_decoder_self_block(const void* x, const void* ln,
                                    const void* qkv_w, const void* qkv_b,
                                    const void* o_w, const void* o_b,
                                    void* cache_k, void* cache_v, void* qbuf,
                                    void* ctx, void* out, int B, int D, int H,
                                    int S, int pos, const void* pos_ptr,
                                    void* stream) {
  if (B < 1 || D != H * DH || D % 128 != 0 || S < 1 || S > MAX_S ||
      (!pos_ptr && (pos < 0 || pos >= S)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int rc = launch_ln_gemm(x, ln, qkv_w, qkv_b, qbuf, cache_k, cache_v,
                          pos_ptr, pos, S, B, D, 3 * D,
                          1.0f / sqrtf((float)DH), false, s);
  if (rc != 0) return rc;
  // shared memory for S rows, whatever `pos` turns out to be on the device
  const size_t smem = (size_t)S * (2 * DH * 2 + sizeof(float));
  const cudaError_t err =
      allow_smem((const void*)self_attn_kernel, smem, attn_allowed);
  if (err != cudaSuccess) return (int)err;
  rc = launch_ex(self_attn_kernel, dim3(B * H), NT, smem, s, 1, true,
                 (const float*)qbuf, (const bf16*)cache_k,
                 (const bf16*)cache_v, (bf16*)ctx, B, H, S, pos,
                 (const int*)pos_ptr);
  if (rc != 0) return rc;
  return launch_out_proj(ctx, o_w, o_b, x, out, B, D, s);
}
