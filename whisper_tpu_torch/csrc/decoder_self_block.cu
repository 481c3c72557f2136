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
// bitwise the plain version's (decoder_block.cuh says how).
//
// What bounds it on the H100: at whisper-base bucket 16 it reads 2.1 MB of
// weights and (pos + 1) * 2 * 16 KB of cache for 34 MFLOP: about a
// microsecond of device memory, less from L2, where the weights stay
// between steps.  At that size the launches are the cost, and the design is
// the plain one: three kernels on one stream inside one call.  (1)
// ln_gemm_kernel, 48 blocks, writes q (fp32 scratch) and the cache rows;
// (2) a block of 256 threads per (b, h), 128 blocks: a thread per cache row
// for the scores (a row of one head is 128 contiguous bytes), block
// reductions for the max and the sum, then each thread owns one of the 64
// columns for a quarter of the rows; rows > pos are never read; (3)
// out_proj_kernel, 32 blocks.  No atomics: a call's sums have one order.
// The cache stays time-major because that is the function's contract (what
// cache_to_time_major feeds); a Hopper kernel has no use for it.
#include "decoder_block.cuh"

namespace {

constexpr int DH = 64;
constexpr int NT = 256;

// ctx[b, h*64:(h+1)*64] = softmax(q_h . K^T over rows <= pos) . V, bf16.
// Blocks of the padding rows (b >= B) write zeros: out_proj reads 16-row
// tiles.
__global__ void __launch_bounds__(NT)
self_attn_kernel(const float* __restrict__ qbuf, const bf16* __restrict__ ck,
                 const bf16* __restrict__ cv, bf16* __restrict__ ctx, int B,
                 int H, int pos) {
  extern __shared__ float sS[];                 // [pos + 1] scores, then p
  __shared__ float sq[DH];
  __shared__ float sred[NT / 32];
  __shared__ float sacc[NT];
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int D = H * DH;
  const int tid = threadIdx.x;
  if (b >= B) {
    if (tid < DH) ctx[(size_t)b * D + h * DH + tid] = __float2bfloat16_rn(0.0f);
    return;
  }
  if (tid < DH) sq[tid] = qbuf[(size_t)b * D + h * DH + tid];
  __syncthreads();
  const size_t head = (size_t)b * D + h * DH;    // offset inside a cache row
  const size_t stride = (size_t)B * D;           // one time step

  float lmax = -FLT_MAX;
  for (int s = tid; s <= pos; s += NT) {
    const uint4* kr = reinterpret_cast<const uint4*>(ck + s * stride + head);
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < DH / 8; ++i) {
      const uint4 w = kr[i];
      const unsigned ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // two bf16 values a word: the low half first
        acc = __fmaf_rn(sq[8 * i + 2 * j], __uint_as_float(ws[j] << 16), acc);
        acc = __fmaf_rn(sq[8 * i + 2 * j + 1],
                        __uint_as_float(ws[j] & 0xffff0000u), acc);
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
    acc = __fmaf_rn(sS[s], __bfloat162float(cv[s * stride + head + d]), acc);
  sacc[tid] = acc;
  __syncthreads();
  if (tid < DH) {
    float c = sacc[tid];
#pragma unroll
    for (int g = 1; g < NT / DH; ++g) c = __fadd_rn(c, sacc[g * DH + tid]);
    ctx[head + tid] = __float2bfloat16_rn(c);
  }
}

}  // namespace

// qbuf: scratch of ceil(B / 16) * 16 rows of D floats; ctx: the same rows of
// D bf16 values.  cache_k, cache_v: [S, B, D] bf16, rows `pos` written.
WT_EXPORT int wt_decoder_self_block(const void* x, const void* ln,
                                    const void* qkv_w, const void* qkv_b,
                                    const void* o_w, const void* o_b,
                                    void* cache_k, void* cache_v, void* qbuf,
                                    void* ctx, void* out, int B, int D, int H,
                                    int S, int pos, void* stream) {
  if (B < 1 || D != H * DH || D % 128 != 0 || pos < 0 || pos >= S)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t row = (size_t)pos * B * D;
  int rc = launch_ln_gemm(x, ln, qkv_w, qkv_b, qbuf, (bf16*)cache_k + row,
                          (bf16*)cache_v + row, B, D, 3 * D,
                          1.0f / sqrtf((float)DH), s);
  if (rc != 0) return rc;
  const int rows = (B + BLK_RT - 1) / BLK_RT * BLK_RT;
  const size_t smem = (size_t)(pos + 1) * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  self_attn_kernel<<<rows * H, NT, smem, s>>>(
      (const float*)qbuf, (const bf16*)cache_k, (const bf16*)cache_v,
      (bf16*)ctx, B, H, pos);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  return launch_out_proj(ctx, o_w, o_b, x, out, B, D, s);
}
