// B10b: the decoder's cross-attention block for one decode step,
// x [B, d] bf16 -> x + O(attention(LN(x), cross K/V)), against the bf16
// cross K/V [B, H, T, 64] of one layer.
//
// Replaces whisper_tpu/ops/decoder_kernels.py:cross_attn_block
// (_cross_kernel).  Contract, as there: LayerNorm (eps 1e-5) cast to bf16;
// the Q product + bias, times Dh^-0.5, kept in fp32; an online softmax over
// blocks of 64 keys (running max from -1e30, running sum and accumulator
// rescaled by exp(m_old - m_new), all fp32, K and V widened from bf16); ctx
// = acc / sum rounded to bf16; the O product accumulated in fp32, + bias,
// + x, one rounding to bf16.  No pad mask; keys past T do not exist here
// (the JAX wrapper pads T to a multiple of 64 and masks the padding).
//
// What bounds it on the H100: it streams one layer's bf16 K and V, 2 x
// 24.6 MB at whisper-base bucket 16: 14.7 us at 3.35 TB/s, twice B4's
// bytes, for 49 MFLOP of fp32 work.  Design: three kernels on one stream
// inside one call.  (1) ln_gemm_kernel (q only, 16 blocks); (2) a block of
// 256 threads per (b, h), 128 blocks: each of the 8 warps walks its own
// blocks of 64 keys (warp w takes blocks w, w + 8, ...) with its own
// running max, sum and accumulator, a lane scoring two keys (a K row is 128
// contiguous bytes) and owning two of the 64 output columns for P.V; the 8
// partial states are merged at the end in a fixed order, as a split
// softmax is; (3) out_proj_kernel.  The online softmax thus runs over
// blocks of 64 keys in another order than the TPU's sequential grid, within
// the tolerance the plain version is held to.  As with B4, one block per
// (b, h) caps what one SM pulls; more blocks per head is the next step.
#include "decoder_block.cuh"

namespace {

constexpr int DH = 64;
constexpr int NT = 256;
constexpr int NW = NT / 32;
constexpr int BK = 64;             // keys per online-softmax block
constexpr float NEG_INF = -1e30f;  // the JAX kernel's, not -FLT_MAX

__global__ void __launch_bounds__(NT)
cross_attn_kernel(const float* __restrict__ qbuf, const bf16* __restrict__ ck,
                  const bf16* __restrict__ cv, bf16* __restrict__ ctx, int B,
                  int H, int T) {
  __shared__ float sq[DH];
  __shared__ float sP[NW][BK];
  __shared__ float sM[NW], sL[NW];
  __shared__ float sA[NW][DH];
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int D = H * DH;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (b >= B) {
    if (tid < DH) ctx[(size_t)b * D + h * DH + tid] = __float2bfloat16_rn(0.0f);
    return;
  }
  if (tid < DH) sq[tid] = qbuf[(size_t)b * D + h * DH + tid];
  __syncthreads();
  float qr[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) qr[d] = sq[d];
  const size_t base = ((size_t)b * H + h) * (size_t)T * DH;
  const bf16* kc = ck + base;
  const bf16* vc = cv + base;

  float m = NEG_INF, l = 0.0f, a0 = 0.0f, a1 = 0.0f;
  const int nblk = (T + BK - 1) / BK;
  for (int jb = warp; jb < nblk; jb += NW) {
    float sc[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int s = jb * BK + lane + 32 * u;
      float acc = NEG_INF;
      if (s < T) {
        const uint4* kr = reinterpret_cast<const uint4*>(kc + (size_t)s * DH);
        acc = 0.0f;
#pragma unroll
        for (int i = 0; i < DH / 8; ++i) {
          const uint4 w = kr[i];
          const unsigned ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc = __fmaf_rn(qr[8 * i + 2 * j], __uint_as_float(ws[j] << 16),
                            acc);
            acc = __fmaf_rn(qr[8 * i + 2 * j + 1],
                            __uint_as_float(ws[j] & 0xffff0000u), acc);
          }
        }
      }
      sc[u] = acc;
    }
    const float m_new = fmaxf(m, warp_max(fmaxf(sc[0], sc[1])));
    const float alpha = expf(m - m_new);
    const float p0 = expf(sc[0] - m_new), p1 = expf(sc[1] - m_new);
    l = __fmaf_rn(l, alpha, warp_sum(p0 + p1));
    __syncwarp();               // the last block's P.V has read sP
    sP[warp][lane] = p0;
    sP[warp][lane + 32] = p1;
    __syncwarp();
    a0 *= alpha;
    a1 *= alpha;
    const int n = min(BK, T - jb * BK);
    const bf16* vb = vc + (size_t)jb * BK * DH + 2 * lane;
    for (int s = 0; s < n; ++s) {
      const unsigned w = *reinterpret_cast<const unsigned*>(vb + (size_t)s * DH);
      const float p = sP[warp][s];
      a0 = __fmaf_rn(p, __uint_as_float(w << 16), a0);
      a1 = __fmaf_rn(p, __uint_as_float(w & 0xffff0000u), a1);
    }
    m = m_new;
  }
  if (lane == 0) {
    sM[warp] = m;
    sL[warp] = l;
  }
  sA[warp][2 * lane] = a0;
  sA[warp][2 * lane + 1] = a1;
  __syncthreads();
  if (tid < DH) {
    float mm = sM[0];
#pragma unroll
    for (int w = 1; w < NW; ++w) mm = fmaxf(mm, sM[w]);
    float ll = 0.0f, aa = 0.0f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float f = expf(sM[w] - mm);   // a warp without keys: exactly 0
      ll = __fmaf_rn(sL[w], f, ll);
      aa = __fmaf_rn(sA[w][tid], f, aa);
    }
    ctx[(size_t)b * D + h * DH + tid] = __float2bfloat16_rn(__fdiv_rn(aa, ll));
  }
}

}  // namespace

// qbuf: scratch of ceil(B / 16) * 16 rows of D floats; ctx: the same rows of
// D bf16 values.  cross_k, cross_v: [B, H, T, 64] bf16.
WT_EXPORT int wt_decoder_cross_block(const void* x, const void* ln,
                                     const void* q_w, const void* q_b,
                                     const void* o_w, const void* o_b,
                                     const void* cross_k, const void* cross_v,
                                     void* qbuf, void* ctx, void* out, int B,
                                     int D, int H, int T, void* stream) {
  if (B < 1 || D != H * DH || D % 128 != 0 || T < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int rc = launch_ln_gemm(x, ln, q_w, q_b, qbuf, nullptr, nullptr, B, D, D,
                          1.0f / sqrtf((float)DH), s);
  if (rc != 0) return rc;
  const int rows = (B + BLK_RT - 1) / BLK_RT * BLK_RT;
  cross_attn_kernel<<<rows * H, NT, 0, s>>>(
      (const float*)qbuf, (const bf16*)cross_k, (const bf16*)cross_v,
      (bf16*)ctx, B, H, T);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  return launch_out_proj(ctx, o_w, o_b, x, out, B, D, s);
}
