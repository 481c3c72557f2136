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
// bytes, for 49 MFLOP of fp32 work.  Three kernels on one stream inside one
// call, each the programmatic dependent of the one before:
//   (1) ln_gemm_kernel (decoder_block.cuh), q only: 32 tiles of 16
//       columns, each a cluster of 8 blocks splitting the depth;
//   (2) cross_attn_kernel: the keys of each (b, h) split over a cluster of
//       up to 8 blocks of 4 warps, about two blocks an SM (3 blocks a head,
//       384 blocks at bucket 16), block `rank` owning a run of whole 64-key
//       blocks and its warp w every fourth of them from w.  Each warp
//       streams its key blocks through its own K and V buffers in shared
//       memory (16 KB), fetched by bulk asynchronous copies on an mbarrier
//       each: K's next block is asked for as soon as the scores have read
//       the last, V's as soon as P.V has, so every warp keeps a copy in
//       flight and the blocks stay resident for the whole stream (no second
//       wave).  (1) lets it start at once: the first copies are asked for at
//       entry, while (1) runs, before the kernel waits for q.  A warp keeps
//       its own running max, sum and accumulator: a lane scores two keys (q
//       in registers, fp32 FMA against K widened from bf16; each lane starts
//       its row at another 16-byte word, so the 8 lanes of a quarter warp
//       hit 8 different banks) and owns two of the 64 columns for P.V.  The
//       warps' states are merged in warp order, then the blocks' in rank
//       order in rank 0, through distributed shared memory; a warp or block
//       without keys has max -1e30 and contributes exactly 0.  One order of
//       every sum for a given batch: two calls are bitwise equal.
//   (3) out_proj_kernel, a cluster of 4 blocks per 16 columns.
// The online softmax thus runs over blocks of 64 keys in another order than
// the TPU's sequential grid, within the tolerance the plain version is held
// to.
#include "decoder_block.cuh"

namespace {

constexpr int DH = 64;
constexpr int BK = 64;             // keys per online-softmax block
constexpr int NW = 4;              // warps a block
constexpr int NT = NW * 32;
constexpr int MAX_RANKS = 8;       // the portable cluster size
constexpr uint32_t KB_BYTES = BK * DH * 2;  // one key block of K or of V
constexpr float NEG_INF = -1e30f;  // the JAX kernel's, not -FLT_MAX

// A warp's or a block's running softmax state over its keys.
struct State {
  float m, l, acc[DH];
};

// (m, l, acc[d]) of n states merged in order into one, by the thread of
// column d; a state without keys (m = -1e30) contributes exactly 0.
__device__ __forceinline__ void merge_states(const State* st, int n, int d,
                                             float& m, float& l, float& a) {
  m = st[0].m;
  for (int i = 1; i < n; ++i) m = fmaxf(m, st[i].m);
  l = 0.0f;
  a = 0.0f;
  for (int i = 0; i < n; ++i) {
    const float f = expf(st[i].m - m);
    l = __fmaf_rn(st[i].l, f, l);
    a = __fmaf_rn(st[i].acc[d], f, a);
  }
}

// grid (ranks, B * H), clusters of `ranks` blocks along x; block `rank`
// takes key blocks [rank nblk / ranks, (rank + 1) nblk / ranks) of its (b,
// h), its warp w those of them at w, w + 4, ...  Dynamic shared memory: a
// [64][64] bf16 K buffer and a V buffer for each warp.
__global__ void __launch_bounds__(NT)
cross_attn_kernel(const float* __restrict__ qbuf, const bf16* __restrict__ ck,
                  const bf16* __restrict__ cv, bf16* __restrict__ ctx,
                  int T) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[2 * NW];   // K, V of each warp
  __shared__ float sq[DH];
  __shared__ float sP[NW][BK];
  __shared__ State warps[NW];
  __shared__ State blocks[MAX_RANKS];   // rank 0: the cluster's states
  cg::cluster_group cluster = cg::this_cluster();
  const int n_rank = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int head = blockIdx.y;          // b * H + h
  const int nblk = (T + BK - 1) / BK;
  const int kb0 = rank * nblk / n_rank;
  const int kb1 = (rank + 1) * nblk / n_rank;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  bf16* sK = reinterpret_cast<bf16*>(smem) + (size_t)warp * 2 * BK * DH;
  bf16* sV = sK + BK * DH;
  const uint32_t bar_k = smem_u32(&bars[warp]);
  const uint32_t bar_v = smem_u32(&bars[NW + warp]);
  const size_t base = (size_t)head * T * DH;
  auto rows_of = [&](int kb) { return min(BK, T - kb * BK); };
  // key block kb of K (or V) into this warp's buffer, by lane 0
  auto fetch = [&](bf16* dst, const bf16* src, int kb, uint32_t bar) {
    const uint32_t bytes = (uint32_t)rows_of(kb) * DH * 2;
    mbar_arrive_expect_tx(bar, bytes);
    bulk_load_1d(smem_u32(dst), src + base + (size_t)kb * BK * DH, bytes,
                 bar);
  };

  grid_launch_dependents();  // the O product may fetch its weights
  if (n_rank > 1) cluster_arrive_relaxed();  // waited for before writes
  if (lane == 0) {
    mbar_init(bar_k, 1);
    mbar_init(bar_v, 1);
    mbar_fence_init();
    if (kb0 + warp < kb1) {
      fetch(sK, ck, kb0 + warp, bar_k);
      fetch(sV, cv, kb0 + warp, bar_v);
    }
  }
  grid_dependency_wait();  // ln_gemm has written q
  if (tid < DH) sq[tid] = qbuf[(size_t)head * DH + tid];
  __syncthreads();  // the barriers and q are visible

  // q in registers, rotated as this lane reads its key rows: word j of the
  // row read in step j is word (j + rot) % 8
  const int rot = lane & 7;
  float qr[DH];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int e = 0; e < 8; ++e) qr[8 * j + e] = sq[8 * ((j + rot) & 7) + e];

  float m = NEG_INF, l = 0.0f, a0 = 0.0f, a1 = 0.0f;
  for (int kb = kb0 + warp, it = 0; kb < kb1; kb += NW, ++it) {
    const int n = rows_of(kb);
    const bool more = kb + NW < kb1;
    mbar_wait(bar_k, it & 1);
    float sc[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = lane + 32 * u;   // r % 8 == rot
      float acc = NEG_INF;
      if (r < n) {
        const uint4* kr = reinterpret_cast<const uint4*>(sK + (size_t)r * DH);
        acc = 0.0f;
#pragma unroll
        for (int j = 0; j < DH / 8; ++j) {
          const uint4 w = kr[(j + rot) & 7];
          const unsigned ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            // two bf16 values a word: the low half first
            acc = __fmaf_rn(qr[8 * j + 2 * c], __uint_as_float(ws[c] << 16),
                            acc);
            acc = __fmaf_rn(qr[8 * j + 2 * c + 1],
                            __uint_as_float(ws[c] & 0xffff0000u), acc);
          }
        }
      }
      sc[u] = acc;
    }
    __syncwarp();  // every lane has read the K buffer: refill it
    if (lane == 0 && more) {
      async_proxy_fence();
      fetch(sK, ck, kb + NW, bar_k);
    }
    const float m_new = fmaxf(m, warp_max(fmaxf(sc[0], sc[1])));
    const float alpha = expf(m - m_new);
    const float p0 = expf(sc[0] - m_new), p1 = expf(sc[1] - m_new);
    l = __fmaf_rn(l, alpha, warp_sum(p0 + p1));
    sP[warp][lane] = p0;    // the last block's P.V ended at a __syncwarp
    sP[warp][lane + 32] = p1;
    __syncwarp();
    a0 *= alpha;
    a1 *= alpha;
    const bf16* vb = sV + 2 * lane;
    mbar_wait(bar_v, it & 1);
    for (int s = 0; s < n; ++s) {
      const unsigned w = *reinterpret_cast<const unsigned*>(vb + s * DH);
      const float p = sP[warp][s];
      a0 = __fmaf_rn(p, __uint_as_float(w << 16), a0);
      a1 = __fmaf_rn(p, __uint_as_float(w & 0xffff0000u), a1);
    }
    __syncwarp();  // every lane has read the V buffer and sP
    if (lane == 0 && more) {
      async_proxy_fence();
      fetch(sV, cv, kb + NW, bar_v);
    }
    m = m_new;
  }
  if (lane == 0) {
    warps[warp].m = m;
    warps[warp].l = l;
  }
  warps[warp].acc[2 * lane] = a0;
  warps[warp].acc[2 * lane + 1] = a1;
  __syncthreads();

  // the warps in warp order into this block's state in rank 0, then there
  // the blocks in rank order
  if (n_rank > 1) cluster_wait();  // every block of the cluster runs
  if (tid < DH) {
    float bm, bl, ba;
    merge_states(warps, NW, tid, bm, bl, ba);
    State* dst = n_rank > 1 ? cluster.map_shared_rank(&blocks[rank], 0)
                            : &blocks[0];
    dst->acc[tid] = ba;
    if (tid == 0) {
      dst->m = bm;
      dst->l = bl;
    }
  }
  if (n_rank > 1) {
    cluster_arrive();
    if (rank != 0) return;  // rank 0 reads only its own shared memory
    cluster_wait();
  } else {
    __syncthreads();
  }
  if (tid < DH) {
    float cm, cl, ca;
    merge_states(blocks, n_rank, tid, cm, cl, ca);
    ctx[(size_t)head * DH + tid] = __float2bfloat16_rn(__fdiv_rn(ca, cl));
  }
}

size_t cross_allowed = 0;  // set at the first call: past static memory

}  // namespace

// qbuf: scratch of ceil(B / 16) * 16 rows of D floats; ctx: the same rows of
// D bf16 values.  cross_k, cross_v: [B, H, T, 64] bf16, 16-byte aligned.
WT_EXPORT int wt_decoder_cross_block(const void* x, const void* ln,
                                     const void* q_w, const void* q_b,
                                     const void* o_w, const void* o_b,
                                     const void* cross_k, const void* cross_v,
                                     void* qbuf, void* ctx, void* out, int B,
                                     int D, int H, int T, void* stream) {
  if (B < 1 || D != H * DH || D % 128 != 0 || T < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int rc = launch_ln_gemm(x, ln, q_w, q_b, qbuf, nullptr, nullptr, nullptr,
                          0, 0, B, D, D, 1.0f / sqrtf((float)DH), true, s);
  if (rc != 0) return rc;
  // about two blocks an SM, at most a cluster of 8 and a key block a block
  const int nblk = (T + BK - 1) / BK;
  int n_rank = (2 * sm_count() + B * H - 1) / (B * H);
  n_rank = n_rank < MAX_RANKS ? n_rank : MAX_RANKS;
  n_rank = n_rank < nblk ? n_rank : nblk;
  const size_t smem = (size_t)NW * 2 * KB_BYTES;
  const cudaError_t err =
      allow_smem((const void*)cross_attn_kernel, smem, cross_allowed);
  if (err != cudaSuccess) return (int)err;
  rc = launch_ex(cross_attn_kernel, dim3(n_rank, B * H), NT, smem, s,
                 (unsigned)n_rank, true, (const float*)qbuf,
                 (const bf16*)cross_k, (const bf16*)cross_v, (bf16*)ctx, T);
  if (rc != 0) return rc;
  return launch_out_proj(ctx, o_w, o_b, x, out, B, D, s);
}
