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
// int8 x int8 (B4, B7-i8).  Both run a cluster of blocks a (b, h), a block
// of CROSS_SEG threads a segment, but each with its own kernel body (B4 one
// query, refetching K and V where a block owns several segments; B7-i8
// cross_int8_cluster, every segment kept for all T queries), and both must
// reach the same denominator.  So the order of sum e is a function of S
// alone, not of the launch: rows fall into groups of 32 (one warp: the xor
// tree over lanes 16, 8, 4, 2, 1 with the row's index in the group as its
// lane), six groups make a segment of CROSS_SEG = 192 rows (added in
// sequence from 0), and the segments are added in sequence from 0.  p8 =
// rint(127 e) depends only on the global max, and every int32 sum is exact
// in any order, so neither the split nor the instruction changes a p8 or a
// context.
//
// Dequantizing (B6, B7-dq).  Both kernels run one cluster of blocks a (b,
// h), a block of CROSS_SEG threads a segment, and call the same function
// (cross_dequant_cluster) for every query, so the order of every fp32 sum
// is a function of S alone and each query of B7-dq is bit for bit B6's:
//   * the dot of a row: bf16 mma.sync m16n8k16 with fp32 accumulation (q is
//     bf16 and int8 is exact in bf16, so every product is exact), the 64
//     columns as four k-steps of 16 chained through the accumulator from 0
//     (dq_scores gives the columns of each step); the row is an mma row and
//     query n of a chunk of at most 8 is column n of B, so B6's one query is
//     column 0 and B7-dq's query t column t % 8: same instruction, same
//     operand layout, and an mma's column does not see the others;
//   * sum e: the int8 order above (the xor tree of a group of 32 rows, the
//     six groups of a segment in sequence, the segments in sequence from 0);
//   * ctx: in a segment, thread t takes columns 16 (t % 4) .. +15 of rows
//     t / 4 + 48 i, i = 0..3 in sequence; the eight threads of a warp that
//     share columns meet by the xor tree over lanes (4, 8, 16); the six warps
//     in sequence; the segments in sequence from 0; then times v_scale.
//
// `kc`/`vc` point at [rows, 64] int8 K and V of one (layer, b, h), in
// device memory or in shared memory.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"
#include "hopper.cuh"

constexpr int CROSS_DH = 64;
constexpr int CROSS_SEG = 192;               // rows a segment
constexpr int CROSS_SEG_GROUPS = CROSS_SEG / 32;

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

// The 4 x 4 bytes of four rows' words (a, b, c, d) transposed: col[j] holds
// byte j of a, b, c, d in its bytes 0..3.
__device__ __forceinline__ void cross_transpose4x4(int a, int b, int c, int d,
                                                   int* col) {
  const int ab_lo = __byte_perm(a, b, 0x5140), cd_lo = __byte_perm(c, d, 0x5140);
  const int ab_hi = __byte_perm(a, b, 0x7362), cd_hi = __byte_perm(c, d, 0x7362);
  col[0] = (int)__byte_perm(ab_lo, cd_lo, 0x5410);
  col[1] = (int)__byte_perm(ab_lo, cd_lo, 0x7632);
  col[2] = (int)__byte_perm(ab_hi, cd_hi, 0x5410);
  col[3] = (int)__byte_perm(ab_hi, cd_hi, 0x7632);
}

// Columns j of four rows' words (bytes j of a, b, c, d) against the four
// packed p8: acc[j] += p . (a_j, b_j, c_j, d_j).
__device__ __forceinline__ void cross_dot4x4(int a, int b, int c, int d, int p,
                                             int* acc) {
  int col[4];
  cross_transpose4x4(a, b, c, d, col);
#pragma unroll
  for (int j = 0; j < 4; ++j) acc[j] = __dp4a(col[j], p, acc[j]);
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

// ---- int8 x int8, T queries: the verify pass (B7-i8) ---------------------

constexpr int I8_WARPS = 3;               // a block's warps, two groups each
constexpr int I8_NT = 32 * I8_WARPS;
constexpr int I8_QC = 8;                  // queries a chunk: an mma's columns
constexpr int I8_SEG_BYTES = CROSS_SEG * CROSS_DH;
constexpr int I8_GROUP_BYTES = 32 * CROSS_DH;
constexpr int I8_MAX_CLUSTER = 8;         // the portable cluster size

// The chunk's int32 scores against the 32 rows of one group of a K segment
// in shared memory, by one warp: two m16n8k32 tiles, the group's rows the
// mma's rows and query n of the chunk its column n (q8 [I8_QC][64] in shared
// memory).  The 64 columns of a row are two k-steps taken in an order that
// lets lane c read bytes 16 c .. 16 c + 15 of each of its rows once (q8 in
// the same order; an int32 sum is exact in any order).  d[mt][e] is row 16
// mt + lane / 4 + 8 (e / 2) of the group against query 2 (lane % 4) + e % 2.
__device__ __forceinline__ void i8_group_scores(const int8_t* sK_group,
                                                const int8_t* sq8,
                                                int (&d)[2][4]) {
  const int lane = threadIdx.x % 32, g = lane / 4, c = lane % 4;
  const int4 qw = reinterpret_cast<const int4*>(sq8 + g * CROSS_DH)[c];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int4 wa =
        reinterpret_cast<const int4*>(sK_group + (16 * mt + g) * CROSS_DH)[c];
    const int4 wb = reinterpret_cast<const int4*>(
        sK_group + (16 * mt + g + 8) * CROSS_DH)[c];
#pragma unroll
    for (int e = 0; e < 4; ++e) d[mt][e] = 0;
    mma_m16n8k32_s8(d[mt], wa.x, wb.x, wa.y, wb.y, qw.x, qw.y);
    mma_m16n8k32_s8(d[mt], wa.z, wb.z, wa.w, wb.w, qw.z, qw.w);
  }
}

// A group's 32 rows of V ([32][64] int8 in shared memory) transposed in
// place into [64][32] (a column's 32 bytes, row order), by one warp: the
// int8 mma's A operand for P . V, whose depth (the rows) must be contiguous.
__device__ __forceinline__ void i8_transpose_group(int8_t* sV_group) {
  const int lane = threadIdx.x % 32, rq = lane / 4, c = lane % 4;
  int4 w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)  // rows 4 rq + j, columns 16 c .. 16 c + 15
    w[j] = reinterpret_cast<const int4*>(sV_group +
                                         (4 * rq + j) * CROSS_DH)[c];
  __syncwarp();
  int col[16];
  cross_transpose4x4(w[0].x, w[1].x, w[2].x, w[3].x, col);
  cross_transpose4x4(w[0].y, w[1].y, w[2].y, w[3].y, col + 4);
  cross_transpose4x4(w[0].z, w[1].z, w[2].z, w[3].z, col + 8);
  cross_transpose4x4(w[0].w, w[1].w, w[2].w, w[3].w, col + 12);
#pragma unroll
  for (int k = 0; k < 16; ++k)
    reinterpret_cast<int*>(sV_group + (16 * c + k) * 32)[rq] = col[k];
  __syncwarp();
}

// T queries of one (b, h) against one layer's int8 K and V, by a cluster of
// n_rank blocks of I8_NT threads (blockIdx.x / n_rank is b * H + h): for each
// query, bit for bit what B4 (cross_attention.cu) gives for it.  Block `rank`
// owns segments rank + i * n_rank (i < n_own) and fetches each once, by bulk
// copies at entry (K on one mbarrier, V on another, so V lands while the
// scores are computed); warp w takes groups 2 w and 2 w + 1 of each (three
// warps, so that eight blocks fit an SM and bucket 16's 1,024 blocks run in
// one wave).  The queries go in chunks of I8_QC, each quantized by one warp
// as B4 does it (cross_quantize_q), and each chunk meets under two cluster
// barriers:
//   1. the scores (i8_group_scores, int8 mma.sync) and each block's max of
//      each query, written into every block;
//   2. the scores again (cheaper than keeping them), e = exp(s - max) and p8
//      = rint(127 e) in the mma's layout; each group's sum of e by B4's xor
//      tree (rows 16 apart are the mma's two tiles, rows 8 apart its two row
//      halves: additions in a lane; then lanes 16, 8, 4); each segment's sum
//      of its six groups in sequence, written into the block that finishes
//      the query (rank n % n_rank for query n of the chunk); p8 . V8 as int8
//      mma.sync (V transposed in place once, the chunk's p8 the columns of
//      B), the warp's int32 context added into the finisher's (exact in any
//      order);
// then the finisher adds the segments' sums in segment order and writes
// cross_finish's output.  What a query computes does not depend on T or on
// the chunk it falls in.  `smem`: cross_int8_smem(n_own, n_rank) bytes; q,
// out [B, T, H, 64] bf16; the scales [L, B, H], one read a block.
__device__ __forceinline__ void cross_int8_cluster(
    unsigned char* smem, const bf16* __restrict__ q,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const int8_t* __restrict__ k8, const int8_t* __restrict__ v8,
    bf16* __restrict__ out, int B, int T, int H, int S, int layer,
    int s_valid, int n_own) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int n_rank = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int n_slot = n_rank * n_own;  // segments, counted to a whole round
  const int n_fin = (I8_QC + n_rank - 1) / n_rank;  // queries finished here
  // [K n_own segs][V n_own segs], then, written by every block: maxima
  // [I8_QC][I8_MAX_CLUSTER] floats, segment sums [n_fin][n_slot] floats,
  // contexts [n_fin][64] int32
  int8_t* sK = reinterpret_cast<int8_t*>(smem);
  int8_t* sV = sK + (size_t)n_own * I8_SEG_BYTES;
  float* cmax = reinterpret_cast<float*>(sV + (size_t)n_own * I8_SEG_BYTES);
  float* csum = cmax + I8_QC * I8_MAX_CLUSTER;
  int* cctx = reinterpret_cast<int*>(csum + n_fin * n_slot);
  __shared__ __align__(16) int8_t sq8[I8_QC][CROSS_DH];
  __shared__ __align__(16) int8_t sp8[I8_WARPS][I8_QC][32];
  __shared__ float qk[I8_QC], red[I8_WARPS][I8_QC];
  __shared__ float gsum[CROSS_SEG_GROUPS][I8_QC];
  __shared__ __align__(8) uint64_t bars[2];

  const int head = blockIdx.x / n_rank;              // b * H + h
  const int b = head / H, h = head % H;
  const size_t lrow = (size_t)layer * B * H + head;
  const int8_t* kc = k8 + lrow * (size_t)S * CROSS_DH;
  const int8_t* vc = v8 + lrow * (size_t)S * CROSS_DH;
  const int n_seg = (S + CROSS_SEG - 1) / CROSS_SEG;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const uint32_t bar_k = smem_u32(&bars[0]), bar_v = smem_u32(&bars[1]);

  // Segment i of this block is segment rank + i * n_rank of the head.
  auto seg_row0 = [&](int i) { return (rank + i * n_rank) * CROSS_SEG; };
  auto seg_rows = [&](int i) {
    return max(0, min(CROSS_SEG, S - seg_row0(i)));
  };
  auto fetch = [&](int8_t* dst, const int8_t* src, uint32_t bar) {
    uint32_t bytes = 0;
    for (int i = 0; i < n_own; ++i) bytes += (uint32_t)seg_rows(i) * CROSS_DH;
    mbar_arrive_expect_tx(bar, bytes);
    for (int i = 0; i < n_own; ++i)
      if (seg_rows(i))
        bulk_load_1d(smem_u32(dst + (size_t)i * I8_SEG_BYTES),
                     src + (size_t)seg_row0(i) * CROSS_DH,
                     (uint32_t)seg_rows(i) * CROSS_DH, bar);
  };

  cluster_arrive_relaxed();  // this block runs: the first wait below
  if (tid == 0) {
    mbar_init(bar_k, 1);
    mbar_init(bar_v, 1);
    mbar_fence_init();
    fetch(sK, kc, bar_k);
    fetch(sV, vc, bar_v);
  }
  for (int x = tid; x < n_fin * CROSS_DH; x += I8_NT) cctx[x] = 0;
  const float ks = k_scale[lrow], vs = v_scale[lrow];

  for (int t0 = 0; t0 < T; t0 += I8_QC) {
    const int qc = min(I8_QC, T - t0);
    // ---- the chunk's queries, quantized as B4 quantizes its one ----
    for (int n = warp; n < I8_QC; n += I8_WARPS) {
      if (n < qc) {
        const float qs = cross_quantize_q(
            q + (((size_t)b * T + t0 + n) * H + h) * CROSS_DH, sq8[n]);
        if (lane == 0) qk[n] = __fmul_rn(qs, ks);
      } else {
        reinterpret_cast<uint16_t*>(sq8[n])[lane] = 0;
        if (lane == 0) qk[n] = 0.0f;
      }
    }
    __syncthreads();  // q8 and the barriers (the first chunk) are visible
    const float qk2[2] = {qk[2 * c], qk[2 * c + 1]};
    // Row 16 mt + g + 8 (e / 2) of group `grp` of segment i: its score
    // against query 2 c + e % 2, -FLT_MAX where masked.
    auto score = [&](int i, int grp, const int (&d)[2][4], int mt, int e) {
      const int col = seg_row0(i) + 32 * grp + 16 * mt + g + 8 * (e / 2);
      return col < s_valid ? __fmul_rn((float)d[mt][e], qk2[e % 2])
                           : -FLT_MAX;
    };
    mbar_wait(bar_k, 0);

    // ---- 1: scores; each block's max of each query, into every block ----
    float lmax[2] = {-FLT_MAX, -FLT_MAX};
    for (int i = 0; i < n_own; ++i)
      for (int grp = 2 * warp; grp < 2 * warp + 2; ++grp) {
        const int rows = seg_rows(i) - 32 * grp;  // of the group
        if (rows <= 0) continue;                  // the same in the warp
        int d[2][4];
        i8_group_scores(sK + (size_t)i * I8_SEG_BYTES + grp * I8_GROUP_BYTES,
                        sq8[0], d);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (16 * mt + g + 8 * (e / 2) < rows)
              lmax[e % 2] = fmaxf(lmax[e % 2], score(i, grp, d, mt, e));
      }
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      lmax[0] = fmaxf(lmax[0], __shfl_xor_sync(0xffffffffu, lmax[0], o));
      lmax[1] = fmaxf(lmax[1], __shfl_xor_sync(0xffffffffu, lmax[1], o));
    }
    if (lane < 4) {
      red[warp][2 * lane] = lmax[0];
      red[warp][2 * lane + 1] = lmax[1];
    }
    __syncthreads();
    if (t0 == 0) cluster_wait();  // every block of the cluster runs
    for (int x = tid; x < qc * n_rank; x += I8_NT) {
      const int n = x % qc, r = x / qc;
      float m = red[0][n];
#pragma unroll
      for (int w = 1; w < I8_WARPS; ++w) m = fmaxf(m, red[w][n]);
      cluster.map_shared_rank(cmax, r)[n * I8_MAX_CLUSTER + rank] = m;
    }
    cluster_arrive();
    cluster_wait();

    // ---- 2: e, p8, the sums of e, p8 . V8 into the query's finisher ----
    float m2[2] = {-FLT_MAX, -FLT_MAX};
    for (int r = 0; r < n_rank; ++r) {
      m2[0] = fmaxf(m2[0], cmax[(2 * c) * I8_MAX_CLUSTER + r]);
      m2[1] = fmaxf(m2[1], cmax[(2 * c + 1) * I8_MAX_CLUSTER + r]);
    }
    int ctx[4][4];  // columns 16 mt + g + 8 (e / 2), query 2 c + e % 2
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) ctx[mt][e] = 0;
    for (int i = 0; i < n_own; ++i) {
      if (i > 0) __syncthreads();  // gsum of segment i - 1 is read
      for (int grp = 2 * warp; grp < 2 * warp + 2; ++grp) {
        const int rows = seg_rows(i) - 32 * grp;
        float gs[2] = {0.0f, 0.0f};  // a group with no rows sums to 0, as B4's
        if (rows > 0) {
          int d[2][4];
          i8_group_scores(
              sK + (size_t)i * I8_SEG_BYTES + grp * I8_GROUP_BYTES, sq8[0], d);
          float ev[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = 16 * mt + g + 8 * (e / 2);
              ev[mt][e] = r < rows ? expf(__fsub_rn(score(i, grp, d, mt, e),
                                                    m2[e % 2]))
                                   : 0.0f;
              sp8[warp][2 * c + e % 2][r] =
                  (int8_t)__float2int_rn(__fmul_rn(ev[mt][e], 127.0f));
            }
          // B4's tree: rows r ^ 16 (the two tiles), r ^ 8 (the row
          // halves), then r ^ 4, r ^ 2, r ^ 1 (lanes 16, 8, 4 apart)
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            gs[k] = __fadd_rn(__fadd_rn(ev[0][k], ev[1][k]),
                              __fadd_rn(ev[0][2 + k], ev[1][2 + k]));
#pragma unroll
            for (int o = 16; o >= 4; o >>= 1)
              gs[k] = __fadd_rn(gs[k],
                                __shfl_xor_sync(0xffffffffu, gs[k], o));
          }
          // p8 . V8: A = the group's V transposed ([64 columns][32 rows]),
          // B = the chunk's p8 ([query][32 rows])
          int8_t* vg = sV + (size_t)i * I8_SEG_BYTES + grp * I8_GROUP_BYTES;
          mbar_wait(bar_v, 0);
          if (t0 == 0) i8_transpose_group(vg);
          __syncwarp();  // sp8 is written
          const int* pw = reinterpret_cast<const int*>(sp8[warp][g]);
          const uint32_t a_addr =
              smem_u32(vg + ((lane % 8) + 8 * ((lane / 8) % 2)) * 32 +
                       16 * (lane / 16));
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            uint32_t a[4];
            ldmatrix_x4(a, a_addr + mt * 16 * 32);
            mma_m16n8k32_s8(ctx[mt], a[0], a[1], a[2], a[3], pw[c], pw[4 + c]);
          }
          __syncwarp();  // sp8 is read before the next group writes it
        }
        if (lane < 4) {
          gsum[grp][2 * lane] = gs[0];
          gsum[grp][2 * lane + 1] = gs[1];
        }
      }
      __syncthreads();  // gsum is written
      if (tid < qc) {
        float seg = 0.0f;
#pragma unroll
        for (int w = 0; w < CROSS_SEG_GROUPS; ++w)
          seg = __fadd_rn(seg, gsum[w][tid]);
        cluster.map_shared_rank(csum, tid % n_rank)
            [(tid / n_rank) * n_slot + rank + i * n_rank] = seg;
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = 2 * c + e % 2;
      if (n >= qc) continue;
      const uint32_t dst =
          dsmem_map(smem_u32(cctx + (n / n_rank) * CROSS_DH), n % n_rank);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        dsmem_add(dst + 4 * (16 * mt + g + 8 * (e / 2)), ctx[mt][e]);
    }
    cluster_arrive();
    cluster_wait();

    // ---- the finisher: the segments' sums in segment order ----
    const int n_mine = qc > rank ? (qc - rank + n_rank - 1) / n_rank : 0;
    for (int x = tid; x < n_mine * CROSS_DH; x += I8_NT) {
      const int slot = x / CROSS_DH, col = x % CROSS_DH;
      float denom = 0.0f;
      for (int s = 0; s < n_seg; ++s)
        denom = __fadd_rn(denom, csum[slot * n_slot + s]);
      out[(((size_t)b * T + t0 + rank + slot * n_rank) * H + h) * CROSS_DH +
          col] = cross_finish(cctx[x], vs, denom);
      cctx[x] = 0;  // before the next chunk's first barrier
    }
  }
}

// Dynamic shared memory of cross_int8_cluster.
inline size_t cross_int8_smem(int n_own, int n_rank) {
  const size_t n_fin = (I8_QC + n_rank - 1) / n_rank;
  return (size_t)n_own * 2 * I8_SEG_BYTES +
         sizeof(float) * (I8_QC * I8_MAX_CLUSTER + n_fin * n_rank * n_own) +
         sizeof(int) * n_fin * CROSS_DH;
}

// ---- dequantizing (B6, B7-dq) -----------------------------------------------
//   scores = (q . K8) * k_scale (fp32 sums); columns >= s_valid masked;
//   p = bf16(exp(s - max) / sum e); ctx = sum_s fp32(bf16(p * bf16(V8)));
//   out = bf16(ctx * v_scale).
// int8 values are exact in bf16 and in fp32, and no widening here goes
// through the conversion unit (a quarter of the FMA rate on sm_90): see
// dq_widen.

constexpr int DQ_NT = CROSS_SEG;          // threads a block: one a segment row
constexpr int DQ_WARPS = DQ_NT / 32;      // = CROSS_SEG_GROUPS
constexpr int DQ_PASS = DQ_NT / 4;        // rows a pass of P.V (48)
constexpr int DQ_SEG_BYTES = CROSS_SEG * CROSS_DH;
constexpr int DQ_MAX_CLUSTER = 8;         // the portable cluster size
constexpr int DQ_MAX_QC = 8;              // queries a chunk: an mma's columns

// Byte j of a word wx = w ^ 0x80808080 (128 + b for the int8 b) placed
// under the exponent of 2^23 is the float 2^23 + 128 + b; one subtraction
// leaves b, exactly.  Returns its bits, whose low 16 are 0: they are also
// bf16(b) in the high half of a word of two bf16 whose low half is +0.
__device__ __forceinline__ uint32_t dq_widen(uint32_t wx, int j) {
  return __float_as_uint(__fsub_rn(
      __uint_as_float(__byte_perm(wx, 0x4B000000u, 0x7650u | j)),
      8388736.0f));
}

// Bytes j and j + 1 of wx as a word of two bf16, byte j in the low half.
__device__ __forceinline__ uint32_t dq_bf16x2(uint32_t wx, int j) {
  return __byte_perm(dq_widen(wx, j), dq_widen(wx, j + 1), 0x7632u);
}

// The mma's B for the queries of a chunk: column g = lane / 4 is query g
// (q_row0 + g * stride; zeros for g >= qc), lane c = lane % 4 holding its
// values 16 c .. 16 c + 15 as eight words of two bf16: words 2 j and 2 j + 1
// are the depths of k-step j (dq_scores).
__device__ __forceinline__ void dq_query_frag(const bf16* __restrict__ q_row0,
                                              size_t stride, int qc,
                                              uint32_t (&qb)[8]) {
  const int lane = threadIdx.x % 32, g = lane / 4, c = lane % 4;
  uint4 lo = make_uint4(0u, 0u, 0u, 0u), hi = lo;
  if (g < qc) {
    const uint4* p =
        reinterpret_cast<const uint4*>(q_row0 + g * stride) + 2 * c;
    lo = p[0];
    hi = p[1];
  }
  qb[0] = lo.x; qb[1] = lo.y; qb[2] = lo.z; qb[3] = lo.w;
  qb[4] = hi.x; qb[5] = hi.y; qb[6] = hi.z; qb[7] = hi.w;
}

// Scores of the chunk's queries against rows [0, rows) of a K segment in
// shared memory, by a block of DQ_NT threads.  Warp w takes rows 32 w ..
// 32 w + 31 as two m16n8k16 tiles (K's rows the mma's rows, the queries its
// columns); the 64 columns are four k-steps chained through the accumulator
// from 0, k-step j holding columns 16 c + 4 j .. + 3 of each c = 0..3 at the
// depths 2c, 2c + 1, 2c + 8, 2c + 9, so that a lane reads its rows' bytes
// 16 c .. 16 c + 15 once.  Row r is column row0 + r of the head; columns >=
// s_valid are masked.  Writes sS[n * CROSS_SEG + r] for queries n < qc and
// folds the values into lmax[0], lmax[1] (queries 2 c, 2 c + 1).
__device__ __forceinline__ void dq_scores(const uint32_t (&qb)[8],
                                          float k_scale, const int8_t* sK,
                                          int rows, int row0, int s_valid,
                                          int qc, float* sS, float (&lmax)[2]) {
  const int lane = threadIdx.x % 32, g = lane / 4, c = lane % 4;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int r0 = 32 * (threadIdx.x / 32) + 16 * mt + g;  // and r0 + 8
    const int4 wa = reinterpret_cast<const int4*>(sK + r0 * CROSS_DH)[c];
    const int4 wb = reinterpret_cast<const int4*>(sK + (r0 + 8) * CROSS_DH)[c];
    const uint32_t xa[4] = {(uint32_t)wa.x ^ 0x80808080u,
                            (uint32_t)wa.y ^ 0x80808080u,
                            (uint32_t)wa.z ^ 0x80808080u,
                            (uint32_t)wa.w ^ 0x80808080u};
    const uint32_t xb[4] = {(uint32_t)wb.x ^ 0x80808080u,
                            (uint32_t)wb.y ^ 0x80808080u,
                            (uint32_t)wb.z ^ 0x80808080u,
                            (uint32_t)wb.w ^ 0x80808080u};
    float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      mma_m16n8k16_bf16(d, dq_bf16x2(xa[j], 0), dq_bf16x2(xb[j], 0),
                        dq_bf16x2(xa[j], 2), dq_bf16x2(xb[j], 2), qb[2 * j],
                        qb[2 * j + 1]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + 8 * (e / 2), n = 2 * c + e % 2;
      if (r < rows && n < qc) {
        const float v =
            row0 + r < s_valid ? __fmul_rn(d[e], k_scale) : -FLT_MAX;
        sS[n * CROSS_SEG + r] = v;
        lmax[e % 2] = fmaxf(lmax[e % 2], v);
      }
    }
  }
}

// One group of 32 rows, by one whole warp: e = exp(s - m) written over the
// scores (masked columns give exactly 0), and the group's sum of e by the
// xor tree.  `left` rows of the group exist (<= 0: none); the others count
// as 0.
__device__ __forceinline__ float dq_group_exp(float* sS, int left, float m) {
  const int lane = threadIdx.x % 32;
  float e = 0.0f;
  if (lane < left) {
    e = expf(__fsub_rn(sS[lane], m));
    sS[lane] = e;
  }
  return warp_sum(e);
}

// One query's part of a segment's context, by a block of DQ_NT threads.
// Thread t takes columns 16 c .. 16 c + 15 (c = t % 4) of rows t / 4 + 48 i,
// i = 0..3 (V in 16-byte vectors); p = bf16(e / denom) (a true division,
// made once a row by one lane of the quad and handed round by shuffles);
// each product p * bf16(V8) rounded to bf16 (__hmul2 against dq_widen's word,
// whose high half is the product and low half +0, so the word is the
// product in fp32) and added in row order from 0.  Then the sums of the
// eight lanes of the warp that share the columns, the xor tree over lanes
// 4, 8, 16 taken as halving exchanges (each lane keeps half of what it holds
// and sends the other half: the tree's sums, 14 shuffles in place of 48).
// Returns the warp's sums of columns `col` and col + 1, which this lane
// holds.
__device__ __forceinline__ float2 dq_segment_pv(const float* sE, float denom,
                                                const int8_t* sV, int rows,
                                                int& col) {
  const int lane = threadIdx.x % 32, c = lane % 4, quad = threadIdx.x / 4;
  const int rp = quad + DQ_PASS * c;  // the row whose p this lane makes
  const uint32_t pm = __bfloat16_as_ushort(__float2bfloat16_rn(
      rp < rows ? __fdiv_rn(sE[rp], denom) : 0.0f));
  float acc[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) acc[j] = 0.0f;
#pragma unroll
  for (int i = 0; i < CROSS_SEG / DQ_PASS; ++i) {  // bounds uniform in a quad
    const int r = quad + DQ_PASS * i;
    const uint32_t pi = __shfl_sync(0xffffffffu, pm, (lane & ~3) | i);
    if (r < rows) {
      const uint32_t pp = pi | (pi << 16);
      const __nv_bfloat162 p2 = *reinterpret_cast<const __nv_bfloat162*>(&pp);
      const int4 w = reinterpret_cast<const int4*>(sV + r * CROSS_DH)[c];
      const uint32_t ws[4] = {(uint32_t)w.x ^ 0x80808080u,
                              (uint32_t)w.y ^ 0x80808080u,
                              (uint32_t)w.z ^ 0x80808080u,
                              (uint32_t)w.w ^ 0x80808080u};
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const uint32_t v = dq_widen(ws[j], k);
          const __nv_bfloat162 pv =
              __hmul2(p2, *reinterpret_cast<const __nv_bfloat162*>(&v));
          acc[4 * j + k] = __fadd_rn(
              acc[4 * j + k], *reinterpret_cast<const float*>(&pv));
        }
    }
  }
  const int b1 = (lane >> 2) & 1, b2 = (lane >> 3) & 1, b3 = (lane >> 4) & 1;
  float h8[8], h4[4];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float keep = b1 ? acc[8 + k] : acc[k];
    const float send = b1 ? acc[k] : acc[8 + k];
    h8[k] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, 4));
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float keep = b2 ? h8[4 + k] : h8[k], send = b2 ? h8[k] : h8[4 + k];
    h4[k] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, 8));
  }
  float h2[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float keep = b3 ? h4[2 + k] : h4[k], send = b3 ? h4[k] : h4[2 + k];
    h2[k] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, 16));
  }
  col = 16 * c + 8 * b1 + 4 * b2 + 2 * b3;
  return make_float2(h2[0], h2[1]);
}

// op over v(0), v(1), .. v(n - 1) in that order, `init` first: the loads
// of eight values are issued together, so a chain of n steps waits for
// about one load, not for n.
template <typename Load, typename Op>
__device__ __forceinline__ float dq_fold(int n, float init, Load v, Op op) {
  float acc = init;
  for (int s0 = 0; s0 < n; s0 += 8) {
    float x[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) x[k] = s0 + k < n ? v(s0 + k) : 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (s0 + k < n) acc = op(acc, x[k]);
  }
  return acc;
}

// T queries of one (b, h) against one layer's K and V, by a cluster of
// n_rank blocks of DQ_NT threads (blockIdx.x / n_rank is b * H + h).  Block
// `rank` owns segments rank + i * n_rank (i < n_own) and fetches each once,
// by bulk copies at entry (K on one mbarrier, V on another, so V lands
// while the scores are computed).  The queries go in chunks of QC (<= 8,
// the columns of one mma), and each chunk meets under three cluster
// barriers; every exchange is a write into the shared memory of the block
// that reads it, before the barrier:
//   1. each query's scores into shared memory; every block writes its max
//      of each query into every block;
//   2. e and each segment's sum of e, written into every block; each block
//      adds all segments' sums in segment order;
//   3. p and each segment's context, written into the block that finishes
//      the query (rank t % n_rank for query t of the chunk), which adds the
//      contexts in segment order, times v_scale, and writes the output.
// What a query computes does not depend on QC, T or the chunk it falls in.
// `smem`: cross_dequant_smem(n_own, qmax, n_rank) bytes, qmax = min(T, QC).
// q, out: [B, T, H, 64] bf16; the scales [L, B, H], one read a block.
template <int QC>
__device__ __forceinline__ void cross_dequant_cluster(
    unsigned char* smem, const bf16* __restrict__ q,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const int8_t* __restrict__ k8, const int8_t* __restrict__ v8,
    bf16* __restrict__ out, int B, int T, int H, int S, int layer,
    int s_valid, int n_own, int qmax) {
  static_assert(QC >= 1 && QC <= DQ_MAX_QC, "a chunk is one mma's columns");
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int n_rank = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int n_slot = n_rank * n_own;  // segments, counted to a whole round
  // [K n_own segs][V n_own segs], then floats: scores [n_own][qmax][SEG],
  // group sums [n_own][qmax][WARPS], warp contexts [qmax][WARPS][64]; written
  // by every block: maxima [qmax][8], segment sums [qmax][n_slot], segment
  // contexts [ceil(qmax / n_rank)][n_slot][64]
  int8_t* sK = reinterpret_cast<int8_t*>(smem);
  int8_t* sV = sK + (size_t)n_own * DQ_SEG_BYTES;
  float* sS = reinterpret_cast<float*>(sV + (size_t)n_own * DQ_SEG_BYTES);
  float* gsum = sS + qmax * n_own * CROSS_SEG;
  float* wpart = gsum + qmax * n_own * DQ_WARPS;
  float* cmax = wpart + qmax * DQ_WARPS * CROSS_DH;
  float* csum = cmax + qmax * DQ_MAX_CLUSTER;
  float* cctx = csum + qmax * n_slot;
  __shared__ float red[DQ_WARPS][DQ_MAX_QC];
  __shared__ __align__(8) uint64_t bars[2];

  const int head = blockIdx.x / n_rank;              // b * H + h
  const int b = head / H, h = head % H;
  const size_t lrow = (size_t)layer * B * H + head;
  const int8_t* kc = k8 + lrow * (size_t)S * CROSS_DH;
  const int8_t* vc = v8 + lrow * (size_t)S * CROSS_DH;
  const int n_seg = (S + CROSS_SEG - 1) / CROSS_SEG;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const uint32_t bar_k = smem_u32(&bars[0]), bar_v = smem_u32(&bars[1]);

  // Segment i of this block is segment rank + i * n_rank of the head.
  auto seg_row0 = [&](int i) { return (rank + i * n_rank) * CROSS_SEG; };
  auto seg_rows = [&](int i) {
    return max(0, min(CROSS_SEG, S - seg_row0(i)));
  };
  auto fetch = [&](int8_t* dst, const int8_t* src, uint32_t bar) {
    uint32_t bytes = 0;
    for (int i = 0; i < n_own; ++i) bytes += (uint32_t)seg_rows(i) * CROSS_DH;
    mbar_arrive_expect_tx(bar, bytes);
    for (int i = 0; i < n_own; ++i)
      if (seg_rows(i))
        bulk_load_1d(smem_u32(dst + (size_t)i * DQ_SEG_BYTES),
                     src + (size_t)seg_row0(i) * CROSS_DH,
                     (uint32_t)seg_rows(i) * CROSS_DH, bar);
  };

  cluster_arrive_relaxed();  // this block runs: the first wait below
  if (tid == 0) {
    mbar_init(bar_k, 1);
    mbar_init(bar_v, 1);
    mbar_fence_init();
    fetch(sK, kc, bar_k);
    fetch(sV, vc, bar_v);
  }
  const float ks = k_scale[lrow], vs = v_scale[lrow];
  __syncthreads();  // the barriers are initialised
  mbar_wait(bar_k, 0);

  for (int t0 = 0; t0 < T; t0 += QC) {
    const int qc = min(QC, T - t0);
    // ---- 1: scores; each block's max of each query, into every block ----
    uint32_t qb[8];
    dq_query_frag(q + (((size_t)b * T + t0) * H + h) * CROSS_DH,
                  (size_t)H * CROSS_DH, qc, qb);
    float lmax[2] = {-FLT_MAX, -FLT_MAX};
    for (int i = 0; i < n_own; ++i)
      if (seg_rows(i) > 0)
        dq_scores(qb, ks, sK + (size_t)i * DQ_SEG_BYTES, seg_rows(i),
                  seg_row0(i), s_valid, qc, sS + i * qmax * CROSS_SEG, lmax);
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      lmax[0] = fmaxf(lmax[0], __shfl_xor_sync(0xffffffffu, lmax[0], o));
      lmax[1] = fmaxf(lmax[1], __shfl_xor_sync(0xffffffffu, lmax[1], o));
    }
    if (lane < 4) {
      red[warp][2 * lane] = lmax[0];
      red[warp][2 * lane + 1] = lmax[1];
    }
    __syncthreads();
    if (t0 == 0) cluster_wait();  // every block of the cluster runs
    for (int x = tid; x < qc * n_rank; x += DQ_NT) {
      const int n = x % qc, r = x / qc;
      float m = red[0][n];
#pragma unroll
      for (int w = 1; w < DQ_WARPS; ++w) m = fmaxf(m, red[w][n]);
      cluster.map_shared_rank(cmax, r)[n * DQ_MAX_CLUSTER + rank] = m;
    }
    cluster_arrive();
    cluster_wait();

    // ---- 2: e; each segment's sum of e, into every block ----
    float m[QC];  // the chunk's queries side by side, for their latencies
#pragma unroll
    for (int t = 0; t < QC; ++t)
      m[t] = dq_fold(
          t < qc ? n_rank : 0, -FLT_MAX,
          [&](int r) { return cmax[t * DQ_MAX_CLUSTER + r]; },
          [](float a, float x) { return fmaxf(a, x); });
    for (int i = 0; i < n_own; ++i)
#pragma unroll
      for (int t = 0; t < QC; ++t)
        if (t < qc) {
          const int it = i * qmax + t;
          const float gs = dq_group_exp(sS + it * CROSS_SEG + 32 * warp,
                                        seg_rows(i) - 32 * warp, m[t]);
          if (lane == 0) gsum[it * DQ_WARPS + warp] = gs;
        }
    __syncthreads();
    for (int x = tid; x < qc * n_own * n_rank; x += DQ_NT) {
      const int t = x % qc, i = x / qc % n_own, r = x / (qc * n_own);
      cluster.map_shared_rank(csum, r)[t * n_slot + rank + i * n_rank] =
          cross_segment_sum(gsum + (i * qmax + t) * DQ_WARPS, DQ_WARPS);
    }
    cluster_arrive();
    cluster_wait();

    // ---- 3: p and each segment's context, into the query's finisher ----
    mbar_wait(bar_v, 0);
    for (int i = 0; i < n_own; ++i) {
      if (seg_rows(i) == 0) continue;  // the same in the whole block
      for (int t = 0; t < qc; ++t) {
        const float denom = dq_fold(
            n_seg, 0.0f, [&](int s) { return csum[t * n_slot + s]; },
            [](float a, float x) { return __fadd_rn(a, x); });
        int col;
        const float2 part =
            dq_segment_pv(sS + (i * qmax + t) * CROSS_SEG, denom,
                          sV + (size_t)i * DQ_SEG_BYTES, seg_rows(i), col);
        *reinterpret_cast<float2*>(wpart + (t * DQ_WARPS + warp) * CROSS_DH +
                                   col) = part;
      }
      __syncthreads();
      for (int x = tid; x < qc * CROSS_DH; x += DQ_NT) {
        const int t = x / CROSS_DH, d = x % CROSS_DH;
        const float* w0 = wpart + t * DQ_WARPS * CROSS_DH + d;
        float sum = w0[0];
#pragma unroll
        for (int w = 1; w < DQ_WARPS; ++w)
          sum = __fadd_rn(sum, w0[w * CROSS_DH]);
        cluster.map_shared_rank(cctx, t % n_rank)
            [((t / n_rank) * n_slot + rank + i * n_rank) * CROSS_DH + d] = sum;
      }
      if (i + 1 < n_own) __syncthreads();  // wpart is read; the next may write
    }
    cluster_arrive();
    cluster_wait();

    // ---- the finisher: the segments' contexts in segment order ----
    const int n_mine = qc > rank ? (qc - rank + n_rank - 1) / n_rank : 0;
    for (int x = tid; x < n_mine * CROSS_DH; x += DQ_NT) {
      const int slot = x / CROSS_DH, d = x % CROSS_DH;
      const float* src = cctx + (size_t)slot * n_slot * CROSS_DH + d;
      const float total = dq_fold(
          n_seg, 0.0f, [&](int s) { return src[s * CROSS_DH]; },
          [](float a, float x) { return __fadd_rn(a, x); });
      out[(((size_t)b * T + t0 + rank + slot * n_rank) * H + h) * CROSS_DH +
          d] = __float2bfloat16_rn(__fmul_rn(total, vs));
    }
  }
}

// Dynamic shared memory of cross_dequant_cluster.
inline size_t cross_dequant_smem(int n_own, int qmax, int n_rank) {
  const size_t n_slot = (size_t)n_rank * n_own;
  return (size_t)n_own * 2 * DQ_SEG_BYTES +
         sizeof(float) *
             ((size_t)qmax * n_own * (CROSS_SEG + DQ_WARPS) +
              (size_t)qmax * DQ_WARPS * CROSS_DH +
              (size_t)qmax * DQ_MAX_CLUSTER +
              (size_t)qmax * n_slot +
              (size_t)((qmax + n_rank - 1) / n_rank) * n_slot * CROSS_DH);
}

// Launch `kernel` (a __global__ that calls cross_dequant_cluster<QC>) with a
// cluster of min(segments, 8) blocks a (b, h): one launch, nothing else.
template <int QC, typename Kernel>
inline int cross_dequant_launch(Kernel kernel, const void* q,
                                const void* k_scale, const void* v_scale,
                                const void* k8, const void* v8, void* out,
                                int B, int T, int H, int S, int layer,
                                int s_valid, cudaStream_t stream) {
  if (B < 1 || T < 1 || H < 1 || S < 1) return (int)cudaErrorInvalidValue;
  const int n_seg = (S + CROSS_SEG - 1) / CROSS_SEG;
  const int n_rank = n_seg < DQ_MAX_CLUSTER ? n_seg : DQ_MAX_CLUSTER;
  const int n_own = (n_seg + n_rank - 1) / n_rank;
  const int qmax = T < QC ? T : QC;
  const size_t smem = cross_dequant_smem(n_own, qmax, n_rank);
  if (smem > 48 * 1024) {
    cudaError_t rc = cudaFuncSetAttribute(
        (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * H * n_rank));
  cfg.blockDim = dim3(DQ_NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)n_rank;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaError_t rc = cudaLaunchKernelEx(
      &cfg, kernel, (const bf16*)q, (const float*)k_scale,
      (const float*)v_scale, (const int8_t*)k8, (const int8_t*)v8, (bf16*)out,
      B, T, H, S, layer, s_valid, n_own, qmax);
  return rc != cudaSuccess ? (int)rc : (int)cudaGetLastError();
}
