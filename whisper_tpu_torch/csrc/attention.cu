// B1: unmasked encoder self-attention, q/k/v [B*H, T, 64] bf16 -> bf16.
//
// Replaces whisper_tpu/ops/attention.py:fused_attention (_attn_kernel).
// Contract (the JAX kernel's): q arrives pre-scaled by 64^-0.5; scores and
// softmax in fp32; probabilities normalised in fp32 and THEN cast to bf16;
// P.V accumulated in fp32 and written in bf16.
//
// What bounds it on the H100: at whisper-base bucket 16 (B*H = 128,
// T = 1500) the function is 4*128*1500^2*64 = 74 GFLOP of bf16 products
// against 98 MB of q/k/v/out, so operations bound it: 0.0746 ms at 989
// TFLOP/s.  The contract keeps the kernel TWO-PASS (an online softmax would
// cast un-normalised probabilities): pass 1 computes each row's max m and
// sum l, pass 2 recomputes the scores and accumulates bf16(p).V.  The second
// Q.K^T makes it 1.5 * 74 = 111 GFLOP executed, a design floor of 0.112 ms.
// Beside the tensor cores, each score costs one ex2 in each pass: 2 * 288 M
// of them on 16 special-function lanes an SM take as long again, so the
// softmax has to run while the tensor cores work.
//
// Design: one block of four warpgroups per (head, 192 query rows).
//   * Warpgroup 0 is the producer: one thread issues TMA loads (3-D tensor
//     maps over [B*H, T, 64], 128-byte swizzle) of the Q tile and then of
//     128-key K and V tiles into a ring of 16 KB slots, each with a full and
//     an empty mbarrier; it gives its registers to the consumers
//     (setmaxnreg).  Rows past T arrive as zeros: that is the ragged-tail
//     load.
//   * Warpgroups 1 to 3 own 64 query rows each.  S = Q.K^T is four
//     wgmma m64n128k16 (Q and K from shared memory, both K-major) into 64
//     fp32 accumulator registers a thread.  The scores never leave the
//     registers: a row lives in one quad of lanes, so max and sum are two
//     shuffles.  Key columns >= T are set to -inf in registers.
//   * Pass 1 costs Q.K^T and one ex2 a score (online max and sum).
//   * Pass 2 forms p = bf16(exp2(s*log2e - (m*log2e + log2 l))): one fused
//     multiply-add and one ex2, normalised before the cast, no division.
//     The accumulator layout of S is the A-operand layout of the next wgmma,
//     so P goes from registers straight into eight m64n64k16 against the V
//     tile as the MN-major (transposed) B operand.  P never touches shared
//     memory.
//   * Inside a warpgroup the products and the softmax arithmetic alternate
//     (a wait after each batch of wgmma), so a warpgroup alone leaves the
//     tensor cores idle while it computes exponentials, and the reverse.
//     The consumer warpgroups run unsynchronised, each on its own rows, and
//     fill each other's gaps: three of them are what 65,536 registers hold
//     (152 a consumer thread).  Two variants were tried and ran slower:
//     two score buffers a warpgroup with the next tile's Q.K^T in flight
//     during the softmax (ptxas serialised its wgmma, C7514/C7515), and
//     the warpgroups taking the tensor cores in strict turns through named
//     barriers.
// Roundings that differ from expf(s - m) / l: the scale by log2e and the
// subtraction are one fma, the division is a subtraction in the exponent,
// and ex2.approx is good to 2 ulp: a relative error near 1e-6 in p before
// its cast to bf16 (2^-9), so a p lands on the neighbouring bf16 value now
// and then.  The kernel is held to 2 bf16 steps of the plain version.
//
// Ragged T: query rows >= T are never written; any T >= 1.
#include "hopper.cuh"

namespace {

constexpr int DH = 64;             // head dim
constexpr int CONSUMERS = 3;       // consumer warpgroups, 64 query rows each
constexpr int BQ = 64 * CONSUMERS;  // query rows a block
constexpr int BK = 128;            // keys a tile
constexpr int NSTAGE = 6;          // ring slots
constexpr int NT = 128 * (1 + CONSUMERS);  // the producer warpgroup first
constexpr int TILE_BYTES = BK * DH * 2;   // 16 KB a ring slot
constexpr int Q_BYTES = BQ * DH * 2;
constexpr int BAR_BYTES = 8 * (2 * NSTAGE + 1);
constexpr int SMEM_BYTES = 1024 + Q_BYTES + TILE_BYTES * NSTAGE + BAR_BYTES;
// registers a thread: 65,536 an SM over NT threads at launch, moved from the
// producer to the consumers (multiples of 8)
constexpr int PRODUCER_REGS = 56;
constexpr int CONSUMER_REGS = 152;
constexpr float LOG2E = 1.4426950408889634f;

// S[64 x 128] = Q[64 x 64] . K[128 x 64]^T for this warpgroup, then wait.
WT_DEV void score_tile(float (&s)[64], uint64_t dq, uint64_t dk) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)  // 16 values = 32 bytes along the row
    wgmma_m64n128k16_ss(s, dq + 2 * kk, dk + 2 * kk, kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(s);
}

// Accumulator element i of a thread: row half (i >> 1) & 1, column
// 8 * (i / 4) + 2 * (lane % 4) + (i & 1).  Columns >= T become -inf.
WT_DEV void mask_tail(float (&s)[64], int k0, int lane, int T) {
#pragma unroll
  for (int i = 0; i < 64; ++i)
    if (k0 + 8 * (i / 4) + 2 * (lane % 4) + (i & 1) >= T) s[i] = -INFINITY;
}

WT_DEV float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

WT_DEV float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__global__ void __launch_bounds__(NT, 1)
attn_kernel(const __grid_constant__ CUtensorMap map_q,
            const __grid_constant__ CUtensorMap map_k,
            const __grid_constant__ CUtensorMap map_v, bf16* __restrict__ out,
            int T, int q_tiles) {
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle is a function of the address: tiles on 1 KB
  const uint32_t s_q = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_ring = s_q + Q_BYTES;
  const uint32_t s_bar = s_ring + NSTAGE * TILE_BYTES;
  auto full = [&](int slot) { return s_bar + 8 * slot; };
  auto empty = [&](int slot) { return s_bar + 8 * (NSTAGE + slot); };
  const uint32_t q_bar = s_bar + 16 * NSTAGE;

  const int head = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * BQ;
  const int n_tiles = (T + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < NSTAGE; ++i) {
      mbar_init(full(i), 1);
      mbar_init(empty(i), 4 * CONSUMERS);  // lane 0 of each consumer warp
    }
    mbar_init(q_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: pass 1 loads K0..Kn-1, pass 2 K0, V0, K1, V1, ... ----
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(q_bar, Q_BYTES);
      tma_load_3d(s_q, &map_q, q_bar, 0, q0, head);
      for (int seq = 0; seq < 3 * n_tiles; ++seq) {
        const int slot = seq % NSTAGE;
        mbar_wait(empty(slot), ((seq / NSTAGE) & 1) ^ 1);
        mbar_arrive_expect_tx(full(slot), TILE_BYTES);
        const int j = seq - n_tiles;
        const int tile = j < 0 ? seq : j / 2;
        const CUtensorMap* map = (j >= 0 && (j & 1)) ? &map_v : &map_k;
        tma_load_3d(s_ring + slot * TILE_BYTES, map, full(slot), 0, tile * BK,
                    head);
      }
    }
  } else {
    // ---- consumers: 64 query rows a warpgroup ----
    reg_alloc<CONSUMER_REGS>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int row_lo = q0 + (wg - 1) * 64 + warp * 16 + lane / 4;
    const uint64_t dq = wgmma_desc(s_q + (wg - 1) * (64 * DH * 2));
    int seq = 0;
    float s[64];
    // the next ring slot as a full tile: wait, and return its descriptor
    auto next_tile = [&](int& slot) {
      slot = seq % NSTAGE;
      mbar_wait(full(slot), (seq / NSTAGE) & 1);
      ++seq;
      return wgmma_desc(s_ring + slot * TILE_BYTES);
    };
    mbar_wait(q_bar, 0);

    // ---- pass 1: m = max s * log2e, l = sum 2^(s * log2e - m), online ----
    float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.0f, l_hi = 0.0f;
    for (int it = 0; it < n_tiles; ++it) {
      int slot;
      const uint64_t dk = next_tile(slot);
      score_tile(s, dq, dk);
      if (lane == 0) mbar_arrive(empty(slot));
      if ((it + 1) * BK > T) mask_tail(s, it * BK, lane, T);
      float t_lo = -INFINITY, t_hi = -INFINITY;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        t_lo = fmaxf(t_lo, fmaxf(s[4 * j], s[4 * j + 1]));
        t_hi = fmaxf(t_hi, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      // every tile holds a column < T, so the new max is finite
      const float n_lo = fmaxf(m_lo, quad_max(t_lo) * LOG2E);
      const float n_hi = fmaxf(m_hi, quad_max(t_hi) * LOG2E);
      l_lo *= fast_exp2(m_lo - n_lo);
      l_hi *= fast_exp2(m_hi - n_hi);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        l_lo += fast_exp2(fmaf(s[4 * j], LOG2E, -n_lo)) +
                fast_exp2(fmaf(s[4 * j + 1], LOG2E, -n_lo));
        l_hi += fast_exp2(fmaf(s[4 * j + 2], LOG2E, -n_hi)) +
                fast_exp2(fmaf(s[4 * j + 3], LOG2E, -n_hi));
      }
      m_lo = n_lo;
      m_hi = n_hi;
    }
    // p = 2^(s * log2e - c), c = m + log2 l: normalised without a division
    const float c_lo = m_lo + log2f(quad_sum(l_lo));
    const float c_hi = m_hi + log2f(quad_sum(l_hi));

    // ---- pass 2: O += bf16(p) . V ----
    float o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.0f;
    for (int it = 0; it < n_tiles; ++it) {
      int slot;
      const uint64_t dk = next_tile(slot);
      score_tile(s, dq, dk);
      if (lane == 0) mbar_arrive(empty(slot));
      if ((it + 1) * BK > T) mask_tail(s, it * BK, lane, T);  // p = 0 there
      // words 4kk..4kk+3 are the m64k16 A fragment of keys 16kk..16kk+15
      uint32_t p[32];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        p[2 * j] = pack_bf16(fast_exp2(fmaf(s[4 * j], LOG2E, -c_lo)),
                             fast_exp2(fmaf(s[4 * j + 1], LOG2E, -c_lo)));
        p[2 * j + 1] = pack_bf16(fast_exp2(fmaf(s[4 * j + 2], LOG2E, -c_hi)),
                                 fast_exp2(fmaf(s[4 * j + 3], LOG2E, -c_hi)));
      }
      const uint64_t dv = next_tile(slot);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)  // 16 keys = 16 rows of 128 bytes
        wgmma_m64n64k16_rs(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                           p[4 * kk + 3], dv + kk * (16 * DH * 2 / 16), 1);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(o);
      if (lane == 0) mbar_arrive(empty(slot));
    }

    // ---- epilogue: O (fp32) -> bf16, rows < T only ----
    bf16* dst = out + ((size_t)head * T + row_lo) * DH + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (row_lo < T)
        *reinterpret_cast<uint32_t*>(dst + 8 * j) =
            pack_bf16(o[4 * j], o[4 * j + 1]);
      if (row_lo + 8 < T)
        *reinterpret_cast<uint32_t*>(dst + 8 * DH + 8 * j) =
            pack_bf16(o[4 * j + 2], o[4 * j + 3]);
    }
  }
}

// [bh, T, 64] bf16 in boxes of `rows` rows of one head, 128-byte swizzle;
// rows outside the tensor are filled with zeros.
bool make_map(CUtensorMap* map, const void* ptr, int bh, int T, int rows) {
  const cuuint64_t dims[3] = {DH, (cuuint64_t)T, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {DH * 2, (cuuint64_t)T * DH * 2};
  const cuuint32_t box[3] = {DH, (cuuint32_t)rows, 1};
  return make_tensor_map(map, ptr, 3, dims, strides, box);
}

}  // namespace

WT_EXPORT int wt_fused_attention(const void* q, const void* k, const void* v,
                                 void* out, int bh, int T, void* stream) {
  if (bh < 1 || T < 1) return (int)cudaErrorInvalidValue;
  if (!tensor_map_encoder()) return (int)cudaErrorNotSupported;
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, bh, T, BQ) || !make_map(&mk, k, bh, T, BK) ||
      !make_map(&mv, v, bh, T, BK))
    return (int)cudaErrorInvalidValue;
  cudaError_t rc = cudaFuncSetAttribute(
      (const void*)attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (rc != cudaSuccess) return (int)rc;
  const int q_tiles = (T + BQ - 1) / BQ;
  attn_kernel<<<bh * q_tiles, NT, SMEM_BYTES, (cudaStream_t)stream>>>(
      mq, mk, mv, (bf16*)out, T, q_tiles);
  return (int)cudaGetLastError();
}
