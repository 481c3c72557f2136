// The sampled pick of a decode step (temperature T > 0): for each row r of
// the fp32 logits [B, V], the id v of the largest
//   logits[r, v] / T - log(E),  E = max(-log(u), FLT_MIN),
// u in (0, 1) the Philox4x32-10 uniform of (step, global row, v): a
// Gumbel-max draw, the distribution jax.random.categorical draws from.
// A suppressed id (-inf) can never be drawn, and a tie goes to the lowest
// id, NaN counting as the largest (torch.argmax's rule).
//
// It replaces no Pallas kernel: the JAX package draws on the TPU inside its
// lax.while_loop with the key in the loop's carry, split once a step
// (whisper_tpu/runtime/generate.py:97-111, 158-159, 195).  Here the key is
// a [2] int64 tensor of the loop's state, (seed, offset), and the step its
// [1] int64 step counter, both read on the card with T, so a CUDA graph of
// the step draws anew at every iteration of its while node.  The random
// bits are a counter-based generator: key (seed low word, seed high word
// ^ offset high word), counter (v / 4, row0 + r, step, offset low word),
// the four output words serving ids 4g .. 4g + 3; u = ((x >> 9) + 0.5) /
// 2^23, exact in fp32 and never 0 or 1.  The division is a true division
// (__fdiv_rn) and the logs are logf, so the kernel is bitwise its plain
// PyTorch version (ops/sampling.py) on the card.
//
// Bound: instruction issue, above bytes.  The call reads the logits once
// (4 B V bytes) and writes B ids, but each group of four ids costs a
// ten-round Philox chain, and each id two precise logfs and a division:
// ~90 instructions an id in the compiled loop, ~2.2 us of the whole
// card's issue at bucket 16 against 1 us of bytes (chip_smoke.py counts
// them from the SASS).  Design: each row is split across S blocks of 128
// threads, S chosen from the rows, the vocabulary and the card's SMs so
// that every SM holds about eight blocks' worth of threads and each
// thread walks only a few groups; each block takes a contiguous slice of
// whole groups, so every counter and every id's word stay as they are.
// A thread asks for its next group's logits before it works on the
// current one and keeps its running best; a warp and then the block
// reduce it to one (score, id), and the row's blocks meet in the same
// launch: each block's thread 0 folds its best into the row's 64-bit slot
// with a relaxed atomic max (the score mapped to an order-preserving word,
// NaN the largest, -0 as +0; the inverted id in the low word, so the
// lower id wins a tie: the order of better() below, whatever order the
// blocks finish in), then takes a ticket with an acquire-release add; the
// block that takes the last ticket sees every fold, writes the id and
// returns the slot and the ticket to 0.  Two round trips to L2 end the
// launch, not a fence each.  The slot and the ticket are a [B, 2] int64
// workspace that the caller zeroes once (a decode loop's state carries
// one, so a CUDA graph replays its own, and two launches in flight never
// share one); every launch leaves it zero again for the next launch, the
// next iteration of a while node or the next graph replay.
//
// The uniform is made from its 23 bits as 1.m - (1 - 2^-24) = (2k + 1) /
// 2^24, which is exact and equals ((float)k + 0.5) * 2^-23 bit for bit.
//
// wt_gumbel_pick returns cudaGetLastError(); it never synchronises.

#include <algorithm>
#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBlocksPerSM = 8;   // the threads an SM is given to hold
constexpr unsigned kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
constexpr unsigned kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;

struct Words {
  unsigned x[4];
};

struct Draw {
  unsigned c1, c2, c3;       // the counter's row, step and offset word
  unsigned k0[10], k1[10];   // the key of each round
  float t;
};

// Philox4x32-10 (Salmon et al., SC'11; Random123's philox4x32_R(10, ...))
// of counter (c0, d.c1, d.c2, d.c3) under the round keys of d.
__device__ __forceinline__ Words philox(unsigned c0, const Draw& d) {
  unsigned c1 = d.c1, c2 = d.c2, c3 = d.c3;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    unsigned hi0 = __umulhi(kM0, c0), lo0 = kM0 * c0;
    unsigned hi1 = __umulhi(kM1, c2), lo1 = kM1 * c2;
    unsigned n0 = hi1 ^ c1 ^ d.k0[i], n2 = hi0 ^ c3 ^ d.k1[i];
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return Words{{c0, c1, c2, c3}};
}

// Whether (a, ia) ranks before (b, ib): the larger value, NaN the largest,
// the lower id on a tie.
__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  bool an = isnan(a), bn = isnan(b);
  if (an || bn) return an && (!bn || ia < ib);
  return a > b || (a == b && ia < ib);
}

// (score, id) as one word whose unsigned order is better()'s: the score's
// bits made monotone (NaN the largest, -0 equal to +0) above the inverted
// id.  Every real score's word is above 0, the empty slot.
__device__ __forceinline__ unsigned long long pack(float s, int id) {
  unsigned b = __float_as_uint(s);
  unsigned w = isnan(s)              ? 0xFFFFFFFFu
               : b == 0x80000000u    ? 0x80000000u
               : (b >> 31)           ? ~b
                                     : b | 0x80000000u;
  return ((unsigned long long)w << 32) | (unsigned)~id;
}

// The n ids of group g (n = 4 but for a row's last group), their logits x,
// in order, into the thread's running best.  Ids come in increasing order,
// so a later id wins only on a larger score, or on a NaN over a number.
template <bool kDraws>
__device__ __forceinline__ void visit(const float (&x)[4], int g, int n,
                                      const Draw& d, float& best,
                                      int& best_id, float* __restrict__ u_row,
                                      float* __restrict__ s_row) {
  Words w = philox((unsigned)g, d);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j >= n) break;
    int v = 4 * g + j;
    float u = __uint_as_float(0x3F800000u | (w.x[j] >> 9)) - 0x1.fffffep-1f;
    float e = fmaxf(-logf(u), FLT_MIN);
    float s = __fdiv_rn(x[j], d.t) - logf(e);
    if (kDraws) {
      u_row[v] = u;
      s_row[v] = s;
    }
    if (!(s <= best) && !isnan(best)) {
      best = s;
      best_id = v;
    }
  }
}

__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) x[j] = __ldg(p + j);
}

__device__ __forceinline__ void warp_best(float& best, int& best_id) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    float s = __shfl_xor_sync(0xffffffffu, best, o);
    int v = __shfl_xor_sync(0xffffffffu, best_id, o);
    if (better(s, v, best, best_id)) {
      best = s;
      best_id = v;
    }
  }
}

// The row's slot and ticket: a block folds its best into the slot with a
// relaxed reduction, then takes a ticket with an acquire-release add, so
// the block that takes the last ticket sees every block's fold.
__device__ __forceinline__ void fold_max(unsigned long long* p,
                                         unsigned long long v) {
  asm volatile("red.relaxed.gpu.global.max.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long take_ticket(
    unsigned long long* p) {
  unsigned long long old;
  asm volatile("atom.acq_rel.gpu.global.add.u64 %0, [%1], 1;"
               : "=l"(old)
               : "l"(p)
               : "memory");
  return old;
}

// grid (S, rows): block (s, r) takes groups [s * per_block, (s + 1) *
// per_block) of row r; ws [rows, 2]: the row's slot and ticket.
template <bool kDraws>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
gumbel_pick_kernel(const float* __restrict__ logits,
                   const float* __restrict__ temperature,
                   const long long* __restrict__ key,
                   const long long* __restrict__ step,
                   long long* __restrict__ tok, float* __restrict__ u_out,
                   float* __restrict__ score_out,
                   unsigned long long* __restrict__ ws, int vocab, int row0,
                   int per_block) {
  const int r = blockIdx.y;
  const float* row = logits + (size_t)r * vocab;
  const int full = vocab / 4, groups = (vocab + 3) / 4;
  const int lo = blockIdx.x * per_block;
  const int hi = min(groups, lo + per_block);
  const int stop = min(hi, full);
  int g = lo + threadIdx.x;
  // the first group's logits, asked for beside the key: the loop then
  // asks for each next group's before it works on this one
  float x[4];
  const float* p = row + 4 * (size_t)min(g, max(stop - 1, 0));
  if (stop > 0) load4(p, x);

  const unsigned long long seed = (unsigned long long)key[0];
  const unsigned long long offset = (unsigned long long)key[1];
  Draw d;
  d.c1 = (unsigned)(row0 + r);
  d.c2 = (unsigned)step[0];
  d.c3 = (unsigned)offset;
  d.k0[0] = (unsigned)seed;
  d.k1[0] = (unsigned)(seed >> 32) ^ (unsigned)(offset >> 32);
#pragma unroll
  for (int i = 1; i < 10; ++i) {
    d.k0[i] = d.k0[i - 1] + kW0;
    d.k1[i] = d.k1[i - 1] + kW1;
  }
  d.t = temperature[0];
  float* u_row = kDraws ? u_out + (size_t)r * vocab : nullptr;
  float* s_row = kDraws ? score_out + (size_t)r * vocab : nullptr;

  float best = -INFINITY;
  int best_id = g < hi ? 4 * g : INT_MAX;   // the first id: a -inf slice's
#pragma unroll 1
  for (; g < stop; g += kThreads) {
    float next[4];
    if (g + kThreads < stop) p += 4 * kThreads;
    load4(p, next);   // the next group's, or this one's again at the end
    visit<kDraws>(x, g, 4, d, best, best_id, u_row, s_row);
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = next[j];
  }
  if (g == full && g < hi) {   // the row's last group, of vocab % 4 ids
    const int n = vocab - 4 * full;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < n) x[j] = __ldg(row + 4 * g + j);
    visit<kDraws>(x, g, n, d, best, best_id, u_row, s_row);
  }

  warp_best(best, best_id);
  __shared__ float s_best[kThreads / 32];
  __shared__ int s_id[kThreads / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    s_best[warp] = best;
    s_id[warp] = best_id;
  }
  __syncthreads();
  if (warp != 0) return;
  best = lane < kThreads / 32 ? s_best[lane] : -INFINITY;
  best_id = lane < kThreads / 32 ? s_id[lane] : INT_MAX;
  warp_best(best, best_id);
  if (lane != 0) return;
  unsigned long long* slot = ws + 2 * r;
  fold_max(slot, pack(best, best_id));
  if (take_ticket(slot + 1) == gridDim.x - 1) {
    unsigned long long won = atomicExch(slot, 0ull);
    slot[1] = 0;   // every block has taken its ticket
    tok[r] = (int)~(unsigned)won;
  }
}

int sm_count() {
  static int counts[64];   // by device; 0 until asked
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (counts[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    counts[dev] = n > 0 ? n : 132;
  }
  return counts[dev];
}

}  // namespace

// Groups of four ids a block takes for `rows` rows of `vocab` ids: as many
// threads as the card holds at kBlocksPerSM blocks an SM, each walking the
// fewest groups that cover the rows (at least one).
WT_EXPORT int wt_gumbel_pick_groups_per_block(int rows, int vocab) {
  const long long groups = (vocab + 3) / 4;
  const long long held = (long long)sm_count() * kBlocksPerSM * kThreads;
  const long long per_thread =
      std::max(1LL, ((long long)rows * groups + held - 1) / held);
  return (int)std::min(groups, per_thread * kThreads);
}

// logits [rows, vocab] fp32; temperature [1] fp32; key [2] int64 (seed,
// offset); step [1] int64; tok [rows] int64 out; u_out and score_out
// [rows, vocab] fp32 or null (the draws and scores, for checks); ws [rows,
// 2] int64, zero, left zero.
WT_EXPORT int wt_gumbel_pick(const float* logits, const float* temperature,
                             const long long* key, const long long* step,
                             long long* tok, float* u_out, float* score_out,
                             long long* ws, int rows, int vocab, int row0,
                             void* stream) {
  if (rows < 1 || rows > 65535 || vocab < 1 ||
      (u_out == nullptr) != (score_out == nullptr))
    return (int)cudaErrorInvalidValue;
  const int per_block = wt_gumbel_pick_groups_per_block(rows, vocab);
  const int groups = (vocab + 3) / 4;
  const dim3 grid((groups + per_block - 1) / per_block, rows);
  auto* slots = reinterpret_cast<unsigned long long*>(ws);
  cudaStream_t s = (cudaStream_t)stream;
  if (u_out != nullptr) {
    gumbel_pick_kernel<true><<<grid, kThreads, 0, s>>>(
        logits, temperature, key, step, tok, u_out, score_out, slots, vocab,
        row0, per_block);
  } else {
    gumbel_pick_kernel<false><<<grid, kThreads, 0, s>>>(
        logits, temperature, key, step, tok, nullptr, nullptr, slots, vocab,
        row0, per_block);
  }
  return (int)cudaGetLastError();
}
