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
// Bound: bytes.  The call reads the logits once (4 B V bytes) and writes B
// ids; ten Philox rounds a group of four ids are far under the card's
// integer rate.  Design: one block a row (the argmax is block-wide, no pass
// across blocks), 512 threads striding over the groups of four ids, each
// thread's running best, then a warp and a block reduction of (score, id).
// A simple kernel: B blocks use B of the card's SMs.
//
// wt_gumbel_pick returns cudaGetLastError(); it never synchronises.

#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr unsigned kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
constexpr unsigned kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;

struct Words {
  unsigned x[4];
};

// Philox4x32-10 (Salmon et al., SC'11; Random123's philox4x32_R(10, ...)).
__device__ __forceinline__ Words philox(unsigned c0, unsigned c1, unsigned c2,
                                        unsigned c3, unsigned k0,
                                        unsigned k1) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    if (i) {
      k0 += kW0;
      k1 += kW1;
    }
    unsigned hi0 = __umulhi(kM0, c0), lo0 = kM0 * c0;
    unsigned hi1 = __umulhi(kM1, c2), lo1 = kM1 * c2;
    unsigned n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
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

__global__ void __launch_bounds__(kThreads)
gumbel_pick_kernel(const float* __restrict__ logits,
                   const float* __restrict__ temperature,
                   const long long* __restrict__ key,
                   const long long* __restrict__ step,
                   long long* __restrict__ tok, float* __restrict__ u_out,
                   float* __restrict__ score_out, int vocab, int row0) {
  const int r = blockIdx.x;
  const unsigned long long seed = (unsigned long long)key[0];
  const unsigned long long offset = (unsigned long long)key[1];
  const unsigned k0 = (unsigned)seed;
  const unsigned k1 = (unsigned)(seed >> 32) ^ (unsigned)(offset >> 32);
  const unsigned c1 = (unsigned)(row0 + r);
  const unsigned c2 = (unsigned)step[0];
  const unsigned c3 = (unsigned)offset;
  const float t = temperature[0];
  const float* row = logits + (size_t)r * vocab;
  const int groups = (vocab + 3) / 4;

  float best = -INFINITY;
  int best_id = INT_MAX;
  for (int g = threadIdx.x; g < groups; g += kThreads) {
    Words w = philox((unsigned)g, c1, c2, c3, k0, k1);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int v = 4 * g + j;
      if (v >= vocab) break;
      float u = ((float)(w.x[j] >> 9) + 0.5f) * 0x1.0p-23f;
      float e = fmaxf(-logf(u), FLT_MIN);
      float s = __fdiv_rn(row[v], t) - logf(e);
      if (u_out) u_out[(size_t)r * vocab + v] = u;
      if (score_out) score_out[(size_t)r * vocab + v] = s;
      if (better(s, v, best, best_id)) {
        best = s;
        best_id = v;
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    float s = __shfl_xor_sync(0xffffffffu, best, o);
    int v = __shfl_xor_sync(0xffffffffu, best_id, o);
    if (better(s, v, best, best_id)) {
      best = s;
      best_id = v;
    }
  }
  __shared__ float s_best[kThreads / 32];
  __shared__ int s_id[kThreads / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    s_best[warp] = best;
    s_id[warp] = best_id;
  }
  __syncthreads();
  if (warp == 0) {
    best = lane < kThreads / 32 ? s_best[lane] : -INFINITY;
    best_id = lane < kThreads / 32 ? s_id[lane] : INT_MAX;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      float s = __shfl_xor_sync(0xffffffffu, best, o);
      int v = __shfl_xor_sync(0xffffffffu, best_id, o);
      if (better(s, v, best, best_id)) {
        best = s;
        best_id = v;
      }
    }
    if (lane == 0) tok[r] = best_id;
  }
}

}  // namespace

// logits [rows, vocab] fp32; temperature [1] fp32; key [2] int64 (seed,
// offset); step [1] int64; tok [rows] int64 out; u_out and score_out
// [rows, vocab] fp32 or null (the draws and scores, for checks).
WT_EXPORT int wt_gumbel_pick(const float* logits, const float* temperature,
                             const long long* key, const long long* step,
                             long long* tok, float* u_out, float* score_out,
                             int rows, int vocab, int row0, void* stream) {
  gumbel_pick_kernel<<<rows, kThreads, 0, (cudaStream_t)stream>>>(
      logits, temperature, key, step, tok, u_out, score_out, vocab, row0);
  return (int)cudaGetLastError();
}
