// B5: the one-shot log-mel front end: framing, window-folded real DFT,
// power spectrum, mel projection and log10, for every frame of a file.
//
// Replaces whisper_tpu/ops/pallas_mel.py:log_mel_pallas (_mel_kernel).
// Contract, as there: frame f covers samples [160f, 160f+400) of the
// reflect-padded signal (zero past its end); int16 input is decoded as
// x * fl32(1/32767) before framing (frontend/mel.decode_transfer);
//   re[k] = sum_n x[n] * cosw[n, k],  im[k] = sum_n x[n] * sinw[n, k]
// with the Hann window folded into the [400, 201] fp32 tables;
//   power = re*re + im*im;  mel[m] = sum_k power[k] * fb_t[k, m];
//   out[f, m] = log10(max(mel, 1e-10)),
// un-normalized: the masked global max, the clamp at max-8, (x+4)/4 and the
// zeroing of invalid frames stay outside, as in JAX.  Every product and sum
// is fp32 on the CUDA cores: the TPU kernel runs its matmuls at
// Precision.HIGHEST, and the tensor cores would give TF32 (~3 digits).
//
// Tables: the same window-folded tables the plain version multiplies
// (frontend/mel._constants), streamed from global memory through L2 (2 x
// 321.6 KB, too large for one block's shared memory).  So both versions
// multiply identical operands and differ only in the order of the fp32
// sums (and FMA contraction in the DFT), a few fp32 ulps of each bin.
//
// What bounds it on the H100: at 7,680 frames the DFT is 7680*201*400*2 =
// 1.24 G FMAs (2.5 GFLOP; the mel projection adds 0.25 GFLOP at 80 mels),
// ~37 us at the 67 TFLOP/s fp32 peak; the samples in and the log-mel out
// are 5 MB together, so the fp32 pipes bound it.  Design: one block of 224
// threads per tile of 16 frames; the tile's 2,800 samples are decoded into
// shared memory once; thread k < 201 owns frequency bin k and keeps the 16
// frames' re/im sums in registers, so each table entry it loads (coalesced
// across k) feeds 16 FMAs, and each 16-byte shared load of a frame feeds 8.
// The power spectra go to shared memory for the mel projection (threads
// over (frame, mel) pairs, filterbank columns coalesced).  The ragged last
// tile computes its frames past n_frames and does not store them.
#include "common.cuh"

namespace {

constexpr int WIN = 400;
constexpr int HOP = 160;
constexpr int NFREQ = 201;
constexpr int FT = 16;                       // frames per block
constexpr int NT = 224;                      // 7 warps; k = tid < 201
constexpr int SPAN = (FT - 1) * HOP + WIN;   // samples a tile reads

template <typename T>
__device__ __forceinline__ float decode(T x, float scale);

template <>
__device__ __forceinline__ float decode<float>(float x, float) {
  return x;
}

template <>
__device__ __forceinline__ float decode<int16_t>(int16_t x, float scale) {
  return __fmul_rn((float)x, scale);
}

template <typename T>
__global__ void __launch_bounds__(NT)
log_mel_kernel(const T* __restrict__ audio, long long n_samples,
               const float* __restrict__ cosw, const float* __restrict__ sinw,
               const float* __restrict__ fb_t, float* __restrict__ out,
               int n_frames, int n_mels, float scale) {
  __shared__ __align__(16) float sx[SPAN];
  __shared__ float spow[FT][NFREQ];

  const int f0 = blockIdx.x * FT;
  const long long s0 = (long long)f0 * HOP;
  const int tid = threadIdx.x;
  for (int i = tid; i < SPAN; i += NT) {
    const long long s = s0 + i;
    sx[i] = s < n_samples ? decode<T>(audio[s], scale) : 0.0f;
  }
  __syncthreads();

  const int k = tid;
  if (k < NFREQ) {
    float re[FT], im[FT];
#pragma unroll
    for (int f = 0; f < FT; ++f) re[f] = im[f] = 0.0f;
    for (int n = 0; n < WIN; n += 4) {
      float c[4], s[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        c[j] = cosw[(n + j) * NFREQ + k];
        s[j] = sinw[(n + j) * NFREQ + k];
      }
#pragma unroll
      for (int f = 0; f < FT; ++f) {
        const float4 x = *reinterpret_cast<const float4*>(&sx[f * HOP + n]);
        re[f] = __fmaf_rn(x.x, c[0], re[f]);
        im[f] = __fmaf_rn(x.x, s[0], im[f]);
        re[f] = __fmaf_rn(x.y, c[1], re[f]);
        im[f] = __fmaf_rn(x.y, s[1], im[f]);
        re[f] = __fmaf_rn(x.z, c[2], re[f]);
        im[f] = __fmaf_rn(x.z, s[2], im[f]);
        re[f] = __fmaf_rn(x.w, c[3], re[f]);
        im[f] = __fmaf_rn(x.w, s[3], im[f]);
      }
    }
    // re*re + im*im as the plain version rounds it: two products, one add.
#pragma unroll
    for (int f = 0; f < FT; ++f)
      spow[f][k] = __fadd_rn(__fmul_rn(re[f], re[f]), __fmul_rn(im[f], im[f]));
  }
  __syncthreads();

  for (int o = tid; o < FT * n_mels; o += NT) {
    const int f = o / n_mels, m = o % n_mels;
    if (f0 + f >= n_frames) break;  // o only grows, so f does too
    float acc = 0.0f;
    for (int kk = 0; kk < NFREQ; ++kk)
      acc = __fmaf_rn(spow[f][kk], fb_t[kk * n_mels + m], acc);
    out[(size_t)(f0 + f) * n_mels + m] = log10f(fmaxf(acc, 1e-10f));
  }
}

}  // namespace

WT_EXPORT int wt_log_mel(const void* audio, int is_int16, long long n_samples,
                         const void* cosw, const void* sinw, const void* fb_t,
                         void* out, int n_frames, int n_mels, float scale,
                         void* stream) {
  const int grid = (n_frames + FT - 1) / FT;
  if (is_int16)
    log_mel_kernel<int16_t><<<grid, NT, 0, (cudaStream_t)stream>>>(
        (const int16_t*)audio, n_samples, (const float*)cosw,
        (const float*)sinw, (const float*)fb_t, (float*)out, n_frames, n_mels,
        scale);
  else
    log_mel_kernel<float><<<grid, NT, 0, (cudaStream_t)stream>>>(
        (const float*)audio, n_samples, (const float*)cosw,
        (const float*)sinw, (const float*)fb_t, (float*)out, n_frames, n_mels,
        scale);
  return (int)cudaGetLastError();
}
