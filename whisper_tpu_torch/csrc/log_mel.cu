// B5: the one-shot log-mel front end: framing, Hann window, real FFT, power
// spectrum, mel projection, log10 and the normalisation, in two kernels.
//
// Replaces whisper_tpu/ops/pallas_mel.py:log_mel_pallas (_mel_kernel and
// the normalisation its wrapper applies).  Contract, as there: frame f
// covers samples [160f, 160f+400) of the reflect-padded signal (zero past
// its end); int16 input is decoded as x * fl32(1/32767) before framing
// (frontend/mel.decode_transfer); the 400 windowed samples give the power
// spectrum of 201 bins, power = re*re + im*im (two products, one add);
//   mel[m] = sum_k power[k] * fb[m, k];  raw = log10(max(mel, 1e-10));
// g = the max of raw over the frames < valid_frames; out = (max(raw, g - 8)
// + 4) / 4 for those frames and 0 for the others.  Every operation is fp32
// on the CUDA cores: the TPU kernel runs its matmuls at Precision.HIGHEST,
// and the tensor cores would give TF32 (~3 digits).
//
// The transform is not the plain version's dense window-folded DFT but an
// FFT, so the sums run in another order: the result is held to 1e-4 on the
// normalised mel against the plain version, not bitwise.  (The plain
// version's own order is cuBLAS's and depends on the shape: at a bucket of
// 3,000 frames and 128 mels it stands 1.4e-4 from a float64 evaluation of
// the function, and a dense DFT loop on the plain version's operands in
// their order stood 1.2e-4 from it there, as the FFT did.)
//   * The 400 windowed samples are taken as a 200-point complex sequence
//     z[n] = x[2n] + i x[2n+1], transformed by a 200-point FFT (8 x 25, the
//     25 as 5 x 5: radix 8, 5, 5, each pass in place in shared memory), and
//     the 201 real-signal bins are split off it:
//       X[k] = (Z[k] + conj Z[-k]) / 2 + W400^k (Z[k] - conj Z[-k]) / 2i.
//     The twiddles W400^k = cos(2 pi k / 400) - i sin(2 pi k / 400) come
//     from one table computed in fp64 and rounded to fp32 (the radix-8 and
//     radix-5 constants are entries of it), the window from another.
//   * The mel projection sums each filter's contiguous band of nonzero bins
//     only, in increasing k, with the band's weights packed in a table: a
//     weight that is exactly 0 adds +0 to a non-negative sum, so this is the
//     dense sum's value in the dense order.
//   * Only frames < valid_frames are transformed; the others are written
//     as 0, what the normalisation makes of them.
//
// What bounds it on the H100: at 7,680 valid frames the FFT, the power and
// the mel projection are about 77 M fp32 operations (1.2 us at 67 TFLOP/s),
// and the samples in and the [80, 12,000] fp32 out are 6.3 MB (1.9 us at
// 3.35 TB/s): bytes bound it, and at this size the launches.  Design:
//   * spectrum kernel: a block of 8 warps a tile of 8 frames, a warp a
//     frame; the warp's 200 complex points live in shared memory, a lane
//     holding one radix-8 or radix-5 butterfly's points in registers; the
//     tile's raw log-mel goes to shared memory and is stored a mel row of 8
//     frames (32 bytes) at a time into the [n_mels, n_frames] layout the
//     encoder reads, with the tile's max into `block_max`.
//   * normalisation kernel, launched as the spectrum kernel's programmatic
//     dependent (it is scheduled while the last tiles run and waits for
//     them): every block reduces the valid tiles' maxima (exact in any
//     order) and normalises its part of the valid frames in place.
#include "hopper.cuh"

namespace {

constexpr int HOP = 160;
constexpr int NC = 200;        // complex points: the 400 samples in pairs
constexpr int NFREQ = 201;
constexpr int FT = 8;          // frames a tile, a warp each
constexpr int NT = 32 * FT;
constexpr int MAX_MELS = 128;
constexpr int NORM_NT = 256;
constexpr int NORM_FRAMES = 2048;  // frames of one mel row a block normalises

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y));
}
// a * (c - i s), the twiddle (c, s) of the table
__device__ __forceinline__ float2 ctw(float2 a, float2 w) {
  return make_float2(__fmaf_rn(a.x, w.x, __fmul_rn(a.y, w.y)),
                     __fmaf_rn(a.y, w.x, -__fmul_rn(a.x, w.y)));
}
// t - i u and t + i u
__device__ __forceinline__ float2 sub_iu(float2 t, float2 u) {
  return make_float2(__fadd_rn(t.x, u.y), __fsub_rn(t.y, u.x));
}
__device__ __forceinline__ float2 add_iu(float2 t, float2 u) {
  return make_float2(__fsub_rn(t.x, u.y), __fadd_rn(t.y, u.x));
}

// The 8-point DFT X[k] = sum_n a[n] W8^(nk) in place, as radix 2:
// h = cos(pi / 4).
__device__ __forceinline__ void dft8(float2 (&a)[8], float h) {
  float2 u[4], v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    u[j] = cadd(a[j], a[j + 4]);
    v[j] = csub(a[j], a[j + 4]);
  }
  const float2 p0 = cadd(u[0], u[2]), p1 = csub(u[0], u[2]);
  const float2 q0 = cadd(u[1], u[3]), q1 = csub(u[1], u[3]);
  const float2 t0 = v[0];
  const float2 t1 = make_float2(__fmul_rn(h, __fadd_rn(v[1].x, v[1].y)),
                                __fmul_rn(h, __fsub_rn(v[1].y, v[1].x)));
  const float2 t2 = make_float2(v[2].y, -v[2].x);
  const float2 t3 = make_float2(__fmul_rn(h, __fsub_rn(v[3].y, v[3].x)),
                                -__fmul_rn(h, __fadd_rn(v[3].x, v[3].y)));
  const float2 r0 = cadd(t0, t2), r1 = csub(t0, t2);
  const float2 s0 = cadd(t1, t3), s1 = csub(t1, t3);
  a[0] = cadd(p0, q0);
  a[4] = csub(p0, q0);
  a[2] = sub_iu(p1, q1);
  a[6] = add_iu(p1, q1);
  a[1] = cadd(r0, s0);
  a[5] = csub(r0, s0);
  a[3] = sub_iu(r1, s1);
  a[7] = add_iu(r1, s1);
}

// The 5-point DFT in place: w1 = (cos, sin)(2 pi / 5), w2 the same of
// 4 pi / 5.
__device__ __forceinline__ void dft5(float2 (&a)[5], float2 w1, float2 w2) {
  const float2 s1 = cadd(a[1], a[4]), d1 = csub(a[1], a[4]);
  const float2 s2 = cadd(a[2], a[3]), d2 = csub(a[2], a[3]);
  const float2 t1 = make_float2(
      __fmaf_rn(w2.x, s2.x, __fmaf_rn(w1.x, s1.x, a[0].x)),
      __fmaf_rn(w2.x, s2.y, __fmaf_rn(w1.x, s1.y, a[0].y)));
  const float2 t2 = make_float2(
      __fmaf_rn(w1.x, s2.x, __fmaf_rn(w2.x, s1.x, a[0].x)),
      __fmaf_rn(w1.x, s2.y, __fmaf_rn(w2.x, s1.y, a[0].y)));
  const float2 u1 = make_float2(__fmaf_rn(w2.y, d2.x, __fmul_rn(w1.y, d1.x)),
                                __fmaf_rn(w2.y, d2.y, __fmul_rn(w1.y, d1.y)));
  const float2 u2 = make_float2(__fmaf_rn(-w1.y, d2.x, __fmul_rn(w2.y, d1.x)),
                                __fmaf_rn(-w1.y, d2.y, __fmul_rn(w2.y, d1.y)));
  a[0] = cadd(a[0], cadd(s1, s2));
  a[1] = sub_iu(t1, u1);
  a[4] = add_iu(t1, u1);
  a[2] = sub_iu(t2, u2);
  a[3] = add_iu(t2, u2);
}

// The 200-point DFT Z[k] = sum_n z[n] W200^(nk) of one warp's z, in place:
// n = 25 n1 + n2 and k = k1 + 8 k2 (radix 8 over n1, then the twiddle
// W200^(n2 k1)), then each 25-point DFT over n2 with n2 = 5 m1 + m2 and k2
// = j1 + 5 j2 (radix 5 over m1, the twiddle W25^(m2 j1), radix 5 over m2).
// Each pass reads and writes the same slots, so it needs no second buffer;
// Z[k1 + 8 (j1 + 5 j2)] ends in slot 25 k1 + 5 j1 + j2 (zslot).
__device__ __forceinline__ void fft200(float2* z,
                                       const float2* __restrict__ tw) {
  const int lane = threadIdx.x % 32;
  if (lane < 25) {
    float2 a[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = z[25 * i + lane];
    dft8(a, __ldg(&tw[50].x));
    z[lane] = a[0];
#pragma unroll
    for (int k1 = 1; k1 < 8; ++k1)
      z[25 * k1 + lane] = ctw(a[k1], __ldg(&tw[2 * lane * k1]));
  }
  __syncwarp();
  const float2 w1 = __ldg(&tw[80]), w2 = __ldg(&tw[160]);
  for (int t = lane; t < 40; t += 32) {  // (k1, m2): radix 5 over m1
    float2* s = z + 25 * (t / 5) + t % 5;
    const int m2 = t % 5;
    float2 a[5];
#pragma unroll
    for (int i = 0; i < 5; ++i) a[i] = s[5 * i];
    dft5(a, w1, w2);
    s[0] = a[0];
#pragma unroll
    for (int j1 = 1; j1 < 5; ++j1)
      s[5 * j1] = ctw(a[j1], __ldg(&tw[16 * m2 * j1]));
  }
  __syncwarp();
  for (int t = lane; t < 40; t += 32) {  // (k1, j1): radix 5 over m2
    float2* s = z + 25 * (t / 5) + 5 * (t % 5);
    float2 a[5];
#pragma unroll
    for (int i = 0; i < 5; ++i) a[i] = s[i];
    dft5(a, w1, w2);
#pragma unroll
    for (int i = 0; i < 5; ++i) s[i] = a[i];
  }
  __syncwarp();
}

__device__ __forceinline__ int zslot(int k) {
  const int k2 = k / 8;
  return 25 * (k % 8) + 5 * (k2 % 5) + k2 / 5;
}

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
mel_spectrum_kernel(const T* __restrict__ audio, long long n_samples,
                    const float2* __restrict__ tw,
                    const float* __restrict__ win,
                    const int* __restrict__ bands,
                    const float* __restrict__ weights, float* __restrict__ out,
                    float* __restrict__ block_max, int n_frames, int valid,
                    int n_mels, float scale) {
  __shared__ float2 sz[FT][NC];
  __shared__ float spow[FT][NFREQ + 3];
  __shared__ float stage[MAX_MELS][FT + 1];  // + 1: no bank conflicts
  __shared__ float wmax[FT];

  grid_launch_dependents();  // the normalisation may be scheduled
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int f0 = blockIdx.x * FT, f = f0 + warp;
  float lmax = -INFINITY;
  if (f < valid) {  // uniform in a warp
    float2* z = sz[warp];
    const long long s0 = (long long)f * HOP;
    for (int n = lane; n < NC; n += 32) {
      const long long s = s0 + 2 * n;
      const float x0 = s < n_samples ? decode<T>(audio[s], scale) : 0.0f;
      const float x1 =
          s + 1 < n_samples ? decode<T>(audio[s + 1], scale) : 0.0f;
      z[n] = make_float2(__fmul_rn(x0, __ldg(&win[2 * n])),
                         __fmul_rn(x1, __ldg(&win[2 * n + 1])));
    }
    __syncwarp();
    fft200(z, tw);
    for (int k = lane; k < NFREQ; k += 32) {
      const float2 zk = z[zslot(k % NC)], zn = z[zslot((NC - k) % NC)];
      // E = (Z[k] + conj Z[-k]) / 2,  O = (Z[k] - conj Z[-k]) / 2i
      const float2 e = make_float2(__fmul_rn(__fadd_rn(zk.x, zn.x), 0.5f),
                                   __fmul_rn(__fsub_rn(zk.y, zn.y), 0.5f));
      const float2 o = make_float2(__fmul_rn(__fadd_rn(zk.y, zn.y), 0.5f),
                                   __fmul_rn(__fsub_rn(zn.x, zk.x), 0.5f));
      const float2 x = cadd(e, ctw(o, __ldg(&tw[k])));
      spow[warp][k] = __fadd_rn(__fmul_rn(x.x, x.x), __fmul_rn(x.y, x.y));
    }
    __syncwarp();
    for (int m = lane; m < n_mels; m += 32) {
      const int first = bands[3 * m], count = bands[3 * m + 1];
      const float* w = weights + bands[3 * m + 2];
      float acc = 0.0f;
      for (int i = 0; i < count; ++i)
        acc = __fmaf_rn(spow[warp][first + i], __ldg(&w[i]), acc);
      const float v = log10f(fmaxf(acc, 1e-10f));
      stage[m][warp] = v;
      lmax = fmaxf(lmax, v);
    }
  } else {
    for (int m = lane; m < n_mels; m += 32) stage[m][warp] = 0.0f;
  }
  lmax = warp_max(lmax);
  if (lane == 0) wmax[warp] = lmax;
  __syncthreads();
  for (int i = tid; i < n_mels * FT; i += NT) {
    const int m = i / FT, j = i % FT;
    if (f0 + j < n_frames) out[(size_t)m * n_frames + f0 + j] = stage[m][j];
  }
  if (tid == 0) {
    float g = wmax[0];
#pragma unroll
    for (int w = 1; w < FT; ++w) g = fmaxf(g, wmax[w]);
    block_max[blockIdx.x] = g;
  }
}

// Blocks (x, m): frames [NORM_FRAMES x, NORM_FRAMES (x + 1)) of mel row m,
// those < valid normalised in place; g from the first `tiles` tiles' maxima.
__global__ void __launch_bounds__(NORM_NT)
mel_normalize_kernel(float* __restrict__ out,
                     const float* __restrict__ block_max, int tiles,
                     int n_frames, int valid) {
  __shared__ float red[NORM_NT / 32];
  grid_dependency_wait();  // the spectrum kernel's writes are visible
  const int tid = threadIdx.x;
  float g = -INFINITY;
  for (int i = tid; i < tiles; i += NORM_NT) g = fmaxf(g, block_max[i]);
  g = block_reduce<NORM_NT>(g, red, true);
  const float lo = __fsub_rn(g, 8.0f);
  float* row = out + (size_t)blockIdx.y * n_frames;
  const int end = min(valid, (blockIdx.x + 1) * NORM_FRAMES);
  for (int f = blockIdx.x * NORM_FRAMES + tid; f < end; f += NORM_NT)
    row[f] = __fmul_rn(__fadd_rn(fmaxf(row[f], lo), 4.0f), 0.25f);
}

}  // namespace

// `tw`: [400] (cos, sin)(2 pi k / 400) in fp32; `win`: [400] the Hann
// window; `bands`: [n_mels][3] (first bin, count, offset into `weights`);
// `block_max`: scratch of one float a tile of 8 frames.  `normalize` 0
// launches the spectrum kernel alone: the raw log-mel of the frames <
// valid, 0 for the others.
WT_EXPORT int wt_log_mel(const void* audio, int is_int16, long long n_samples,
                         const void* tw, const void* win, const void* bands,
                         const void* weights, void* out, void* block_max,
                         int n_frames, int valid, int n_mels, float scale,
                         int normalize, void* stream) {
  if (n_frames < 1 || n_mels < 1 || n_mels > MAX_MELS || valid < 0 ||
      valid > n_frames)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int tiles = (n_frames + FT - 1) / FT;
  if (is_int16)
    mel_spectrum_kernel<int16_t><<<tiles, NT, 0, s>>>(
        (const int16_t*)audio, n_samples, (const float2*)tw,
        (const float*)win, (const int*)bands, (const float*)weights,
        (float*)out, (float*)block_max, n_frames, valid, n_mels, scale);
  else
    mel_spectrum_kernel<float><<<tiles, NT, 0, s>>>(
        (const float*)audio, n_samples, (const float2*)tw, (const float*)win,
        (const int*)bands, (const float*)weights, (float*)out,
        (float*)block_max, n_frames, valid, n_mels, scale);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess || !normalize) return (int)rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)max(1, (valid + NORM_FRAMES - 1) / NORM_FRAMES),
                     (unsigned)n_mels);
  cfg.blockDim = dim3(NORM_NT);
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  rc = cudaLaunchKernelEx(&cfg, mel_normalize_kernel, (float*)out,
                          (const float*)block_max,
                          (valid + FT - 1) / FT, n_frames, valid);
  return rc != cudaSuccess ? (int)rc : (int)cudaGetLastError();
}
