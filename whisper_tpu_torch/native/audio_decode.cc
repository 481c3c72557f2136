// Native audio decoder: any container/codec supported by FFmpeg ->
// mono float32 PCM + source sample rate.
//
// C++ counterpart of the reference's symphonia decode loop
// (ref src/main.rs:228-316): probe/demux/decode, channel-mean mono
// downmix, normalization to [-1, 1].  Resampling to 16 kHz stays in the
// caller so the linear-interp resampler (ref src/main.rs:207-226) is shared
// between the native and Python paths.
//
// The port's copy of whisper_tpu/native/audio_decode.cc.  audio_native.py
// builds it at first use with g++ -O2 -fPIC -std=c++17 -ffp-contract=off
// -shared ... -lavformat -lavcodec -lavutil and binds this C ABI with ctypes:
//   int  wt_decode_mono(const char* path, float** out, long* n, int* sr);
//   long wt_resample_len(long n_in, int sr_in, int sr_out);
//   void wt_resample_linear(const float* in, long n_in, int sr_in,
//                           int sr_out, float* out, long n_out);
//   void wt_free(float* p);
//   const char* wt_last_error(void);

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/opt.h>
}

#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

thread_local std::string g_last_error;

void set_error(const std::string& msg) { g_last_error = msg; }

// Convert one decoded frame to mono float32 (channel mean), appending to out.
// Handles the common packed/planar integer and float sample formats, i.e.
// the same lattice the reference matches on symphonia buffer types
// (U8/S16/S32/F32..., ref src/main.rs:241-307).
bool append_frame_mono(const AVFrame* f, std::vector<float>& out) {
  const int ch = f->ch_layout.nb_channels;
  const int n = f->nb_samples;
  if (ch <= 0 || n <= 0) return true;
  const auto fmt = static_cast<AVSampleFormat>(f->format);
  const float inv_ch = 1.0f / static_cast<float>(ch);

  auto accumulate = [&](auto sample_at, float scale, float offset) {
    for (int i = 0; i < n; ++i) {
      float acc = 0.0f;
      for (int c = 0; c < ch; ++c) {
        acc += (static_cast<float>(sample_at(c, i)) - offset) * scale;
      }
      out.push_back(acc * inv_ch);
    }
  };

  switch (fmt) {
    case AV_SAMPLE_FMT_FLT: {
      const float* d = reinterpret_cast<const float*>(f->data[0]);
      accumulate([&](int c, int i) { return d[i * ch + c]; }, 1.0f, 0.0f);
      return true;
    }
    case AV_SAMPLE_FMT_FLTP:
      accumulate([&](int c, int i) {
        return reinterpret_cast<const float*>(f->data[c])[i];
      }, 1.0f, 0.0f);
      return true;
    case AV_SAMPLE_FMT_DBL: {
      const double* d = reinterpret_cast<const double*>(f->data[0]);
      accumulate([&](int c, int i) { return d[i * ch + c]; }, 1.0f, 0.0f);
      return true;
    }
    case AV_SAMPLE_FMT_DBLP:
      accumulate([&](int c, int i) {
        return reinterpret_cast<const double*>(f->data[c])[i];
      }, 1.0f, 0.0f);
      return true;
    case AV_SAMPLE_FMT_S16: {
      const int16_t* d = reinterpret_cast<const int16_t*>(f->data[0]);
      accumulate([&](int c, int i) { return d[i * ch + c]; },
                 1.0f / 32768.0f, 0.0f);
      return true;
    }
    case AV_SAMPLE_FMT_S16P:
      accumulate([&](int c, int i) {
        return reinterpret_cast<const int16_t*>(f->data[c])[i];
      }, 1.0f / 32768.0f, 0.0f);
      return true;
    case AV_SAMPLE_FMT_S32: {
      const int32_t* d = reinterpret_cast<const int32_t*>(f->data[0]);
      accumulate([&](int c, int i) { return d[i * ch + c]; },
                 1.0f / 2147483648.0f, 0.0f);
      return true;
    }
    case AV_SAMPLE_FMT_S32P:
      accumulate([&](int c, int i) {
        return reinterpret_cast<const int32_t*>(f->data[c])[i];
      }, 1.0f / 2147483648.0f, 0.0f);
      return true;
    case AV_SAMPLE_FMT_U8: {
      const uint8_t* d = f->data[0];
      accumulate([&](int c, int i) { return d[i * ch + c]; },
                 1.0f / 128.0f, 128.0f);
      return true;
    }
    case AV_SAMPLE_FMT_U8P:
      accumulate([&](int c, int i) { return f->data[c][i]; },
                 1.0f / 128.0f, 128.0f);
      return true;
    default:
      set_error(std::string("unsupported sample format: ") +
                av_get_sample_fmt_name(fmt));
      return false;
  }
}

}  // namespace

extern "C" {

const char* wt_last_error(void) { return g_last_error.c_str(); }

void wt_free(float* p) { free(p); }

// Reference-exact linear resampler (ref src/main.rs:207-226; the numerical
// contract is audio/resample.py): output length = round(n * ratio) half
// away from zero, sample positions t = i / ratio in f64, 2-tap lerp with
// FLOAT32 blend weights, zero for out-of-bounds taps.  Compiled with
// -ffp-contract=off (audio_native.CXXFLAGS) so the lerp rounds exactly like the NumPy
// float32 expression — the Python fallback and this path are bit-equal.
long wt_resample_len(long n_in, int sr_in, int sr_out) {
  const double ratio = static_cast<double>(sr_out) / sr_in;
  return static_cast<long>(std::floor(n_in * ratio + 0.5));
}

void wt_resample_linear(const float* in, long n_in, int sr_in, int sr_out,
                        float* out, long n_out) {
  const double ratio = static_cast<double>(sr_out) / sr_in;
  for (long i = 0; i < n_out; ++i) {
    const double t = i / ratio;
    const long i0 = static_cast<long>(std::floor(t));
    const float a = static_cast<float>(t - static_cast<double>(i0));
    const float s0 = (i0 >= 0 && i0 < n_in) ? in[i0] : 0.0f;
    const float s1 = (i0 + 1 >= 0 && i0 + 1 < n_in) ? in[i0 + 1] : 0.0f;
    out[i] = (1.0f - a) * s0 + a * s1;
  }
}

int wt_decode_mono(const char* path, float** out_samples, long* out_n,
                   int* out_sr) {
  g_last_error.clear();
  *out_samples = nullptr;
  *out_n = 0;
  *out_sr = 0;

  AVFormatContext* fmt_ctx = nullptr;
  if (avformat_open_input(&fmt_ctx, path, nullptr, nullptr) < 0) {
    set_error(std::string("cannot open: ") + path);
    return 1;
  }
  if (avformat_find_stream_info(fmt_ctx, nullptr) < 0) {
    avformat_close_input(&fmt_ctx);
    set_error("cannot read stream info");
    return 2;
  }

  const AVCodec* codec = nullptr;
  int stream_idx =
      av_find_best_stream(fmt_ctx, AVMEDIA_TYPE_AUDIO, -1, -1, &codec, 0);
  if (stream_idx < 0 || codec == nullptr) {
    avformat_close_input(&fmt_ctx);
    set_error("no audio stream / codec");
    return 3;
  }
  AVStream* stream = fmt_ctx->streams[stream_idx];

  AVCodecContext* dec = avcodec_alloc_context3(codec);
  if (dec == nullptr ||
      avcodec_parameters_to_context(dec, stream->codecpar) < 0 ||
      avcodec_open2(dec, codec, nullptr) < 0) {
    if (dec != nullptr) avcodec_free_context(&dec);
    avformat_close_input(&fmt_ctx);
    set_error("cannot open decoder");
    return 4;
  }

  std::vector<float> samples;
  if (stream->duration > 0 && stream->time_base.den > 0) {
    const double secs = static_cast<double>(stream->duration) *
                        stream->time_base.num / stream->time_base.den;
    if (secs > 0 && secs < 24 * 3600.0) {
      samples.reserve(static_cast<size_t>(secs * dec->sample_rate) + 4096);
    }
  }

  AVPacket* pkt = av_packet_alloc();
  AVFrame* frame = av_frame_alloc();
  int rc = 0;

  auto drain = [&]() -> bool {
    while (true) {
      int r = avcodec_receive_frame(dec, frame);
      if (r == AVERROR(EAGAIN) || r == AVERROR_EOF) return true;
      if (r < 0) {
        set_error("decode error");
        return false;
      }
      if (!append_frame_mono(frame, samples)) return false;
      av_frame_unref(frame);
    }
  };

  while (av_read_frame(fmt_ctx, pkt) >= 0) {
    if (pkt->stream_index == stream_idx) {
      if (avcodec_send_packet(dec, pkt) == 0) {
        if (!drain()) {
          rc = 5;
          av_packet_unref(pkt);
          break;
        }
      }
    }
    av_packet_unref(pkt);
  }
  if (rc == 0) {
    avcodec_send_packet(dec, nullptr);  // flush
    if (!drain()) rc = 5;
  }

  const int sr = dec->sample_rate;
  av_frame_free(&frame);
  av_packet_free(&pkt);
  avcodec_free_context(&dec);
  avformat_close_input(&fmt_ctx);

  if (rc != 0) return rc;
  if (samples.empty()) {
    set_error("no samples decoded");
    return 6;
  }

  float* buf = static_cast<float*>(malloc(samples.size() * sizeof(float)));
  if (buf == nullptr) {
    set_error("out of memory");
    return 7;
  }
  std::memcpy(buf, samples.data(), samples.size() * sizeof(float));
  *out_samples = buf;
  *out_n = static_cast<long>(samples.size());
  *out_sr = sr;
  return 0;
}

}  // extern "C"
