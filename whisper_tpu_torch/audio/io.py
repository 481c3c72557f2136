"""Audio loading: decode -> mono downmix -> 16 kHz linear resample (port of
``whisper_tpu.audio.io``).

Equivalent of the reference's ``load_audio_16k_mono`` (ref
src/main.rs:228-316): returns (float32 samples at 16 kHz mono, 16000,
duration_seconds).  Two backends, chosen as the JAX package chooses:

- the native library (``native/audio_native``: libavformat/libavcodec,
  built from ``native/audio_decode.cc`` at first use) for wav, flac, mp3,
  aac and vorbis, whenever it loads;
- the NumPy RIFF/WAVE reader (``audio.wav``) otherwise, for .wav only; any
  other extension then raises, quoting why the library is missing.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from whisper_tpu_torch.audio.resample import resample_linear
from whisper_tpu_torch.audio.wav import read_wav

TARGET_SR = 16_000


def load_audio_16k_mono(path: str) -> Tuple[np.ndarray, int, float]:
    """Decode ``path``, downmix to mono (channel mean) and resample to
    16 kHz.  duration_s = len(resampled) / 16000, the reference's duration
    accounting (src/main.rs:310-315)."""
    from whisper_tpu_torch.native import audio_native

    if audio_native.available():
        mono, sr = audio_native.decode_mono(path)
    else:
        ext = os.path.splitext(path)[1].lower()
        if ext != ".wav":
            raise RuntimeError(
                f"{path}: the native audio decoder is not available "
                f"({audio_native.unavailable_reason()}); without it only "
                ".wav is read")
        mono, sr = read_wav(path)
    if sr != TARGET_SR:
        mono = resample_linear(mono, sr, TARGET_SR)
    duration = len(mono) / float(TARGET_SR)
    return mono.astype(np.float32, copy=False), TARGET_SR, duration
