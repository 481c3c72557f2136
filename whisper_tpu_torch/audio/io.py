"""Audio loading: decode -> mono downmix -> 16 kHz linear resample (port of
``whisper_tpu.audio.io``, WAV only).

Equivalent of the reference's ``load_audio_16k_mono`` (ref
src/main.rs:228-316): returns (float32 samples at 16 kHz mono, 16000,
duration_seconds).  The JAX package decodes flac/mp3 through its libav
based native library (``whisper_tpu/native``); that decoder is not ported
yet (ROADMAP queue 1 item 9), so any other extension raises.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from whisper_tpu_torch.audio.resample import resample_linear
from whisper_tpu_torch.audio.wav import read_wav

TARGET_SR = 16_000


def load_audio_16k_mono(path: str) -> Tuple[np.ndarray, int, float]:
    """Decode the WAV file ``path``, downmix to mono (channel mean) and
    resample to 16 kHz.  duration_s = len(resampled) / 16000, the
    reference's duration accounting (src/main.rs:310-315)."""
    ext = os.path.splitext(path)[1].lower()
    if ext != ".wav":
        raise NotImplementedError(
            f"{path}: only .wav is decoded; flac/mp3 need the native audio "
            "decoder, ROADMAP queue 1 item 9")
    mono, sr = read_wav(path)
    if sr != TARGET_SR:
        mono = resample_linear(mono, sr, TARGET_SR)
    duration = len(mono) / float(TARGET_SR)
    return mono.astype(np.float32, copy=False), TARGET_SR, duration
