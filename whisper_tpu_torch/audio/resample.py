"""Linear-interpolation resampler with the reference's exact math
(ref src/main.rs:207-226; port of ``whisper_tpu.audio.resample``): output
length = round(len * ratio) (half away from zero), sample positions
t = i / ratio in f64, 2-tap lerp with float32 blend weights, zero for
out-of-bounds taps.

Transcript parity with the reference requires this exact resampler
(SURVEY.md §2.1 N6).  Where the native library loads, the C++
``wt_resample_linear`` (``native/audio_decode.cc``) runs instead; it is
bit-equal to the NumPy expression (tests/test_torch_native_audio.py), as
in the JAX package.  ``ulaw_encode`` is the ulaw8 upload wire's host
encoder (its device decode: ``frontend.mel.decode_transfer``).
"""

from __future__ import annotations

import numpy as np


def ulaw_encode(x: np.ndarray, mu: float = 255.0) -> np.ndarray:
    """mu-law companding to uint8 (G.711-style): a quarter of the float32
    upload's bytes at about 37 dB SNR."""
    x = np.clip(np.asarray(x, dtype=np.float32), -1.0, 1.0)
    y = np.sign(x) * np.log1p(mu * np.abs(x)) / np.log1p(mu)
    return np.round((y + 1.0) * 127.5).astype(np.uint8)


def resample_linear(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Resample ``x`` from ``sr_in`` to ``sr_out`` Hz (a copy when equal)."""
    x = np.asarray(x, dtype=np.float32)
    if sr_in == sr_out:
        return x.copy()
    # Only a library that does not load takes NumPy; an error of a loaded
    # resampler propagates, so a defect is not masked.
    from whisper_tpu_torch.native import audio_native

    if audio_native.available():
        return audio_native.resample_linear(x, sr_in, sr_out)
    return _resample_linear_numpy(x, sr_in, sr_out)


def _resample_linear_numpy(x: np.ndarray, sr_in: int,
                           sr_out: int) -> np.ndarray:
    ratio = float(sr_out) / float(sr_in)           # f64, like the reference
    n_out = int(np.floor(len(x) * ratio + 0.5))    # Rust round(): half away from zero

    t = np.arange(n_out, dtype=np.float64) / ratio
    i0 = np.floor(t).astype(np.int64)
    a = (t - i0).astype(np.float32)                # blend weight cast to f32

    def tap(idx):
        valid = (idx >= 0) & (idx < len(x))
        return np.where(valid, x[np.clip(idx, 0, len(x) - 1)], np.float32(0.0))

    s0 = tap(i0)
    s1 = tap(i0 + 1)
    return ((np.float32(1.0) - a) * s0 + a * s1).astype(np.float32)
