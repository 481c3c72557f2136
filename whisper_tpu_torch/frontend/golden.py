"""Golden NumPy log-mel front end — THE numerical contract.

This is a host-side, dependency-free implementation of the Whisper log-mel-80
(or -128) spectrogram exactly as specified by the reference implementation
(`whisper_log_mel_80`, ref src/main.rs:407-509):

- sr=16000, n_fft=400, hop=160, win=400 periodic Hann (ref :323-330)
- reflect-pad n_fft/2=200 samples each side, matching
  ``torch.stft(center=True, pad_mode="reflect")``; for signals shorter than
  2 samples the reference right-pads with zeros instead (ref :418-435)
- frame count ``1 + (len_padded - win) // hop`` then drop the last frame,
  matching HF's ``stft[..., :-1]`` (ref :443-451)
- per frame: window -> real FFT -> power spectrum, 201 bins (ref :459-481)
- Slaney-scale triangular mel filterbank, fmin=0, fmax=8000, area
  normalization ``2/(f_right-f_left)`` (ref :332-405)
- mel energies clamped >= 1e-10, global log10, clamp at ``max - 8``,
  then ``(x + 4) / 4`` (ref :484-508)

A copy of ``whisper_tpu.frontend.golden``: that package's ``__init__``
imports jax, and this package never does.  The torch front end
(whisper_tpu_torch.frontend.mel) is validated against this module.
"""

from __future__ import annotations

import numpy as np

SAMPLE_RATE = 16_000
N_FFT = 400
HOP = 160
WIN = 400
N_FREQ = N_FFT // 2 + 1  # 201
FMIN = 0.0
FMAX = 8000.0


def hann_window_periodic(n: int = WIN) -> np.ndarray:
    """Periodic Hann window ``0.5 - 0.5*cos(2*pi*i/n)`` (ref src/main.rs:323-330)."""
    i = np.arange(n, dtype=np.float32)
    return (0.5 - 0.5 * np.cos(2.0 * np.float32(np.pi) * i / np.float32(n))).astype(
        np.float32
    )


def _hz_to_mel(hz: float) -> float:
    """Slaney mel scale: linear below 1 kHz, log above (ref src/main.rs:332-341)."""
    min_log_hz = 1000.0
    min_log_mel = 15.0
    logstep = 27.0 / np.log(6.4)
    if hz >= min_log_hz:
        return float(min_log_mel + np.log(hz / min_log_hz) * logstep)
    return float(3.0 * hz / 200.0)


def _mel_to_hz(mel: float) -> float:
    min_log_hz = 1000.0
    min_log_mel = 15.0
    logstep = np.log(6.4) / 27.0
    if mel >= min_log_mel:
        return float(min_log_hz * np.exp(logstep * (mel - min_log_mel)))
    return float(200.0 * mel / 3.0)


def build_mel_filterbank(
    sr: int = SAMPLE_RATE,
    n_fft: int = N_FFT,
    n_mels: int = 80,
    fmin: float = FMIN,
    fmax: float = FMAX,
) -> np.ndarray:
    """[n_mels, n_fft//2+1] Slaney triangular filterbank (ref src/main.rs:354-405)."""
    n_freq = n_fft // 2 + 1
    fmax = min(fmax, sr / 2.0)
    mel_min = _hz_to_mel(fmin)
    mel_max = _hz_to_mel(fmax)

    mel_points = [
        mel_min + (mel_max - mel_min) * i / (n_mels + 1) for i in range(n_mels + 2)
    ]
    freq_points = np.array([_mel_to_hz(m) for m in mel_points], dtype=np.float64)

    max_hz = sr / 2.0
    fft_freqs = np.arange(n_freq, dtype=np.float64) * max_hz / (n_freq - 1)

    f_left = freq_points[:-2][:, None]     # [n_mels, 1]
    f_center = freq_points[1:-1][:, None]
    f_right = freq_points[2:][:, None]

    lower = (fft_freqs[None, :] - f_left) / np.maximum(f_center - f_left, 1e-6)
    upper = (f_right - fft_freqs[None, :]) / np.maximum(f_right - f_center, 1e-6)
    fb = np.maximum(np.minimum(lower, upper), 0.0)

    # Slaney area normalization (ref src/main.rs:395-404)
    enorm = 2.0 / np.maximum(f_right - f_left, 1e-6)
    fb = fb * enorm
    return fb.astype(np.float32)


def reflect_pad(audio: np.ndarray, pad: int = N_FFT // 2) -> np.ndarray:
    """Reflect-pad `pad` samples each side with the reference's exact
    (clamped) index rule (ref src/main.rs:418-435).

    For signals with fewer than 2 samples, the reference instead appends
    ``2*pad`` trailing zeros.
    """
    audio = np.asarray(audio, dtype=np.float32)
    n = audio.shape[0]
    if n < 2 or pad == 0:
        return np.concatenate([audio, np.zeros(2 * pad, dtype=np.float32)])
    left_idx = np.minimum(pad - np.arange(pad), n - 1)           # pad, pad-1, .. 1
    right_idx = np.maximum(n - 2 - np.arange(pad), 0)            # n-2, n-3, ..
    return np.concatenate([audio[left_idx], audio, audio[right_idx]])


def num_frames(n_samples: int) -> int:
    """Number of output frames for an unpadded input of `n_samples`
    (ref src/main.rs:443-451: compute on padded signal, then drop last)."""
    padded = n_samples + 2 * (N_FFT // 2)
    n = 1 if padded < WIN else 1 + (padded - WIN) // HOP
    if n > 1:
        n -= 1
    return n


def log_mel_golden(audio: np.ndarray, n_mels: int = 80) -> np.ndarray:
    """Whisper log-mel spectrogram, shape [n_mels, n_frames] (ref src/main.rs:407-509)."""
    audio = np.asarray(audio, dtype=np.float32)
    if audio.size == 0:
        raise ValueError("Empty audio")

    padded = reflect_pad(audio)
    window = hann_window_periodic(WIN)
    fb = build_mel_filterbank(n_mels=n_mels)

    n_frames = num_frames(audio.shape[0])

    # Frame extraction: frame f covers padded[f*hop : f*hop + win].
    idx = np.arange(n_frames)[:, None] * HOP + np.arange(WIN)[None, :]
    frames = padded[idx] * window[None, :]           # [n_frames, 400]

    spec = np.fft.rfft(frames, n=N_FFT, axis=-1)     # [n_frames, 201]
    power = (spec.real ** 2 + spec.imag ** 2).astype(np.float32)

    mel = power @ fb.T                               # [n_frames, n_mels]
    mel = np.maximum(mel, np.float32(1e-10))

    log_spec = np.log10(mel)
    log_spec = np.maximum(log_spec, log_spec.max() - 8.0)
    log_spec = (log_spec + 4.0) / 4.0
    return log_spec.T.astype(np.float32)             # [n_mels, n_frames]
