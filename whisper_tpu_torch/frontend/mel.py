"""PyTorch log-mel front end (port of ``whisper_tpu.frontend.mel``).

The numerical contract is :mod:`whisper_tpu_torch.frontend.golden`'s:
framing by three strided row views (hop 160 divides the signal into rows;
a 400-sample window spans 2.5 rows), the 400-point real DFT as two fp32
matmuls against window-folded cos/sin matrices [400, 201], the power
spectrum, the mel projection, log10(max(., 1e-10)), and the global
max / clamp / affine normalization with invalid frames excluded and
zeroed.  The matmuls run in full fp32: the session turns TF32 off
(``ops.common.disable_tf32``).

Only the int16 and float32 wire encodings are ported; the delta-coded,
mu-law and bit-packed ones exist for the JAX package's remote-device
tunnel (ROADMAP "Not to port").
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from whisper_tpu_torch.frontend import golden
from whisper_tpu_torch.frontend.golden import HOP, N_FFT, N_FREQ, WIN


@functools.lru_cache(maxsize=None)
def dft_matrices() -> tuple[np.ndarray, np.ndarray]:
    """Constant real-DFT matrices (cos, -sin), each [N_FFT, N_FREQ] float32,
    built in float64 then cast so the entries are correctly rounded."""
    n = np.arange(N_FFT, dtype=np.float64)[:, None]
    k = np.arange(N_FREQ, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / N_FFT
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _constants(n_mels: int):
    """Host NumPy constants: window-folded DFT matrices and fb.T."""
    cos_m, sin_m = dft_matrices()
    window = golden.hann_window_periodic(WIN)
    fb = golden.build_mel_filterbank(n_mels=n_mels)  # [n_mels, 201]
    return (cos_m * window[:, None], sin_m * window[:, None],
            np.ascontiguousarray(fb.T))


_DEVICE_CONSTANTS: dict = {}   # (device, n_mels) -> _constants on it


def device_constants(device, n_mels: int) -> tuple:
    """``_constants`` as tensors on ``device``, uploaded once per (device,
    n_mels): a copy from the host cannot sit inside a CUDA graph, and a
    bucket program's mel runs in one."""
    key = (torch.device(device), n_mels)
    if key not in _DEVICE_CONSTANTS:
        _DEVICE_CONSTANTS[key] = tuple(torch.from_numpy(c).to(device)
                                       for c in _constants(n_mels))
    return _DEVICE_CONSTANTS[key]


def decode_transfer(audio: torch.Tensor) -> torch.Tensor:
    """Wire decode: int16 PCM -> float32 (x / 32767); float32 passes."""
    if audio.dtype == torch.int16:
        return audio.float() * (1.0 / 32767.0)
    if audio.dtype == torch.float32:
        return audio
    raise NotImplementedError(
        f"audio transfer dtype {audio.dtype}: the port carries only the "
        "int16 and float32 encodings (ROADMAP 'Not to port')")


def frame_signal(padded: torch.Tensor, n_frames: int) -> torch.Tensor:
    """[n_frames, WIN] frames with hop HOP: frame f = rows f, f+1 and the
    first 80 samples of row f+2 of the [*, 160] reshape."""
    need = (n_frames + 2) * HOP
    if padded.shape[0] < need:
        padded = torch.nn.functional.pad(padded, (0, need - padded.shape[0]))
    rows = padded[:need].reshape(n_frames + 2, HOP)
    return torch.cat([rows[:n_frames], rows[1:n_frames + 1],
                      rows[2:n_frames + 2, :WIN - 2 * HOP]], dim=-1)


def _log_spec_raw(padded_audio: torch.Tensor, n_mels: int,
                  n_frames: int) -> torch.Tensor:
    """Framing + windowed DFT matmuls + mel projection + log10: returns
    log_spec [n_frames, n_mels] fp32, un-clamped and un-normalized."""
    cosw, sinw, fb_t = device_constants(padded_audio.device, n_mels)
    frames = frame_signal(decode_transfer(padded_audio), n_frames)
    re = torch.matmul(frames, cosw)
    im = torch.matmul(frames, sinw)
    power = re * re + im * im                          # [n_frames, 201]
    mel = torch.matmul(power, fb_t)
    return torch.log10(torch.clamp_min(mel, 1e-10))


def log_spec_slab(padded_slab: torch.Tensor, valid_frames: int,
                  n_mels: int, n_frames: int):
    """Unnormalized log-spec of one frame slab and its masked max.

    Building block of the streamed front end (runtime/session.py
    compute_mel_streamed): frame f is a pure function of padded samples
    [160f, 160f+400), so slab log-specs concatenated equal the whole-file
    log-spec, and the global max is the max of the slab maxes.
    Returns (log_spec [n_mels, n_frames] fp32 raw, vmax 0-d fp32)."""
    log_spec = _log_spec_raw(padded_slab, n_mels, n_frames)
    valid = (torch.arange(n_frames, device=log_spec.device)
             < valid_frames)[:, None]
    vmax = torch.where(valid, log_spec, -torch.inf).amax()
    return log_spec.T, vmax


def normalize(log_spec: torch.Tensor, gmax: torch.Tensor,
              valid_frames: int) -> torch.Tensor:
    """Clamp at gmax - 8, then (x + 4) / 4; frames >= valid_frames -> 0.
    log_spec: [n_mels, n_frames]."""
    valid = (torch.arange(log_spec.shape[1], device=log_spec.device)
             < valid_frames)[None, :]
    out = (torch.maximum(log_spec, gmax - 8.0) + 4.0) / 4.0
    return torch.where(valid, out, 0.0)


def log_mel_torch(padded_audio: torch.Tensor, valid_frames: int,
                  n_mels: int = 80, n_frames: int | None = None):
    """One-shot log-mel [n_mels, n_frames] from reflect-padded audio
    (port of ``log_mel_jax``); frames >= valid_frames are excluded from the
    global max and zeroed."""
    if n_frames is None:
        raise ValueError("n_frames is required")
    log_spec, vmax = log_spec_slab(padded_audio, valid_frames, n_mels,
                                   n_frames)
    return normalize(log_spec, vmax, valid_frames)


def log_mel_batch(padded_audio: torch.Tensor, valid_frames: torch.Tensor,
                  n_mels: int = 80, n_frames: int = 3000) -> torch.Tensor:
    """``log_mel_torch`` of every row of ``padded_audio`` [B, L] (float32
    or a wire encoding, L >= (n_frames + 2) * HOP) at once, as the JAX short
    program vmaps ``log_mel_jax``: [B, n_mels, n_frames], row r normalized
    over its own ``valid_frames[r]`` frames (an integer [B] tensor on the
    audio's device, read there).  One framing, the DFT and mel products
    over every row's frames, one masked max a row."""
    audio = decode_transfer(padded_audio)
    b = audio.shape[0]
    cosw, sinw, fb_t = device_constants(audio.device, n_mels)
    rows = audio[:, :(n_frames + 2) * HOP].reshape(b, n_frames + 2, HOP)
    frames = torch.cat([rows[:, :n_frames], rows[:, 1:n_frames + 1],
                        rows[:, 2:n_frames + 2, :WIN - 2 * HOP]], dim=-1)
    re = torch.matmul(frames, cosw)
    im = torch.matmul(frames, sinw)
    power = re * re + im * im                          # [B, n_frames, 201]
    log_spec = torch.log10(torch.clamp_min(torch.matmul(power, fb_t), 1e-10))
    valid = (torch.arange(n_frames, device=audio.device)[None, :]
             < valid_frames[:, None])                  # [B, n_frames]
    vmax = torch.where(valid[:, :, None], log_spec, -torch.inf).amax(
        dim=(1, 2))
    out = (torch.maximum(log_spec.transpose(1, 2), vmax[:, None, None] - 8.0)
           + 4.0) / 4.0
    return torch.where(valid[:, None, :], out, 0.0)
