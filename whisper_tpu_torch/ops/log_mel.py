"""B5: the one-shot log-mel front end (port of ``whisper_tpu.ops.pallas_mel``).

``log_mel`` replaces the JAX package's Pallas ``log_mel_pallas``
(``_mel_kernel``), with its signature and semantics: reflect-padded audio
(float32, or int16 PCM decoded as x / 32767) -> normalized log-mel
[n_mels, n_frames], frames >= ``valid_frames`` excluded from the global max
and zeroed.  The kernel computes the raw log10(max(mel, 1e-10)) of every
frame; the masked max, the clamp at max - 8 and (x + 4) / 4 stay outside it,
as in JAX, through ``frontend.mel.normalize``.

On a CUDA tensor it launches the hand-written Hopper kernel
``csrc/log_mel.cu`` (fp32 on the CUDA cores, not TF32 tensor cores: the
TPU kernel runs at Precision.HIGHEST); on a CPU tensor it takes
``log_mel_plain`` (the plain front end, ``frontend.mel.log_mel_torch``).
Any other device raises.

The CLI's prefetch thread computes the next file's mel from a second
Python thread, so the launch count is incremented under a lock.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from whisper_tpu_torch.frontend.mel import _constants, log_mel_torch, normalize
from whisper_tpu_torch.ops import kernels
from whisper_tpu_torch.ops.common import check_operand, route

INT16_SCALE = float(np.float32(1.0 / 32767.0))  # decode_transfer's factor

launches = 0  # kernel launches since the last reset (plain calls excluded)
_count_lock = threading.Lock()
_tables: dict = {}  # (device, n_mels) -> (cosw, sinw, fb_t) on the device


def log_mel_plain(padded_audio: torch.Tensor, valid_frames: int,
                  n_mels: int = 80, n_frames: int | None = None):
    """Reference version: the plain PyTorch front end (framing views, fp32
    DFT matmuls with TF32 off, mel matmul, log10, normalization)."""
    return log_mel_torch(padded_audio, valid_frames, n_mels=n_mels,
                         n_frames=n_frames)


def _device_tables(device: torch.device, n_mels: int):
    key = (str(device), n_mels)
    if key not in _tables:
        _tables[key] = tuple(torch.from_numpy(np.ascontiguousarray(c))
                             .to(device) for c in _constants(n_mels))
    return _tables[key]


def log_spec(padded_audio: torch.Tensor, n_mels: int,
             n_frames: int) -> torch.Tensor:
    """The kernel: raw log10(max(mel, 1e-10)) [n_frames, n_mels] fp32 of
    every frame of a CUDA tensor (frames past the signal read zeros)."""
    global launches
    if route(padded_audio) != "kernel":
        raise ValueError("log_spec launches the CUDA kernel; a CPU tensor "
                         "takes log_mel_plain")
    if padded_audio.dtype not in (torch.float32, torch.int16):
        raise NotImplementedError(
            f"audio transfer dtype {padded_audio.dtype}: the port carries "
            "only the int16 and float32 encodings (ROADMAP 'Not to port')")
    if n_frames < 1 or padded_audio.dim() != 1:
        raise ValueError(f"log_mel kernel: n_frames {n_frames}, audio "
                         f"shape {tuple(padded_audio.shape)}")
    dev = padded_audio.device
    check_operand("audio", padded_audio, padded_audio.dtype,
                  tuple(padded_audio.shape), dev)
    cosw, sinw, fb_t = _device_tables(dev, n_mels)
    out = torch.empty((n_frames, n_mels), dtype=torch.float32, device=dev)
    lib = kernels.library()
    kernels.check(lib.wt_log_mel(
        padded_audio.data_ptr(), int(padded_audio.dtype == torch.int16),
        padded_audio.shape[0], cosw.data_ptr(), sinw.data_ptr(),
        fb_t.data_ptr(), out.data_ptr(), n_frames, n_mels, INT16_SCALE,
        kernels.stream_ptr(dev)), "log_mel")
    with _count_lock:
        launches += 1
    return out


def log_mel(padded_audio: torch.Tensor, valid_frames: int, n_mels: int = 80,
            n_frames: int | None = None) -> torch.Tensor:
    """Log-mel [n_mels, n_frames] from reflect-padded audio (the signal
    needs (n_frames + 2) * 160 samples; fewer are zero-extended)."""
    if n_frames is None:
        raise ValueError("n_frames is required")
    if route(padded_audio) == "plain":
        return log_mel_plain(padded_audio, valid_frames, n_mels, n_frames)
    ls = log_spec(padded_audio, n_mels, n_frames)
    valid = (torch.arange(n_frames, device=ls.device) < valid_frames)[:, None]
    vmax = torch.where(valid, ls, -torch.inf).amax()
    return normalize(ls.T, vmax, valid_frames)
