"""PyTorch log-mel front end (port of ``whisper_tpu.frontend.mel``).

The numerical contract is :mod:`whisper_tpu_torch.frontend.golden`'s:
framing by three strided row views (hop 160 divides the signal into rows;
a 400-sample window spans 2.5 rows), the 400-point real DFT as two fp32
matmuls against window-folded cos/sin matrices [400, 201], the power
spectrum, the mel projection, log10(max(., 1e-10)), and the global
max / clamp / affine normalization with invalid frames excluded and
zeroed.  The matmuls run in full fp32: the session turns TF32 off
(``ops.common.disable_tf32``).

Every upload wire of the JAX package is decoded here on the device
(``decode_transfer``): float32, int16, dint16, dint16p, ulaw8, pcm12 and
pcm14 (the host encoders: ``utils.pcmpack``, ``audio.resample.ulaw_encode``).
The mel functions take the JAX functions' ``transfer`` tag, which names
pcm12 and pcm14 (they share uint8 with ulaw8); every other wire is told
by its dtype.
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


_DEVICE_CONSTANTS: dict = {}   # (device, n_mels) -> _constants on it;
                               # (device, "ulaw8") -> ulaw_table on it


def device_constants(device, n_mels: int) -> tuple:
    """``_constants`` as tensors on ``device``, uploaded once per (device,
    n_mels): a copy from the host cannot sit inside a CUDA graph, and a
    bucket program's mel runs in one."""
    key = (torch.device(device), n_mels)
    if key not in _DEVICE_CONSTANTS:
        _DEVICE_CONSTANTS[key] = tuple(torch.from_numpy(c).to(device)
                                       for c in _constants(n_mels))
    return _DEVICE_CONSTANTS[key]


# decode_transfer's factors: the float32 values JAX multiplies by (its
# Python constants, weakly typed to float32), as Python floats equal to
# them, so the product rounds once to JAX's float32 either way.
INT16_SCALE = float(np.float32(1.0 / 32767.0))
PCM12_SCALE = float(np.float32(1.0 / 2047.0))
PCM14_SCALE = float(np.float32(1.0 / 8191.0))
ULAW_STEP = np.float32(1.0 / 127.5)
ULAW_LOG1P_MU = np.float32(np.log1p(255.0))


@functools.lru_cache(maxsize=None)
def ulaw_table() -> np.ndarray:
    """The ulaw8 decode of each of the 256 codes, float32: the JAX
    formula sign(y) * expm1(|y| * log1p(255)) / 255, y = code / 127.5 - 1,
    with y and |y| * log1p(255) in float32 as JAX's source orders them, the
    rest in float64, rounded once: the same bits on every device.  (XLA's
    float32 expm1 on a CPU stands up to 3 ulp from that value.)"""
    y = np.arange(256, dtype=np.float32) * ULAW_STEP - np.float32(1.0)
    m = (np.abs(y) * ULAW_LOG1P_MU).astype(np.float64)
    return (np.sign(y) * (np.expm1(m) / 255.0)).astype(np.float32)


def _ulaw_decode(audio: torch.Tensor) -> torch.Tensor:
    """ulaw8 codes [..., L] as float32 by ``ulaw_table``, gathered on the
    codes' device (the table uploaded once a device, before any capture:
    a bucket program's warm-up runs its decode eagerly first)."""
    key = (audio.device, "ulaw8")
    if key not in _DEVICE_CONSTANTS:
        _DEVICE_CONSTANTS[key] = torch.from_numpy(ulaw_table()).to(
            audio.device)
    return _DEVICE_CONSTANTS[key][audio.long()]


def _delta_sum(d: torch.Tensor) -> torch.Tensor:
    """The int16 PCM of 16-bit deltas ``d`` (int32, [..., L]) as float32:
    the running sum mod 2^16 along the last axis, sign-extended (JAX's
    ``cumsum(uint32) & 0xFFFF``; torch sums integers in int64)."""
    acc = torch.cumsum(d, dim=-1) & 0xFFFF
    acc = torch.where(acc >= 32768, acc - 65536, acc)
    return acc.float() * INT16_SCALE


def _interleave(codes, audio: torch.Tensor) -> torch.Tensor:
    """A pack group's codes (each [..., groups]) in sample order [..., L']."""
    return torch.stack(codes, dim=-1).reshape(*audio.shape[:-1], -1)


def transfer_tag(mode: str) -> str:
    """``decode_transfer``'s tag for the upload wire ``mode``: pcm12 and
    pcm14 by name (their bytes are uint8, as ulaw8's), "auto" for the
    wires their dtype tells."""
    return mode if mode in ("pcm12", "pcm14") else "auto"


def decode_transfer(audio: torch.Tensor,
                    transfer: str = "auto") -> torch.Tensor:
    """An upload wire [..., L] as float32 samples on its device (port of
    the JAX ``decode_transfer``, bitwise it for the integer wires).

    ``transfer`` "pcm12" or "pcm14" names the bit-packed wires (uint8, as
    ulaw8): 2 samples from 3 bytes or 4 from 7, each code less its bias,
    times the float32 reciprocal of 2047 or 8191.  Any other tag
    dispatches by dtype: int16 PCM (x / 32767 as a product), uint16 dint16
    (read as its int16 bytes widened, then ``_delta_sum``), int8 dint16p
    (the byte planes joined, un-zig-zagged, ``_delta_sum``), uint8 ulaw8
    (``ulaw_table``), float32 as it is.  Any other dtype raises: nothing
    is decoded as float32 unless it is float32."""
    if transfer == "pcm12":
        b = audio.to(torch.int32) & 0xFF
        b0, b1, b2 = b[..., 0::3], b[..., 1::3], b[..., 2::3]
        u0 = (b0 << 4) | (b1 >> 4)
        u1 = ((b1 & 0xF) << 8) | b2
        return (_interleave((u0, u1), audio) - 2048).float() * PCM12_SCALE
    if transfer == "pcm14":
        b = audio.to(torch.int32) & 0xFF
        b0, b1, b2, b3, b4, b5, b6 = (b[..., k::7] for k in range(7))
        u0 = (b0 << 6) | (b1 >> 2)
        u1 = ((b1 & 0x3) << 12) | (b2 << 4) | (b3 >> 4)
        u2 = ((b3 & 0xF) << 10) | (b4 << 2) | (b5 >> 6)
        u3 = ((b5 & 0x3F) << 8) | b6
        return (_interleave((u0, u1, u2, u3), audio) - 8192).float() \
            * PCM14_SCALE
    if audio.dtype == torch.int16:
        return audio.float() * INT16_SCALE
    if audio.dtype == torch.uint16:
        # torch's uint16 has few operations: its bytes are read as int16
        # and widened to the unsigned value
        return _delta_sum(audio.view(torch.int16).to(torch.int32) & 0xFFFF)
    if audio.dtype == torch.int8:
        n = audio.shape[-1] // 2
        u = audio.to(torch.int32) & 0xFF
        z = (u[..., :n] << 8) | u[..., n:]            # zig-zag in [0, 65535]
        return _delta_sum((z >> 1) ^ -(z & 1))
    if audio.dtype == torch.uint8:
        return _ulaw_decode(audio)
    if audio.dtype == torch.float32:
        return audio
    raise ValueError(f"audio transfer dtype {audio.dtype} (tag "
                     f"{transfer!r}) is no upload wire")


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
                  n_frames: int, transfer: str = "auto") -> torch.Tensor:
    """Framing + windowed DFT matmuls + mel projection + log10: returns
    log_spec [n_frames, n_mels] fp32, un-clamped and un-normalized."""
    cosw, sinw, fb_t = device_constants(padded_audio.device, n_mels)
    frames = frame_signal(decode_transfer(padded_audio, transfer), n_frames)
    re = torch.matmul(frames, cosw)
    im = torch.matmul(frames, sinw)
    power = re * re + im * im                          # [n_frames, 201]
    mel = torch.matmul(power, fb_t)
    return torch.log10(torch.clamp_min(mel, 1e-10))


def log_spec_slab(padded_slab: torch.Tensor, valid_frames: int,
                  n_mels: int, n_frames: int, transfer: str = "auto"):
    """Unnormalized log-spec of one frame slab and its masked max.

    Building block of the streamed front end (runtime/session.py
    compute_mel_streamed): frame f is a pure function of padded samples
    [160f, 160f+400), so slab log-specs concatenated equal the whole-file
    log-spec, and the global max is the max of the slab maxes.
    Returns (log_spec [n_mels, n_frames] fp32 raw, vmax 0-d fp32)."""
    log_spec = _log_spec_raw(padded_slab, n_mels, n_frames, transfer)
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
                  n_mels: int = 80, n_frames: int | None = None,
                  transfer: str = "auto"):
    """One-shot log-mel [n_mels, n_frames] from reflect-padded audio in any
    upload wire (port of ``log_mel_jax``); frames >= valid_frames are
    excluded from the global max and zeroed."""
    if n_frames is None:
        raise ValueError("n_frames is required")
    log_spec, vmax = log_spec_slab(padded_audio, valid_frames, n_mels,
                                   n_frames, transfer)
    return normalize(log_spec, vmax, valid_frames)


def log_mel_batch(padded_audio: torch.Tensor, valid_frames: torch.Tensor,
                  n_mels: int = 80, n_frames: int = 3000,
                  transfer: str = "auto") -> torch.Tensor:
    """``log_mel_torch`` of every row of ``padded_audio`` [B, L] (in any
    upload wire; decoded, L >= (n_frames + 2) * HOP) at once, as the JAX short
    program vmaps ``log_mel_jax``: [B, n_mels, n_frames], row r normalized
    over its own ``valid_frames[r]`` frames (an integer [B] tensor on the
    audio's device, read there).  One framing, the DFT and mel products
    over every row's frames, one masked max a row."""
    audio = decode_transfer(padded_audio, transfer)
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
