"""B5: the one-shot log-mel front end (port of ``whisper_tpu.ops.pallas_mel``).

``log_mel`` replaces the JAX package's Pallas ``log_mel_pallas``
(``_mel_kernel``), with its signature and semantics: reflect-padded audio
in any upload wire (``transfer`` as ``frontend.mel.decode_transfer`` takes
it) -> normalized log-mel [n_mels, n_frames], frames >= ``valid_frames``
excluded from the global max and zeroed.  The kernels read float32, or
int16 PCM that they decode as x / 32767 in their own loads; every other
wire (dint16, dint16p, ulaw8, pcm12, pcm14) is decoded to float32 by
``decode_transfer``'s torch operations ahead of the launch, as the JAX
wrapper decodes with XLA operations ahead of its ``pallas_call`` (a running
sum over the whole signal does not fit the frame-blocked grid).  A pcm
wire's decode may be up to 3 samples longer than the padded audio; the
kernels address frames by index, so those samples feed no valid frame.

On a CUDA tensor it launches the hand-written Hopper kernels of
``csrc/log_mel.cu``, and for float32 and int16 puts nothing else on the
card: a spectrum kernel
(only the valid frames, each by a 200-point complex FFT of its 400 windowed
samples, the mel filters' bands of nonzero weights, log10) that writes the
raw log-mel in the [n_mels, n_frames] layout and each tile's max, and a
normalization kernel (the masked max, the clamp at max - 8, (x + 4) / 4)
launched as its programmatic dependent.  Everything is fp32 on the CUDA
cores (the TPU kernel runs at Precision.HIGHEST).  The FFT sums in another
order than the plain version's dense DFT: the two agree to 1e-4 on the
normalized mel.  On a CPU tensor it takes ``log_mel_plain`` (the plain
front end, ``frontend.mel.log_mel_torch``).  Any other device raises.

The host tables the kernels read are built here, once per device:
``fft_tables`` (the twiddles cos, sin of 2 pi k / 400 computed in float64
and rounded to float32, and the Hann window) and ``mel_bands`` (each
filter's contiguous band of nonzero bins and its weights).

The CLI's prefetch thread computes the next file's mel from a second
Python thread, so the launch count is incremented under a lock.
"""

from __future__ import annotations

import functools
import sys

import numpy as np
import torch

from whisper_tpu_torch.frontend import golden
from whisper_tpu_torch.frontend.mel import (
    INT16_SCALE,
    _constants,
    decode_transfer,
    frame_signal,
    log_mel_torch,
    normalize,
)
from whisper_tpu_torch.ops import kernels
from whisper_tpu_torch.ops.common import check_operand, count_launch, route

TILE_FRAMES = 8     # frames of one block of the spectrum kernel (its FT)
MAX_MELS = 128      # what the spectrum kernel's staging holds (its MAX_MELS)

launches = 0  # kernel launches since the last reset (plain calls excluded)
_tables: dict = {}  # (device, n_mels) -> the kernels' tables on the device


def log_mel_plain(padded_audio: torch.Tensor, valid_frames: int,
                  n_mels: int = 80, n_frames: int | None = None,
                  transfer: str = "auto"):
    """Reference version: the plain PyTorch front end (the wire decode,
    framing views, fp32 DFT matmuls with TF32 off, mel matmul, log10,
    normalization)."""
    return log_mel_torch(padded_audio, valid_frames, n_mels=n_mels,
                         n_frames=n_frames, transfer=transfer)


def log_mel_float64(padded_audio: torch.Tensor, valid_frames: int,
                    n_mels: int, n_frames: int,
                    transfer: str = "auto") -> torch.Tensor:
    """The plain version's function evaluated in float64 on its own fp32
    operands (the decoded samples and the window-folded DFT tables,
    widened), normalized and returned in float32: the yardstick for B5
    where the plain version's fp32 sums, whose order cuBLAS picks by the
    shape, stand farther than B5's 1e-4 from it."""
    dev = padded_audio.device
    cosw, sinw, fb_t = (torch.from_numpy(c).to(dev, torch.float64)
                        for c in _constants(n_mels))
    frames = frame_signal(decode_transfer(padded_audio, transfer),
                          n_frames).double()
    re, im = frames @ cosw, frames @ sinw
    ls = torch.log10(torch.clamp_min((re * re + im * im) @ fb_t, 1e-10)).T
    return normalize(ls, ls[:, :valid_frames].amax(), valid_frames).float()


@functools.lru_cache(maxsize=None)
def fft_tables() -> tuple[np.ndarray, np.ndarray]:
    """(twiddles [400, 2] float32: cos and sin of 2 pi k / 400 computed in
    float64 and rounded once; the periodic Hann window [400] float32)."""
    ang = (2.0 * np.pi * np.arange(golden.N_FFT, dtype=np.float64)
           / golden.N_FFT)
    tw = np.stack([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)
    return tw, golden.hann_window_periodic(golden.WIN).astype(np.float32)


@functools.lru_cache(maxsize=None)
def mel_bands(n_mels: int) -> tuple[np.ndarray, np.ndarray]:
    """Each mel filter's contiguous band of nonzero bins, from the filterbank
    the plain version multiplies: (bands [n_mels, 3] int32 of (first bin,
    count, offset into the weights), weights float32 of every band in
    turn).  Raises if a filter's nonzeros are not one contiguous band."""
    fb = _constants(n_mels)[2].T                     # [n_mels, 201]
    bands, weights = [], []
    offset = 0
    for m, row in enumerate(fb):
        nz = np.flatnonzero(row)
        first, count = (int(nz[0]), len(nz)) if len(nz) else (0, 0)
        if count and nz[-1] - first + 1 != count:
            raise ValueError(f"mel filter {m}: its nonzero bins are not "
                             "contiguous")
        bands.append((first, count, offset))
        weights.append(row[first:first + count])
        offset += count
    return (np.asarray(bands, np.int32),
            np.concatenate(weights).astype(np.float32))


def _device_tables(device: torch.device, n_mels: int):
    """(twiddles, window, bands, weights) on ``device``, built once."""
    key = (str(device), n_mels)
    if key not in _tables:
        _tables[key] = tuple(torch.from_numpy(np.ascontiguousarray(c))
                             .to(device)
                             for c in fft_tables() + mel_bands(n_mels))
    return _tables[key]


def _launch(padded_audio: torch.Tensor, n_mels: int, n_frames: int,
            valid_frames: int, normalize: bool) -> torch.Tensor:
    if route(padded_audio) != "kernel":
        raise ValueError("log_spec launches the CUDA kernel; a CPU tensor "
                         "takes log_mel_plain")
    if padded_audio.dtype not in (torch.float32, torch.int16):
        raise ValueError(f"log_mel kernel: audio dtype {padded_audio.dtype};"
                         " it reads float32 or int16 PCM")
    if n_frames < 1 or padded_audio.dim() != 1 or not 0 < n_mels <= MAX_MELS:
        raise ValueError(f"log_mel kernel: n_frames {n_frames}, n_mels "
                         f"{n_mels}, audio shape {tuple(padded_audio.shape)}")
    dev = padded_audio.device
    check_operand("audio", padded_audio, padded_audio.dtype,
                  tuple(padded_audio.shape), dev)
    valid = min(max(int(valid_frames), 0), n_frames)
    tw, win, bands, weights = _device_tables(dev, n_mels)
    out = torch.empty((n_mels, n_frames), dtype=torch.float32, device=dev)
    tile_max = torch.empty(-(-n_frames // TILE_FRAMES), dtype=torch.float32,
                           device=dev)
    lib = kernels.library()
    kernels.check(lib.wt_log_mel(
        padded_audio.data_ptr(), int(padded_audio.dtype == torch.int16),
        padded_audio.shape[0], tw.data_ptr(), win.data_ptr(),
        bands.data_ptr(), weights.data_ptr(), out.data_ptr(),
        tile_max.data_ptr(), n_frames, valid, n_mels, INT16_SCALE,
        int(normalize), kernels.stream_ptr(dev)), "log_mel")
    count_launch(sys.modules[__name__], launches=1)
    return out


def log_spec(padded_audio: torch.Tensor, n_mels: int, n_frames: int,
             valid_frames: int | None = None) -> torch.Tensor:
    """The spectrum kernel alone on a CUDA tensor: the raw
    log10(max(mel, 1e-10)) [n_mels, n_frames] fp32 of the frames <
    ``valid_frames`` (all by default; frames past the signal read zeros),
    0 for the others."""
    return _launch(padded_audio, n_mels, n_frames,
                   n_frames if valid_frames is None else valid_frames, False)


def log_mel(padded_audio: torch.Tensor, valid_frames: int, n_mels: int = 80,
            n_frames: int | None = None,
            transfer: str = "auto") -> torch.Tensor:
    """Log-mel [n_mels, n_frames] from reflect-padded audio in the wire
    ``transfer`` names or its dtype tells (the signal needs
    (n_frames + 2) * 160 samples; fewer are zero-extended)."""
    if n_frames is None:
        raise ValueError("n_frames is required")
    if route(padded_audio) == "plain":
        return log_mel_plain(padded_audio, valid_frames, n_mels, n_frames,
                             transfer)
    if transfer != "auto" or padded_audio.dtype not in (torch.float32,
                                                         torch.int16):
        padded_audio = decode_transfer(padded_audio, transfer)
    return _launch(padded_audio, n_mels, n_frames, valid_frames, True)
