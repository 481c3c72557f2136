"""Pure-NumPy RIFF/WAVE reader (port of ``whisper_tpu.audio.wav``).

Supports PCM u8 / s16 / s24 / s32 and IEEE float32/float64, plus
WAVE_FORMAT_EXTENSIBLE wrappers.  Sample normalization matches the
reference's symphonia path (ref src/main.rs:241-307): u8 -> (x-128)/128,
s16 -> x/32768, etc., with channel-mean mono downmix.

A copy of the JAX package's reader: that package's ``__init__`` can reach
jax, and this package never imports it.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

_PCM = 1
_IEEE_FLOAT = 3
_EXTENSIBLE = 0xFFFE


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Returns (mono float32 samples in [-1, 1], sample_rate)."""
    with open(path, "rb") as f:
        data = f.read()

    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"Not a RIFF/WAVE file: {path}")

    fmt = None
    payload = None
    off = 12
    while off + 8 <= len(data):
        cid = data[off : off + 4]
        size = struct.unpack_from("<I", data, off + 4)[0]
        body = data[off + 8 : off + 8 + size]
        if cid == b"fmt ":
            fmt = body
        elif cid == b"data":
            payload = body
        off += 8 + size + (size & 1)  # chunks are word-aligned

    if fmt is None or payload is None:
        raise ValueError(f"WAV missing fmt/data chunk: {path}")

    audio_format, channels, sample_rate, _, _, bits = struct.unpack_from(
        "<HHIIHH", fmt, 0
    )
    if audio_format == _EXTENSIBLE:
        if len(fmt) < 40:
            raise ValueError("Malformed WAVE_FORMAT_EXTENSIBLE fmt chunk")
        audio_format = struct.unpack_from("<H", fmt, 24)[0]

    if channels <= 0:
        raise ValueError("WAV has zero channels")

    def _whole(buf: bytes, size: int) -> bytes:
        # Truncated/streaming files often declare a data size past EOF
        # (or 0xFFFFFFFF); keep whole samples instead of letting
        # np.frombuffer raise on a ragged tail (the 24-bit branch always
        # truncated this way — now every branch does).
        return buf[: (len(buf) // size) * size]

    if audio_format == _IEEE_FLOAT:
        dtype = {32: "<f4", 64: "<f8"}.get(bits)
        if dtype is None:
            raise ValueError(f"Unsupported float bit depth: {bits}")
        x = np.frombuffer(_whole(payload, bits // 8),
                          dtype=dtype).astype(np.float32)
    elif audio_format == _PCM:
        if bits == 8:
            x = (np.frombuffer(payload, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 16:
            x = np.frombuffer(_whole(payload, 2),
                              dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 24:
            raw = np.frombuffer(payload, dtype=np.uint8)
            raw = raw[: (len(raw) // 3) * 3].reshape(-1, 3)
            vals = (
                raw[:, 0].astype(np.int32)
                | (raw[:, 1].astype(np.int32) << 8)
                | (raw[:, 2].astype(np.int32) << 16)
            )
            vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
            x = vals.astype(np.float32) / float(1 << 23)
        elif bits == 32:
            x = np.frombuffer(_whole(payload, 4),
                              dtype="<i4").astype(np.float32) / float(1 << 31)
        else:
            raise ValueError(f"Unsupported PCM bit depth: {bits}")
    else:
        raise ValueError(
            f"Unsupported WAV format tag {audio_format} (compressed audio "
            f"needs the native decoder, whisper_tpu_torch.native)"
        )

    n = (len(x) // channels) * channels
    x = x[:n].reshape(-1, channels)
    return x.mean(axis=1).astype(np.float32), int(sample_rate)
