"""Host-side encoders of the compact audio upload wires (port of
``whisper_tpu.utils.pcmpack``; numpy only, byte for byte the JAX package's).

- int16: PCM, round(clip(x) * 32767).
- dint16: first differences of the int16 PCM mod 2^16, as uint16 (per row,
  the first sample's predecessor 0); the device's modular cumsum gives the
  int16 back exactly.
- dint16p: the same differences zig-zagged and split into a high-byte and
  a low-byte plane ([..., hi | lo], 2L int8); exact as dint16.
- pcm12, pcm14: the top 12 or 14 bits of each sample, bit-packed MSB-first
  (2 samples in 3 bytes; 4 samples in 7 bytes).  25% and 12.5% fewer bytes
  than int16 on any link; lossy, with quantization noise near (pcm12, about
  -77 dB) or below (pcm14, about -89 dB) the log-mel's clamp floor of
  max - 80 dB.  A row's tail is zero-padded to a whole pack group, so its
  decode is up to 1 or 3 samples longer: frames are addressed by index, and
  the tail feeds only frames past the valid ones.

The device decodes are ``frontend.mel.decode_transfer``; the session
(``runtime.session._encode_transfer``) and the wire probe
(``utils.wireprobe``) share ``encode_wire``, so the probe measures the
payload the session ships.  ulaw8's encoder is ``audio.resample.ulaw_encode``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["encode_wire", "pack_pcm", "quantized_reference"]


def _to_pcm16(audio: np.ndarray) -> np.ndarray:
    if audio.dtype == np.int16:
        return audio
    x = np.clip(np.asarray(audio, dtype=np.float32), -1.0, 1.0)
    return np.round(x * 32767.0).astype(np.int16)


def encode_wire(audio: np.ndarray, mode: str) -> np.ndarray:
    """``audio`` (float32 in [-1, 1] or int16 PCM, [..., L]; deltas run
    along the last axis, so a batch's rows encode independently) in wire
    ``mode``: int16, dint16, dint16p, pcm12 or pcm14.  Any other mode
    raises ValueError."""
    if mode == "int16":
        return _to_pcm16(audio)
    if mode == "dint16":
        pcm = _to_pcm16(audio)
        return np.diff(pcm.astype(np.int32), axis=-1,
                       prepend=np.int32(0)).astype(np.uint16)
    if mode == "dint16p":
        pcm = _to_pcm16(audio)
        d = np.diff(pcm.astype(np.int32), axis=-1,
                    prepend=np.int32(0)).astype(np.int16)
        di = d.astype(np.int32)
        z = ((di << 1) ^ (di >> 15)) & 0xFFFF            # zig-zag
        hi = (z >> 8).astype(np.uint8)
        lo = (z & 0xFF).astype(np.uint8)
        return np.concatenate([hi, lo], axis=-1).view(np.int8)
    if mode in ("pcm12", "pcm14"):
        return pack_pcm(audio, mode)
    raise ValueError(f"unknown wire encoding {mode!r}")


def pack_pcm(audio: np.ndarray, mode: str) -> np.ndarray:
    """float32 [-1, 1] (or int16) samples [..., L] as packed uint8, the
    last axis zero-padded to a whole pack group (2 or 4 samples)."""
    if audio.dtype == np.int16:
        x = audio.astype(np.float32) / 32767.0
    else:
        x = np.clip(np.asarray(audio, dtype=np.float32), -1.0, 1.0)
    if mode == "pcm12":
        if x.shape[-1] % 2:
            x = np.concatenate(
                [x, np.zeros(x.shape[:-1] + (1,), x.dtype)], axis=-1)
        u = (np.round(x * 2047.0).astype(np.int32) + 2048).astype(np.uint32)
        u0, u1 = u[..., 0::2], u[..., 1::2]
        packed = np.stack(
            [u0 >> 4, ((u0 & 0xF) << 4) | (u1 >> 8), u1 & 0xFF], axis=-1)
    elif mode == "pcm14":
        pad = (-x.shape[-1]) % 4
        if pad:
            x = np.concatenate(
                [x, np.zeros(x.shape[:-1] + (pad,), x.dtype)], axis=-1)
        u = (np.round(x * 8191.0).astype(np.int32) + 8192).astype(np.uint32)
        u0, u1, u2, u3 = (u[..., k::4] for k in range(4))
        packed = np.stack(
            [u0 >> 6,
             ((u0 & 0x3F) << 2) | (u1 >> 12),
             (u1 >> 4) & 0xFF,
             ((u1 & 0xF) << 4) | (u2 >> 10),
             (u2 >> 2) & 0xFF,
             ((u2 & 0x3) << 6) | (u3 >> 8),
             u3 & 0xFF],
            axis=-1)
    else:
        raise ValueError(f"unknown pcm pack mode {mode!r}")
    return packed.reshape(*packed.shape[:-2], -1).astype(np.uint8)


def quantized_reference(audio: np.ndarray, mode: str) -> np.ndarray:
    """The float32 samples the pcm12 or pcm14 decode gives back: the
    quantizer's round trip without the packing, multiplied by the float32
    reciprocal as the decode multiplies, so it is bitwise the decode."""
    if audio.dtype == np.int16:
        x = audio.astype(np.float32) / 32767.0
    else:
        x = np.clip(np.asarray(audio, dtype=np.float32), -1.0, 1.0)
    scale = 2047.0 if mode == "pcm12" else 8191.0
    codes = np.round(x * scale).astype(np.float32)
    return (codes * np.float32(1.0 / scale)).astype(np.float32)
