"""A FLAC writer of verbatim subframes, in pure Python: 16-bit PCM into a
file that libav's FLAC decoder reads back sample for sample (the native
decoder's tests and ``chip_smoke.py`` write their .flac inputs with it;
nothing is downloaded).

The file is the marker ``fLaC``, a STREAMINFO block (the MD5 left
unknown), then fixed blocks of ``block`` samples (the last one shorter):
a frame header with its CRC-8, one VERBATIM subframe a channel (channels
independent) and the frame's CRC-16.  No compression: the point is a real
FLAC container and codec with known samples.
"""

from __future__ import annotations

import struct

import numpy as np


def _crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07) & 0xFF if crc & 0x80 else (crc << 1) & 0xFF
    return crc


def _crc16(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = (((crc << 1) ^ 0x8005) & 0xFFFF if crc & 0x8000
                   else (crc << 1) & 0xFFFF)
    return crc


def _frame_number(n: int) -> bytes:
    """FLAC's UTF-8-like coding of a frame number (below 2^16)."""
    if n < 0x80:
        return bytes([n])
    if n < 0x800:
        return bytes([0xC0 | (n >> 6), 0x80 | (n & 0x3F)])
    return bytes([0xE0 | (n >> 12), 0x80 | ((n >> 6) & 0x3F),
                  0x80 | (n & 0x3F)])


def write_flac(path, pcm16, sr: int, block: int = 1152) -> None:
    """Write int16 samples ``pcm16`` ([n] or [n, channels], up to 8
    channels) at ``sr`` Hz to ``path`` as FLAC."""
    pcm16 = np.asarray(pcm16, dtype=np.int16)
    if pcm16.ndim == 1:
        pcm16 = pcm16[:, None]
    n, ch = pcm16.shape
    if not 1 <= ch <= 8 or n // block >= 1 << 16:
        raise ValueError(f"{ch} channels / {n} samples: out of range")
    info = struct.pack(">HH", block, block) + b"\0" * 6   # frame sizes unknown
    packed = (sr << 44) | ((ch - 1) << 41) | (15 << 36) | n
    info += packed.to_bytes(8, "big") + b"\0" * 16       # MD5 unknown
    out = bytearray(b"fLaC")
    out += bytes([0x80]) + len(info).to_bytes(3, "big") + info  # last block
    for k, s0 in enumerate(range(0, n, block)):
        blk = pcm16[s0:s0 + block]
        hdr = bytearray([0xFF, 0xF8])            # sync code, fixed blocks
        hdr.append(0b0111 << 4)                  # size: 16 bits at the end;
        #                                          rate: from STREAMINFO
        hdr.append(((ch - 1) << 4) | (0b100 << 1))   # independent, 16 bits
        hdr += _frame_number(k)
        hdr += struct.pack(">H", len(blk) - 1)
        hdr.append(_crc8(bytes(hdr)))
        frame = bytearray(hdr)
        for c in range(ch):
            frame.append(0b00000010)             # VERBATIM, no wasted bits
            frame += blk[:, c].astype(">i2").tobytes()
        frame += struct.pack(">H", _crc16(bytes(frame)))
        out += frame
    with open(path, "wb") as f:
        f.write(bytes(out))
