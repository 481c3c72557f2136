"""Long-form chunking: 30 s windows with overlap over a whole-file mel.

Reproduces the reference's chunk geometry exactly
(ref src/main.rs:859-882): chunk starts every ``chunk_len - overlap``
samples; the whole-file log-mel is computed once and frame-sliced per chunk
(``mel_full[:, pos/160 : pos/160+3000]``, zero-padded to 3000 frames,
ref :899-905).  The chunk set becomes a batch dimension (SURVEY.md §5.7)
instead of the reference's rayon thread pool.

A copy of ``CHUNK_FRAMES``, ``chunk_starts`` and ``mel_frame_bucket`` from
``whisper_tpu.pipeline.chunk``, whose package ``__init__`` imports jax (the
chunks are sliced on the device, in ``runtime/session.py``).
"""

from __future__ import annotations

from typing import List


CHUNK_FRAMES = 3000  # 30 s of mel frames: the encoder's fixed context


def chunk_starts(n_samples: int, chunk_len: int, step: int) -> List[int]:
    """Chunk start sample positions (exact reference loop, src/main.rs:875-882)."""
    starts: List[int] = []
    pos = 0
    while pos < n_samples:
        end = min(pos + chunk_len, n_samples)
        starts.append(pos)
        if end == n_samples:
            break
        pos += step
    return starts


def mel_frame_bucket(n_frames: int) -> int:
    """Static mel-frame capacity: CHUNK_FRAMES * next_pow2 — bounds compiled
    front-end variants to O(log audio_len) while wasting < 2x frames."""
    mult = 1
    while CHUNK_FRAMES * mult < n_frames:
        mult <<= 1
    return CHUNK_FRAMES * mult

