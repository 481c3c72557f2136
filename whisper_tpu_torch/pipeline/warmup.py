"""Pre-warming (port of ``whisper_tpu.pipeline.warmup``): run zero-audio
transcriptions through every (mel-bucket, batch-bucket) combination a set
of file durations will hit, before the measured per-file loop.

On the TPU each new shape is a full XLA compile.  The port compiles
nothing per shape, but the first run of a shape still pays the kernel
library's build and load, cuBLAS's heuristics, the caching allocator's
growth and, on a card, the capture of the greedy loop's CUDA graph for
the shape's key (``runtime.generate``), so the CLI warms the same shapes
the JAX CLI does and no timed run captures the keys they cover.  The
fallback ladder's re-decodes run buckets of the chunks that failed, whose
sizes depend on the data: a bucket size first met there captures then.
"""

from __future__ import annotations

from typing import Iterable, Set, Tuple

import numpy as np

from whisper_tpu_torch.frontend.golden import num_frames
from whisper_tpu_torch.pipeline.chunk import chunk_starts, mel_frame_bucket
from whisper_tpu_torch.pipeline.longform import (
    SAMPLE_RATE,
    transcribe_longform,
)


def _batch_buckets(n_chunks: int, cap: int) -> frozenset:
    """The batch buckets a C-chunk file runs (session._bucket_batch over
    the sub-batch loop of transcribe_from_mel)."""
    buckets = set()
    start = 0
    while start < n_chunks:
        n = min(cap, n_chunks - start)
        b = 1
        while b < n and b < cap:
            b <<= 1
        buckets.add(min(b, cap))
        start += n
    return frozenset(buckets)


def _shape_key(duration_s: float, chunk_length_s: float, overlap_s: float,
               max_batch: int) -> Tuple[int, frozenset]:
    """(mel frame bucket, batch bucket set) of a file of this duration."""
    n = int(round(duration_s * SAMPLE_RATE))
    chunk_len = int(round(chunk_length_s * SAMPLE_RATE))
    step = max(chunk_len - int(round(overlap_s * SAMPLE_RATE)), 1)
    n_chunks = len(chunk_starts(max(n, 1), chunk_len, step))
    return (mel_frame_bucket(num_frames(max(n, 1))),
            _batch_buckets(n_chunks, max_batch))


def warm_buckets(session, durations_s: Iterable[float], *, language: str,
                 task: str, max_new_tokens: int, chunk_length_s: float,
                 overlap_s: float, tokenizer=None, timestamps: bool = False,
                 gen_cfg=None, num_beams: int = 1,
                 length_penalty: float = 1.0, initial_prompt_ids=None,
                 speculative: bool = False, draft_k: int = 4) -> int:
    """Transcribe synthetic zero audio once per distinct shape (capturing
    each bucket's greedy loop on a card); returns the number of shapes
    warmed.  The ranks of a mesh, given the same durations, warm and
    capture the same keys in the same order, their warm-ups' collectives
    in lockstep."""
    seen: Set[Tuple[int, frozenset]] = set()
    durs = []
    for d in durations_s:
        key = _shape_key(d, chunk_length_s, overlap_s, session.cfg.max_batch)
        if key not in seen:
            seen.add(key)
            durs.append(d)
    for d in durs:
        audio = np.zeros(max(int(round(d * SAMPLE_RATE)), 1), dtype=np.float32)
        transcribe_longform(
            session, audio, language, task, max_new_tokens, chunk_length_s,
            overlap_s, tokenizer, timestamps, gen_cfg, num_beams,
            length_penalty, initial_prompt_ids=initial_prompt_ids,
            speculative=speculative, draft_k=draft_k)
    return len(durs)
