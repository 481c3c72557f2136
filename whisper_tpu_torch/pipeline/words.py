"""Word-level timestamps by cross-attention DTW alignment (port of
``whisper_tpu.pipeline.words``: numpy on the host, beside one teacher-forced
pass on the device).

The openai-whisper / faster-whisper word-timing algorithm:

1. a teacher-forced decoder pass gives the cross-attention probabilities
   (``session.alignment_weights``, ``models.whisper.decoder_alignment_weights``);
2. every head of the upper half of the decoder layers (openai's fallback
   without tuned alignment heads) is std-normalized over the TOKEN axis
   and median-filtered;
3. dynamic time warping over the negated mean matrix gives a monotonic
   token -> frame path; token boundaries are where the path's text index
   jumps (one encoder position = 0.02 s);
4. tokens merge into words at BPE space boundaries (token ids as words
   without a tokenizer).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

FRAMES_PER_SECOND = 50  # encoder positions: 20 ms each


@dataclass
class WordTiming:
    word: str
    start_s: float
    end_s: float
    tokens: List[int]

    def to_dict(self) -> dict:
        return {"word": self.word, "start": round(self.start_s, 2),
                "end": round(self.end_s, 2)}


def median_filter(x: np.ndarray, width: int = 7) -> np.ndarray:
    """Median filter over the last axis with edge replication (openai's
    medfilt); width must be odd."""
    if width <= 1:
        return x
    pad = width // 2
    xp = np.concatenate(
        [np.repeat(x[..., :1], pad, axis=-1), x,
         np.repeat(x[..., -1:], pad, axis=-1)], axis=-1
    )
    windows = np.lib.stride_tricks.sliding_window_view(xp, width, axis=-1)
    return np.median(windows, axis=-1)


def dtw_path(cost: np.ndarray):
    """Monotonic DTW over cost [N, M] with steps (1,0),(0,1),(1,1).
    Returns (text_indices, time_indices) along the optimal path."""
    n, m = cost.shape
    d = np.full((n + 1, m + 1), np.inf, dtype=np.float64)
    d[0, 0] = 0.0
    trace = np.zeros((n + 1, m + 1), dtype=np.int8)
    for i in range(1, n + 1):
        row_prev = d[i - 1]
        row = d[i]
        for j in range(1, m + 1):
            c0, c1, c2 = row_prev[j - 1], row_prev[j], row[j - 1]
            best = c0
            t = 0
            if c1 < best:
                best, t = c1, 1
            if c2 < best:
                best, t = c2, 2
            row[j] = cost[i - 1, j - 1] + best
            trace[i, j] = t
    i, j = n, m
    text, time = [], []
    while i > 0 and j > 0:
        text.append(i - 1)
        time.append(j - 1)
        t = trace[i, j]
        if t == 0:
            i, j = i - 1, j - 1
        elif t == 1:
            i -= 1
        else:
            j -= 1
    return np.asarray(text[::-1]), np.asarray(time[::-1])


def alignment_matrix(
    weights: np.ndarray,       # [L, H, P, T] cross-attn probs (one row)
    n_tokens: int,
    n_frames: int,
) -> np.ndarray:
    """Std-normalize + median-filter the upper-half-layer heads and average
    them into a [n_tokens, n_frames] alignment matrix."""
    l = weights.shape[0]
    w = weights[l // 2:, :, :n_tokens, :n_frames].astype(np.float64)
    w = w.reshape(-1, n_tokens, n_frames)
    # Normalize over the TOKEN axis per frame column (openai-whisper
    # timing.py / HF _extract_token_timestamps: std_mean with dim=-2,
    # unbiased=False).  A round-3 review caught this normalizing over
    # frames (axis=-1), which rescales weak token rows to unit std and
    # shifts the DTW path vs the reference SUTs.
    mean = w.mean(axis=-2, keepdims=True)
    std = w.std(axis=-2, keepdims=True)
    w = (w - mean) / np.maximum(std, 1e-8)
    w = median_filter(w, 7)
    return w.mean(axis=0)


def _word_starts(pieces: List[str]) -> List[bool]:
    """True where a token starts a new word (BPE space boundary; the first
    token always starts one)."""
    starts = []
    for i, piece in enumerate(pieces):
        starts.append(i == 0 or piece.startswith(" ") or piece == "")
    return starts


def words_from_alignment(
    matrix: np.ndarray,            # [n_tokens, n_frames]
    tokens: Sequence[int],         # the aligned generated tokens
    tokenizer=None,
    offset_s: float = 0.0,
) -> List[WordTiming]:
    """DTW the alignment matrix and merge tokens into timed words."""
    if matrix.size == 0 or not len(tokens):
        return []
    text_idx, time_idx = dtw_path(-matrix)
    # End frame of each token = time index at the LAST path cell of that row.
    ends = np.zeros(len(tokens), dtype=np.int64)
    for ti, fi in zip(text_idx, time_idx):
        ends[ti] = fi
    starts = np.concatenate([[time_idx[0]], ends[:-1]])

    if tokenizer is not None:
        pieces = [tokenizer.decode([t], skip_special_tokens=False)
                  for t in tokens]
    else:
        pieces = [f" {t}" for t in tokens]  # token ids as standalone words
    new_word = _word_starts(pieces)

    out: List[WordTiming] = []
    for i, tok in enumerate(tokens):
        if new_word[i] or not out:
            out.append(WordTiming(
                word=pieces[i],
                start_s=offset_s + starts[i] / FRAMES_PER_SECOND,
                end_s=offset_s + (ends[i] + 1) / FRAMES_PER_SECOND,
                tokens=[int(tok)],
            ))
        else:
            out[-1].word += pieces[i]
            out[-1].end_s = offset_s + (ends[i] + 1) / FRAMES_PER_SECOND
            out[-1].tokens.append(int(tok))
    for w in out:
        w.word = w.word.strip()
    return [w for w in out if w.word]


def align_chunk_words(
    session,
    mel_chunk: np.ndarray,         # [n_mels, 3000]
    prompt: Sequence[int],
    gen_tokens: Sequence[int],     # EOT-stripped generated ids
    tokenizer=None,
    offset_s: float = 0.0,
    audio_len_s: Optional[float] = None,
) -> List[WordTiming]:
    """Full alignment for one decoded 30 s chunk through the session."""
    if not gen_tokens:
        return []
    weights = session.alignment_weights(mel_chunk, list(prompt),
                                        list(gen_tokens))
    n_frames = int(min(
        weights.shape[-1],
        (audio_len_s or 30.0) * FRAMES_PER_SECOND,
    ))
    # Row of generated token i is its own input position p+i (openai's
    # find_alignment slices the text-token rows the same way).
    p = len(prompt)
    matrix = alignment_matrix(
        weights[:, :, p: p + len(gen_tokens), :],
        len(gen_tokens), n_frames,
    )
    return words_from_alignment(matrix, gen_tokens, tokenizer, offset_s)
