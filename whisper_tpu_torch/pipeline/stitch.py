"""Chunk-text stitching with overlap dedupe (ref src/main.rs:659-696).

Concatenates chunk texts, removing up to 16 overlapping words at each join
(case-insensitive suffix/prefix match, longest first).

A copy of ``whisper_tpu.pipeline.stitch``, whose package ``__init__``
imports jax.
"""

from __future__ import annotations

from typing import Sequence


def word_overlap(a: str, b: str, max_words: int = 16) -> int:
    """Longest k <= max_words with a's last k words == b's first k words,
    case-insensitively (ref src/main.rs:686-696)."""
    a_words = [w.lower() for w in a.split()]
    b_words = [w.lower() for w in b.split()]
    top = min(max_words, len(a_words), len(b_words))
    for k in range(top, 0, -1):
        if a_words[len(a_words) - k :] == b_words[:k]:
            return k
    return 0


def stitch_texts(chunks: Sequence[str]) -> str:
    """Join chunk texts, deduping overlaps (ref src/main.rs:659-684)."""
    out = ""
    for chunk in chunks:
        t = chunk.strip()
        if not t:
            continue
        if not out:
            out = t
            continue
        k = word_overlap(out, t, 16)
        if k > 0:
            remaining = " ".join(t.split()[k:])
            if remaining:
                out += " " + remaining
        else:
            out += " " + t
    return out
