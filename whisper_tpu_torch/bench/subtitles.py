"""SRT / WebVTT subtitle writers (a copy of ``whisper_tpu.bench.subtitles``,
which is host-only).

Beyond-reference output surface: the reference emits plain transcripts
only (`<stem>.transcript.txt`, ref src/main.rs:1208-1212), but every
Whisper deployment ecosystem (openai-whisper CLI, faster-whisper,
whisper.cpp) ships subtitle output.  Cues come from the two timing
sources the framework already produces:

- word-level timestamps (``--word-timestamps``: cross-attention DTW,
  pipeline/words.py) — grouped into readable cues here;
- sequential-mode segments (``--longform-mode sequential``: timestamp-
  grammar segmentation, pipeline/sequential.py) — one cue per segment.

Formats follow the de-facto specs: SRT = 1-based index, ``HH:MM:SS,mmm``
arrow times, blank-line separated; WebVTT = ``WEBVTT`` header and
``HH:MM:SS.mmm`` times.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence


@dataclass
class Cue:
    start_s: float
    end_s: float
    text: str


def _fmt_time(seconds: float, sep: str) -> str:
    ms = max(0, int(round(seconds * 1000.0)))
    h, rem = divmod(ms, 3_600_000)
    m, rem = divmod(rem, 60_000)
    s, ms = divmod(rem, 1000)
    return f"{h:02d}:{m:02d}:{s:02d}{sep}{ms:03d}"


def cues_from_words(
    words: Sequence[Dict],
    max_chars: int = 42,
    max_dur_s: float = 7.0,
    max_gap_s: float = 1.0,
) -> List[Cue]:
    """Group word timings (``{"word","start","end"}`` dicts) into cues.

    A cue closes when adding the next word would exceed ``max_chars``,
    when the cue would span more than ``max_dur_s``, or when the gap to
    the next word exceeds ``max_gap_s`` (a pause = a natural cue break).
    """
    cues: List[Cue] = []
    buf: List[Dict] = []

    def flush() -> None:
        if buf:
            text = "".join(w["word"] for w in buf).strip()
            if text:
                cues.append(Cue(buf[0]["start"], buf[-1]["end"], text))
            buf.clear()

    for w in words:
        if not str(w.get("word", "")).strip():
            continue
        if buf:
            chars = sum(len(x["word"]) for x in buf) + len(w["word"])
            too_long = chars > max_chars
            too_slow = w["end"] - buf[0]["start"] > max_dur_s
            gap = w["start"] - buf[-1]["end"] > max_gap_s
            if too_long or too_slow or gap:
                flush()
        buf.append(w)
    flush()
    return cues


def cues_from_segments(segments: Sequence) -> List[Cue]:
    """One cue per timestamped Segment (pipeline/sequential.parse_segments);
    empty-text segments are dropped."""
    return [
        Cue(seg.start_s, seg.end_s, seg.text.strip())
        for seg in segments
        if seg.text.strip()
    ]


def format_srt(cues: Sequence[Cue]) -> str:
    blocks = []
    for i, c in enumerate(cues, start=1):
        blocks.append(
            f"{i}\n{_fmt_time(c.start_s, ',')} --> "
            f"{_fmt_time(c.end_s, ',')}\n{c.text}\n"
        )
    return "\n".join(blocks)


def format_vtt(cues: Sequence[Cue]) -> str:
    blocks = ["WEBVTT\n"]
    for c in cues:
        blocks.append(
            f"{_fmt_time(c.start_s, '.')} --> "
            f"{_fmt_time(c.end_s, '.')}\n{c.text}\n"
        )
    return "\n".join(blocks)


def write_subtitles(path: str, cues: Sequence[Cue]) -> None:
    """Write cues to ``path``; format chosen by extension (.srt / .vtt)."""
    if path.endswith(".vtt"):
        content = format_vtt(cues)
    elif path.endswith(".srt"):
        content = format_srt(cues)
    else:
        raise ValueError(f"unknown subtitle extension: {path}")
    with open(path, "w", encoding="utf-8") as f:
        f.write(content)
