"""Energy-based voice activity detection (VAD) for long-form filtering (a
copy of ``whisper_tpu.audio.vad``, numpy only).

The faster-whisper comparison SUT's headline option is ``vad_filter=True``
(silero model): silence is cut out before transcription, the model sees
only speech, and output timestamps are mapped back to original time.
This module provides the same surface — detect speech spans, collect
them into a condensed signal, restore timestamps — with a
dependency-free adaptive-energy detector instead of a learned model
(no silero checkpoint in this environment; zero egress).

Detector: 20 ms frames / 10 ms hop log-energy, noise floor estimated as
a low percentile, speech = energy above floor + ``threshold_db`` with
attack/release hysteresis; spans shorter than ``min_speech_ms`` are
dropped, gaps shorter than ``min_silence_ms`` are bridged, and
``speech_pad_ms`` margins are added (parameter names follow
faster-whisper's VadOptions so its users can map their configs over).

Reference surface: faster-whisper transcribe(vad_filter=...,
vad_parameters=...) used by the P3 SUT (benchmark_faster_whisper.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

SR = 16_000
_FRAME = 320      # 20 ms
_HOP = 160        # 10 ms


@dataclass
class VadOptions:
    threshold_db: float = 9.0        # speech = floor + this many dB
    min_speech_duration_ms: int = 250
    min_silence_duration_ms: int = 2000
    speech_pad_ms: int = 400
    release_db: float = 6.0          # hysteresis: stay-in-speech margin
    min_speech_db: float = -55.0     # no-silence guard: bulk energy above
                                     # this = all-speech, pass through


def _frame_energy_db(audio: np.ndarray) -> np.ndarray:
    n = max(0, 1 + (len(audio) - _FRAME) // _HOP)
    if n == 0:
        return np.zeros(0, dtype=np.float32)
    idx = np.arange(n)[:, None] * _HOP + np.arange(_FRAME)[None, :]
    frames = audio[idx]
    e = np.maximum((frames.astype(np.float64) ** 2).mean(axis=1), 1e-12)
    return (10.0 * np.log10(e)).astype(np.float32)


def detect_speech(
    audio: np.ndarray,
    options: VadOptions | None = None,
) -> List[Tuple[int, int]]:
    """Speech spans as [(start_sample, end_sample), ...] in order.

    Adaptive: the noise floor is the 15th percentile of frame energies
    (robust to mostly-speech signals as long as some silence exists; for
    all-speech audio the floor sits inside the speech mass and the whole
    signal stays marked as speech via the hysteresis + bridging rules).
    """
    opts = options or VadOptions()
    audio = np.asarray(audio, dtype=np.float32)
    e = _frame_energy_db(audio)
    if e.size == 0:
        return [(0, len(audio))] if len(audio) else []

    floor = float(np.percentile(e, 15.0))
    loud = float(np.percentile(e, 85.0))
    # No-silence guard: when the signal has no quiet tail to anchor the
    # floor (loud-floor spread under the threshold) and its bulk energy
    # is clearly above digital silence, treat the WHOLE signal as speech
    # rather than dropping everything — a relative-energy detector
    # cannot segment continuous speech/music, only pass it through.
    if loud - floor < opts.threshold_db and loud > opts.min_speech_db:
        return [(0, len(audio))]

    attack = floor + opts.threshold_db
    release = floor + opts.release_db

    spans: List[Tuple[int, int]] = []
    in_speech = False
    start = 0
    for i, v in enumerate(e):
        if not in_speech and v >= attack:
            in_speech, start = True, i
        elif in_speech and v < release:
            spans.append((start, i))
            in_speech = False
    if in_speech:
        spans.append((start, len(e)))

    # frames -> samples: frames [s, t) are speech; the LAST speech frame
    # t-1 covers samples up to (t-1)*hop + frame (using t's coverage
    # would leak one hop of confirmed silence into every span).
    spans = [(s * _HOP, min((t - 1) * _HOP + _FRAME, len(audio)))
             for s, t in spans]

    # Bridge short silences.
    bridged: List[Tuple[int, int]] = []
    min_sil = int(opts.min_silence_duration_ms * SR / 1000)
    for s, t in spans:
        if bridged and s - bridged[-1][1] < min_sil:
            bridged[-1] = (bridged[-1][0], t)
        else:
            bridged.append((s, t))

    # Drop too-short speech, then pad.
    min_speech = int(opts.min_speech_duration_ms * SR / 1000)
    pad = int(opts.speech_pad_ms * SR / 1000)
    out: List[Tuple[int, int]] = []
    for s, t in bridged:
        if t - s < min_speech:
            continue
        s, t = max(0, s - pad), min(len(audio), t + pad)
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], t)
        else:
            out.append((s, t))
    return out


@dataclass
class SpeechMap:
    """Condensed-time -> original-time mapping for collected spans."""

    spans: List[Tuple[int, int]]        # original-sample spans, in order
    offsets: List[int]                  # condensed start sample per span

    def restore_time(self, t_s: float) -> float:
        """Map a time in the condensed signal back to original time
        (same contract as faster-whisper's restore_speech_timestamps)."""
        x = t_s * SR
        for (s, e), off in zip(self.spans, self.offsets):
            if x <= off + (e - s):
                return (s + max(0.0, x - off)) / SR
        if not self.spans:
            return t_s
        s, e = self.spans[-1]
        return e / SR

    @property
    def total_samples(self) -> int:
        if not self.spans:
            return 0
        s, e = self.spans[-1]
        return self.offsets[-1] + (e - s)


def collect_chunks(
    audio: np.ndarray, spans: List[Tuple[int, int]]
) -> Tuple[np.ndarray, SpeechMap]:
    """Concatenate the speech spans into one condensed signal."""
    audio = np.asarray(audio, dtype=np.float32)
    pieces, offsets, off = [], [], 0
    for s, e in spans:
        pieces.append(audio[s:e])
        offsets.append(off)
        off += e - s
    condensed = (np.concatenate(pieces) if pieces
                 else np.zeros(0, dtype=np.float32))
    return condensed, SpeechMap(list(spans), offsets)
