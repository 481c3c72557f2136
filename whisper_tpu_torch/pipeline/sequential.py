"""Sequential (seek-based) long-form transcription (port of
``whisper_tpu.pipeline.sequential``; the HF-style strategy of the
reference's Python SUT, benchmark_without_hf_pipeline.py:236-244 via
``return_timestamps=True``).

1. whole-file log-mel once on the device (``session.compute_mel``: B5 for
   files up to 7,680 frames at x3+, streamed slabs above);
2. decode the window at ``seek`` with the timestamp grammar enforced
   (``runtime.timestamps``);
3. split the generated tokens into timestamped segments; if the window
   ended on a timestamp boundary, advance ``seek`` to it (2 mel frames a
   0.02 s step), else consume the whole window;
4. repeat until the audio is exhausted.

There is no overlap stitching: boundaries are the model's.

Previous-text conditioning (``condition_on_prev_text=True``, openai-whisper's
and HF's ``condition_on_prev_tokens``): each window's prompt is prefixed
with ``<|startofprev|>`` and the tail of the text tokens emitted so far,
LEFT-padded to ``prev_context_tokens`` slots so that every window's prompt
has one length; the session's ``pad_count`` masks the pad slots
(``models.whisper.decoder_prefill``'s prompt mask, then B3/B8 on every
step), so the padded prompt decodes as the unpadded shorter one.

Each window is one bucket-1 decode through ``transcribe_from_mel``: on a
card its steps run from the session's graph of that key (bucket 1, the
grammar, ``pad_count`` when conditioned), captured at the first window;
the window's tokens are read before the next seek, which needs them.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from whisper_tpu_torch.frontend import golden
from whisper_tpu_torch.pipeline.chunk import CHUNK_FRAMES, mel_frame_bucket
from whisper_tpu_torch.runtime.generate import strip_generated
from whisper_tpu_torch.runtime.genconfig import GenerationCfg
from whisper_tpu_torch.runtime.timestamps import TimestampCfg
from whisper_tpu_torch.tokenizer.specials import special_tokens
from whisper_tpu_torch.utils.timing import Timing

SAMPLE_RATE = 16_000
FRAMES_PER_TS = 2  # one 0.02 s timestamp step = two 10 ms mel frames


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Segment:
    start_s: float
    end_s: float
    tokens: List[int]
    text: str = ""


def parse_segments(
    tokens: List[int], ts_begin: int, window_offset_s: float,
    max_end_s: Optional[float] = None,
) -> Tuple[List[Segment], Optional[int]]:
    """Split a generated token row into timestamped segments.

    Returns (segments with absolute times, last closing timestamp index
    relative to ts_begin — None if the window did not end on a boundary).
    max_end_s clamps the synthetic end time of an UNCLOSED trailing
    segment (window ran out mid-speech) to the true audio duration —
    otherwise a 35 s file's second window would report end_s=60."""
    segments: List[Segment] = []
    start: Optional[int] = None
    body: List[int] = []
    last_close: Optional[int] = None
    for t in tokens:
        if t >= ts_begin:
            idx = t - ts_begin
            if start is None:
                start = idx
            elif body:
                segments.append(Segment(
                    start_s=window_offset_s + start * 0.02,
                    end_s=window_offset_s + idx * 0.02,
                    tokens=body,
                ))
                last_close = idx
                start = idx  # pairs: close also opens the next segment
                body = []
            else:
                # consecutive timestamps: a closed pair boundary
                last_close = idx
                start = idx
        else:
            body.append(t)
    if body and start is not None:
        # Unclosed trailing segment: window ran out mid-speech.
        end_s = window_offset_s + CHUNK_FRAMES * 0.01
        if max_end_s is not None:
            end_s = min(end_s, max_end_s)
        segments.append(Segment(
            start_s=window_offset_s + start * 0.02,
            end_s=end_s,
            tokens=body,
        ))
        last_close = None
    return segments, last_close


def transcribe_sequential(
    session,
    audio_16k: np.ndarray,
    language: str,
    task: str,
    max_new_tokens: int = 224,
    tokenizer=None,
    gen_cfg: Optional[GenerationCfg] = None,
    max_windows: int = 1000,
    condition_on_prev_text: bool = False,
    prev_context_tokens: int = 64,
    initial_prompt_ids: Optional[list] = None,
    num_beams: int = 1,
    length_penalty: float = 1.0,
    word_collector: Optional[list] = None,
    segment_callback=None,
) -> Tuple[str, List[Segment], Timing]:
    """Seek-based long-form transcription. Returns (text, segments, timing).

    condition_on_prev_text prefixes each window's prompt with
    <|startofprev|> + the last `prev_context_tokens` text tokens emitted so
    far (ref: the Python SUT's generate(return_timestamps=True) drives the
    same conditioning inside HF, benchmark_without_hf_pipeline.py:236-244;
    openai-whisper transcribe.py semantics: text tokens only, tail-clipped).

    num_beams > 1 runs each window through the on-device beam search
    (composes with conditioning — the Python SUT accepts any num_beams on
    its sequential path, ref benchmark_without_hf_pipeline.py:236-244).

    word_collector: pass a list to also receive word-level timestamps
    (cross-attention DTW, pipeline.words) with absolute times per window.

    segment_callback: called after each decoded window with the window's
    new segments as {"start","end","text"} dicts (text decoded eagerly) —
    the hook behind streaming partial results (serve/http_server.py SSE).
    """
    t0 = time.perf_counter()
    gen_cfg = gen_cfg or GenerationCfg()
    # `language="auto"`: detect from the first 30 s window, like
    # transcribe_longform (the prompt's lang slot is patched after the
    # mel is up; special_tokens has no <|auto|> token).
    detect = language == "auto"
    special = special_tokens("en" if detect else language, task, tokenizer)
    ts_begin = special.no_timestamps + 1
    ts_cfg = TimestampCfg(
        timestamp_begin=ts_begin,
        eot_id=special.eot,
        no_timestamps_id=special.no_timestamps,
    )
    prompt = [special.sot, special.lang, special.task]
    # Fixed-length conditioned prompt: [pad*, sot_prev, prev_tail..., sot,
    # lang, task]. pad slots are masked in prefill; with no prev text yet
    # the whole prefix (incl. sot_prev) is padding == the plain prompt.
    k_prev = prev_context_tokens if condition_on_prev_text else 0
    # --initial-prompt: with conditioning on, the prompt text seeds the
    # rolling previous-text context (openai-whisper semantics: window 1
    # is conditioned on it; later windows roll to decoded text). Without
    # conditioning it becomes a static <|startofprev|> prefix on every
    # window (HF prompt_ids semantics).
    prev_tokens: List[int] = (list(initial_prompt_ids)
                              if (initial_prompt_ids and condition_on_prev_text)
                              else [])
    if initial_prompt_ids and not condition_on_prev_text:
        prompt = [special.sot_prev] + list(initial_prompt_ids) + prompt

    audio_16k = np.asarray(audio_16k, dtype=np.float32)
    tp0 = time.perf_counter()
    padded = golden.reflect_pad(audio_16k)
    total_frames = golden.num_frames(len(audio_16k))
    bucket = mel_frame_bucket(total_frames)
    mel_dev = session.compute_mel(padded, total_frames, bucket)
    _sync(session.device)
    preprocess_s = time.perf_counter() - tp0

    if detect:
        from whisper_tpu_torch.runtime.langdetect import (
            detect_language,
            language_token_ids,
        )

        lang_ids = language_token_ids(tokenizer, special.sot,
                                      session.dims.vocab_size)
        detected = detect_language(
            session, mel_dev[:, :CHUNK_FRAMES], special.sot, lang_ids)
        if detected is not None:
            # The lang slot sits right after <|sot|> — whether or not a
            # static <|startofprev|> prefix was prepended above.
            prompt[prompt.index(special.sot) + 1] = detected[1]

    segments: List[Segment] = []
    model_s = 0.0
    decode_s = 0.0
    seek = 0
    windows = 0
    mel_pad = None   # lazily padded whole-file mel for word alignment
    while seek < total_frames and windows < max_windows:
        if condition_on_prev_text:
            tail = prev_tokens[-(k_prev - 1):] if k_prev > 1 else []
            prev_region = [special.sot_prev] + tail if tail else []
            pad = k_prev - len(prev_region)
            window_prompt = [special.eot] * pad + prev_region + prompt
            pad_count = pad
        else:
            window_prompt, pad_count = prompt, None
        tm0 = time.perf_counter()
        tokens = session.transcribe_from_mel(
            mel_dev, [seek],
            prompt=window_prompt, max_new_tokens=max_new_tokens,
            eot_id=special.eot,
            suppress_ids=gen_cfg.suppress_tokens,
            begin_suppress_ids=gen_cfg.begin_suppress_tokens,
            ts_cfg=ts_cfg,
            pad_count=pad_count,
            num_beams=num_beams,
            length_penalty=length_penalty,
        )
        model_s += time.perf_counter() - tm0

        td0 = time.perf_counter()
        gen = strip_generated(tokens[0], special.eot)
        segs, last_close = parse_segments(gen, ts_begin, seek * 0.01,
                                          max_end_s=total_frames * 0.01)
        segments.extend(segs)
        if word_collector is not None:
            text_tokens = [t for t in gen if t < ts_begin]
            if text_tokens:
                from whisper_tpu_torch.pipeline.words import (
                    align_chunk_words,
                )

                if mel_pad is None:
                    # Hoisted across windows: the whole-file pad is
                    # O(file size) device work, the same every window.
                    mel_pad = torch.nn.functional.pad(mel_dev,
                                                      (0, CHUNK_FRAMES))
                chunk_mel = mel_pad[:, seek:seek + CHUNK_FRAMES]
                # Teacher-forced alignment uses the PLAIN prompt: the
                # conditioned window_prompt's left padding has no mask on
                # the alignment pass (and openai-whisper aligns without
                # prev-text context too).
                words = align_chunk_words(
                    session, chunk_mel, prompt, text_tokens,
                    tokenizer, offset_s=seek * 0.01,
                    audio_len_s=min(30.0, (total_frames - seek) * 0.01),
                )
                word_collector.extend(w.to_dict() for w in words)
        if condition_on_prev_text:
            # Text tokens only (openai-whisper keeps segment text tokens,
            # not timestamps, in the conditioning window).
            for s in segs:
                prev_tokens.extend(s.tokens)
        if segment_callback is not None and segs:
            segment_callback([
                {"start": s.start_s, "end": s.end_s,
                 "text": (tokenizer.decode(s.tokens, skip_special_tokens=True)
                          if tokenizer is not None else
                          f"[TOKENS:{' '.join(str(t) for t in s.tokens[:200])}]")}
                for s in segs
            ])
        decode_s += time.perf_counter() - td0

        if last_close is not None and last_close > 0:
            seek += last_close * FRAMES_PER_TS
        else:
            seek += CHUNK_FRAMES
        windows += 1

    td0 = time.perf_counter()
    texts = []
    for seg in segments:
        if tokenizer is not None:
            seg.text = tokenizer.decode(seg.tokens, skip_special_tokens=True)
        else:
            seg.text = f"[TOKENS:{' '.join(str(t) for t in seg.tokens[:200])}]"
        if seg.text.strip():
            texts.append(seg.text.strip())
    full_text = " ".join(texts)
    decode_s += time.perf_counter() - td0

    timing = Timing(
        preprocess_s=preprocess_s,
        model_only_s=model_s,
        decode_s=decode_s,
        end_to_end_s=time.perf_counter() - t0,
    )
    return full_text, segments, timing
