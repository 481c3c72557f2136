"""Long-form transcription driver (port of
``whisper_tpu.pipeline.longform``; ref transcribe_longform_chunked,
src/main.rs:834-1008):

1. whole-file log-mel once on the device (preprocess_s)
2. chunk starts every chunk_len - overlap samples
3. all chunks stacked on a batch dimension -> encoder + greedy decoding
   per batch bucket (model_only_s)
4. per-chunk detokenize (strip prompt/EOT, drop empties) and overlap-
   deduped stitching on the host (decode_s)

Device work is fenced with ``torch.cuda.synchronize`` inside each timed
region, so the breakdown is honest.  On a card each bucket's greedy
decode is one launch of a CUDA graph whose while node runs its steps until
its rows are done (``runtime.generate``).  Greedy decoding, plain or speculative
(a draft model attached to the session), or beam search; timestamp
decoding; ``language="auto"`` detects the language on the first window;
an initial prompt conditions every chunk; word timings come from
cross-attention DTW (``pipeline.words``).
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from whisper_tpu_torch.frontend import golden
from whisper_tpu_torch.pipeline.chunk import chunk_starts, mel_frame_bucket
from whisper_tpu_torch.pipeline.stitch import stitch_texts
from whisper_tpu_torch.runtime.generate import strip_generated
from whisper_tpu_torch.runtime.genconfig import GenerationCfg
from whisper_tpu_torch.runtime.session import WhisperSession
from whisper_tpu_torch.tokenizer.specials import special_tokens
from whisper_tpu_torch.utils.timing import Timing

SAMPLE_RATE = 16_000


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def transcribe_longform(
    session: WhisperSession,
    audio_16k: np.ndarray,
    language: str,
    task: str,
    max_new_tokens: int,
    chunk_length_s: float = 30.0,
    overlap_s: float = 5.0,
    tokenizer=None,
    timestamps: bool = False,
    gen_cfg: Optional[GenerationCfg] = None,
    num_beams: int = 1,
    length_penalty: float = 1.0,
    precomputed_mel: Optional[Tuple] = None,
    word_collector: Optional[list] = None,
    initial_prompt_ids: Optional[list] = None,
    language_collector: Optional[list] = None,
    speculative: bool = False,
    token_collector: Optional[list] = None,
    draft_k: int = 4,
) -> Tuple[str, Timing]:
    """Transcribe one 16 kHz mono array: (stitched text, Timing).

    tokenizer: anything with ``decode(ids, skip_special_tokens=...)`` and
    ``token_to_id`` (e.g. ``tokenizer.bpe.WhisperDetokenizer``); without
    one, chunk texts are the token ids, as in the reference.
    timestamps: no <|notimestamps|> in the prompt, the timestamp grammar
    enforced, and timestamps rendered as ``<|x.xx|>`` in the text.
    language: a code, or "auto" to detect it on the first 30 s window;
    language_collector: a list that receives the detected code.
    num_beams > 1: beam search; length_penalty is read by beam search only,
    as in the JAX package.
    precomputed_mel: an optional (device mel, total_frames) pair, computed
    by the CLI's prefetch thread while the previous file decoded; the
    device is synchronized before preprocess_s is read, so it measures the
    residual wait.
    token_collector: a list that receives the generated tokens
    [n_chunks, max_new_tokens] (int32 numpy).
    speculative: draft-and-verify decoding with the session's draft model
    (``session.set_draft_model``), ``draft_k`` proposals a round; the text
    is the greedy text.
    initial_prompt_ids: every chunk's prompt is prefixed with
    ``[<|startofprev|>] + ids`` (the HF pipeline's prompt_ids), unpadded.
    word_collector: a list extended with {word, start, end} dicts in file
    time: each chunk's text tokens aligned against its own 30 s slice of
    the device mel (``pipeline.words.align_chunk_words``)."""
    t0 = time.perf_counter()
    gen_cfg = gen_cfg or GenerationCfg()
    detect = language == "auto"
    special = special_tokens("en" if detect else language, task, tokenizer)
    prompt = [special.sot, special.lang, special.task]
    prefix = ([special.sot_prev] + list(initial_prompt_ids)
              if initial_prompt_ids else [])
    ts_cfg = None
    ts_begin = special.no_timestamps + 1
    if not timestamps:
        prompt.append(special.no_timestamps)
    else:
        from whisper_tpu_torch.runtime.timestamps import TimestampCfg

        ts_cfg = TimestampCfg(timestamp_begin=ts_begin, eot_id=special.eot,
                              no_timestamps_id=special.no_timestamps)

    chunk_len = int(round(chunk_length_s * SAMPLE_RATE))
    step = max(chunk_len - int(round(overlap_s * SAMPLE_RATE)), 1)

    # 1. whole-file mel on the device
    tp0 = time.perf_counter()
    audio_16k = np.asarray(audio_16k, dtype=np.float32)
    if precomputed_mel is not None:
        mel, total_frames = precomputed_mel
    else:
        padded = golden.reflect_pad(audio_16k)
        total_frames = golden.num_frames(len(audio_16k))
        mel = session.compute_mel(padded, total_frames,
                                  mel_frame_bucket(total_frames))
    _sync(session.device)
    preprocess_s = time.perf_counter() - tp0

    if detect:
        from whisper_tpu_torch.pipeline.chunk import CHUNK_FRAMES
        from whisper_tpu_torch.runtime.langdetect import (
            detect_language,
            language_token_ids,
        )

        lang_ids = language_token_ids(tokenizer, special.sot,
                                      session.dims.vocab_size)
        detected = detect_language(session, mel[:, :CHUNK_FRAMES],
                                   special.sot, lang_ids)
        if detected is not None:
            prompt[1] = detected[1]
            if language_collector is not None:
                language_collector.append(detected[0])

    starts = chunk_starts(len(audio_16k), chunk_len, step)
    frame_starts = [pos // golden.HOP for pos in starts]

    # 3. batched chunk slicing + encoder + decoding
    tm0 = time.perf_counter()
    tokens = session.transcribe_from_mel(
        mel, frame_starts, prompt=prefix + prompt,
        max_new_tokens=max_new_tokens,
        eot_id=special.eot, suppress_ids=gen_cfg.suppress_tokens,
        begin_suppress_ids=gen_cfg.begin_suppress_tokens,
        num_beams=num_beams, length_penalty=length_penalty, ts_cfg=ts_cfg,
        speculative=speculative, draft_k=draft_k)
    model_only_s = time.perf_counter() - tm0   # gather_tokens synced
    if token_collector is not None:
        token_collector.append(tokens)

    # 4. detokenize + stitch (host)
    td0 = time.perf_counter()
    texts = []
    for row in tokens:
        gen = strip_generated(row, special.eot)
        if tokenizer is not None:
            text = tokenizer.decode(
                gen, skip_special_tokens=True,
                timestamp_begin=ts_begin if timestamps else None)
        else:
            text = (f"[TOKENS:{' '.join(str(t) for t in gen[:200])}]"
                    if gen else "")
        if text.strip():
            texts.append(text)
    full_text = stitch_texts(texts)

    if word_collector is not None:
        from whisper_tpu_torch.pipeline.chunk import CHUNK_FRAMES
        from whisper_tpu_torch.pipeline.words import align_chunk_words

        mel_pad = torch.nn.functional.pad(mel, (0, CHUNK_FRAMES))
        for i, row in enumerate(tokens):
            gen = [t for t in strip_generated(row, special.eot)
                   if t < ts_begin]                       # text tokens only
            if not gen:
                continue
            s0 = frame_starts[i]
            words = align_chunk_words(
                session, mel_pad[:, s0:s0 + CHUNK_FRAMES], prefix + prompt,
                gen, tokenizer, offset_s=s0 * 0.01,
                audio_len_s=min(30.0, (total_frames - s0) * 0.01))
            word_collector.extend(w.to_dict() for w in words)
    decode_s = time.perf_counter() - td0
    return full_text, Timing(preprocess_s=preprocess_s,
                             model_only_s=model_only_s, decode_s=decode_s,
                             end_to_end_s=time.perf_counter() - t0)
