"""Temperature-fallback long-form transcription (port of
``whisper_tpu.pipeline.fallback``).

openai-whisper's decode robustness ladder (also in faster-whisper): decode
greedily first; any 30 s chunk whose output looks degenerate (too
compressible: a repetition loop; or too low an average log-probability) is
decoded again at the next sampling temperature, until it passes or the
ladder ends.  Only the chunks that failed are decoded again, batched
together, rung ``ti`` with seed ``seed + ti``.

Quality gates (the standard thresholds):
- compression_ratio(text) > 2.4  -> repetitive
- avg_logprob < -1.0             -> low confidence
"""

from __future__ import annotations

import time
import zlib
from typing import Optional, Sequence, Tuple

import numpy as np

from whisper_tpu_torch.frontend import golden
from whisper_tpu_torch.pipeline.chunk import (
    CHUNK_FRAMES,
    chunk_starts,
    mel_frame_bucket,
)
from whisper_tpu_torch.pipeline.longform import SAMPLE_RATE, _sync
from whisper_tpu_torch.pipeline.stitch import stitch_texts
from whisper_tpu_torch.runtime.generate import strip_generated
from whisper_tpu_torch.runtime.genconfig import GenerationCfg
from whisper_tpu_torch.tokenizer.specials import special_tokens
from whisper_tpu_torch.utils.timing import Timing

DEFAULT_TEMPERATURES = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)


def compression_ratio(text: str) -> float:
    """len(utf8) / len(zlib(utf8)): high values mean repetitive text."""
    data = text.encode("utf-8")
    if not data:
        return 0.0
    return len(data) / len(zlib.compress(data))


def needs_fallback(text: str, avg_logprob: float,
                   compression_ratio_threshold: float = 2.4,
                   logprob_threshold: float = -1.0) -> bool:
    if compression_ratio(text) > compression_ratio_threshold:
        return True
    if avg_logprob < logprob_threshold:
        return True
    return False


def transcribe_longform_fallback(
    session,
    audio_16k: np.ndarray,
    language: str,
    task: str,
    max_new_tokens: int,
    chunk_length_s: float = 30.0,
    overlap_s: float = 5.0,
    tokenizer=None,
    gen_cfg: Optional[GenerationCfg] = None,
    temperatures: Sequence[float] = DEFAULT_TEMPERATURES,
    compression_ratio_threshold: float = 2.4,
    logprob_threshold: float = -1.0,
    seed: int = 0,
    token_collector: Optional[list] = None,
) -> Tuple[str, Timing, dict]:
    """Chunked long-form with the temperature-fallback ladder: (text,
    timing, info), info["accepted_at"] the temperature each chunk was
    accepted at.  ``language="auto"`` detects the language on the first
    window.  token_collector: a list that receives, for each rung decoded,
    (temperature, chunk indices, tokens [n, max_new_tokens] int32)."""
    t0 = time.perf_counter()
    gen_cfg = gen_cfg or GenerationCfg()
    # `language="auto"`: first-window detection, as in the long-form
    # driver (special_tokens has no <|auto|> token; the prompt's language
    # slot is set once the mel is up).
    detect = language == "auto"
    special = special_tokens("en" if detect else language, task, tokenizer)
    prompt = [special.sot, special.lang, special.task, special.no_timestamps]

    chunk_len = int(round(chunk_length_s * SAMPLE_RATE))
    step = max(chunk_len - int(round(overlap_s * SAMPLE_RATE)), 1)

    tp0 = time.perf_counter()
    audio_16k = np.asarray(audio_16k, dtype=np.float32)
    padded = golden.reflect_pad(audio_16k)
    total_frames = golden.num_frames(len(audio_16k))
    mel = session.compute_mel(padded, total_frames,
                              mel_frame_bucket(total_frames))
    _sync(session.device)
    preprocess_s = time.perf_counter() - tp0

    if detect:
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

    starts = chunk_starts(len(audio_16k), chunk_len, step)
    frame_starts = [pos // golden.HOP for pos in starts]
    c = len(frame_starts)

    texts: list = [None] * c
    accepted_at: list = [None] * c
    pending = list(range(c))
    model_s = 0.0
    decode_s = 0.0

    for ti, temp in enumerate(temperatures):
        is_last = ti == len(temperatures) - 1
        tm0 = time.perf_counter()
        tokens, sum_lp, n_tok = session.transcribe_from_mel(
            mel, [frame_starts[i] for i in pending],
            prompt=prompt, max_new_tokens=max_new_tokens,
            eot_id=special.eot,
            suppress_ids=gen_cfg.suppress_tokens,
            begin_suppress_ids=gen_cfg.begin_suppress_tokens,
            temperature=float(temp), seed=seed + ti, with_scores=True)
        model_s += time.perf_counter() - tm0   # gather_tokens synced
        if token_collector is not None:
            token_collector.append((float(temp), list(pending), tokens))

        td0 = time.perf_counter()
        still_pending = []
        for row, lp, nt, i in zip(tokens, sum_lp, n_tok, pending):
            gen = strip_generated(row, special.eot)
            if tokenizer is not None:
                text = tokenizer.decode(gen, skip_special_tokens=True)
            else:
                text = (f"[TOKENS:{' '.join(str(t) for t in gen[:200])}]"
                        if gen else "")
            avg_lp = float(lp) / max(int(nt), 1)
            if is_last or not needs_fallback(
                    text, avg_lp, compression_ratio_threshold,
                    logprob_threshold):
                texts[i] = text
                accepted_at[i] = temp
            else:
                still_pending.append(i)
        decode_s += time.perf_counter() - td0
        pending = still_pending
        if not pending:
            break

    td0 = time.perf_counter()
    full_text = stitch_texts([t for t in texts if t and t.strip()])
    decode_s += time.perf_counter() - td0

    timing = Timing(preprocess_s=preprocess_s, model_only_s=model_s,
                    decode_s=decode_s,
                    end_to_end_s=time.perf_counter() - t0)
    return full_text, timing, {"accepted_at": accepted_at}
