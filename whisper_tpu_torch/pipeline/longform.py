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
region, so the breakdown is honest.  Greedy decoding with an explicit
language only: the rest raises NotImplementedError naming its ROADMAP item.
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
    word_collector: Optional[list] = None,
    initial_prompt_ids: Optional[list] = None,
    speculative: bool = False,
    token_collector: Optional[list] = None,
) -> Tuple[str, Timing]:
    """Transcribe one 16 kHz mono array: (stitched text, Timing).

    tokenizer: anything with ``decode(ids, skip_special_tokens=...)`` and
    ``token_to_id`` (e.g. ``whisper_tpu.tokenizer.WhisperDetokenizer``);
    without one, chunk texts are the token ids, as in the reference.
    token_collector: a list that receives the generated tokens
    [n_chunks, max_new_tokens] (int32 numpy)."""
    for flag, item in ((language == "auto", "language 'auto' (detection): "
                        "ROADMAP queue 1 item 8"),
                       (timestamps, "timestamp decoding: ROADMAP queue 1 "
                        "item 8"),
                       (num_beams > 1, "beam search: ROADMAP queue 1 item 8"),
                       (word_collector is not None, "word timings: ROADMAP "
                        "queue 1 item 8"),
                       (bool(initial_prompt_ids), "conditioned prompts: "
                        "ROADMAP queue 1 item 8"),
                       (speculative, "speculative decoding: ROADMAP queue 1 "
                        "item 11")):
        if flag:
            raise NotImplementedError(item)
    t0 = time.perf_counter()
    gen_cfg = gen_cfg or GenerationCfg()
    special = special_tokens(language, task, tokenizer)
    prompt = [special.sot, special.lang, special.task, special.no_timestamps]

    chunk_len = int(round(chunk_length_s * SAMPLE_RATE))
    step = max(chunk_len - int(round(overlap_s * SAMPLE_RATE)), 1)

    # 1. whole-file mel on the device
    tp0 = time.perf_counter()
    audio_16k = np.asarray(audio_16k, dtype=np.float32)
    padded = golden.reflect_pad(audio_16k)
    total_frames = golden.num_frames(len(audio_16k))
    mel = session.compute_mel(padded, total_frames,
                              mel_frame_bucket(total_frames))
    _sync(session.device)
    preprocess_s = time.perf_counter() - tp0

    starts = chunk_starts(len(audio_16k), chunk_len, step)
    frame_starts = [pos // golden.HOP for pos in starts]

    # 3. batched chunk slicing + encoder + greedy decoding
    tm0 = time.perf_counter()
    tokens = session.transcribe_from_mel(
        mel, frame_starts, prompt=prompt, max_new_tokens=max_new_tokens,
        eot_id=special.eot, suppress_ids=gen_cfg.suppress_tokens,
        begin_suppress_ids=gen_cfg.begin_suppress_tokens)
    model_only_s = time.perf_counter() - tm0   # gather_tokens synced
    if token_collector is not None:
        token_collector.append(tokens)

    # 4. detokenize + stitch (host)
    td0 = time.perf_counter()
    texts = []
    for row in tokens:
        gen = strip_generated(row, special.eot)
        if tokenizer is not None:
            text = tokenizer.decode(gen, skip_special_tokens=True)
        else:
            text = (f"[TOKENS:{' '.join(str(t) for t in gen[:200])}]"
                    if gen else "")
        if text.strip():
            texts.append(text)
    full_text = stitch_texts(texts)
    decode_s = time.perf_counter() - td0
    return full_text, Timing(preprocess_s=preprocess_s,
                             model_only_s=model_only_s, decode_s=decode_s,
                             end_to_end_s=time.perf_counter() - t0)
