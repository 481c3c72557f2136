"""Pipelined long-form transcription (port of
``whisper_tpu.pipeline.pipelined``).

Chunks are normalized with their OWN masked max, the per-chunk semantics
of the reference's HF-pipeline comparison SUT (each 30 s window
feature-extracted on its own), in place of the whole-file max of the
chunked mode.  The chunk geometry and the zero-padded window slicing stay
the chunked mode's; only the normalization scope changes, so transcripts
can differ from the chunked mode's near quiet regions.  The file is cut
into slabs of ``slab_chunks`` chunks, one capacity for every slab (ragged
tails masked by their valid-frame count), and each slab is uploaded
(``session.encode_host_slab``), turned into a raw log-spec by the plain
``frontend.mel.log_spec_slab`` (kernel B5 is not on this path, as in the
JAX module, which calls the XLA ``log_spec_slab``) and decoded by
``session.transcribe_from_mel_async(..., chunk_norm_n_valid=n_valid)``.

The limit of the overlap on the card: the mode exists so that slab k
decodes while slab k+1's audio is still on the wire (the JAX package's
remote-device link).  In the port ``transcribe_from_mel_async`` returns
only after its decode loop, because the greedy loop reads
``bool(done.all())`` on the host every step (``runtime/generate.py``,
ROADMAP queue 1 item 4(a)); so the slabs run one after another, and each
slab is a batch bucket of its own (4 rows at ``slab_chunks`` 4), that is a
host-bound decode loop of its own.

Timing: preprocess_s covers the host preparation and slab 0's upload and
log-spec (synchronized); model_only_s runs from slab 0's decode to the
last token copy, so it holds the later slabs' uploads and log-specs too
(upload and decode are deliberately one stage here); language detection
sits between the two, in end_to_end_s only.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np

from whisper_tpu_torch.frontend import golden
from whisper_tpu_torch.frontend.golden import HOP
from whisper_tpu_torch.pipeline.chunk import CHUNK_FRAMES, chunk_starts
from whisper_tpu_torch.pipeline.longform import _sync
from whisper_tpu_torch.pipeline.stitch import stitch_texts
from whisper_tpu_torch.runtime.generate import strip_generated
from whisper_tpu_torch.runtime.genconfig import GenerationCfg
from whisper_tpu_torch.runtime.session import WhisperSession
from whisper_tpu_torch.tokenizer.specials import special_tokens
from whisper_tpu_torch.utils.timing import Timing

SAMPLE_RATE = 16_000


def _slab_plan(frame_starts, total_frames: int, slab_chunks: int):
    """Partition chunks into slabs of `slab_chunks`; returns
    (slab_capacity_frames, [(f0, n_valid, [local_starts...]), ...]).
    One capacity serves every slab (ragged tails are masked via n_valid),
    so every slab's log-spec has one shape."""
    c = len(frame_starts)
    slabs = [(k, min(k + slab_chunks, c))
             for k in range(0, c, slab_chunks)]
    cap = max(frame_starts[b - 1] - frame_starts[a] for a, b in slabs)
    cap += CHUNK_FRAMES
    plan = []
    for a, b in slabs:
        f0 = frame_starts[a]
        n_valid = max(0, min(total_frames - f0, cap))
        plan.append((f0, n_valid, [frame_starts[i] - f0 for i in range(a, b)]))
    return cap, plan


def transcribe_longform_pipelined(
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
    slab_chunks: int = 4,
    word_collector: Optional[list] = None,
    initial_prompt_ids: Optional[list] = None,
    speculative: bool = False,
    draft_k: int = 4,
) -> Tuple[str, Timing]:
    """Pipelined long-form transcription: (stitched text, Timing); the
    surface of ``pipeline.longform.transcribe_longform`` less
    precomputed_mel (the slab schedule is the point here), with
    ``slab_chunks`` chunks a slab.  ``language="auto"`` detects on chunk
    0's own normalized window; word timings align each chunk against its
    own normalized window (``session.chunk_norm_window``); an initial
    prompt prefixes every chunk's prompt with ``[<|startofprev|>] + ids``;
    ``speculative`` decodes with the session's draft model.  Empty audio
    gives ""."""
    from whisper_tpu_torch.frontend.mel import log_spec_slab

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
    overlap = int(round(overlap_s * SAMPLE_RATE))
    step = max(chunk_len - overlap, 1)

    tp0 = time.perf_counter()
    audio_16k = np.asarray(audio_16k, dtype=np.float32)
    padded = golden.reflect_pad(audio_16k)
    total_frames = golden.num_frames(len(audio_16k))
    starts = chunk_starts(len(audio_16k), chunk_len, step)
    frame_starts = [pos // HOP for pos in starts]
    if not frame_starts:
        # Zero-length audio: nothing to decode (the chunked mode returns
        # empty text here too; _slab_plan would max() an empty sequence).
        return "", Timing(end_to_end_s=time.perf_counter() - t0)
    cap, plan = _slab_plan(frame_starts, total_frames, slab_chunks)

    need = (cap + 2) * HOP
    slab_ls, slab_pieces = [], []
    for i, (f0, n_valid, local) in enumerate(plan):
        enc = session._upload(session.encode_host_slab(padded, f0 * HOP,
                                                       need))
        ls, _vmax = log_spec_slab(enc, n_valid, n_mels=session.dims.n_mels,
                                  n_frames=cap)
        slab_ls.append(ls)
        if i == 0:
            _sync(session.device)
            preprocess_s = time.perf_counter() - tp0
            # `--language auto`: detect on chunk 0's own normalized window
            if detect:
                from whisper_tpu_torch.runtime.langdetect import (
                    detect_language,
                    language_token_ids,
                )

                lang_ids = language_token_ids(tokenizer, special.sot,
                                              session.dims.vocab_size)
                mel0 = session.chunk_norm_window(ls, 0, n_valid)
                detected = detect_language(session, mel0, special.sot,
                                           lang_ids)
                if detected is not None:
                    prompt[1] = detected[1]
            tm0 = time.perf_counter()
        slab_pieces.append(session.transcribe_from_mel_async(
            ls, local,
            prompt=prefix + prompt,
            max_new_tokens=max_new_tokens,
            eot_id=special.eot,
            suppress_ids=gen_cfg.suppress_tokens,
            begin_suppress_ids=gen_cfg.begin_suppress_tokens,
            num_beams=num_beams,
            length_penalty=length_penalty,
            ts_cfg=ts_cfg,
            chunk_norm_n_valid=n_valid,
            speculative=speculative,
            draft_k=draft_k,
        ))

    # tokens to the host, in slab order
    token_rows = []
    for pieces, (f0, n_valid, local) in zip(slab_pieces, plan):
        token_rows.extend(session.gather_tokens(pieces, len(local),
                                                max_new_tokens))
    model_only_s = time.perf_counter() - tm0

    # detokenize + stitch (host)
    td0 = time.perf_counter()
    texts = []
    for row in token_rows:
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
        from whisper_tpu_torch.pipeline.words import align_chunk_words

        chunk_ix = 0
        for ls, (f0, n_valid, local) in zip(slab_ls, plan):
            for lstart in local:
                row = token_rows[chunk_ix]
                chunk_ix += 1
                gen = [t for t in strip_generated(row, special.eot)
                       if t < ts_begin]                   # text tokens only
                if not gen:
                    continue
                chunk_mel = session.chunk_norm_window(ls, lstart, n_valid)
                words = align_chunk_words(
                    session, chunk_mel, prefix + prompt, gen, tokenizer,
                    offset_s=(f0 + lstart) * 0.01,
                    audio_len_s=min(30.0,
                                    (total_frames - f0 - lstart) * 0.01))
                word_collector.extend(w.to_dict() for w in words)
    decode_s = time.perf_counter() - td0

    return full_text, Timing(preprocess_s=preprocess_s,
                             model_only_s=model_only_s, decode_s=decode_s,
                             end_to_end_s=time.perf_counter() - t0)
