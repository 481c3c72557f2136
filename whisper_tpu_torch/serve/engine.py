"""Continuous-batching transcription engine (port of
``whisper_tpu.serve.engine``; BASELINE.json config 5, "faster-whisper-style
continuous decode across concurrent streams"):

- concurrent requests land in per-lane queues drained by two workers;
- short utterances (<= chunk length, the streaming case) from DIFFERENT
  streams are merged into one batch through audio -> mel -> encoder ->
  greedy decoding (session.transcribe_short_batch) per scheduling tick,
  padded to a power-of-two bucket: kernels B1 and B2 in the encoder at x3+,
  B3 (or B8 at x7) and B6 (x4) or B4 (x5+) in every decode step;
- long requests run on a SEPARATE lane (their own worker thread) through
  the long-form pipeline (still chunk-batched within the request), so a
  long file never head-of-line-blocks queued short streams;
- a small batching window lets concurrent arrivals coalesce without
  adding tail latency when the queue is empty.

Both lanes launch kernels from their own threads on the one CUDA stream
PyTorch gives every thread by default (``ops/kernels.stream_ptr``), so the
card runs their work in the order it is issued.  The greedy loop reads
``bool(done.all())`` on the host every step, so a tick's dispatch returns
after its decode: the one-deep tick pipeline overlaps less than the JAX
engine's (ROADMAP queue 1 item 4(a)).  Both lanes hold the interpreter lock
while they issue work, so a long request slows the short lane's host side.

The engine is transport-agnostic; whisper_tpu_torch.serve.server wraps it
in a JSON-lines TCP front end.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from whisper_tpu_torch.frontend import golden
from whisper_tpu_torch.pipeline.chunk import CHUNK_FRAMES
from whisper_tpu_torch.pipeline.longform import transcribe_longform
from whisper_tpu_torch.runtime.generate import strip_generated
from whisper_tpu_torch.runtime.genconfig import GenerationCfg
from whisper_tpu_torch.tokenizer.specials import special_tokens

SAMPLE_RATE = 16_000


@dataclass
class EngineConfig:
    language: str = "en"
    task: str = "transcribe"
    max_new_tokens: int = 128
    chunk_length_s: float = 30.0
    overlap_s: float = 5.0
    batch_window_ms: float = 4.0   # coalescing window once >=1 request waits
    timestamps: bool = False
    # Ship each tick's rows only as long as its LONGEST utterance (rounded
    # up to {1/8, 1/4, 1/2, 1} of the 30 s window); the zero padding is
    # recreated on the device (runtime/session.py _short_mel).  A tick of
    # 2 s utterances then uploads ~1/8 of the bytes.  warmup() runs the 1/8
    # and full-window lengths.
    trim_upload: bool = True


@dataclass
class _Request:
    audio: np.ndarray
    future: Future
    enqueued_at: float


class StreamingEngine:
    """Single-device continuous-batching engine over a WhisperSession
    (``whisper_tpu_torch.runtime.session``)."""

    def __init__(self, session, tokenizer=None,
                 cfg: Optional[EngineConfig] = None,
                 gen_cfg: Optional[GenerationCfg] = None):
        self.session = session
        self.tokenizer = tokenizer
        self.cfg = cfg or EngineConfig()
        self.gen_cfg = gen_cfg or GenerationCfg()
        self._queue: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._long_queue: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._special = special_tokens(self.cfg.language, self.cfg.task,
                                       tokenizer)
        self._prompt = [self._special.sot, self._special.lang,
                        self._special.task]
        if not self.cfg.timestamps:
            self._prompt.append(self._special.no_timestamps)
        self._short_limit = int(self.cfg.chunk_length_s * SAMPLE_RATE)
        self.stats = {"batches": 0, "batched_requests": 0, "longform": 0,
                      "speculative": 0}
        self._running = True
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()
        self._long_worker = threading.Thread(target=self._run_long,
                                             daemon=True)
        self._long_worker.start()

    # -- public API ---------------------------------------------------------

    def submit(self, audio_16k: np.ndarray) -> Future:
        """Enqueue one utterance (float32 @16 kHz mono); resolves to the
        transcript string."""
        fut: Future = Future()
        if not self._running:
            # A request enqueued behind close()'s shutdown sentinel would
            # never be drained and its future would hang forever.
            fut.set_exception(RuntimeError("engine is closed"))
            return fut
        audio = np.asarray(audio_16k, dtype=np.float32)
        if audio.size == 0:
            # Reference behavior: empty audio is an error (src/main.rs:414-416).
            fut.set_exception(ValueError("Empty audio"))
            return fut
        req = _Request(
            audio=audio, future=fut, enqueued_at=time.perf_counter(),
        )
        # Lane routing at admission: long-form work never sits in front of
        # short streams (VERDICT r1: head-of-line blocking).
        if len(audio) > self._short_limit:
            self._long_queue.put(req)
        else:
            self._queue.put(req)
        return fut

    def transcribe(self, audio_16k: np.ndarray, timeout: float = 300.0) -> str:
        return self.submit(audio_16k).result(timeout=timeout)

    def _ship_len(self, need: int) -> int:
        """Quantize a tick's sample need to {1/8, 1/4, 1/2, 1} of the full
        30 s window — few enough sub-buckets that warmup can cover the
        common ones, big enough steps that most of the padding is never
        uploaded."""
        pad_len = self._short_limit + 2 * 200
        for frac in (8, 4, 2):
            if need <= pad_len // frac:
                return pad_len // frac
        return pad_len

    def warmup(self, batch: int = 0) -> None:
        """Run the short-batch path once for the given bucket, or for every
        power-of-two bucket up to max_batch (a lone request hits bucket 1,
        a burst the bigger ones): nothing compiles, but the first run of a
        shape builds the kernels (at first use), the libraries' handles and
        the allocator's cache.

        With trim_upload the live ticks ship sub-bucket lengths; the
        smallest (1/8 window, the short-utterance streaming case) is run
        beside the full window."""
        if batch:
            buckets = [batch]
        else:
            buckets, b = [], 1
            while b <= self.session.cfg.max_batch:
                buckets.append(b)
                b <<= 1
        pad_len = self._short_limit + 2 * 200
        lengths = ([pad_len // 8, pad_len] if self.cfg.trim_upload
                   else [pad_len])
        for n in buckets:
            for ship_len in lengths:
                audio = np.zeros((n, ship_len), dtype=np.float32)
                n_valid = np.full(n, CHUNK_FRAMES, dtype=np.int32)
                self._warm_one(audio, n_valid)

    def _warm_one(self, audio: np.ndarray, n_valid: np.ndarray) -> None:
        if self.session.has_draft:
            # Every short bucket takes the speculative program.
            self.session.transcribe_short_speculative(
                audio, n_valid, self._prompt, self.cfg.max_new_tokens,
                self._special.eot,
                suppress_ids=self.gen_cfg.suppress_tokens,
                begin_suppress_ids=self.gen_cfg.begin_suppress_tokens,
            )
        else:
            self.session.transcribe_short_batch(
                audio, n_valid, self._prompt, self.cfg.max_new_tokens,
                self._special.eot,
                suppress_ids=self.gen_cfg.suppress_tokens,
                begin_suppress_ids=self.gen_cfg.begin_suppress_tokens,
            )

    def close(self) -> None:
        self._running = False
        self._queue.put(None)
        self._long_queue.put(None)
        self._worker.join(timeout=10)
        self._long_worker.join(timeout=10)

    # -- worker -------------------------------------------------------------

    def _run(self) -> None:
        # One-deep tick pipeline: tick k's copy of its tokens to the host
        # is deferred until tick k+1 is dispatched.  Under light load
        # (nothing else queued) it happens at once: no added latency for a
        # lone request.  The port's dispatch returns after its decode loop
        # (the loop reads `done` on the host each step), so what overlaps
        # is the copy and the detokenizing of tick k with tick k+1.
        inflight = None  # (device_tokens, reqs)
        while self._running:
            try:
                req = self._queue.get(timeout=0.05 if inflight else None)
            except queue.Empty:
                if inflight is not None:
                    self._finish_short(*inflight)
                    inflight = None
                continue
            if req is None:
                break
            batch = [req]
            # Coalesce: brief window for concurrent arrivals.
            deadline = time.perf_counter() + self.cfg.batch_window_ms / 1000.0
            cap = self.session.cfg.max_batch
            while len(batch) < cap:
                remaining = deadline - time.perf_counter()
                try:
                    nxt = self._queue.get(
                        timeout=max(remaining, 0) if remaining > 0 else 0
                    )
                except queue.Empty:
                    break
                if nxt is None:
                    self._running = False
                    break
                batch.append(nxt)

            try:
                current = (self._dispatch_short(batch), batch)
            except Exception as e:  # resolve futures, keep serving
                current = None
                for r in batch:
                    if not r.future.done():
                        r.future.set_exception(e)
            if inflight is not None:
                self._finish_short(*inflight)
            inflight = current
            if inflight is not None and self._queue.empty():
                self._finish_short(*inflight)
                inflight = None
        if inflight is not None:
            self._finish_short(*inflight)

    def _run_long(self) -> None:
        """Long-form lane: one request at a time through the long-form
        pipeline, on its own thread, so the short lane's ticks go on beside
        it."""
        while self._running:
            req = self._long_queue.get()
            if req is None:
                break
            try:
                self.stats["longform"] += 1
                # With a draft attached (and no timestamp grammar), the
                # long lane's chunk batch takes the speculative program
                # too — same lever as the short lane.
                spec = self.session.has_draft and not self.cfg.timestamps
                text, _ = transcribe_longform(
                    self.session, req.audio, self.cfg.language,
                    self.cfg.task, self.cfg.max_new_tokens,
                    self.cfg.chunk_length_s, self.cfg.overlap_s,
                    self.tokenizer, self.cfg.timestamps, self.gen_cfg,
                    speculative=spec,
                )
                req.future.set_result(text)
            except Exception as e:
                req.future.set_exception(e)

    def _process_short(self, reqs: List[_Request]) -> None:
        """Dispatch + finish one tick synchronously (tests; the worker
        loop pipelines the two halves instead)."""
        self._finish_short(self._dispatch_short(reqs), reqs)

    def _dispatch_short(self, reqs: List[_Request]):
        """Run the short path over all short requests in this tick;
        returns the tokens on the device (no copy to the host: see _run's
        tick pipeline).

        With a draft model attached, the whole bucket takes the speculative
        path (lossless greedy, fewer full-model steps; per-row cache
        positions let rows accept different draft lengths)."""
        n = len(reqs)
        bucket = 1
        while bucket < n and bucket < self.session.cfg.max_batch:
            bucket <<= 1
        # Non-power-of-two max_batch (settable via discovery JSON): the
        # doubling can overshoot the cap; clamp like session._bucket_batch,
        # so a tick never runs a bucket wider than max_batch.
        bucket = min(bucket, self.session.cfg.max_batch)
        pad_len = self._short_limit + 2 * 200
        ship_len = (self._ship_len(max(len(r.audio) for r in reqs) + 2 * 200)
                    if self.cfg.trim_upload else pad_len)

        audio = np.zeros((bucket, ship_len), dtype=np.float32)
        n_valid = np.zeros(bucket, dtype=np.int32)
        for i, r in enumerate(reqs):
            padded = golden.reflect_pad(r.audio)
            audio[i, : len(padded)] = padded
            n_valid[i] = golden.num_frames(len(r.audio))

        if self.session.has_draft:
            tokens = self.session.transcribe_short_speculative_async(
                audio, n_valid, self._prompt, self.cfg.max_new_tokens,
                self._special.eot,
                suppress_ids=self.gen_cfg.suppress_tokens,
                begin_suppress_ids=self.gen_cfg.begin_suppress_tokens,
            )
            self.stats["speculative"] += n
        else:
            tokens = self.session.transcribe_short_batch_async(
                audio, n_valid, self._prompt, self.cfg.max_new_tokens,
                self._special.eot,
                suppress_ids=self.gen_cfg.suppress_tokens,
                begin_suppress_ids=self.gen_cfg.begin_suppress_tokens,
            )
        self.stats["batches"] += 1
        self.stats["batched_requests"] += n
        return tokens

    def _finish_short(self, device_tokens, reqs: List[_Request]) -> None:
        """Copy a tick's tokens to the host, detokenize, resolve futures
        (error-isolating: serving survives a failed tick)."""
        try:
            tokens = device_tokens.cpu().numpy()
            for i, r in enumerate(reqs):
                gen = strip_generated(tokens[i], self._special.eot)
                if self.tokenizer is not None:
                    text = self.tokenizer.decode(gen, skip_special_tokens=True)
                else:
                    text = (f"[TOKENS:{' '.join(str(t) for t in gen[:200])}]"
                            if gen else "")
                r.future.set_result(text.strip())
        except Exception as e:
            for r in reqs:
                if not r.future.done():
                    r.future.set_exception(e)
