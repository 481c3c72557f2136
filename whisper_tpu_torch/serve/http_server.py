"""OpenAI-compatible HTTP transcription server (port of
``whisper_tpu.serve.http_server``: the same routes, fields, status codes and
response bodies).

The reference ships only offline batch benchmarks (src/main.rs CLI); real
deployments of its SUTs are fronted by the OpenAI audio API shape, so this
module exposes the continuous-batching engine (serve/engine.py) over the
de-facto standard REST endpoints:

  POST /v1/audio/transcriptions   multipart/form-data:
        file                      audio (wav always; mp3/flac/ogg/m4a...
                                  when the native FFmpeg decoder is built)
        model                     echoed back (the server's model is fixed)
        language                  ISO-639-1 or "auto" (default: server's)
        prompt                    conditioning text (<|startofprev|>
                                  prefix semantics; needs tokenizer.json)
        response_format           json | text | srt | vtt | verbose_json
        temperature               0 = greedy; >0 samples at that
                                  temperature (fallback ladder pinned to
                                  one rung, pipeline/fallback.py);
                                  echoed in verbose_json
        timestamp_granularities[] word and/or segment (verbose_json only)
        vad_filter                "true": cut silence before decoding
                                  (energy VAD, audio/vad.py); times are
                                  restored to original file time
        stream                    "true": text/event-stream of
                                  transcript.text.delta events (one per
                                  decoded segment, sequential pipeline)
                                  ending in transcript.text.done
  POST /v1/audio/translations     same fields, task=translate
  GET  /v1/models                 OpenAI model-list shape
  GET  /healthz                   {"status":"ok"}
  GET  /stats                     engine counters (serve/engine.py)

Routing: plain text/json requests that match the engine's configured
language+task ride the continuous-batching short lane (cross-request
fusion, serve/engine.py); requests needing timing (srt/vtt/verbose_json)
or a per-request language/task override run the long-form pipeline
directly with the cross-attention DTW word aligner (pipeline/words.py)
and are serialized by a lock so they cannot starve the batched lane.

stdlib-only (http.server + email multipart parsing): no flask/fastapi in
the runtime image, and the reference's own servers are dependency-light.

Run: python -m whisper_tpu_torch.serve.http_server --allow-random-init \
         --model-id openai/whisper-base --variant x5 --port 8000
Try: curl -F file=@a.wav -F response_format=srt \
         http://127.0.0.1:8000/v1/audio/transcriptions

It serves on the first CUDA card and exits non-zero without one;
WHISPER_TPU_TORCH_DEVICE=cpu (or main(argv, device="cpu")) runs the
kernels' plain versions on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import threading
from email.parser import BytesParser
from email.policy import default as _EMAIL_POLICY
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

import numpy as np

from whisper_tpu_torch.audio.io import load_audio_16k_mono
from whisper_tpu_torch.bench.subtitles import (
    Cue,
    cues_from_words,
    format_srt,
    format_vtt,
)
from whisper_tpu_torch.pipeline.longform import transcribe_longform
from whisper_tpu_torch.pipeline.sequential import transcribe_sequential
from whisper_tpu_torch.serve.engine import StreamingEngine

MAX_BODY_BYTES = 512 * 1024 * 1024  # matches the TCP server's line limit
RESPONSE_FORMATS = ("json", "text", "srt", "vtt", "verbose_json")


class HttpError(Exception):
    def __init__(self, status: int, message: str,
                 err_type: str = "invalid_request_error"):
        super().__init__(message)
        self.status = status
        self.err_type = err_type


def parse_multipart(content_type: str, body: bytes) -> Tuple[
    Dict[str, List[str]], Dict[str, Tuple[str, bytes]]
]:
    """Parse a multipart/form-data body into (fields, files).

    fields maps name -> list of values (repeated fields accumulate, e.g.
    ``timestamp_granularities[]``); files maps name -> (filename, bytes).
    Uses the stdlib email package — the body is re-framed as a MIME
    message so BytesParser handles boundaries/quoting/charsets.
    """
    head = (f"Content-Type: {content_type}\r\n"
            f"MIME-Version: 1.0\r\n\r\n").encode("ascii", "replace")
    msg = BytesParser(policy=_EMAIL_POLICY).parsebytes(head + body)
    if not msg.is_multipart():
        raise HttpError(400, "expected multipart/form-data body")
    fields: Dict[str, List[str]] = {}
    files: Dict[str, Tuple[str, bytes]] = {}
    for part in msg.iter_parts():
        name = part.get_param("name", header="content-disposition")
        if not name:
            continue
        payload = part.get_payload(decode=True) or b""
        filename = part.get_filename()
        if filename:
            files[name] = (filename, payload)
        else:
            fields.setdefault(name, []).append(
                payload.decode("utf-8", "replace"))
    return fields, files


def _decode_upload(filename: str, data: bytes) -> Tuple[np.ndarray, float]:
    """Decode an uploaded audio file to float32 mono @16 kHz.

    Goes through audio.io.load_audio_16k_mono (native FFmpeg decoder when
    built, WAV fallback otherwise) via a temp file carrying the original
    extension so the demuxer can sniff the container.
    """
    if not data:
        raise HttpError(400, "uploaded file is empty")
    ext = os.path.splitext(filename or "audio.wav")[1].lower() or ".wav"
    fd, path = tempfile.mkstemp(suffix=ext)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        try:
            audio, _, duration = load_audio_16k_mono(path)
        except Exception as e:
            raise HttpError(400, f"could not decode audio: {e}")
    finally:
        try:
            os.unlink(path)
        except OSError:
            pass
    if audio.size == 0:
        raise HttpError(400, "audio decoded to zero samples")
    return audio, duration


class TranscriptionService:
    """Request router over a StreamingEngine.

    Batched-lane fast path for plain text; direct long-form pipeline
    (with word timestamps) for timing formats and per-request overrides.
    """

    def __init__(self, engine: StreamingEngine, model_label: str,
                 tokenizer_json: str = ""):
        self.engine = engine
        self.model_label = model_label
        # Path to tokenizer.json for ENCODING the OpenAI `prompt` field
        # (decoding is dependency-free, tokenizer/bpe.py; encoding
        # delegates to the tokenizers library via encode_text).
        self.tokenizer_json = tokenizer_json
        # Direct pipeline calls bypass the engine's worker serialization,
        # so serialize them here: one direct request at a time beside the
        # engine's two lanes.
        self._direct_lock = threading.Lock()

    # -- core paths ---------------------------------------------------------

    def prompt_ids(self, prompt_text: str) -> Optional[List[int]]:
        """Encode the OpenAI `prompt` field to conditioning token ids
        (<|startofprev|> prefix semantics, pipeline/longform.py)."""
        if not prompt_text:
            return None
        if not self.tokenizer_json:
            raise HttpError(
                400, "prompt conditioning needs a tokenizer.json "
                     "(serve with --model-dir containing one)")
        from whisper_tpu_torch.tokenizer.bpe import encode_text

        return encode_text(self.tokenizer_json, prompt_text)

    def transcribe_text(self, audio: np.ndarray, language: str,
                        task: str, prompt_ids=None) -> str:
        cfg = self.engine.cfg
        if (task == cfg.task and language in ("", cfg.language)
                and prompt_ids is None):
            return self.engine.transcribe(audio)
        text, _, _ = self._direct(audio, language or cfg.language, task,
                                  collect_words=False,
                                  prompt_ids=prompt_ids)
        return text

    def transcribe_verbose(
        self, audio: np.ndarray, language: str, task: str, prompt_ids=None,
    ) -> Tuple[str, List[dict], Optional[str]]:
        """Returns (text, words, detected_language) where words are
        {word,start,end} dicts in absolute file time (cross-attention DTW,
        pipeline/words.py) and detected_language is the first-window
        detection when language was "auto" (else None)."""
        return self._direct(audio, language or self.engine.cfg.language,
                            task, collect_words=True, prompt_ids=prompt_ids)

    def _direct(self, audio, language, task, collect_words, prompt_ids=None):
        cfg = self.engine.cfg
        words: List[dict] = []
        langs: List[str] = []
        with self._direct_lock:
            text, _ = transcribe_longform(
                self.engine.session, audio, language, task,
                cfg.max_new_tokens, cfg.chunk_length_s, cfg.overlap_s,
                self.engine.tokenizer, False, self.engine.gen_cfg,
                word_collector=words if collect_words else None,
                initial_prompt_ids=prompt_ids,
                language_collector=langs,
            )
        return text, words, langs[0] if langs else None

    def transcribe_streaming(self, audio: np.ndarray, language: str,
                             task: str, emit, prompt_ids=None) -> str:
        """Run the seek-based sequential pipeline, calling ``emit(segment)``
        with each {"start","end","text"} dict as its window decodes (the
        SSE delta source); returns the final stitched text.  language
        "auto" detects from the first window (pipeline/sequential.py)."""
        cfg = self.engine.cfg

        def on_segments(segs: List[dict]) -> None:
            for s in segs:
                emit(s)

        with self._direct_lock:
            text, _, _ = transcribe_sequential(
                self.engine.session, audio,
                language or cfg.language, task, cfg.max_new_tokens,
                self.engine.tokenizer, self.engine.gen_cfg,
                initial_prompt_ids=prompt_ids,
                segment_callback=on_segments,
            )
        return text

    # -- response shaping ---------------------------------------------------

    def respond(self, audio: np.ndarray, duration: float, task: str,
                fields: Dict[str, List[str]]) -> Tuple[str, str]:
        """Run one request; returns (content_type, payload)."""
        def field(name: str, default: str = "") -> str:
            return fields.get(name, [default])[0].strip()

        language = field("language")
        fmt = field("response_format", "json")
        if fmt not in RESPONSE_FORMATS:
            raise HttpError(
                400, f"response_format must be one of {RESPONSE_FORMATS}")
        prompt_ids = self.prompt_ids(field("prompt"))

        try:
            temperature = float(field("temperature") or 0.0)
        except ValueError:
            raise HttpError(400, "temperature must be a number")
        if temperature > 0.0 and fmt not in ("json", "text"):
            # The sampled path produces no word alignments; claiming a
            # temperature on greedy timing output would be a lie.
            raise HttpError(
                400, "temperature sampling supports response_format json "
                     "or text (timing formats decode greedily)")
        if temperature > 0.0 and prompt_ids is not None:
            raise HttpError(400, "prompt is not supported together with "
                                 "temperature sampling")

        smap = None
        if field("vad_filter").lower() in ("1", "true"):
            # faster-whisper's vad_filter surface: cut silence before
            # transcription; word/segment times are restored to original
            # file time below (audio/vad.py).
            from whisper_tpu_torch.audio.vad import (
                collect_chunks,
                detect_speech,
            )

            audio, smap = collect_chunks(audio, detect_speech(audio))

        if fmt in ("json", "text"):
            if audio.size == 0:
                text = ""
            elif temperature > 0.0:
                # OpenAI semantics: temperature>0 samples.  Routed through
                # the fallback ladder pinned to a single rung
                # (pipeline/fallback.py), serialized like the other
                # direct-lane work.
                from whisper_tpu_torch.pipeline.fallback import (
                    transcribe_longform_fallback,
                )

                cfg = self.engine.cfg
                lang = (language if language not in ("", "auto")
                        else cfg.language)
                with self._direct_lock:
                    text, _, _ = transcribe_longform_fallback(
                        self.engine.session, audio,
                        lang, task, cfg.max_new_tokens,
                        cfg.chunk_length_s, cfg.overlap_s,
                        self.engine.tokenizer, self.engine.gen_cfg,
                        temperatures=(temperature,),
                    )
            else:
                text = self.transcribe_text(audio, language, task,
                                            prompt_ids)
            if fmt == "text":
                return "text/plain; charset=utf-8", text + "\n"
            return "application/json", json.dumps({"text": text})

        if audio.size == 0:          # vad found no speech: empty envelope
            text, words, detected = "", [], None
        else:
            text, words, detected = self.transcribe_verbose(
                audio, language, task, prompt_ids)
        if smap is not None:
            for w in words:
                w["start"] = smap.restore_time(w["start"])
                w["end"] = smap.restore_time(w["end"])
        cues = cues_from_words(words)
        if not cues and text.strip():
            # No word timings (e.g. tokenizer-less [TOKENS:...] output):
            # one cue spanning the file keeps srt/vtt/segments non-empty.
            cues = [Cue(0.0, duration, text.strip())]

        if fmt == "srt":
            return "text/plain; charset=utf-8", format_srt(cues)
        if fmt == "vtt":
            return "text/vtt; charset=utf-8", format_vtt(cues)

        granularities = [g.strip() for g in
                         fields.get("timestamp_granularities[]", [])
                         + fields.get("timestamp_granularities", [])]
        out = {
            "task": "translate" if task == "translate" else "transcribe",
            # verbose_json reports the DETECTED language for "auto"
            # requests (OpenAI contract), not the literal request value.
            "language": (detected if language == "auto" and detected
                         else language if language != "auto" and language
                         else self.engine.cfg.language),
            "duration": round(duration, 3),
            "text": text,
            "segments": [
                {"id": i, "start": round(c.start_s, 3),
                 "end": round(c.end_s, 3), "text": c.text}
                for i, c in enumerate(cues)
            ],
        }
        if "word" in granularities:
            out["words"] = [
                {"word": w["word"], "start": round(w["start"], 3),
                 "end": round(w["end"], 3)}
                for w in words
            ]
        if fields.get("temperature"):
            out["temperature"] = 0.0   # timing formats decode greedily
                                       # (temperature>0 is rejected above)
        return "application/json", json.dumps(out)


class _Handler(BaseHTTPRequestHandler):
    # Set by make_server():
    service: TranscriptionService = None  # type: ignore[assignment]
    protocol_version = "HTTP/1.1"

    # -- plumbing -----------------------------------------------------------

    def log_message(self, fmt, *args):  # quiet by default
        if os.environ.get("WHISPER_TPU_HTTP_LOG"):
            sys.stderr.write(
                f"{self.address_string()} - {fmt % args}\n")

    def _send(self, status: int, content_type: str, payload) -> None:
        body = payload.encode("utf-8") if isinstance(payload, str) else payload
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_error_json(self, status: int, message: str,
                         err_type: str = "invalid_request_error") -> None:
        self._send(status, "application/json", json.dumps(
            {"error": {"message": message, "type": err_type}}))
        # Error paths may not have consumed the request body (404 route,
        # non-multipart 400, 411/413); leftover bytes would desync the
        # next request on a kept-alive connection — close instead.
        self.close_connection = True

    def _read_body(self) -> bytes:
        length = self.headers.get("Content-Length")
        if length is None:
            raise HttpError(411, "Content-Length required")
        n = int(length)
        if n > MAX_BODY_BYTES:
            raise HttpError(413, f"body exceeds {MAX_BODY_BYTES} bytes")
        return self.rfile.read(n)

    # -- routes -------------------------------------------------------------

    def do_GET(self):
        if self.path == "/healthz":
            self._send(200, "application/json", json.dumps({"status": "ok"}))
        elif self.path == "/stats":
            self._send(200, "application/json",
                       json.dumps(self.service.engine.stats))
        elif self.path == "/v1/models":
            self._send(200, "application/json", json.dumps({
                "object": "list",
                "data": [{"id": self.service.model_label, "object": "model",
                          "owned_by": "whisper_tpu"}],
            }))
        else:
            self._send_error_json(404, f"no route {self.path}")

    def do_POST(self):
        if self.path == "/v1/audio/transcriptions":
            task = "transcribe"
        elif self.path == "/v1/audio/translations":
            task = "translate"
        else:
            self._send_error_json(404, f"no route {self.path}")
            return
        try:
            ctype = self.headers.get("Content-Type", "")
            if "multipart/form-data" not in ctype:
                raise HttpError(400, "expected multipart/form-data")
            fields, files = parse_multipart(ctype, self._read_body())
            if "file" not in files:
                raise HttpError(400, "missing 'file' form part")
            filename, data = files["file"]
            audio, duration = _decode_upload(filename, data)
            if fields.get("stream", [""])[0].strip().lower() in ("1", "true"):
                self._stream_sse(audio, task, fields)
            else:
                content_type, payload = self.service.respond(
                    audio, duration, task, fields)
                self._send(200, content_type, payload)
        except HttpError as e:
            self._send_error_json(e.status, str(e), e.err_type)
        except BrokenPipeError:
            pass
        except Exception as e:  # per-request isolation, like the TCP server
            self._send_error_json(500, f"{type(e).__name__}: {e}",
                                  "server_error")

    def _stream_sse(self, audio, task: str, fields) -> None:
        """Server-sent events: one transcript.text.delta per decoded
        segment as the seek-based pipeline advances through the file, then
        transcript.text.done with the full text (the OpenAI streaming-
        transcription event shapes)."""
        language = fields.get("language", [""])[0].strip()
        prompt_ids = self.service.prompt_ids(
            fields.get("prompt", [""])[0].strip())
        if float(fields.get("temperature", ["0"])[0].strip() or 0.0) > 0.0:
            # The streaming lane decodes greedily; pretending to sample
            # would be the same lie the timing formats reject.
            raise HttpError(400, "temperature sampling is not supported "
                                 "with stream=true")
        smap = None
        if fields.get("vad_filter", [""])[0].strip().lower() in ("1", "true"):
            from whisper_tpu_torch.audio.vad import (
                collect_chunks,
                detect_speech,
            )

            audio, smap = collect_chunks(audio, detect_speech(audio))
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Connection", "close")  # length-less body
        self.end_headers()

        def write_event(obj: dict) -> None:
            self.wfile.write(f"data: {json.dumps(obj)}\n\n".encode("utf-8"))
            self.wfile.flush()

        # Decode runs on a worker thread emitting into an unbounded queue;
        # THIS thread writes to the socket.  Socket writes must not happen
        # under the service's direct-lane lock — a client that stops
        # reading (full TCP window) would otherwise hold the lock and hang
        # every other direct-lane request on the server.
        import queue as _queue
        import threading as _threading

        q: "_queue.SimpleQueue" = _queue.SimpleQueue()

        def run() -> None:
            try:
                text = self.service.transcribe_streaming(
                    audio, language, task,
                    lambda seg: q.put(("delta", seg)), prompt_ids)
                q.put(("done", text))
            except Exception as e:  # surfaced as an SSE error event
                q.put(("error", e))

        _threading.Thread(target=run, daemon=True).start()

        def t(x: float) -> float:
            # VAD: delta times are restored to ORIGINAL file time.
            return round(smap.restore_time(x) if smap is not None else x, 3)

        sent_any = False
        try:
            while True:
                kind, payload = q.get()
                if kind == "delta":
                    sent_any = True
                    write_event({"type": "transcript.text.delta",
                                 "delta": payload["text"],
                                 "start": t(payload["start"]),
                                 "end": t(payload["end"])})
                elif kind == "done":
                    if not sent_any and payload.strip():
                        # No timestamped segments (e.g. no-timestamp
                        # output): deliver the text as one delta.
                        write_event({"type": "transcript.text.delta",
                                     "delta": payload})
                    write_event({"type": "transcript.text.done",
                                 "text": payload})
                    break
                else:
                    write_event({"type": "error",
                                 "error": f"{type(payload).__name__}: "
                                          f"{payload}"})
                    break
        except OSError:
            # BrokenPipe/ConnectionReset/...: the client is gone.  Headers
            # were already sent, so no second HTTP response may be written
            # — swallow here (the worker drains the queue and exits).
            pass
        finally:
            self.close_connection = True


def make_server(service: TranscriptionService, host: str,
                port: int) -> ThreadingHTTPServer:
    handler = type("BoundHandler", (_Handler,), {"service": service})
    return ThreadingHTTPServer((host, port), handler)


def main(argv=None, *, device=None) -> int:
    from whisper_tpu_torch.serve.server import add_model_args, build_engine

    p = argparse.ArgumentParser(description=__doc__)
    add_model_args(p)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    args = p.parse_args(argv)

    engine = build_engine(args, device=device)
    label = args.model_dir or args.model_id
    service = TranscriptionService(
        engine, label,
        tokenizer_json=getattr(engine, "tokenizer_json", ""))
    print(f"Warming up the serving path on {engine.session.device} "
          f"(max_batch={engine.session.cfg.max_batch})...", flush=True)
    engine.warmup()
    httpd = make_server(service, args.host, args.port)
    print(f"Serving OpenAI-compatible API on http://{args.host}:{args.port}",
          flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        engine.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
