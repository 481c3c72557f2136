"""The port's OpenAI-compatible HTTP server against the JAX package's (CPU):
multipart parsing, every route and status code of
``whisper_tpu.serve.http_server`` over a live ThreadingHTTPServer, SSE, the
prompt field, and the response bodies of every format equal to the JAX
service's for the same audio and weights at x0 (fp32).

The model and tokenizer are ``tests/test_torch_serve.py``'s (d_model 128,
two heads of 64, two layers each side, 1500 encoder positions, vocabulary
512, special ids 400-407, one word a token).  Every socket wait has a
timeout.
"""

import dataclasses
import json
import os
import socket
import struct
import threading
import urllib.error
import urllib.request
from urllib.parse import urlparse

import numpy as np
import pytest
import torch

from whisper_tpu.runtime.session import RuntimeCfg as JaxCfg
from whisper_tpu.runtime.session import WhisperSession as JaxSession
from whisper_tpu.serve import http_server as jax_http
from whisper_tpu.serve.engine import EngineConfig as JaxEngineCfg
from whisper_tpu.serve.engine import StreamingEngine as JaxEngine
from whisper_tpu.variants.ladder import apply_variant as jax_apply_variant
from whisper_tpu_torch.models import convert
from whisper_tpu_torch.runtime.session import RuntimeCfg, WhisperSession
from whisper_tpu_torch.serve import http_server
from whisper_tpu_torch.serve.engine import EngineConfig, StreamingEngine
from whisper_tpu_torch.serve.http_server import (
    TranscriptionService,
    make_server,
    parse_multipart,
)
from whisper_tpu_torch.variants.ladder import apply_variant

from test_torch_serve import DIMS, Tok

torch.set_num_threads(2)

BOUNDARY = "whispertpuTESTboundary"
TIMEOUT = 300


def _wav_bytes(seconds=1.0, seed=0, sr=16000, audio=None):
    if audio is None:
        rng = np.random.default_rng(seed)
        audio = rng.normal(0, 0.1, int(seconds * sr)).astype(np.float32)
    pcm = np.clip(audio * 32768.0, -32768, 32767).astype("<i2").tobytes()
    hdr = struct.pack("<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + len(pcm), b"WAVE",
                      b"fmt ", 16, 1, 1, sr, sr * 2, 2, 16, b"data", len(pcm))
    return hdr + pcm


def _multipart_body(fields=None, file_bytes=None, filename="a.wav"):
    parts = []
    for k, vals in (fields or {}).items():
        for v in (vals if isinstance(vals, list) else [vals]):
            parts.append(
                (f'--{BOUNDARY}\r\nContent-Disposition: form-data; '
                 f'name="{k}"\r\n\r\n{v}\r\n').encode())
    if file_bytes is not None:
        parts.append(
            (f'--{BOUNDARY}\r\nContent-Disposition: form-data; '
             f'name="file"; filename="{filename}"\r\n'
             f'Content-Type: audio/wav\r\n\r\n').encode()
            + file_bytes + b"\r\n")
    parts.append(f"--{BOUNDARY}--\r\n".encode())
    return b"".join(parts), f"multipart/form-data; boundary={BOUNDARY}"


def _post(url, body, ctype):
    req = urllib.request.Request(
        url, data=body, headers={"Content-Type": ctype}, method="POST")
    with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
        return resp.status, resp.headers.get("Content-Type"), resp.read()


def _error(call, *args):
    """(status, JSON body) of a call that must answer with an HTTP error;
    the error response is closed here."""
    with pytest.raises(urllib.error.HTTPError) as exc:
        call(*args)
    with exc.value as err:
        return err.code, json.load(err)


def _get(url):
    with urllib.request.urlopen(url, timeout=TIMEOUT) as r:
        return json.load(r)


class TestMultipartParser:
    def test_fields_files_and_repeats(self):
        body, ctype = _multipart_body(
            fields={"model": "whisper-1",
                    "timestamp_granularities[]": ["word", "segment"]},
            file_bytes=b"RIFFxxxx", filename="x.wav")
        fields, files = parse_multipart(ctype, body)
        assert fields["model"] == ["whisper-1"]
        assert fields["timestamp_granularities[]"] == ["word", "segment"]
        assert files["file"] == ("x.wav", b"RIFFxxxx")
        assert (fields, files) == jax_http.parse_multipart(ctype, body)

    def test_binary_file_survives(self):
        blob = bytes(range(256)) * 3
        body, ctype = _multipart_body(file_bytes=blob)
        assert parse_multipart(ctype, body)[1]["file"][1] == blob

    def test_not_multipart_is_a_400(self):
        with pytest.raises(http_server.HttpError) as e:
            parse_multipart("text/plain", b"x")
        assert e.value.status == 400


def _x0(cls, apply, **over):
    cfg, _ = apply(cls(), "x0")
    return dataclasses.replace(cfg, **over)


@pytest.fixture(scope="module")
def params():
    return convert.init_params(DIMS, seed=0)


@pytest.fixture(scope="module")
def service(params):
    session = WhisperSession(params, DIMS,
                             _x0(RuntimeCfg, apply_variant, max_batch=4),
                             device="cpu")
    engine = StreamingEngine(session, Tok(), EngineConfig(
        max_new_tokens=3, batch_window_ms=2))
    try:
        yield TranscriptionService(engine, "toy/whisper")
    finally:
        engine.close()


@pytest.fixture(scope="module")
def server_url(service):
    httpd = make_server(service, "127.0.0.1", 0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=10)
        assert not t.is_alive()


@pytest.fixture(scope="module")
def jax_service(params):
    session = JaxSession(params, DIMS,
                         _x0(JaxCfg, jax_apply_variant, max_batch=4))
    engine = JaxEngine(session, Tok(), JaxEngineCfg(max_new_tokens=3,
                                                    batch_window_ms=2))
    try:
        yield jax_http.TranscriptionService(engine, "toy/whisper")
    finally:
        engine.close()


class TestRoutes:
    def test_healthz_and_models(self, server_url):
        assert _get(server_url + "/healthz") == {"status": "ok"}
        assert _get(server_url + "/v1/models") == {
            "object": "list", "data": [{"id": "toy/whisper",
                                        "object": "model",
                                        "owned_by": "whisper_tpu"}]}

    def test_transcription_json_default(self, server_url):
        body, ctype = _multipart_body(fields={"model": "whisper-1"},
                                      file_bytes=_wav_bytes(1.0))
        status, rtype, payload = _post(
            server_url + "/v1/audio/transcriptions", body, ctype)
        assert status == 200 and rtype.startswith("application/json")
        out = json.loads(payload)
        assert set(out) == {"text"} and isinstance(out["text"], str)

    def test_transcription_text_format(self, server_url):
        body, ctype = _multipart_body(
            fields={"response_format": "text"}, file_bytes=_wav_bytes(1.0))
        status, rtype, payload = _post(
            server_url + "/v1/audio/transcriptions", body, ctype)
        assert status == 200 and rtype.startswith("text/plain")
        assert payload.endswith(b"\n")

    def test_transcription_srt_and_vtt(self, server_url):
        for fmt, expect in (("srt", None), ("vtt", b"WEBVTT")):
            body, ctype = _multipart_body(
                fields={"response_format": fmt}, file_bytes=_wav_bytes(1.0))
            status, _, payload = _post(
                server_url + "/v1/audio/transcriptions", body, ctype)
            assert status == 200
            if expect:
                assert payload.startswith(expect)
            if b"-->" in payload:
                sep = b"," if fmt == "srt" else b"."
                assert sep in payload.split(b"-->")[0][-6:]

    def test_verbose_json_shape(self, server_url):
        body, ctype = _multipart_body(
            fields={"response_format": "verbose_json",
                    "timestamp_granularities[]": ["word", "segment"],
                    "temperature": "0"},
            file_bytes=_wav_bytes(1.5))
        status, _, payload = _post(
            server_url + "/v1/audio/transcriptions", body, ctype)
        assert status == 200
        out = json.loads(payload)
        assert out["task"] == "transcribe" and out["language"] == "en"
        assert out["duration"] == pytest.approx(1.5, abs=0.01)
        assert out["temperature"] == 0.0 and "words" in out
        for seg in out["segments"]:
            assert {"id", "start", "end", "text"} <= set(seg)

    def test_translation_route(self, server_url):
        body, ctype = _multipart_body(
            fields={"response_format": "verbose_json"},
            file_bytes=_wav_bytes(1.0))
        status, _, payload = _post(
            server_url + "/v1/audio/translations", body, ctype)
        assert status == 200
        assert json.loads(payload)["task"] == "translate"

    def test_language_override_uses_direct_path(self, server_url):
        body, ctype = _multipart_body(
            fields={"language": "de"}, file_bytes=_wav_bytes(1.0))
        status, _, payload = _post(
            server_url + "/v1/audio/transcriptions", body, ctype)
        assert status == 200 and "text" in json.loads(payload)

    def test_temperature_sampling_path(self, server_url):
        body, ctype = _multipart_body(
            fields={"temperature": "0.7"}, file_bytes=_wav_bytes(1.0))
        status, _, payload = _post(
            server_url + "/v1/audio/transcriptions", body, ctype)
        assert status == 200
        assert isinstance(json.loads(payload)["text"], str)

    @pytest.mark.parametrize("fields,status,words", [
        ({"temperature": "0.5", "response_format": "verbose_json"}, 400,
         "timing formats"),
        ({"temperature": "warm"}, 400, "number"),
        ({"response_format": "yaml"}, 400, "response_format"),
        ({"prompt": "technical jargon"}, 400, "tokenizer"),
        ({"stream": "true", "temperature": "0.5"}, 400, "stream=true"),
        ({"model": "whisper-1"}, 400, "'file'"),
    ])
    def test_4xx_bodies(self, server_url, fields, status, words):
        body, ctype = _multipart_body(
            fields=fields,
            file_bytes=None if "model" in fields else _wav_bytes(0.5))
        code, out = _error(_post, server_url + "/v1/audio/transcriptions",
                           body, ctype)
        assert code == status
        err = out["error"]
        assert err["type"] == "invalid_request_error"
        assert words in err["message"]

    def test_empty_upload_and_undecodable_upload_400(self, server_url):
        for blob in (b"", b"not a wav at all"):
            body, ctype = _multipart_body(file_bytes=blob)
            assert _error(_post, server_url + "/v1/audio/transcriptions",
                          body, ctype)[0] == 400

    def test_error_response_closes_connection(self, server_url):
        u = urlparse(server_url)
        body, ctype = _multipart_body(file_bytes=_wav_bytes(0.2))
        req = (f"POST /nope HTTP/1.1\r\nHost: {u.hostname}\r\n"
               f"Content-Type: {ctype}\r\n"
               f"Content-Length: {len(body)}\r\n\r\n").encode() + body
        with socket.create_connection((u.hostname, u.port),
                                      timeout=30) as s:
            s.sendall(req)
            s.settimeout(30)
            data = b""
            while True:
                chunk = s.recv(65536)
                if not chunk:
                    break
                data += chunk
        assert data.startswith(b"HTTP/1.1 404")
        assert data.count(b"HTTP/1.1") == 1

    def test_missing_content_length_411(self, server_url):
        u = urlparse(server_url)
        _, ctype = _multipart_body(file_bytes=b"x")
        req = (f"POST /v1/audio/transcriptions HTTP/1.1\r\n"
               f"Host: {u.hostname}\r\nContent-Type: {ctype}\r\n\r\n"
               ).encode()
        with socket.create_connection((u.hostname, u.port),
                                      timeout=30) as s:
            s.sendall(req)
            s.settimeout(30)
            data = s.recv(65536)
        assert data.startswith(b"HTTP/1.1 411")

    def test_vad_filter_silence_yields_empty(self, server_url):
        body, ctype = _multipart_body(
            fields={"vad_filter": "true",
                    "response_format": "verbose_json",
                    "timestamp_granularities[]": "word"},
            file_bytes=_wav_bytes(audio=np.zeros(24000, np.float32)))
        status, _, payload = _post(
            server_url + "/v1/audio/transcriptions", body, ctype)
        assert status == 200
        out = json.loads(payload)
        assert out["text"] == "" and out["segments"] == []
        assert out["words"] == []
        assert out["duration"] == pytest.approx(1.5, abs=0.01)

    def test_vad_filter_speech_transcribes(self, server_url):
        t = np.arange(16000) / 16000
        audio = np.concatenate(
            [np.zeros(16000, np.float32),
             (0.3 * np.sin(2 * np.pi * 440 * t)).astype(np.float32),
             np.zeros(16000, np.float32)])
        body, ctype = _multipart_body(fields={"vad_filter": "true"},
                                      file_bytes=_wav_bytes(audio=audio))
        status, _, payload = _post(
            server_url + "/v1/audio/transcriptions", body, ctype)
        assert status == 200
        assert isinstance(json.loads(payload)["text"], str)

    def test_non_multipart_400(self, server_url):
        req = urllib.request.Request(
            server_url + "/v1/audio/transcriptions", data=b"{}",
            headers={"Content-Type": "application/json"}, method="POST")
        assert _error(lambda: urllib.request.urlopen(req, timeout=60))[0] \
            == 400

    def test_unknown_routes_404(self, server_url):
        assert _error(lambda: urllib.request.urlopen(server_url + "/nope",
                                                     timeout=60))[0] == 404
        body, ctype = _multipart_body(file_bytes=_wav_bytes(0.2))
        assert _error(_post, server_url + "/v1/audio/nope", body,
                      ctype)[0] == 404

    def test_stats_endpoint(self, server_url):
        stats = _get(server_url + "/stats")
        assert {"batches", "longform", "speculative"} <= set(stats)

    def test_streaming_sse(self, server_url):
        body, ctype = _multipart_body(
            fields={"stream": "true"}, file_bytes=_wav_bytes(1.0))
        req = urllib.request.Request(
            server_url + "/v1/audio/transcriptions", data=body,
            headers={"Content-Type": ctype}, method="POST")
        with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
            assert resp.status == 200
            assert resp.headers["Content-Type"].startswith(
                "text/event-stream")
            raw = resp.read().decode()
        events = [json.loads(line[6:]) for line in raw.splitlines()
                  if line.startswith("data: ")]
        assert events, raw
        assert events[-1]["type"] == "transcript.text.done"
        assert isinstance(events[-1]["text"], str)
        for ev in events[:-1]:
            assert ev["type"] == "transcript.text.delta"
            assert isinstance(ev["delta"], str)


# ---------------------------------------------------------------------------
# The bodies equal the JAX server's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route,fields", [
    ("transcriptions", {"response_format": "json"}),
    ("transcriptions", {"response_format": "text"}),
    ("transcriptions", {"response_format": "srt"}),
    ("transcriptions", {"response_format": "vtt"}),
    ("transcriptions", {"response_format": "verbose_json",
                        "timestamp_granularities[]": ["word", "segment"]}),
    ("translations", {"response_format": "verbose_json",
                      "timestamp_granularities[]": "word"}),
    ("transcriptions", {"response_format": "json", "language": "de"}),
])
def test_bodies_equal_the_jax_servers(server_url, jax_service, route,
                                      fields):
    """x0 on both sides: the same upload gives the same content type and
    the same body, byte for byte; words come from DTW over each package's
    own alignment weights."""
    wav = _wav_bytes(2.0, seed=3)
    body, ctype = _multipart_body(fields=fields, file_bytes=wav)
    status, rtype, payload = _post(f"{server_url}/v1/audio/{route}", body,
                                   ctype)
    assert status == 200
    f, files = jax_http.parse_multipart(ctype, body)
    audio, duration = jax_http._decode_upload(*files["file"])
    task = "translate" if route == "translations" else "transcribe"
    want_type, want = jax_service.respond(audio, duration, task, f)
    assert rtype == want_type
    assert payload.decode("utf-8") == want


class TestPromptField:
    def test_prompt_ids_equal_jax_and_reach_the_direct_lane(
            self, tmp_path, monkeypatch):
        """A tokenizer built inside the test: the port encodes the prompt
        field as the JAX service does, and the ids reach the long-form
        pipeline as its initial prompt."""
        pytest.importorskip("tokenizers")
        from tokenizers import (
            Tokenizer,
            decoders,
            models,
            pre_tokenizers,
            trainers,
        )

        tok = Tokenizer(models.BPE())
        tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
        tok.decoder = decoders.ByteLevel()
        tok.train_from_iterator(
            ["hello proper nouns like Kubernetes"],
            trainers.BpeTrainer(
                vocab_size=400,
                initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
        path = str(tmp_path / "tokenizer.json")
        tok.save(path)

        captured = {}

        def fake_longform(session, audio, language, task, *a, **k):
            captured["prompt_ids"] = k.get("initial_prompt_ids")
            return "ok", None

        monkeypatch.setattr(http_server, "transcribe_longform",
                            fake_longform)
        svc = TranscriptionService(_FakeEngine(), "m", tokenizer_json=path)
        jsvc = jax_http.TranscriptionService(_FakeEngine(), "m",
                                             tokenizer_json=path)
        ids = svc.prompt_ids("hello Kubernetes")
        assert ids and ids == jsvc.prompt_ids("hello Kubernetes")
        assert svc.prompt_ids("") is None
        text = svc.transcribe_text(np.zeros(16000, np.float32), "",
                                   "transcribe", ids)
        assert text == "ok" and captured["prompt_ids"] == ids


class _FakeEngine:
    class cfg:
        language, task, max_new_tokens = "en", "transcribe", 8
        chunk_length_s, overlap_s = 30.0, 5.0
    tokenizer = None
    gen_cfg = None
    session = None


class TestStreamingPlumbing:
    def test_delta_events_flow_through_emit(self, monkeypatch):
        def fake_sequential(session, audio, language, task, max_new,
                            tokenizer, gen_cfg, segment_callback=None,
                            **kwargs):
            segment_callback([{"start": 0.0, "end": 1.2, "text": "hello"}])
            segment_callback([{"start": 1.2, "end": 2.0, "text": "world"}])
            return "hello world", [], None

        monkeypatch.setattr(http_server, "transcribe_sequential",
                            fake_sequential)
        svc = TranscriptionService(_FakeEngine(), "m")
        got = []
        text = svc.transcribe_streaming(
            np.zeros(16000, np.float32), "", "transcribe", got.append)
        assert text == "hello world"
        assert [g["text"] for g in got] == ["hello", "world"]

    def test_segment_callback_matches_segments(self, params):
        from whisper_tpu_torch.pipeline.sequential import (
            transcribe_sequential,
        )

        session = WhisperSession(params, DIMS,
                                 _x0(RuntimeCfg, apply_variant, max_batch=2),
                                 device="cpu")
        audio = np.random.default_rng(3).normal(0, 0.1, 32000)
        streamed = []
        text, segments, _ = transcribe_sequential(
            session, audio.astype(np.float32), "en", "transcribe",
            max_new_tokens=4, tokenizer=Tok(),
            segment_callback=streamed.extend)
        assert len(streamed) == len(segments)
        for got, seg in zip(streamed, segments):
            assert got["start"] == seg.start_s and got["end"] == seg.end_s
            assert isinstance(got["text"], str)


def test_example_client_talks_to_the_port(server_url, tmp_path):
    """examples/http_client.py builds a body the port's server accepts."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "http_client_example",
        os.path.join(os.path.dirname(__file__), "..", "examples",
                     "http_client.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    wav = tmp_path / "x.wav"
    wav.write_bytes(_wav_bytes(0.5))
    body, ctype = mod.multipart(
        {"model": "whisper-1", "response_format": "json"}, str(wav))
    status, _, payload = _post(server_url + "/v1/audio/transcriptions",
                               body, ctype)
    assert status == 200 and "text" in json.loads(payload)
