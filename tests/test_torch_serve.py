"""The port's serving path against the JAX package's (CPU): the session's
short path, the continuous-batching engine, the JSON-lines TCP server and
the router.

The model is ``tests/test_torch_slice.py``'s (d_model 128, two heads of 64,
two encoder and two decoder layers, the encoder's full 1500 positions) with
a vocabulary of 512, so that the special tokens of ``Tok`` and a range of
timestamp tokens fit it.  Same weights (``init_params(DIMS, seed=0)``) and
the same audio, made from a seed with numpy, go through both packages; at
x0 (fp32) the tokens must be EQUAL, at x5 each row's chain equals JAX's or
first diverges where JAX's top-2 margin is below LOGIT_TOL (a tie-flip), as
``tests/test_torch_rungs.py`` holds that rung.  The JAX side runs as its own
tests run it on the CPU (Pallas in interpret mode).  The engine, server and
router cases are tests/test_serve.py's, on the port.  Every socket wait
has a timeout.
"""

import argparse
import asyncio
import base64
import dataclasses
import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisper_tpu.frontend.mel import log_mel_jax
from whisper_tpu.models import whisper as jw
from whisper_tpu.ops.self_attention import pack_self_cache
from whisper_tpu.runtime.session import RuntimeCfg as JaxCfg
from whisper_tpu.runtime.session import WhisperSession as JaxSession
from whisper_tpu.variants.ladder import apply_variant as jax_apply_variant
from whisper_tpu_torch.frontend import golden
from whisper_tpu_torch.models import convert
from whisper_tpu_torch.models.registry import WhisperDims
from whisper_tpu_torch.pipeline.chunk import CHUNK_FRAMES
from whisper_tpu_torch.runtime.session import RuntimeCfg, WhisperSession
from whisper_tpu_torch.serve.engine import EngineConfig, StreamingEngine
from whisper_tpu_torch.variants.ladder import apply_variant

torch.set_num_threads(2)

DIMS = WhisperDims(n_mels=80, d_model=128, encoder_layers=2, encoder_heads=2,
                   decoder_layers=2, decoder_heads=2, vocab_size=512,
                   max_source_positions=1500, max_target_positions=64)
PAD_LEN = CHUNK_FRAMES * 160 + 400     # the full 30 s window, reflect-padded
LOGIT_TOL = 2e-2                       # test_torch_rungs.py's
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOCKET_TIMEOUT = 120


class Tok:
    """Special ids inside the 512-token vocabulary; every other id decodes
    to " w<id>", one word a token."""

    ids = {"<|endoftext|>": 400, "<|startoftranscript|>": 401,
           "<|en|>": 402, "<|de|>": 403, "<|translate|>": 404,
           "<|transcribe|>": 405, "<|startofprev|>": 406,
           "<|notimestamps|>": 407}

    def token_to_id(self, t):
        return self.ids.get(t)

    def decode(self, ids, skip_special_tokens=True, **_):
        return "".join(f" w{int(i)}" for i in ids
                       if not (skip_special_tokens and int(i) >= 400))


PROMPT = [401, 402, 405, 407]
EOT = 400


def _audio(seconds, seed=0):
    rng = np.random.default_rng(seed)
    n = int(seconds * 16000)
    t = np.arange(n) / 16000.0
    return (0.2 * np.sin(2 * np.pi * (200 + 40 * seed) * t)
            + rng.normal(0, 0.05, n)).astype(np.float32)


def _rows(clips, ship_len):
    """The engine's tick layout: reflect-padded rows in [B, ship_len]."""
    audio = np.zeros((len(clips), ship_len), dtype=np.float32)
    n_valid = np.zeros(len(clips), dtype=np.int32)
    for i, c in enumerate(clips):
        p = golden.reflect_pad(c)
        audio[i, :len(p)] = p
        n_valid[i] = golden.num_frames(len(c))
    return audio, n_valid


@pytest.fixture(scope="module")
def params():
    return convert.init_params(DIMS, seed=0)


def _cfgs(rung, **over):
    jcfg, _ = jax_apply_variant(JaxCfg(), rung)
    tcfg, _ = apply_variant(RuntimeCfg(), rung)
    return (dataclasses.replace(jcfg, **over),
            dataclasses.replace(tcfg, **over))


@pytest.fixture(scope="module")
def sess(params):
    """The port at x0 (fp32), max_batch 4: the engine's session."""
    return WhisperSession(params, DIMS, _cfgs("x0", max_batch=4)[1],
                          device="cpu")


# ---------------------------------------------------------------------------
# The session's short path against JAX
# ---------------------------------------------------------------------------

CLIPS = [_audio(1.0, 0), _audio(2.5, 1), _audio(3.6, 2)]


@pytest.mark.parametrize("wire", ["int16", "float32"])
def test_short_batch_equals_jax_trimmed_full_and_over_the_window(params,
                                                                 wire):
    """x0: the port's tokens equal JAX's full-width tokens at the full
    width, at the engine's 1/8 trimmed width (the zero tail made on the
    device after the wire decode) and for rows shipped past the window
    (cut back to it: the samples past it must not count)."""
    jcfg, tcfg = _cfgs("x0", max_batch=4, audio_transfer=wire)
    jsess = JaxSession(params, DIMS, jcfg)
    tsess = WhisperSession(params, DIMS, tcfg, device="cpu")
    full, n_valid = _rows(CLIPS, PAD_LEN)
    want = np.asarray(jsess.transcribe_short_batch(full, n_valid, PROMPT, 6,
                                                   EOT))
    trimmed, _ = _rows(CLIPS, PAD_LEN // 8)
    over = np.concatenate(
        [full, np.random.default_rng(9).normal(0, 0.5, (3, 800))
         .astype(np.float32)], axis=1)
    for audio in (full, trimmed, over):
        got = tsess.transcribe_short_batch(audio, n_valid, PROMPT, 6, EOT)
        assert got.dtype == np.int32 and got.shape == (3, 6)
        np.testing.assert_array_equal(got, want)


def _jax_short_replay(jsess, audio, n_valid, max_new):
    """JAX's x5 greedy chain over a short batch, step by step as its
    ``greedy_generate`` runs it: per-step logits [max_new, B, V], tokens."""
    p = jsess.params
    a = jnp.asarray(audio)
    mel = jax.vmap(lambda x, v: log_mel_jax(x, v, n_mels=DIMS.n_mels,
                                            n_frames=CHUNK_FRAMES))(
        a, jnp.asarray(n_valid))
    enc = jw.encoder_apply(p, DIMS, mel, fused_attention=True,
                           fused_mlp=True)
    b = audio.shape[0]
    prompt = jnp.asarray([PROMPT] * b, jnp.int32)
    logits, cache = jw.decoder_prefill(p, DIMS, prompt, enc,
                                       len(PROMPT) + max_new,
                                       int8_cross_kv=True)
    cache = jw.pack_cross_cache(cache, transpose_k=True)
    cache = cache._replace(self_k=pack_self_cache(cache.self_k),
                           self_v=pack_self_cache(cache.self_v))
    steps = [np.asarray(logits[:, -1].astype(jnp.float32))]
    toks = [steps[0].argmax(-1)]
    for i in range(1, max_new):
        lg, cache = jw.decoder_step(
            p, DIMS, jnp.asarray(toks[-1], jnp.int32),
            jnp.int32(len(PROMPT) + i - 1), cache,
            cross_len=DIMS.max_source_positions, int8_mxu=True)
        steps.append(np.asarray(lg.astype(jnp.float32)))
        toks.append(steps[-1].argmax(-1))
    return np.stack(steps), np.stack(toks, axis=1)


def test_short_batch_x5_rows_hold_to_jax(params):
    """x5 (B1, B2, B3, B4's plain versions here): each row's chain equals
    JAX's or first diverges at a tie-flip; JAX's replay is its own short
    program's chain."""
    max_new = 5
    jcfg, tcfg = _cfgs("x5", max_batch=2, audio_transfer="float32")
    jsess = JaxSession(params, DIMS, jcfg)
    tsess = WhisperSession(params, DIMS, tcfg, device="cpu")
    audio, n_valid = _rows(CLIPS[:2], PAD_LEN)
    no_suppress = dict(suppress_ids=[], begin_suppress_ids=[])
    want = np.asarray(jsess.transcribe_short_batch(
        audio, n_valid, PROMPT, max_new, EOT, **no_suppress))
    logits_j, toks_j = _jax_short_replay(jsess, audio, n_valid, max_new)
    for r in range(2):    # the replay is the program's chain up to its EOT
        stop = list(want[r]).index(EOT) + 1 if EOT in want[r] else max_new
        np.testing.assert_array_equal(toks_j[r, :stop], want[r, :stop])
    got = tsess.transcribe_short_batch(audio, n_valid, PROMPT, max_new, EOT,
                                       **no_suppress)
    for r in range(2):
        diff = np.nonzero(got[r] != want[r])[0]
        if diff.size:
            i = diff[0]
            top2 = np.sort(logits_j[i, r])[-2:]
            assert top2[1] - top2[0] < LOGIT_TOL, (r, i, top2)


def test_short_speculative_equals_short_batch(params):
    """The speculative leg (a random one-layer draft) gives the greedy
    tokens, and without a draft it raises as the JAX session does."""
    tsess = WhisperSession(params, DIMS, _cfgs("x0", max_batch=4)[1],
                           device="cpu")
    audio, n_valid = _rows(CLIPS, PAD_LEN // 8)
    with pytest.raises(RuntimeError, match="no draft model"):
        tsess.transcribe_short_speculative(audio, n_valid, PROMPT, 6, EOT)
    greedy = tsess.transcribe_short_batch(audio, n_valid, PROMPT, 6, EOT)
    ddims = dataclasses.replace(DIMS, encoder_layers=1, decoder_layers=1)
    tsess.set_draft_model(convert.init_params(ddims, seed=3), ddims)
    spec = tsess.transcribe_short_speculative(audio, n_valid, PROMPT, 6, EOT,
                                              draft_k=3)
    assert spec.dtype == np.int32
    np.testing.assert_array_equal(spec, greedy)


def test_transcribe_chunks_and_warmup_equal_jax(params):
    """Three mel chunks at max_batch 2: a bucket of 2 and a bucket of 1
    padded with zero rows, as in the JAX session."""
    jcfg, tcfg = _cfgs("x0", max_batch=2)
    jsess = JaxSession(params, DIMS, jcfg)
    tsess = WhisperSession(params, DIMS, tcfg, device="cpu")
    mel = np.random.default_rng(4).uniform(-1, 1, (3, 80, CHUNK_FRAMES))
    mel = mel.astype(np.float32)
    want = jsess.transcribe_chunks(mel, PROMPT, 5, EOT)
    got = tsess.transcribe_chunks(mel, PROMPT, 5, EOT)
    assert got.dtype == np.int32 and got.shape == (3, 5)
    np.testing.assert_array_equal(got, want)
    assert tsess.warmup(3, PROMPT, 5, EOT) is None
    with pytest.raises(ValueError, match="3000"):
        tsess.transcribe_chunks(mel[:, :, :100], PROMPT, 5, EOT)


def test_short_path_takes_the_plain_mel_not_b5(params, monkeypatch):
    """x5's fused front end is the one-shot path's; the short batch takes
    the plain mel, as the JAX short program calls log_mel_jax."""
    from whisper_tpu_torch.ops import log_mel

    tsess = WhisperSession(params, DIMS, _cfgs("x5", max_batch=2)[1],
                           device="cpu")
    assert tsess.cfg.fused_frontend
    called = []
    monkeypatch.setattr(log_mel, "log_mel",
                        lambda *a, **k: called.append(1) / 0)
    audio, n_valid = _rows(CLIPS[:1], PAD_LEN // 8)
    assert tsess.transcribe_short_batch(audio, n_valid, PROMPT, 2,
                                        EOT).shape == (1, 2)
    assert not called


# ---------------------------------------------------------------------------
# The engine (tests/test_serve.py's cases)
# ---------------------------------------------------------------------------

def _engine(sess, **cfg):
    return StreamingEngine(sess, Tok(), EngineConfig(**cfg))


class TestEngine:
    def test_concurrent_short_requests_batched(self, sess):
        eng = _engine(sess, max_new_tokens=3, batch_window_ms=50)
        try:
            eng.warmup(batch=4)
            futs = [eng.submit(_audio(2.0, seed=i)) for i in range(4)]
            texts = [f.result(timeout=120) for f in futs]
            assert len(texts) == 4 and all(isinstance(t, str) for t in texts)
            assert eng.stats["batched_requests"] == 4
            assert eng.stats["batches"] <= 2
        finally:
            eng.close()

    def test_tick_pipeline_burst_resolves_all(self, sess):
        eng = _engine(sess, max_new_tokens=3, batch_window_ms=5)
        try:
            futs = [eng.submit(_audio(1.0, seed=i)) for i in range(12)]
            texts = [f.result(timeout=300) for f in futs]
            assert len(texts) == 12
            assert eng.stats["batched_requests"] == 12
            assert eng.stats["batches"] >= 3
            lone = eng.transcribe(_audio(1.0, seed=0), timeout=300)
            assert lone == texts[0]
        finally:
            eng.close()

    def test_batched_results_match_individual_and_the_session(self, sess):
        eng = _engine(sess, max_new_tokens=4, batch_window_ms=50)
        try:
            a0, a1 = _audio(1.5, seed=7), _audio(2.5, seed=8)
            t0, t1 = eng.transcribe(a0), eng.transcribe(a1)
            got = [f.result(timeout=120)
                   for f in (eng.submit(a0), eng.submit(a1))]
            assert got == [t0, t1]
            audio, n_valid = _rows([a0], PAD_LEN)
            toks = sess.transcribe_short_batch(
                audio, n_valid, PROMPT, 4, EOT,
                suppress_ids=eng.gen_cfg.suppress_tokens,
                begin_suppress_ids=eng.gen_cfg.begin_suppress_tokens)[0]
            row = list(toks[:list(toks).index(EOT)] if EOT in toks else toks)
            assert t0 == Tok().decode(row).strip()
        finally:
            eng.close()

    def test_long_request_does_not_block_short_lane(self, sess):
        eng = _engine(sess, max_new_tokens=3, batch_window_ms=20)
        try:
            long_fut = eng.submit(_audio(95.0, seed=5))  # 4 chunks of work
            short_futs = [eng.submit(_audio(1.5, seed=i)) for i in range(4)]
            for f in short_futs:
                f.result(timeout=120)
            assert isinstance(long_fut.result(timeout=300), str)
            assert eng.stats["longform"] == 1
            assert eng.stats["batched_requests"] == 4
        finally:
            eng.close()

    def test_long_request_text_is_the_longform_text(self, sess):
        from whisper_tpu_torch.pipeline.longform import transcribe_longform

        eng = _engine(sess, max_new_tokens=3)
        try:
            audio = _audio(40.0, seed=2)
            text = eng.transcribe(audio)
            want, _ = transcribe_longform(sess, audio, "en", "transcribe", 3,
                                          30.0, 5.0, Tok(), False,
                                          eng.gen_cfg)
            assert text == want and eng.stats["longform"] == 1
        finally:
            eng.close()

    def test_error_isolation(self, sess):
        eng = _engine(sess, max_new_tokens=2)
        try:
            bad = eng.submit(np.zeros(0, dtype=np.float32))
            with pytest.raises(ValueError, match="Empty audio"):
                bad.result(timeout=60)
            assert isinstance(eng.transcribe(_audio(1.0, seed=3)), str)
        finally:
            eng.close()

    def test_a_failing_tick_fails_its_futures_and_serving_goes_on(
            self, sess, monkeypatch):
        eng = _engine(sess, max_new_tokens=2, batch_window_ms=2)
        real = sess.transcribe_short_batch_async
        calls = []

        def once_broken(*a, **k):
            calls.append(1)
            if len(calls) == 1:
                raise RuntimeError("kernel refused")
            return real(*a, **k)

        try:
            monkeypatch.setattr(sess, "transcribe_short_batch_async",
                                once_broken)
            with pytest.raises(RuntimeError, match="kernel refused"):
                eng.transcribe(_audio(1.0, seed=1))
            assert isinstance(eng.transcribe(_audio(1.0, seed=1)), str)
        finally:
            eng.close()

    def test_speculative_leg_with_a_draft(self, params):
        tsess = WhisperSession(params, DIMS, _cfgs("x0", max_batch=4)[1],
                               device="cpu")
        eng = _engine(tsess, max_new_tokens=4, batch_window_ms=20)
        try:
            clips = [_audio(1.0 + i, seed=i) for i in range(3)]
            greedy = [f.result(timeout=120)
                      for f in [eng.submit(c) for c in clips]]
            ddims = dataclasses.replace(DIMS, decoder_layers=1)
            tsess.set_draft_model(convert.init_params(ddims, seed=3), ddims)
            spec = [f.result(timeout=120)
                    for f in [eng.submit(c) for c in clips]]
            assert spec == greedy and eng.stats["speculative"] == 3
        finally:
            eng.close()


class TestTrimmedUpload:
    def test_engine_ships_subbucket(self, sess, monkeypatch):
        shapes = []
        orig = sess.transcribe_short_batch_async

        def spy(audio, *a, **k):
            shapes.append(audio.shape)
            return orig(audio, *a, **k)

        eng = _engine(sess, max_new_tokens=3, batch_window_ms=2)
        try:
            monkeypatch.setattr(sess, "transcribe_short_batch_async", spy)
            trimmed = eng.transcribe(_audio(1.5))
            assert shapes[-1][1] == PAD_LEN // 8
            eng.cfg.trim_upload = False
            assert eng.transcribe(_audio(1.5)) == trimmed
            assert shapes[-1][1] == PAD_LEN
        finally:
            eng.close()

    @pytest.mark.parametrize("need,want", [
        (1, PAD_LEN // 8), (PAD_LEN // 8, PAD_LEN // 8),
        (PAD_LEN // 8 + 1, PAD_LEN // 4), (PAD_LEN // 2, PAD_LEN // 2),
        (PAD_LEN // 2 + 1, PAD_LEN), (PAD_LEN, PAD_LEN)])
    def test_ship_len_quantizes_as_jax(self, sess, need, want):
        from whisper_tpu.serve.engine import StreamingEngine as JaxEngine

        assert StreamingEngine._ship_len(_ShipLen(), need) == want
        assert JaxEngine._ship_len(_ShipLen(), need) == want


class _ShipLen:
    """What ``_ship_len`` reads of an engine: the 30 s window."""
    _short_limit = 30 * 16000


class TestEngineLifecycle:
    def test_submit_after_close_fails_fast(self, sess):
        eng = _engine(sess, max_new_tokens=3)
        eng.close()
        with pytest.raises(RuntimeError, match="closed"):
            eng.submit(_audio(1.0)).result(timeout=5)

    def test_tick_bucket_clamped_to_non_pow2_max_batch(self, sess,
                                                      monkeypatch):
        monkeypatch.setattr(
            sess, "cfg", dataclasses.replace(sess.cfg, max_batch=3))
        eng = _engine(sess, max_new_tokens=3, batch_window_ms=50)
        shapes = []
        orig = sess.transcribe_short_batch_async

        def spy(audio, *a, **k):
            shapes.append(audio.shape)
            return orig(audio, *a, **k)

        try:
            monkeypatch.setattr(sess, "transcribe_short_batch_async", spy)
            for f in [eng.submit(_audio(1.0, seed=i)) for i in range(3)]:
                f.result(timeout=300)
            assert shapes and all(s[0] <= 3 for s in shapes)
        finally:
            eng.close()


# ---------------------------------------------------------------------------
# TCP server and router
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_async_server(coro_fn, ready_timeout=30):
    """Run coro_fn(ready_event) on a daemon thread's loop; returns stop()."""
    ready = threading.Event()
    holder = {}

    def run_loop():
        async def main():
            class Ev:
                def set(self):
                    ready.set()

            holder["loop"] = asyncio.get_running_loop()
            holder["task"] = asyncio.current_task()
            try:
                await coro_fn(Ev())
            except asyncio.CancelledError:
                pass

        asyncio.run(main())

    t = threading.Thread(target=run_loop, daemon=True)
    t.start()
    assert ready.wait(timeout=ready_timeout)

    def stop():
        holder["loop"].call_soon_threadsafe(holder["task"].cancel)
        t.join(timeout=10)
        assert not t.is_alive()

    return stop


def _start_server(eng, port):
    from whisper_tpu_torch.serve.server import serve

    return _run_async_server(lambda ev: serve(eng, "127.0.0.1", port, ev))


def _ask(port, payload, timeout=SOCKET_TIMEOUT):
    with socket.create_connection(("127.0.0.1", port),
                                  timeout=timeout) as s:
        s.settimeout(timeout)
        s.sendall((json.dumps(payload) + "\n").encode())
        buf = b""
        while not buf.endswith(b"\n"):
            chunk = s.recv(1 << 20)
            if not chunk:
                break
            buf += chunk
    return json.loads(buf)


def _pcm(i, seconds=1.0):
    return (np.clip(_audio(seconds, seed=i), -1, 1) * 32767).astype("<i2")


def _pcm_request(i, seconds=1.0):
    return {"id": f"r{i}",
            "pcm16_b64": base64.b64encode(_pcm(i, seconds).tobytes()).decode()}


def _decoded(i, seconds=1.0):
    """The audio the server decodes from ``_pcm_request(i)``."""
    return _pcm(i, seconds).astype(np.float32) / 32768.0


class TestServer:
    def test_tcp_roundtrip_concurrent_clients_and_stats(self, sess):
        eng = _engine(sess, max_new_tokens=3, batch_window_ms=30)
        port = _free_port()
        stop = _start_server(eng, port)
        try:
            out = {}
            threads = [threading.Thread(
                target=lambda i=i: out.__setitem__(
                    i, _ask(port, _pcm_request(i)))) for i in range(3)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=SOCKET_TIMEOUT)
                assert not th.is_alive()
            assert set(out) == {0, 1, 2}
            for i, resp in out.items():
                assert resp["id"] == f"r{i}" and "error" not in resp
                assert resp["latency_s"] >= 0
                assert resp["text"] == eng.transcribe(_decoded(i))
            stats = _ask(port, {"id": "q", "stats": True})
            assert stats["id"] == "q"
            assert set(stats["stats"]) >= {"batches", "batched_requests",
                                           "longform", "speculative"}
            bad = _ask(port, {"id": "b"})
            assert bad == {"id": "b",
                           "error": "request needs 'pcm16_b64' or 'path'"}
        finally:
            stop()
            eng.close()

    def test_large_request_exceeds_default_stream_limit(self, sess):
        """A 40 s clip is a ~1.7 MB base64 line, far past asyncio's 64 KiB
        default; it round-trips through the long-form lane."""
        eng = _engine(sess, max_new_tokens=2)
        port = _free_port()
        stop = _start_server(eng, port)
        try:
            req = _pcm_request(9, seconds=40.0)
            assert len(req["pcm16_b64"]) > 64 * 1024
            resp = _ask(port, req, timeout=300)
            assert resp["id"] == "r9" and "error" not in resp
            assert eng.stats["longform"] == 1
        finally:
            stop()
            eng.close()

    def test_path_requests_and_resampling(self, sess, tmp_path):
        from whisper_tpu_torch.serve.server import _decode_audio

        from whisper_tpu.serve.server import _decode_audio as jax_decode

        pcm = (np.clip(_audio(0.5, seed=1), -1, 1) * 32767).astype("<i2")
        msg = {"pcm16_b64": base64.b64encode(pcm.tobytes()).decode(),
               "sample_rate": 8000}
        np.testing.assert_array_equal(_decode_audio(msg), jax_decode(msg))
        import struct

        path = tmp_path / "a.wav"
        data = pcm.tobytes()
        path.write_bytes(struct.pack(
            "<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + len(data), b"WAVE", b"fmt ",
            16, 1, 1, 16000, 32000, 2, 16, b"data", len(data)) + data)
        np.testing.assert_array_equal(_decode_audio({"path": str(path)}),
                                      jax_decode({"path": str(path)}))


class TestRouter:
    def _start(self, sess, n_backends=2):
        from whisper_tpu_torch.serve.router import serve_router

        engines, stops, backends = [], [], []
        for _ in range(n_backends):
            eng = _engine(sess, max_new_tokens=2, batch_window_ms=10)
            port = _free_port()
            stops.append(_start_server(eng, port))
            engines.append(eng)
            backends.append(("127.0.0.1", port))
        rport = _free_port()
        stop_router = _run_async_server(
            lambda ev: serve_router(backends, "127.0.0.1", rport, ev))

        def stop_all():
            stop_router()
            for s in stops:
                s()
            for e in engines:
                e.close()

        return rport, engines, stop_all

    def test_requests_spread_and_match_the_server(self, sess):
        rport, engines, stop_all = self._start(sess)
        try:
            out = {}
            threads = [threading.Thread(
                target=lambda i=i: out.__setitem__(
                    i, _ask(rport, _pcm_request(i)))) for i in range(6)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=SOCKET_TIMEOUT)
                assert not th.is_alive()
            assert set(out) == set(range(6))
            served = [e.stats["batched_requests"] for e in engines]
            assert sum(served) == 6 and all(s > 0 for s in served)
            for i, resp in out.items():
                assert resp["id"] == f"r{i}" and "error" not in resp
                assert resp["text"] == engines[0].transcribe(_decoded(i))
        finally:
            stop_all()

    def test_merged_stats(self, sess):
        rport, engines, stop_all = self._start(sess)
        try:
            resp = _ask(rport, {"id": "q", "stats": True})
            assert resp["id"] == "q"
            assert "batches" in resp["stats"]
            assert len(resp["stats"]["backends"]) == 2
        finally:
            stop_all()


class TestRouterHealth:
    """tests/test_serve.py's health, failover, registration and token
    cases against echo backends (no engine)."""

    @staticmethod
    def _echo_backend(port, ready):
        async def handle(reader, writer):
            while True:
                line = await reader.readline()
                if not line:
                    break
                msg = json.loads(line)
                msg["via"] = port
                if msg.get("stats"):
                    msg = {"id": msg.get("id"), "stats": {"served": 1}}
                writer.write((json.dumps(msg) + "\n").encode())
                await writer.drain()
            writer.close()

        async def main():
            server = await asyncio.start_server(handle, "127.0.0.1", port)
            ready.set()
            async with server:
                await server.serve_forever()

        threading.Thread(target=lambda: asyncio.run(main()),
                         daemon=True).start()

    def _echo(self):
        port = _free_port()
        ready = threading.Event()
        self._echo_backend(port, ready)
        assert ready.wait(10)
        return port

    def _router(self, backends, **kw):
        from whisper_tpu_torch.serve.router import serve_router

        rport = _free_port()
        return rport, _run_async_server(
            lambda ev: serve_router(backends, "127.0.0.1", rport, ev, **kw),
            ready_timeout=10)

    def test_dead_backend_fails_over_and_gets_benched(self):
        good, dead = self._echo(), _free_port()
        rport, stop = self._router(
            [("127.0.0.1", dead), ("127.0.0.1", good)],
            unhealthy_after=2, cooldown_s=30.0)
        try:
            for i in range(8):
                assert _ask(rport, {"id": i, "x": 1}, 10).get("via") == good
            per = _ask(rport, {"id": "s", "stats": True}, 10)["stats"][
                "backends"]
            assert per[f"127.0.0.1:{dead}"]["healthy"] is False
            assert per[f"127.0.0.1:{good}"]["healthy"] is True
        finally:
            stop()

    def test_all_dead_fails_open_with_error(self):
        rport, stop = self._router(
            [("127.0.0.1", _free_port()), ("127.0.0.1", _free_port())],
            unhealthy_after=1, cooldown_s=30.0)
        try:
            for i in range(3):
                assert "error" in _ask(rport, {"id": i}, 10)
        finally:
            stop()

    def test_runtime_register_deregister(self):
        bport = self._echo()
        rport, stop = self._router([])
        try:
            spec = {"host": "127.0.0.1", "port": bport}
            r = _ask(rport, {"id": "c", "register": spec}, 10)
            assert r["registered"] == f"127.0.0.1:{bport}"
            assert r["n_backends"] == 1
            assert _ask(rport, {"id": "c2", "register": spec},
                        10)["n_backends"] == 1
            assert _ask(rport, {"id": "q"}, 10).get("via") == bport
            r3 = _ask(rport, {"id": "c3", "deregister": spec}, 10)
            assert r3["deregistered"] and r3["n_backends"] == 0
        finally:
            stop()

    def test_control_token_gates_pool_mutation(self):
        bport = self._echo()
        rport, stop = self._router([], control_token="sekrit")
        try:
            spec = {"host": "127.0.0.1", "port": bport}
            r = _ask(rport, {"id": "c", "register": spec}, 10)
            assert "error" in r and "token" in r["error"]
            assert "error" in _ask(rport, {"id": "c1", "token": "wrong",
                                           "register": spec}, 10)
            r = _ask(rport, {"id": "c2", "token": "sekrit",
                             "register": spec}, 10)
            assert r["registered"] == f"127.0.0.1:{bport}"
            assert _ask(rport, {"id": "q"}, 10).get("via") == bport
            assert "error" in _ask(rport, {"id": "c3", "deregister": spec},
                                   10)
            assert _ask(rport, {"id": "q2"}, 10).get("via") == bport
            r = _ask(rport, {"id": "c4", "token": "sekrit",
                             "deregister": spec}, 10)
            assert r["deregistered"] and r["n_backends"] == 0
        finally:
            stop()

    def test_zero_backends_bounded_error(self):
        rport, stop = self._router([], pick_timeout_s=1.0)
        try:
            t0 = time.time()
            resp = _ask(rport, {"id": "r0", "pcm16_b64": ""}, 30)
            assert resp["id"] == "r0"
            assert "no backend available" in resp.get("error", ""), resp
            assert time.time() - t0 < 15
        finally:
            stop()

    def test_resolve_advertise_host_and_register_backend(self):
        from whisper_tpu_torch.serve.server import (
            register_backend,
            resolve_advertise_host,
        )

        assert resolve_advertise_host("10.0.0.7") == "10.0.0.7"
        assert resolve_advertise_host("0.0.0.0") == socket.gethostname()
        assert resolve_advertise_host("::") == socket.gethostname()
        assert resolve_advertise_host("0.0.0.0", "gpu-host-3") == "gpu-host-3"
        rport, stop = self._router([], control_token="t")
        try:
            resp = register_backend(f"127.0.0.1:{rport}", "127.0.0.1", 9,
                                    token="t")
            assert resp["registered"] == "127.0.0.1:9"
            with pytest.raises(RuntimeError, match="refused"):
                register_backend(f"127.0.0.1:{rport}", "127.0.0.1", 9,
                                 retries=1, token="bad")
        finally:
            stop()


# ---------------------------------------------------------------------------
# Entry points: flags, the device, no jax
# ---------------------------------------------------------------------------

class _Parsed(Exception):
    pass


def _parser_of(main, monkeypatch, **kw):
    """The ArgumentParser a main() builds, caught at parse_args."""
    def grab(self, *a, **k):
        raise _Parsed(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(_Parsed) as caught:
        main([], **kw)
    monkeypatch.undo()
    return {tuple(a.option_strings): (a.default, a.choices, a.type,
                                      type(a).__name__)
            for a in caught.value.args[0]._actions}


@pytest.mark.parametrize("name", ["server", "http_server", "router"])
def test_entry_points_take_the_jax_flags(name, monkeypatch):
    import importlib

    mine = importlib.import_module(f"whisper_tpu_torch.serve.{name}")
    theirs = importlib.import_module(f"whisper_tpu.serve.{name}")
    assert _parser_of(mine.main, monkeypatch) == _parser_of(theirs.main,
                                                            monkeypatch)
    if name == "server":
        assert mine._LINE_LIMIT == theirs._LINE_LIMIT


@pytest.mark.parametrize("name", ["server", "http_server"])
def test_servers_exit_without_a_card_unless_asked_for_the_cpu(name,
                                                              monkeypatch):
    import importlib

    from whisper_tpu_torch.utils.device import DEVICE_ENV

    mod = importlib.import_module(f"whisper_tpu_torch.serve.{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv(DEVICE_ENV, raising=False)
    argv = ["--allow-random-init", "--model-id", "test/whisper-nano",
            "--port", str(_free_port())]
    with pytest.raises(SystemExit) as e:
        mod.main(argv)
    assert "no CUDA card" in str(e.value.code)
    monkeypatch.setenv(DEVICE_ENV, "cuda")
    with pytest.raises(SystemExit) as e:
        mod.main(argv)
    assert "was asked for" in str(e.value.code)
    # asked for the CPU, it builds its engine there
    from whisper_tpu_torch.serve.server import add_model_args, build_engine

    p = argparse.ArgumentParser()
    add_model_args(p)
    eng = build_engine(p.parse_args(["--allow-random-init", "--model-id",
                                     "test/whisper-nano"]), device="cpu")
    try:
        assert eng.session.device.type == "cpu"
        assert eng.session.cfg.packed_cross_kv      # the default, x4
    finally:
        eng.close()


def test_module_runs_exit_nonzero_without_a_card():
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "WHISPER_TPU_TORCH_DEVICE")}
    env.update(PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    for mod in ("server", "http_server"):
        proc = subprocess.run(
            [sys.executable, "-m", f"whisper_tpu_torch.serve.{mod}",
             "--allow-random-init", "--model-id", "test/whisper-nano",
             "--port", str(_free_port())],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0, proc.stdout
        assert "no CUDA card" in proc.stderr, proc.stderr[-2000:]
