"""The port's long-form slice against the JAX package's, end to end (CPU).

``transcribe_longform`` runs on 70 s of synthetic audio with
``mel_slab_frames`` lowered to 3000, so the streamed front end runs over
three slabs and the file gives three 30 s chunks (one batch bucket of
four).  The model is small (d_model 128, two heads of 64, two encoder and
two decoder layers, vocab 256) but keeps the encoder's full 1500 positions,
so every kernel module runs at the path's own sequence lengths.  The JAX
side runs as its own tests run it on the CPU (Pallas in interpret mode).
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from whisper_tpu.models import whisper as jw
from whisper_tpu.ops.self_attention import pack_self_cache
from whisper_tpu.pipeline.longform import transcribe_longform as jax_longform
from whisper_tpu.runtime.session import RuntimeCfg as JaxCfg
from whisper_tpu.runtime.session import WhisperSession as JaxSession
from whisper_tpu.variants.ladder import apply_variant as jax_apply_variant
from whisper_tpu_torch.frontend import golden
from whisper_tpu_torch.models import convert
from whisper_tpu_torch.models import whisper as tw
from whisper_tpu_torch.models.registry import WhisperDims
from whisper_tpu_torch.pipeline.chunk import CHUNK_FRAMES, mel_frame_bucket
from whisper_tpu_torch.pipeline.longform import transcribe_longform
from whisper_tpu_torch.runtime.session import RuntimeCfg, WhisperSession
from whisper_tpu_torch.runtime.timestamps import TimestampCfg
from whisper_tpu_torch.variants.ladder import apply_variant

torch.set_num_threads(2)

DIMS = WhisperDims(n_mels=80, d_model=128, encoder_layers=2, encoder_heads=2,
                   decoder_layers=2, decoder_heads=2, vocab_size=256,
                   max_source_positions=1500, max_target_positions=32)
SLAB = 3000
MAX_NEW = 6
PROMPT_LEN = 4
# x5 logits agree within LOGIT_TOL: a few bf16 steps of the hidden state
# they project (bf16 rounding after every op, summed in another order).
LOGIT_TOL = 2e-2
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class RecordingTok:
    """Special ids that fit the small vocab; ``decode`` records the
    generated ids of every chunk (prompt and EOT stripped) it is given."""

    ids = {"<|startoftranscript|>": 250, "<|endoftext|>": 251,
           "<|en|>": 252, "<|transcribe|>": 253, "<|notimestamps|>": 254,
           "<|startofprev|>": 255}

    def __init__(self):
        self.rows = []

    def token_to_id(self, t):
        return self.ids.get(t)

    def decode(self, ids, skip_special_tokens=True, **_):
        self.rows.append([int(i) for i in ids])
        return " ".join(f"w{i}" for i in ids)


def _audio(seconds: float = 70.0, seed: int = 5) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = int(seconds * 16000)
    t = np.arange(n) / 16000.0
    x = (0.3 * np.sin(2 * np.pi * (180 + 60 * np.sin(2 * np.pi * 0.7 * t)) * t)
         + 0.15 * np.sin(2 * np.pi * 920 * t) + 0.04 * rng.standard_normal(n))
    return (0.5 * x).astype(np.float32)


def _sessions(rung: str, params):
    jcfg, _ = jax_apply_variant(JaxCfg(), rung)
    tcfg, _ = apply_variant(RuntimeCfg(), rung)
    jcfg = dataclasses.replace(jcfg, mel_slab_frames=SLAB)
    tcfg = dataclasses.replace(tcfg, mel_slab_frames=SLAB)
    return (JaxSession(params, DIMS, jcfg),
            WhisperSession(params, DIMS, tcfg, device="cpu"))


def _run_both(rung: str, params, audio):
    jsess, tsess = _sessions(rung, params)
    jtok, ttok = RecordingTok(), RecordingTok()
    jtext, _ = jax_longform(jsess, audio, "en", "transcribe", MAX_NEW,
                            tokenizer=jtok)
    tokens = []
    ttext, timing = transcribe_longform(tsess, audio, "en", "transcribe",
                                        MAX_NEW, tokenizer=ttok,
                                        token_collector=tokens)
    return jsess, tsess, (jtext, jtok.rows), (ttext, ttok.rows, tokens[0]), \
        timing


@pytest.fixture(scope="module")
def params():
    return convert.init_params(DIMS, seed=7)


def test_x0_tokens_and_text_equal_jax(params):
    """fp32 with TF32 off against JAX at HIGHEST: the same tokens for every
    chunk and the same stitched text."""
    audio = _audio()
    _, tsess, (jtext, jrows), (ttext, trows, tokens), timing = _run_both(
        "x0", params, audio)
    assert tokens.shape == (3, MAX_NEW)
    assert len(jrows) == 3 and trows == jrows
    assert ttext == jtext
    assert timing.end_to_end_s >= timing.model_only_s > 0


def _jax_replay(jsess, mel, frame_starts):
    """JAX's x5 greedy chain for one batch bucket, step by step through the
    packed kernels as ``greedy_generate`` runs it: (encoder states,
    per-step logits [MAX_NEW, B, V], tokens [B, MAX_NEW])."""
    bucket = 4
    starts = list(frame_starts) + [mel.shape[1]] * (bucket - len(frame_starts))
    mel_pad = jnp.pad(mel, ((0, 0), (0, CHUNK_FRAMES)))
    chunks = jnp.stack([mel_pad[:, s:s + CHUNK_FRAMES] for s in starts])
    p = jsess.params
    enc = jw.encoder_apply(p, DIMS, chunks, fused_attention=True,
                           fused_mlp=True)
    prompt = jnp.asarray([[250, 252, 253, 254]] * bucket, jnp.int32)
    logits, cache = jw.decoder_prefill(p, DIMS, prompt, enc,
                                       PROMPT_LEN + MAX_NEW,
                                       int8_cross_kv=True)
    cache = jw.pack_cross_cache(cache, transpose_k=True)
    cache = cache._replace(self_k=pack_self_cache(cache.self_k),
                           self_v=pack_self_cache(cache.self_v))
    steps = [np.asarray(logits[:, -1].astype(jnp.float32))]
    toks = [steps[0].argmax(-1)]
    for i in range(1, MAX_NEW):
        lg, cache = jw.decoder_step(p, DIMS, jnp.asarray(toks[-1], jnp.int32),
                                    jnp.int32(PROMPT_LEN + i - 1), cache,
                                    cross_len=DIMS.max_source_positions,
                                    int8_mxu=True)
        steps.append(np.asarray(lg.astype(jnp.float32)))
        toks.append(steps[-1].argmax(-1))
    return enc, np.stack(steps), np.stack(toks, axis=1)


def _strip(row, eot=251):
    out = []
    for t in row:
        if t == eot:
            break
        out.append(int(t))
    return out


def test_x5_slice_agrees_with_jax(params):
    """Rung x5 (bf16, int8 weights, kernels B1-B4 as plain versions on the
    CPU) against JAX's x5: the streamed mel within 3e-5 (as in
    test_torch_model), the encoder states
    within 4 bf16 steps of each value, the first-step logits within
    LOGIT_TOL, and each chunk's token chain equal to JAX's or first
    diverging at a step where JAX's top-2 logit margin is below LOGIT_TOL."""
    audio = _audio()
    jsess, tsess, (jtext, jrows), (ttext, trows, tokens), _ = _run_both(
        "x5", params, audio)
    assert tokens.shape == (3, MAX_NEW) and len(jrows) == 3

    padded = golden.reflect_pad(audio)
    nv = golden.num_frames(len(audio))
    bucket = mel_frame_bucket(nv)
    mel_j = jsess.compute_mel(padded, nv, bucket)
    mel_t = tsess.compute_mel(padded, nv, bucket)
    np.testing.assert_allclose(mel_t.numpy(), np.asarray(mel_j), atol=3e-5,
                               rtol=0)

    frame_starts = [0, 2500, 5000]
    enc_j, logits_j, toks_j = _jax_replay(jsess, mel_j, frame_starts)
    # The replay is JAX's own chain: it strips to what the session decoded.
    assert [_strip(r) for r in toks_j[:3]] == jrows

    mel_pad = torch.nn.functional.pad(torch.from_numpy(np.array(mel_j)),
                                      (0, CHUNK_FRAMES))
    chunks = torch.stack([mel_pad[:, s:s + CHUNK_FRAMES]
                          for s in frame_starts + [nv]])
    enc_t = tsess.encoder(chunks).float().numpy()
    ej = np.array(enc_j.astype(jnp.float32))
    scale = np.maximum(np.maximum(np.abs(enc_t), np.abs(ej)),
                       np.abs(ej).mean())
    assert (np.abs(enc_t - ej) / (scale * 2.0 ** -7)).max() <= 4.0

    prompt = torch.tensor([[250, 252, 253, 254]] * 4)
    lt, _ = tw.decoder_prefill(tsess._decoder_params, DIMS, prompt,
                               torch.from_numpy(ej).to(torch.bfloat16),
                               PROMPT_LEN + MAX_NEW, int8_cross_kv=True)
    np.testing.assert_allclose(lt[:, -1].numpy(), logits_j[0],
                               atol=LOGIT_TOL, rtol=0)

    for r in range(3):
        diff = np.nonzero(tokens[r] != toks_j[r])[0]
        if diff.size:
            i = diff[0]
            top2 = np.sort(logits_j[i, r])[-2:]
            assert top2[1] - top2[0] < LOGIT_TOL, (
                f"chunk {r} diverges at step {i} with margin "
                f"{top2[1] - top2[0]}")
    if (tokens == toks_j[:3]).all():
        assert trows == jrows and ttext == jtext


@pytest.mark.parametrize("mode", ["f32", "float32", "auto"])
def test_float_audio_transfer_modes_match_jax(mode):
    """Every audio_transfer mode that is not a wire encoding uploads
    float32 as it is, as the JAX session's ``_encode_transfer`` does: "f32"
    is a choice of the CLI's --audio-transfer and may come from a discovery
    JSON.  The one-shot (20 s) and the streamed (45 s, slabs of 2,000
    frames) mel equal the JAX session's within 3e-5, the bound of
    test_x5_slice_agrees_with_jax."""
    cfg = dict(dtype="float32", audio_transfer=mode, mel_slab_frames=2000)
    jsess = JaxSession(convert.init_params(SMALL, seed=0), SMALL,
                       JaxCfg(**cfg))
    tsess = WhisperSession(convert.init_params(SMALL, seed=0), SMALL,
                           RuntimeCfg(**cfg), device="cpu")
    for seconds in (20.0, 45.0):
        audio = _audio(seconds, seed=3)
        padded = golden.reflect_pad(audio)
        nv = golden.num_frames(len(audio))
        bucket = mel_frame_bucket(nv)
        want = np.asarray(jsess.compute_mel(padded, nv, bucket))
        got = tsess.compute_mel(padded, nv, bucket).numpy()
        np.testing.assert_allclose(got, want, atol=3e-5, rtol=0)


def test_port_loads_no_jax():
    """A fresh process, WHISPER_TPU_PLATFORM unset, runs the x5 slice at a
    small size through the port, greedy and then speculative with a draft
    model attached, then a request through the serving engine, imports the
    TCP server, the HTTP server and the router, and never imports jax or
    whisper_tpu."""
    code = f"""
import dataclasses, sys
import numpy as np, torch
torch.set_num_threads(2)
from whisper_tpu_torch.models.convert import init_params
from whisper_tpu_torch.models.registry import WhisperDims
from whisper_tpu_torch.pipeline.longform import transcribe_longform
from whisper_tpu_torch.runtime.session import RuntimeCfg, WhisperSession
from whisper_tpu_torch.runtime.timestamps import TimestampCfg
from whisper_tpu_torch.variants.ladder import apply_variant
dims = WhisperDims(80, 128, 1, 2, 1, 2, 256)
cfg, _ = apply_variant(RuntimeCfg(), "x5")
cfg = dataclasses.replace(cfg, mel_slab_frames=1000)
sess = WhisperSession(init_params(dims, seed=0), dims, cfg, device="cpu")
rng = np.random.default_rng(0)
tok = []
class Tok:
    def token_to_id(self, t):
        return {{"<|startoftranscript|>": 250, "<|endoftext|>": 251,
                 "<|en|>": 252, "<|transcribe|>": 253,
                 "<|notimestamps|>": 254}}.get(t)
    def decode(self, ids, **_):
        return " ".join(map(str, ids))
text, _ = transcribe_longform(sess, rng.normal(0, 0.1, 35 * 16000),
                              "en", "transcribe", 3, tokenizer=Tok(),
                              token_collector=tok)
assert tok[0].shape == (2, 3), tok[0].shape
sess.set_draft_model(init_params(dims, seed=1), dims)
spec, _ = transcribe_longform(sess, rng.normal(0, 0.1, 35 * 16000),
                              "en", "transcribe", 3, tokenizer=Tok(),
                              speculative=True, draft_k=2)
assert isinstance(spec, str)
from whisper_tpu_torch.serve import (engine, http_server, router, server,
                                     serve_bench)
eng = engine.StreamingEngine(sess, Tok(), engine.EngineConfig(
    max_new_tokens=2))
assert isinstance(eng.transcribe(rng.normal(0, 0.1, 16000)), str)
assert eng.stats["speculative"] == 1
eng.close()
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "whisper_tpu")]
assert not bad, bad
print("no-jax-ok")
"""
    env = {k: v for k, v in os.environ.items()
           if k not in ("WHISPER_TPU_PLATFORM", "PYTHONPATH")}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "no-jax-ok" in proc.stdout


# ---------------------------------------------------------------------------
# What the slice does not carry raises NotImplementedError
# ---------------------------------------------------------------------------

SMALL = WhisperDims(80, 128, 1, 2, 1, 2, 256, max_source_positions=1500,
                    max_target_positions=32)


def _small_session(rung="x5", **overrides):
    cfg, _ = apply_variant(RuntimeCfg(), rung)
    cfg = dataclasses.replace(cfg, **overrides)
    return WhisperSession(convert.init_params(SMALL, seed=0), SMALL, cfg,
                          device="cpu")


LONGFORM_CASES = {
    "speculative": dict(speculative=True),
}


def _refusal(case):
    """What refuses a case: speculative decoding is ported and asks for a
    draft model first; the rest names its ROADMAP item."""
    if case == "speculative":
        return pytest.raises(RuntimeError, match="set_draft_model")
    return pytest.raises(NotImplementedError, match="ROADMAP")


@pytest.mark.parametrize("case", sorted(LONGFORM_CASES))
def test_longform_options_not_ported_raise(case):
    kw = dict(language="en", task="transcribe", max_new_tokens=2)
    kw.update(LONGFORM_CASES[case])
    with _refusal(case):
        transcribe_longform(_small_session(), np.zeros(16000, np.float32),
                            **kw)


class LangTok(RecordingTok):
    """RecordingTok with a token table, which language detection reads."""

    _tokens = [None] * 250 + sorted(RecordingTok.ids, key=RecordingTok.ids.get)


LONGFORM_RUNS = {
    "beams": dict(num_beams=2),
    "beams_length_penalty": dict(num_beams=3, length_penalty=0.5),
    "timestamps": dict(timestamps=True),
    "beams_timestamps": dict(num_beams=2, timestamps=True),
    "language_auto": dict(language="auto"),
    "word_timings": dict(word_collector=[]),
    "conditioned_prompt": dict(initial_prompt_ids=[1, 2]),
    "conditioned_prompt_timestamps": dict(initial_prompt_ids=[3],
                                          timestamps=True),
}


@pytest.mark.parametrize("case", sorted(LONGFORM_RUNS))
def test_longform_decoding_options_run(case):
    """What the long-form driver refused before the decoding options were
    ported now runs at x5: one chunk decoded, a detected language
    collected."""
    kw = dict(language="en", task="transcribe", max_new_tokens=3)
    kw.update(LONGFORM_RUNS[case])
    tok, tokens, langs = LangTok(), [], []
    text, timing = transcribe_longform(
        _small_session(), _audio(8.0), tokenizer=tok, token_collector=tokens,
        language_collector=langs, **kw)
    assert tokens[0].shape == (1, 3) and timing.end_to_end_s > 0
    assert langs == (["en"] if kw["language"] == "auto" else [])


SESSION_CASES = {
    "mesh": ("x5", dict(data_parallel=2)),
    "mesh_tensor_parallel": ("x7", dict(tensor_parallel=2)),
    "wire_encoding": ("x5", dict(audio_transfer="ulaw8")),
}


@pytest.mark.parametrize("case", sorted(SESSION_CASES))
def test_session_configs_not_ported_raise(case):
    rung, overrides = SESSION_CASES[case]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _small_session(rung, **overrides)


DECODE_CASES = {
    "speculative": dict(speculative=True),
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_options_not_ported_raise(case):
    sess = _small_session()
    mel = torch.zeros((80, 3000))
    with _refusal(case):
        sess.transcribe_from_mel(mel, [0], [250], 2, 251,
                                 **DECODE_CASES[case])


DECODE_RUNS = {
    "beams": dict(num_beams=2),
    "timestamps": dict(ts_cfg=TimestampCfg(255, 251, 254), prompt=[250, 252,
                                                                  253]),
    "temperature": dict(temperature=0.5, seed=3),
    "scores": dict(with_scores=True),
    "temperature_scores": dict(temperature=1.0, with_scores=True),
    "conditioned_prompt": dict(pad_count=2, prompt=[251, 251, 255, 7, 250,
                                                    252, 253, 254]),
    "conditioned_prompt_beams": dict(pad_count=1, num_beams=2,
                                     prompt=[251, 255, 250, 252, 253, 254]),
    "conditioned_prompt_scores": dict(pad_count=2, with_scores=True,
                                      prompt=[251, 251, 250, 252, 253, 254]),
}


@pytest.mark.parametrize("case", sorted(DECODE_RUNS))
def test_decode_options_run(case):
    """The session's decoding options, refused before they were ported:
    tokens of the asked shape, and with with_scores finite sums and counts
    of at least one token."""
    kw = dict(DECODE_RUNS[case])
    prompt = kw.pop("prompt", [250, 252, 253, 254])
    mel = torch.from_numpy(_audio(30.0)[:80 * 3000].reshape(80, 3000))
    out = _small_session().transcribe_from_mel(mel, [0, 1000], prompt, 3, 251,
                                               **kw)
    toks = out[0] if kw.get("with_scores") else out
    assert toks.shape == (2, 3)
    if kw.get("with_scores"):
        assert np.isfinite(out[1]).all() and (out[2] >= 1).all()


COMBINATION_CASES = {
    # the JAX session's refusals (session.py:801-807, 850-854)
    "beams_with_scores": (dict(num_beams=2, with_scores=True), ValueError,
                          "num_beams > 1 does not compose"),
    "beams_with_temperature": (dict(num_beams=2, temperature=0.5),
                               ValueError, "num_beams > 1 does not compose"),
    "speculative_with_beams": (dict(speculative=True, num_beams=2),
                               ValueError, "plain greedy only"),
    "speculative_with_timestamps": (
        dict(speculative=True, ts_cfg=TimestampCfg(255, 251, 254)),
        ValueError, "plain greedy only"),
    "speculative_with_scores": (dict(speculative=True, with_scores=True),
                                ValueError, "plain greedy only"),
    "speculative_with_pad_count": (dict(speculative=True, pad_count=1),
                                   ValueError, "plain greedy only"),
}


@pytest.mark.parametrize("case", sorted(COMBINATION_CASES))
def test_decode_combinations_refused_as_in_jax(case):
    kw, exc, match = COMBINATION_CASES[case]
    sess = _small_session()
    if kw.get("speculative"):
        sess.set_draft_model(convert.init_params(SMALL, seed=1), SMALL)
    with pytest.raises(exc, match=match):
        sess.transcribe_from_mel(torch.zeros((80, 3000)), [0], [250], 2, 251,
                                 **kw)


def test_model_options_not_ported_raise():
    """Every model option the JAX functions take now runs: the fused block
    with int8 activations, and a prefill with a prompt mask (all real
    slots: the logits of the call without one)."""
    tp = convert.params_from_numpy(convert.init_params(SMALL, seed=0), "cpu",
                                   torch.float32)
    mel = torch.zeros((1, 80, 3000))
    assert tw.encoder_apply(tp, SMALL, mel, int8_activations=True,
                            fused_block=True).shape == (1, 1500, 128)
    args = (tp, SMALL, torch.tensor([[3, 9]]),
            torch.randn((1, 1500, 128), generator=torch.Generator().manual_seed(0)),
            8)
    masked, _ = tw.decoder_prefill(
        *args, prompt_mask=torch.ones((1, 2), dtype=torch.bool))
    assert torch.equal(masked, tw.decoder_prefill(*args)[0])
