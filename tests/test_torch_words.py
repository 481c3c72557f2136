"""The port's word timestamps (``pipeline.words``,
``models.whisper.decoder_alignment_weights``,
``WhisperSession.alignment_weights``) against the JAX package's (CPU).

- ``decoder_alignment_weights`` within 1e-5 of JAX's at x0 fp32;
- ``median_filter``, ``dtw_path``, ``alignment_matrix`` (normalized over
  the TOKEN axis) and ``words_from_alignment`` equal JAX's on the same
  arrays;
- ``align_chunk_words`` through an x0 session: JAX's words, times within
  0.01 s; ``transcribe_longform(word_collector=...)`` JAX's words;
- the session's alignment pass takes the plain encoder with
  ``fused_attention`` only, so at x6 (int8 q/k/v/o kept for W8A8) and with
  the fused encoder block it is bitwise x5's.

Models: d_model 128, two heads of 64, two layers each side (the encoder's
full 1,500 positions where a session runs), vocab 320.
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from whisper_tpu.models import convert as jconvert
from whisper_tpu.models import whisper as jw
from whisper_tpu.pipeline import words as jwords
from whisper_tpu.pipeline.longform import transcribe_longform as jax_longform
from whisper_tpu.runtime.session import RuntimeCfg as JaxCfg
from whisper_tpu.runtime.session import WhisperSession as JaxSession
from whisper_tpu.variants.ladder import apply_variant as jax_apply_variant
from whisper_tpu_torch.models import convert
from whisper_tpu_torch.models import whisper as tw
from whisper_tpu_torch.models.registry import WhisperDims
from whisper_tpu_torch.pipeline import words
from whisper_tpu_torch.pipeline.longform import transcribe_longform
from whisper_tpu_torch.runtime.session import RuntimeCfg, WhisperSession
from whisper_tpu_torch.variants.ladder import apply_variant

torch.set_num_threads(2)

DIMS = WhisperDims(n_mels=80, d_model=128, encoder_layers=2, encoder_heads=2,
                   decoder_layers=2, decoder_heads=2, vocab_size=320,
                   max_source_positions=1500, max_target_positions=48)
SOT, EOT, LANG, TASK, NO_TS = 250, 251, 252, 253, 318
PROMPT = [SOT, LANG, TASK, NO_TS]


@pytest.mark.parametrize("seed", [0, 1])
def test_alignment_weights_equal_jax(seed):
    rng = np.random.default_rng(seed)
    dims = dataclasses.replace(DIMS, max_source_positions=96)
    enc = rng.normal(0, 1, (2, 96, 128)).astype(np.float32)
    toks = rng.integers(0, 250, (2, 21)).astype(np.int32)
    jp = jconvert.cast_params(jconvert.init_params(dims, seed), jnp.float32)
    tp = convert.params_from_numpy(convert.init_params(dims, seed), "cpu",
                                   torch.float32)
    want = np.asarray(jw.decoder_alignment_weights(
        jp, dims, jnp.asarray(toks), jnp.asarray(enc)))
    got = tw.decoder_alignment_weights(tp, dims,
                                       torch.from_numpy(toks).long(),
                                       torch.from_numpy(enc)).numpy()
    assert got.shape == want.shape == (2, 2, 2, 21, 96)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("width", [1, 3, 7])
def test_median_filter_equals_jax(width):
    x = np.random.default_rng(width).normal(size=(3, 4, 50))
    np.testing.assert_array_equal(words.median_filter(x, width),
                                  jwords.median_filter(x, width))


@pytest.mark.parametrize("shape", [(1, 1), (5, 40), (12, 30), (30, 12)])
def test_dtw_path_equals_jax(shape):
    cost = np.random.default_rng(shape[0]).normal(size=shape)
    for got, want in zip(words.dtw_path(cost), jwords.dtw_path(cost)):
        np.testing.assert_array_equal(got, want)


def _weights(seed, l=4, h=3, p=20, t=200):
    w = np.random.default_rng(seed).random((l, h, p, t)).astype(np.float32)
    return w / w.sum(-1, keepdims=True)


@pytest.mark.parametrize("n_tokens,n_frames", [(6, 200), (20, 150), (1, 50)])
def test_alignment_matrix_equals_jax(n_tokens, n_frames):
    w = _weights(n_tokens)
    np.testing.assert_array_equal(
        words.alignment_matrix(w, n_tokens, n_frames),
        jwords.alignment_matrix(w, n_tokens, n_frames))


class PieceTok:
    """Decodes an id to a piece that starts a word for even ids."""

    def decode(self, ids, skip_special_tokens=False):
        return "".join((" w" if i % 2 == 0 else "x") + str(i) for i in ids)


@pytest.mark.parametrize("tokenizer", [None, PieceTok()],
                         ids=["token_ids", "pieces"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_words_from_alignment_equals_jax(tokenizer, seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 15))
    tokens = rng.integers(0, 200, n).tolist()
    matrix = words.alignment_matrix(_weights(seed, p=n), n, 180)
    got = words.words_from_alignment(matrix, tokens, tokenizer, offset_s=2.5)
    want = jwords.words_from_alignment(matrix, tokens, tokenizer, 2.5)
    assert [dataclasses.astuple(w) for w in got] == \
        [dataclasses.astuple(w) for w in want]
    assert [w.to_dict() for w in got] == [w.to_dict() for w in want]


def _sessions(rung, params, dims=DIMS, **overrides):
    jcfg, _ = jax_apply_variant(JaxCfg(), rung)
    tcfg, _ = apply_variant(RuntimeCfg(), rung)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return (JaxSession(params, dims, jcfg),
                WhisperSession(params, dims,
                               dataclasses.replace(tcfg, **overrides),
                               device="cpu"))


def _mel(seed, frames=3000):
    return np.random.default_rng(seed).normal(0, 1, (80, frames)).astype(
        np.float32)


@pytest.mark.parametrize("n_gen", [3, 13])
def test_align_chunk_words_equals_jax_at_x0(n_gen):
    jsess, tsess = _sessions("x0", convert.init_params(DIMS, 3))
    mel = _mel(n_gen)
    gen = np.random.default_rng(n_gen).integers(0, 250, n_gen).tolist()
    jw_ = jwords.align_chunk_words(jsess, jnp.asarray(mel), PROMPT, gen,
                                   offset_s=12.0, audio_len_s=21.0)
    tw_ = words.align_chunk_words(tsess, torch.from_numpy(mel), PROMPT, gen,
                                  offset_s=12.0, audio_len_s=21.0)
    assert [w.word for w in tw_] == [w.word for w in jw_] and tw_
    for a, b in zip(tw_, jw_):
        assert abs(a.start_s - b.start_s) <= 0.01
        assert abs(a.end_s - b.end_s) <= 0.01
    # P_pad rows: a multiple of 16; every row a distribution over T_enc
    w = tsess.alignment_weights(torch.from_numpy(mel), PROMPT, gen)
    assert w.shape == (2, 2, max(16, -(-(4 + n_gen) // 16) * 16), 1500)
    np.testing.assert_allclose(w.sum(-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("rung,overrides", [
    ("x6", {}), ("x5", dict(fused_encoder_block=True))],
    ids=["x6", "x5_fused_block"])
def test_alignment_at_x6_and_fused_block_is_x5s(rung, overrides):
    params = convert.init_params(DIMS, 4)
    x5 = _sessions("x5", params)[1]
    other = _sessions(rung, params, **overrides)[1]
    mel = torch.from_numpy(_mel(4))
    gen = [5, 9, 77, 140]
    np.testing.assert_array_equal(other.alignment_weights(mel, PROMPT, gen),
                                  x5.alignment_weights(mel, PROMPT, gen))


class RecordingTok:
    ids = {"<|startoftranscript|>": SOT, "<|endoftext|>": EOT,
           "<|en|>": LANG, "<|transcribe|>": TASK, "<|notimestamps|>": NO_TS,
           "<|startofprev|>": 255}

    def token_to_id(self, t):
        return self.ids.get(t)

    def decode(self, ids, skip_special_tokens=True, **_):
        return "".join(f" w{i}" for i in ids)


@pytest.mark.parametrize("case", ["plain", "initial_prompt", "timestamps"])
def test_longform_word_collector_equals_jax_at_x0(case):
    """A 40 s file (two chunks): the words of JAX's transcribe_longform in
    file time, each chunk aligned against its own slice of the device
    mel."""
    jsess, tsess = _sessions("x0", convert.init_params(DIMS, 5))
    audio = np.random.default_rng(5).normal(0, 0.1, 40 * 16000).astype(
        np.float32)
    kw = {"plain": {}, "initial_prompt": dict(initial_prompt_ids=[20, 30]),
          "timestamps": dict(timestamps=True)}[case]
    jwl, twl = [], []
    jax_longform(jsess, audio, "en", "transcribe", 6, tokenizer=RecordingTok(),
                 word_collector=jwl, **kw)
    transcribe_longform(tsess, audio, "en", "transcribe", 6,
                        tokenizer=RecordingTok(), word_collector=twl, **kw)
    assert twl and [w["word"] for w in twl] == [w["word"] for w in jwl]
    for a, b in zip(twl, jwl):
        assert abs(a["start"] - b["start"]) <= 0.01
        assert abs(a["end"] - b["end"]) <= 0.01
    assert all(0 <= w["start"] <= w["end"] <= 40.0 for w in twl)
