"""The port's pipelined long-form mode (``pipeline.pipelined``, the
session's ``chunk_norm`` and ``chunk_norm_window``) against the JAX
package's (CPU).

Same weights (``init_params(dims, seed)``) and the same synthetic audio,
made from a seed with numpy, through ``whisper_tpu`` (Pallas kernels in
interpret mode, as its own tests run them on the CPU) and through
``whisper_tpu_torch`` (the kernels' plain versions, which CPU tensors
take).  Normalized windows: within 1e-6 of JAX's and of the numpy oracle of
tests/test_pipelined.py.  Tokens and texts at x0 fp32 on
``test/whisper-nano``, and at x5 on head_dim-64 dims: EQUAL.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from whisper_tpu.frontend.mel import log_spec_slab as jax_log_spec_slab
from whisper_tpu.pipeline.pipelined import (
    transcribe_longform_pipelined as jax_pipelined,
)
from whisper_tpu.runtime.session import RuntimeCfg as JaxCfg
from whisper_tpu.runtime.session import WhisperSession as JaxSession
from whisper_tpu.variants.ladder import apply_variant as jax_apply_variant
from whisper_tpu_torch.frontend.golden import num_frames, reflect_pad
from whisper_tpu_torch.frontend.mel import log_spec_slab
from whisper_tpu_torch.models import convert
from whisper_tpu_torch.models.registry import WhisperDims, get_dims
from whisper_tpu_torch.pipeline import pipelined
from whisper_tpu_torch.pipeline.chunk import CHUNK_FRAMES
from whisper_tpu_torch.runtime.session import (
    RuntimeCfg,
    WhisperSession,
    chunk_norm,
)
from whisper_tpu_torch.variants.ladder import apply_variant

torch.set_num_threads(2)

NANO = get_dims("test/whisper-nano")
PROMPT = [1, 2, 3]
EOT = 5


def _speechy_audio(n: int, seed: int = 0) -> np.ndarray:
    """tests/test_pipelined.py's signal: a wobbling tone, a second tone
    and noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float64) / 16000.0
    x = (0.3 * np.sin(2 * np.pi * (200 + 40 * np.sin(2 * np.pi * 1.3 * t)) * t)
         + 0.2 * np.sin(2 * np.pi * 850 * t)
         + 0.05 * rng.standard_normal(n))
    return (x * 0.5).astype(np.float32)


def _chunk_norm_numpy(raw, start, n_valid):
    """The numpy oracle of tests/test_pipelined.py:56-69."""
    n_mels = raw.shape[0]
    win = np.zeros((n_mels, CHUNK_FRAMES), dtype=np.float32)
    avail = max(0, min(start + CHUNK_FRAMES, n_valid) - start)
    if avail:
        win[:, :avail] = raw[:, start:start + avail]
    mask = (start + np.arange(CHUNK_FRAMES)) < n_valid
    if mask.any():
        vmax = win[:, mask].max()
        win = np.maximum(win, vmax - 8.0)
    win = (win + 4.0) / 4.0
    win[:, ~mask] = 0.0
    return win


@pytest.fixture(scope="module")
def nano():
    """x0 sessions of both packages (max_batch 4) on the same weights."""
    params = convert.init_params(NANO, seed=0)
    jcfg, _ = jax_apply_variant(JaxCfg(), "x0")
    tcfg, _ = apply_variant(RuntimeCfg(), "x0")
    return (JaxSession(params, NANO, dataclasses.replace(jcfg, max_batch=4)),
            WhisperSession(params, NANO, dataclasses.replace(tcfg,
                                                             max_batch=4),
                           device="cpu"))


def _raw(tsess, audio):
    """The port's whole-file RAW log-spec [n_mels, frames] (numpy, fp32)
    and its frame count."""
    nv = num_frames(len(audio))
    enc = torch.from_numpy(tsess._encode_transfer(
        np.ascontiguousarray(reflect_pad(audio))))
    ls, _ = log_spec_slab(enc, nv, n_mels=tsess.dims.n_mels, n_frames=nv)
    return ls.contiguous().numpy(), nv


def test_raw_log_spec_equals_jax(nano):
    """The slab front end of the mode: the raw log-spec within 1.2e-4 of
    the JAX package's, the 3e-5 of the normalized mel in
    tests/test_torch_slice.py in raw units ((x + 4) / 4 divides by 4)."""
    jsess, tsess = nano
    audio = _speechy_audio(40 * 16000, seed=2)
    raw, nv = _raw(tsess, audio)
    enc = jsess._encode_transfer(np.ascontiguousarray(reflect_pad(audio)))
    want, _ = jax_log_spec_slab(jnp.asarray(enc), jnp.int32(nv),
                                n_mels=NANO.n_mels, n_frames=nv)
    np.testing.assert_allclose(raw, np.asarray(want), atol=1.2e-4, rtol=0)


@pytest.mark.parametrize("where", ["start", "mid", "tail"])
def test_chunk_norm_window_equals_jax_and_numpy(nano, where):
    """One raw slab through both packages' ``chunk_norm_window`` and the
    numpy oracle, at frame 0, mid-file and n_valid - 100: atol 1e-6."""
    jsess, tsess = nano
    raw, nv = _raw(tsess, _speechy_audio(40 * 16000, seed=2))
    start = {"start": 0, "mid": 2500, "tail": nv - 100}[where]
    got = tsess.chunk_norm_window(torch.from_numpy(raw), start, nv).numpy()
    want = np.asarray(jsess.chunk_norm_window(jnp.asarray(raw), start, nv))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got, _chunk_norm_numpy(raw, start, nv),
                               atol=1e-6, rtol=0)


def test_padding_rows_of_a_ragged_bucket_are_zeros(nano):
    """A bucket's padding rows start at the slab's width: none of their
    frames is valid, their max is -inf and they come out all zeros, with
    no NaN; the real rows equal the oracle's."""
    _, tsess = nano
    raw, nv = _raw(tsess, _speechy_audio(40 * 16000, seed=2))
    mel_pad = torch.nn.functional.pad(torch.from_numpy(raw), (0, CHUNK_FRAMES))
    starts = [0, 1000, nv, nv]
    chunks = torch.stack([mel_pad[:, s:s + CHUNK_FRAMES] for s in starts])
    out = chunk_norm(chunks, starts, nv)
    assert torch.isfinite(out).all()
    assert (out[2:] == 0).all()
    for i, s in enumerate(starts[:2]):
        np.testing.assert_allclose(out[i].numpy(),
                                   _chunk_norm_numpy(raw, s, nv),
                                   atol=1e-6, rtol=0)


def test_transcribe_from_mel_chunk_norm_equals_jax_and_the_oracle(nano):
    """``transcribe_from_mel(chunk_norm_n_valid=...)`` on a raw slab: the
    JAX session's tokens, and ``transcribe_chunks`` on host-normalized
    windows (three chunks in a bucket of 4: one padding row)."""
    jsess, tsess = nano
    raw, nv = _raw(tsess, _speechy_audio(70 * 16000, seed=3))
    starts = [0, 2500, 5000]
    got = tsess.transcribe_from_mel(torch.from_numpy(raw), starts, PROMPT,
                                    5, EOT, chunk_norm_n_valid=nv)
    want = jsess.transcribe_from_mel(jnp.asarray(raw), starts, PROMPT, 5,
                                     EOT, chunk_norm_n_valid=nv)
    np.testing.assert_array_equal(got, want)
    oracle = tsess.transcribe_chunks(
        np.stack([_chunk_norm_numpy(raw, s, nv) for s in starts]), PROMPT, 5,
        EOT)
    np.testing.assert_array_equal(got, oracle)


def test_chunk_norm_with_pad_count_raises_as_in_jax(nano):
    jsess, tsess = nano
    raw = np.zeros((NANO.n_mels, 3000), np.float32)
    with pytest.raises(ValueError, match="mutually exclusive") as want:
        jsess.transcribe_from_mel(jnp.asarray(raw), [0], PROMPT, 2, EOT,
                                  pad_count=1, chunk_norm_n_valid=3000)
    with pytest.raises(ValueError) as got:
        tsess.transcribe_from_mel(torch.from_numpy(raw), [0], PROMPT, 2, EOT,
                                  pad_count=1, chunk_norm_n_valid=3000)
    assert str(got.value) == str(want.value)


def test_slab_plan_equals_jax():
    """The slab partition: one capacity for every slab, ragged tails
    masked by their valid-frame count."""
    from whisper_tpu.pipeline.pipelined import _slab_plan as jax_plan

    starts = [0, 2500, 5000, 7500, 10000]
    for slab in (1, 2, 3, 4, 100):
        assert pipelined._slab_plan(starts, 10312, slab) == \
            jax_plan(starts, 10312, slab)


class FakeTok:
    """Special ids that fit the nano vocabulary (tests/test_torch_sequential
    .py's); decodes ids as words."""

    _ids = {"<|startoftranscript|>": 3, "<|endoftext|>": 2, "<|en|>": 4,
            "<|transcribe|>": 5, "<|notimestamps|>": 499,
            "<|startofprev|>": 7}
    _tokens: list = []

    def token_to_id(self, t):
        return self._ids.get(t)

    def decode(self, ids, skip_special_tokens=True, timestamp_begin=None):
        return "".join(f" w{i}" for i in ids)


def _both(nano, audio, **kw):
    """Both packages' pipelined mode on the same audio.  Without a
    tokenizer the default special ids (50258 ...) lie past the nano
    vocabulary's 1,000 ids: both packages clamp them into it."""
    jsess, tsess = nano
    kw.setdefault("max_new_tokens", 5)
    want = jax_pipelined(jsess, audio, "en", "transcribe", **kw)
    got = pipelined.transcribe_longform_pipelined(tsess, audio, "en",
                                                  "transcribe", **kw)
    return got, want


@pytest.mark.parametrize("tok", ["default_specials", "fake_tok"])
@pytest.mark.parametrize("slab", [2, 3, 100])
def test_pipelined_text_equals_jax_at_each_slab_size(nano, slab, tok):
    """103 s (five chunks) in slabs of 2, 3 and all: JAX's text, the same
    text at every slab size, and the Timing fields filled; with the
    default special ids (clamped into the nano vocabulary, as JAX clamps
    them) and with FakeTok's, which fit it."""
    audio = _speechy_audio(103 * 16000, seed=4)
    tokenizer = FakeTok() if tok == "fake_tok" else None
    (text, timing), (want, _) = _both(nano, audio, slab_chunks=slab,
                                      tokenizer=tokenizer)
    assert text == want and text
    one, _ = pipelined.transcribe_longform_pipelined(
        nano[1], audio, "en", "transcribe", 5, tokenizer=tokenizer,
        slab_chunks=100)
    assert text == one
    assert timing.preprocess_s > 0 and timing.model_only_s > 0
    assert timing.end_to_end_s >= timing.model_only_s


@pytest.mark.parametrize("slab", [2, 100])
def test_pipelined_odd_geometry_equals_jax(nano, slab):
    """29.5 s windows with a 4.3 s overlap (steps off the hop grid)."""
    audio = _speechy_audio(int(97.7 * 16000), seed=9)
    (text, _), (want, _) = _both(nano, audio, max_new_tokens=4,
                                 chunk_length_s=29.5, overlap_s=4.3,
                                 slab_chunks=slab)
    assert text == want and text


def test_pipelined_empty_audio_returns_empty(nano):
    (text, timing), (want, _) = _both(nano, np.zeros(0, np.float32))
    assert text == want == "" and timing.end_to_end_s >= 0


CASES = {
    "words": dict(words=True),
    "language_auto": dict(language="auto"),
    "words_language_auto_prompt": dict(words=True, language="auto",
                                       initial_prompt_ids=[30, 31, 32]),
    "beams": dict(num_beams=2),
    "timestamps": dict(timestamps=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pipelined_options_equal_jax(nano, case):
    """Word timings on the chunk-normalized windows, language detection on
    chunk 0's window, an initial prompt, beams and the grammar: JAX's text
    and words (times within 0.01 s), a 65 s file in slabs of 2."""
    jsess, tsess = nano
    kw = dict(CASES[case])
    language = kw.pop("language", "en")
    with_words = kw.pop("words", False)
    audio = np.random.default_rng(2).normal(0, 0.1, 65 * 16000).astype(
        np.float32)
    out = []
    for fn, sess in ((pipelined.transcribe_longform_pipelined, tsess),
                     (jax_pipelined, jsess)):
        words = [] if with_words else None
        text, _ = fn(sess, audio, language, "transcribe", 8,
                     tokenizer=FakeTok(), slab_chunks=2,
                     word_collector=words, **kw)
        out.append((text, words))
    (text, words), (want, jwords) = out
    assert text == want and text
    if with_words:
        assert words and [w["word"] for w in words] == \
            [w["word"] for w in jwords]
        for a, b in zip(words, jwords):
            assert abs(a["start"] - b["start"]) <= 0.01
            assert abs(a["end"] - b["end"]) <= 0.01


def test_speculative_pipelined_equals_jax(nano):
    """Speculative decoding over the pipelined mode, a nano draft of its
    own seed attached to both sessions: JAX's text (the greedy text)."""
    jsess, tsess = nano
    dparams = convert.init_params(NANO, seed=5)
    jsess.set_draft_model(dparams, NANO)
    tsess.set_draft_model(dparams, NANO)
    try:
        audio = _speechy_audio(70 * 16000, seed=7)
        (text, _), (want, _) = _both(nano, audio, slab_chunks=2,
                                     speculative=True, draft_k=3)
        greedy, _ = pipelined.transcribe_longform_pipelined(
            tsess, audio, "en", "transcribe", 5, slab_chunks=2)
        assert text == want == greedy
    finally:
        jsess._draft = None
        tsess._draft = None


HD64 = WhisperDims(80, 128, 1, 2, 2, 2, 256, max_source_positions=1500,
                   max_target_positions=48)


class SmallTok(FakeTok):
    _ids = {"<|startoftranscript|>": 100, "<|endoftext|>": 101, "<|en|>": 102,
            "<|transcribe|>": 103, "<|notimestamps|>": 105,
            "<|startofprev|>": 104}


def test_pipelined_at_x5_equals_jax_on_head_dim_64():
    """head_dim 64: the port's kernel step (B3 and B4, their plain
    versions) against the JAX session's packed step (Pallas in interpret
    mode); 60 s in slabs of 2."""
    params = convert.init_params(HD64, seed=3)
    jcfg, _ = jax_apply_variant(JaxCfg(), "x5")
    tcfg, _ = apply_variant(RuntimeCfg(), "x5")
    jsess = JaxSession(params, HD64, jcfg)
    tsess = WhisperSession(params, HD64, tcfg, device="cpu")
    assert tsess._kernel_step and tsess._int8_mxu
    audio = _speechy_audio(60 * 16000, seed=11)
    kw = dict(max_new_tokens=6, tokenizer=SmallTok(), slab_chunks=2)
    want, _ = jax_pipelined(jsess, audio, "en", "transcribe", **kw)
    got, _ = pipelined.transcribe_longform_pipelined(tsess, audio, "en",
                                                     "transcribe", **kw)
    assert got == want and got
