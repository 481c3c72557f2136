"""The port's language detection (``runtime.langdetect``) against the JAX
package's (CPU).

A byte-level BPE tokenizer.json with Whisper's special tokens and four
language tokens is built in the test (as tests/test_initial_prompt.py
builds one) and read by both packages' detokenizers.  ``language_token_ids``
gives JAX's ids with it and without it (the sot+1 .. sot+99 layout).  At x0
fp32 ``detect_language`` picks JAX's language with a probability within
1e-5; through ``transcribe_longform(language="auto")`` both packages detect
the same language and decode the same rows at x0 and x5.  Detection takes
the plain encoder with ``fused_attention`` only, so at x6 (int8 q/k/v/o
leaves kept for W8A8) and with the fused encoder block (one [q|k|v]
weight) it is bitwise what the x5 session detects.
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from whisper_tpu.pipeline.longform import transcribe_longform as jax_longform
from whisper_tpu.runtime import langdetect as jld
from whisper_tpu.runtime.session import RuntimeCfg as JaxCfg
from whisper_tpu.runtime.session import WhisperSession as JaxSession
from whisper_tpu.tokenizer.bpe import WhisperDetokenizer as JaxDetok
from whisper_tpu.variants.ladder import apply_variant as jax_apply_variant
from whisper_tpu_torch.models import convert
from whisper_tpu_torch.models.registry import WhisperDims
from whisper_tpu_torch.pipeline.fallback import transcribe_longform_fallback
from whisper_tpu_torch.pipeline.longform import transcribe_longform
from whisper_tpu_torch.runtime import langdetect
from whisper_tpu_torch.runtime.session import RuntimeCfg, WhisperSession
from whisper_tpu_torch.tokenizer.bpe import WhisperDetokenizer
from whisper_tpu_torch.variants.ladder import apply_variant

torch.set_num_threads(2)

DIMS = WhisperDims(n_mels=80, d_model=128, encoder_layers=2, encoder_heads=2,
                   decoder_layers=2, decoder_heads=2, vocab_size=400,
                   max_source_positions=1500, max_target_positions=32)
LANGS = ("en", "de", "fr", "hi")


@pytest.fixture(scope="module")
def tok_path(tmp_path_factory):
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
    trainer = trainers.BpeTrainer(
        vocab_size=300, initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    tok.train_from_iterator(["some text to build a vocab"], trainer)
    tok.add_special_tokens(
        ["<|endoftext|>", "<|startoftranscript|>"]
        + [f"<|{c}|>" for c in LANGS]
        + ["<|translate|>", "<|transcribe|>", "<|startoflm|>",
           "<|startofprev|>", "<|nospeech|>", "<|notimestamps|>"])
    path = tmp_path_factory.mktemp("tok") / "tokenizer.json"
    tok.save(str(path))
    return str(path)


@pytest.fixture(scope="module")
def tok(tok_path):
    return WhisperDetokenizer.from_file(tok_path)


def test_language_token_ids_equal_jax(tok, tok_path):
    jtok = JaxDetok.from_file(tok_path)
    sot = tok.token_to_id("<|startoftranscript|>")
    ids = langdetect.language_token_ids(tok, sot, DIMS.vocab_size)
    assert ids == jld.language_token_ids(jtok, sot, DIMS.vocab_size)
    assert sorted(ids.values()) == sorted(LANGS)
    # no tokenizer: the standard layout, cut at the vocabulary's end
    for sot, v in ((500, 1000), (50258, 51865), (350, 400)):
        assert langdetect.language_token_ids(None, sot, v) == \
            jld.language_token_ids(None, sot, v)


@pytest.fixture(scope="module")
def params():
    return convert.init_params(DIMS, seed=21)


def _mel(seed):
    rng = np.random.default_rng(seed)
    return rng.normal(0, 1, (DIMS.n_mels, 3000)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_detect_language_equals_jax_at_x0(params, tok, seed):
    cfg = dict(dtype="float32", matmul_precision="highest")
    jsess = JaxSession(params, DIMS, JaxCfg(**cfg))
    tsess = WhisperSession(params, DIMS, RuntimeCfg(**cfg), device="cpu")
    sot = tok.token_to_id("<|startoftranscript|>")
    ids = langdetect.language_token_ids(tok, sot, DIMS.vocab_size)
    mel = _mel(seed)
    code, tid, p = langdetect.detect_language(tsess, torch.from_numpy(mel),
                                              sot, ids)
    jcode, jtid, jp = jld.detect_language(jsess, mel, sot, ids)
    assert (code, tid) == (jcode, jtid)
    assert abs(p - jp) <= 1e-5
    assert langdetect.detect_language(tsess, torch.from_numpy(mel), sot,
                                      {}) is None


def _session(rung, **overrides):
    cfg, _ = apply_variant(RuntimeCfg(), rung)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # x6's W8A8 note
        return WhisperSession(convert.init_params(DIMS, seed=21), DIMS,
                              dataclasses.replace(cfg, **overrides),
                              device="cpu")


@pytest.mark.parametrize("rung,overrides", [
    ("x6", {}), ("x5", dict(fused_encoder_block=True)),
    ("x7", dict(fused_encoder_block=True, fused_decoder_step=True))])
def test_detection_takes_the_plain_encoder_at_every_rung(tok, rung,
                                                         overrides):
    """x6 keeps int8 q/k/v/o leaves and the fused block one [q|k|v]
    weight: detection dequantizes or slices them, and its probabilities
    are bitwise the x5 session's."""
    sot = tok.token_to_id("<|startoftranscript|>")
    ids = langdetect.language_token_ids(tok, sot, DIMS.vocab_size)
    mel = torch.from_numpy(_mel(3))
    want = langdetect.detect_language(_session("x5"), mel, sot, ids)
    assert langdetect.detect_language(_session(rung, **overrides), mel, sot,
                                      ids) == want


def _audio(seconds=40.0):
    rng = np.random.default_rng(4)
    t = np.arange(int(seconds * 16000)) / 16000.0
    x = 0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.standard_normal(t.size)
    return x.astype(np.float32)


class Recorder:
    """Wraps a detokenizer; records the ids of every chunk decoded."""

    def __init__(self, inner):
        self.inner, self.rows = inner, []
        self._tokens = inner._tokens

    def token_to_id(self, t):
        return self.inner.token_to_id(t)

    def decode(self, ids, **kw):
        self.rows.append([int(i) for i in ids])
        return self.inner.decode(ids, **kw)


@pytest.mark.parametrize("rung", ["x0", "x5"])
def test_longform_auto_language_equals_jax(params, tok_path, rung):
    """Both sessions detect one language on the first window (collected),
    put it in the prompt and decode the same rows and text."""
    jcfg, _ = jax_apply_variant(JaxCfg(), rung)
    tcfg, _ = apply_variant(RuntimeCfg(), rung)
    audio = _audio()
    jtok = Recorder(JaxDetok.from_file(tok_path))
    ttok = Recorder(WhisperDetokenizer.from_file(tok_path))
    jlang, tlang = [], []
    jtext, _ = jax_longform(JaxSession(params, DIMS, jcfg), audio, "auto",
                           "transcribe", 5, tokenizer=jtok,
                           language_collector=jlang)
    ttext, _ = transcribe_longform(
        WhisperSession(params, DIMS, tcfg, device="cpu"), audio, "auto",
        "transcribe", 5, tokenizer=ttok, language_collector=tlang)
    assert tlang == jlang and len(tlang) == 1 and tlang[0] in LANGS
    assert ttok.rows == jtok.rows and len(ttok.rows) == 2
    assert ttext == jtext


def test_fallback_auto_language_equals_jax(params, tok_path):
    """The ladder detects on the first window too: at (0.0,) the text
    JAX's ladder gives."""
    from whisper_tpu.pipeline.fallback import (
        transcribe_longform_fallback as jax_fallback,
    )

    cfg = dict(dtype="float32", matmul_precision="highest")
    audio = _audio()
    jtext, _, jinfo = jax_fallback(
        JaxSession(params, DIMS, JaxCfg(**cfg)), audio, "auto", "transcribe",
        5, tokenizer=JaxDetok.from_file(tok_path), temperatures=(0.0,))
    ttext, _, tinfo = transcribe_longform_fallback(
        WhisperSession(params, DIMS, RuntimeCfg(**cfg), device="cpu"), audio,
        "auto", "transcribe", 5,
        tokenizer=WhisperDetokenizer.from_file(tok_path),
        temperatures=(0.0,))
    assert (ttext, tinfo) == (jtext, jinfo)
