"""The port's left-padded conditioned prompts against the JAX package's
(CPU).

A conditioned prompt has one static length: its first ``pad_count`` slots
are left padding, masked in ``decoder_prefill`` (``prompt_mask``) and on
every ``decoder_step`` (``pad_count``), so each row decodes as its
unpadded shorter prompt would.  Held here, on weights from
``init_params(dims, seed)`` and encoder states made from a seed with numpy:

- the prefill with a mask within 1e-5 of JAX's at x0 fp32, and of the
  port's own unpadded shorter prompt, row by row;
- ``decoder_step`` with ``pad_count`` (plain, and through the cross-
  attention kernels' plain versions) within 1e-5 of JAX's;
- ``greedy_generate`` and ``beam_generate`` (K = 2) with mixed pad counts:
  JAX's tokens, token for token;
- at x5 and x7 (the plain versions of B3 and B8, which take ``pad_count``)
  the padded run gives the tokens of the unpadded runs;
- the session (``transcribe_from_mel(pad_count=...)``) at x0 and x5, and
  ``transcribe_longform(initial_prompt_ids=...)``, JAX's rows;
- ``encode_text`` JAX's ids with a tokenizer built in the test.

The model: d_model 128, two heads of 64, two decoder layers, vocab 320.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from whisper_tpu.models import convert as jconvert
from whisper_tpu.models import whisper as jw
from whisper_tpu.pipeline.longform import transcribe_longform as jax_longform
from whisper_tpu.runtime.beam import beam_generate as jax_beam
from whisper_tpu.runtime.generate import greedy_generate as jax_greedy
from whisper_tpu.runtime.session import RuntimeCfg as JaxCfg
from whisper_tpu.runtime.session import WhisperSession as JaxSession
from whisper_tpu.tokenizer.bpe import encode_text as jax_encode_text
from whisper_tpu.variants.ladder import apply_variant as jax_apply_variant
from whisper_tpu_torch.models import convert
from whisper_tpu_torch.models import whisper as tw
from whisper_tpu_torch.models.registry import WhisperDims
from whisper_tpu_torch.pipeline.longform import transcribe_longform
from whisper_tpu_torch.runtime.beam import beam_generate
from whisper_tpu_torch.runtime.generate import (
    build_suppress_mask,
    greedy_generate,
)
from whisper_tpu_torch.runtime.session import RuntimeCfg, WhisperSession
from whisper_tpu_torch.tokenizer.bpe import encode_text
from whisper_tpu_torch.variants.ladder import apply_variant

torch.set_num_threads(2)

DIMS = WhisperDims(n_mels=80, d_model=128, encoder_layers=2, encoder_heads=2,
                   decoder_layers=2, decoder_heads=2, vocab_size=320,
                   max_source_positions=96, max_target_positions=48)
SOT, EOT, LANG, TASK, NO_TS, SOT_PREV = 250, 251, 252, 253, 254, 255
# [pad slots | <|startofprev|> + tail | sot, lang, task, notimestamps]
PROMPT = [EOT] * 3 + [SOT_PREV, 17, 99, 140, 33, 61, 7] + [SOT, LANG, TASK,
                                                           NO_TS]
PADS = [3, 5, 9]          # row r's real prompt is PROMPT[PADS[r]:]
SUPPRESS = [8, 300]
TOL = 1e-5
LONG_DIMS = dataclasses.replace(DIMS, max_source_positions=1500)


def _inputs(seed, b=3):
    rng = np.random.default_rng(seed)
    enc = rng.normal(0, 1, (b, DIMS.max_source_positions,
                            DIMS.d_model)).astype(np.float32)
    jp = jconvert.cast_params(jconvert.init_params(DIMS, seed), jnp.float32)
    tp = convert.params_from_numpy(convert.init_params(DIMS, seed), "cpu",
                                   torch.float32)
    return enc, jp, tp


def _masks():
    base = build_suppress_mask(DIMS.vocab_size, SUPPRESS)
    first = build_suppress_mask(DIMS.vocab_size, SUPPRESS + [EOT])
    return base, first


def _prompt_mask(p, pads):
    return np.arange(p)[None, :] >= np.asarray(pads)[:, None]


@pytest.mark.parametrize("seed", [0, 1])
def test_prefill_with_a_prompt_mask_equals_jax_and_the_unpadded_prompt(seed):
    enc, jp, tp = _inputs(seed)
    toks = np.asarray([PROMPT] * 3, np.int32)
    p = len(PROMPT)
    mask = _prompt_mask(p, PADS)
    jl, jc = jw.decoder_prefill(jp, DIMS, jnp.asarray(toks),
                                jnp.asarray(enc), p + 4,
                                prompt_mask=jnp.asarray(mask))
    tl, tc = tw.decoder_prefill(tp, DIMS, torch.from_numpy(toks).long(),
                                torch.from_numpy(enc), p + 4,
                                prompt_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL)
    np.testing.assert_allclose(tc.self_k.numpy(), np.asarray(jc.self_k),
                               atol=TOL)
    for r, pad in enumerate(PADS):
        ul, uc = tw.decoder_prefill(
            tp, DIMS, torch.tensor([PROMPT[pad:]]), torch.from_numpy(enc[r:r + 1]),
            p + 4)
        np.testing.assert_allclose(tl[r, pad:].numpy(), ul[0].numpy(),
                                   atol=TOL)
        # the real rows' K/V sit pad slots later in the padded cache
        np.testing.assert_allclose(tc.self_k[:, r, :, pad:p].numpy(),
                                   uc.self_k[:, 0, :, :p - pad].numpy(),
                                   atol=TOL)


@pytest.mark.parametrize("cross", ["plain", "int8_kernels"])
def test_decoder_step_with_pad_count_equals_jax(cross):
    """Six steps teacher-forced after a padded prefill: each step's logits
    within 1e-5 of JAX's.  ``int8_kernels``: the int8 cross cache through
    the cross-attention kernels' plain versions (``cross_len``), the step
    beams and drafts take."""
    enc, jp, tp = _inputs(2)
    toks = np.asarray([PROMPT] * 3, np.int32)
    p = len(PROMPT)
    mask = _prompt_mask(p, PADS)
    i8 = cross == "int8_kernels"
    _, jc = jw.decoder_prefill(jp, DIMS, jnp.asarray(toks), jnp.asarray(enc),
                               p + 6, prompt_mask=jnp.asarray(mask),
                               int8_cross_kv=i8)
    _, tc = tw.decoder_prefill(tp, DIMS, torch.from_numpy(toks).long(),
                               torch.from_numpy(enc), p + 6,
                               prompt_mask=torch.from_numpy(mask),
                               int8_cross_kv=i8)
    pads = np.asarray(PADS, np.int32)
    cross_len = DIMS.max_source_positions if i8 else None
    if i8:      # JAX's packed int8 cross cache, as its beam search packs it
        jc = jw.pack_cross_cache(jc, transpose_k=True)
    rng = np.random.default_rng(4)
    for i in range(6):
        tok = rng.integers(0, 250, 3).astype(np.int32)
        jl, jc = jw.decoder_step(jp, DIMS, jnp.asarray(tok), jnp.int32(p + i),
                                 jc, pad_count=jnp.asarray(pads),
                                 cross_len=cross_len, int8_mxu=True)
        tl, tc = tw.decoder_step(tp, DIMS, torch.from_numpy(tok).long(),
                                 p + i, tc, pad_count=torch.from_numpy(pads),
                                 cross_len=cross_len, int8_mxu=True)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL)


def _greedy_both(seed, max_new=8):
    enc, jp, tp = _inputs(seed)
    base, first = _masks()
    pads = np.asarray(PADS, np.int32)
    jt = jax_greedy(jp, DIMS, jnp.asarray(enc), jnp.asarray(PROMPT, jnp.int32),
                    jnp.asarray(base), jnp.asarray(first), max_new, EOT,
                    pad_count=jnp.asarray(pads))
    tt = greedy_generate(tp, DIMS, torch.from_numpy(enc), torch.tensor(PROMPT),
                         torch.from_numpy(base), torch.from_numpy(first),
                         max_new, EOT, pad_count=torch.from_numpy(pads))
    return np.asarray(jt), tt.numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_with_mixed_pad_counts_equals_jax(seed):
    jt, tt = _greedy_both(seed)
    np.testing.assert_array_equal(tt, jt)


@pytest.mark.parametrize("seed", [0, 1])
def test_beam_k2_with_mixed_pad_counts_equals_jax(seed):
    enc, jp, tp = _inputs(seed)
    base, first = _masks()
    pads = np.asarray(PADS, np.int32)
    jt, js = jax_beam(jp, DIMS, jnp.asarray(enc),
                      jnp.asarray(PROMPT, jnp.int32), jnp.asarray(base),
                      jnp.asarray(first), 8, EOT, 2,
                      pad_count=jnp.asarray(pads))
    tt, tsc = beam_generate(tp, DIMS, torch.from_numpy(enc),
                            torch.tensor(PROMPT), torch.from_numpy(base),
                            torch.from_numpy(first), 8, EOT, 2,
                            pad_count=torch.from_numpy(pads))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tsc.numpy(), np.asarray(js), atol=1e-4)


def _unpadded_rows(fn):
    """fn(prompt [P'], rows) -> tokens of those rows unpadded, one call per
    distinct pad count."""
    out = {}
    for pad in sorted(set(PADS)):
        rows = [r for r, x in enumerate(PADS) if x == pad]
        toks = fn(PROMPT[pad:], rows)
        for j, r in enumerate(rows):
            out[r] = toks[j]
    return np.stack([out[r] for r in range(len(PADS))])


@pytest.mark.parametrize("rung", ["x5", "x7", "x5_beam"])
def test_padded_equals_unpadded_through_the_plain_kernel_steps(rung):
    """A session's decoder weights at x5 (B3's and B4's plain versions on
    the kernel step), x7 (B8's) and x5 beam search (plain self-attention,
    B4's plain version at B*K rows): the padded run's tokens are the
    unpadded runs' tokens, row by row."""
    variant = rung.split("_")[0]
    cfg, _ = apply_variant(RuntimeCfg(), variant)
    sess = WhisperSession(convert.init_params(DIMS, 5), DIMS, cfg,
                          device="cpu")
    enc = torch.from_numpy(_inputs(5)[0]).to(torch.bfloat16)
    base, first = (torch.from_numpy(m) for m in _masks())
    p = sess._decoder_params

    def decode(prompt, rows, pad_count=None):
        if rung == "x5_beam":
            return beam_generate(p, DIMS, enc[rows], torch.tensor(prompt),
                                 base, first, 10, EOT, 2, int8_cross_kv=True,
                                 packed_cross=True, int8_mxu=True,
                                 pad_count=pad_count)[0].numpy()
        return greedy_generate(p, DIMS, enc[rows], torch.tensor(prompt),
                               base, first, 10, EOT, int8_cross_kv=True,
                               kernel_step=True, int8_mxu=True,
                               int8_self=rung == "x7",
                               pad_count=pad_count).numpy()

    padded = decode(PROMPT, [0, 1, 2], torch.tensor(PADS, dtype=torch.int32))
    np.testing.assert_array_equal(padded, _unpadded_rows(decode))


@pytest.mark.parametrize("rung,pad", [("x0", 4), ("x5", 4), ("x0", 0)])
def test_session_pad_count_equals_jax(rung, pad):
    """``transcribe_from_mel(pad_count=...)``: the JAX session's tokens
    for two chunks (x5: the kernels' plain versions against JAX's Pallas
    kernels in interpret mode)."""
    params = convert.init_params(LONG_DIMS, 6)
    jcfg, _ = jax_apply_variant(JaxCfg(), rung)
    tcfg, _ = apply_variant(RuntimeCfg(), rung)
    jsess = JaxSession(params, LONG_DIMS, jcfg)
    tsess = WhisperSession(params, LONG_DIMS, tcfg, device="cpu")
    mel = np.random.default_rng(6).normal(0, 1, (80, 3400)).astype(
        np.float32)
    kw = dict(prompt=[EOT] * pad + PROMPT[3:], max_new_tokens=6, eot_id=EOT,
              suppress_ids=SUPPRESS, pad_count=pad)
    jt = jsess.transcribe_from_mel(jnp.asarray(mel), [0, 400], **kw)
    tt = tsess.transcribe_from_mel(torch.from_numpy(mel), [0, 400], **kw)
    np.testing.assert_array_equal(tt, np.asarray(jt))


class RecordingTok:
    ids = {"<|startoftranscript|>": SOT, "<|endoftext|>": EOT,
           "<|en|>": LANG, "<|transcribe|>": TASK, "<|notimestamps|>": NO_TS,
           "<|startofprev|>": SOT_PREV}

    def __init__(self):
        self.rows = []

    def token_to_id(self, t):
        return self.ids.get(t)

    def decode(self, ids, skip_special_tokens=True, **_):
        self.rows.append([int(i) for i in ids])
        return " ".join(f"w{i}" for i in ids)


@pytest.mark.parametrize("rung", ["x0", "x5"])
def test_longform_initial_prompt_equals_jax(rung):
    """``transcribe_longform(initial_prompt_ids=...)`` prefixes every
    chunk's prompt with <|startofprev|> and the ids, unpadded: JAX's rows
    and text for a 40 s file (two chunks), and other rows than without
    the prompt."""
    params = convert.init_params(LONG_DIMS, 8)
    jcfg, _ = jax_apply_variant(JaxCfg(), rung)
    tcfg, _ = apply_variant(RuntimeCfg(), rung)
    jsess = JaxSession(params, LONG_DIMS, jcfg)
    tsess = WhisperSession(params, LONG_DIMS, tcfg, device="cpu")
    audio = np.random.default_rng(8).normal(0, 0.1, 40 * 16000).astype(
        np.float32)
    ids = [33, 44, 55, 66]
    jtok, ttok, plain = RecordingTok(), RecordingTok(), RecordingTok()
    jtext, _ = jax_longform(jsess, audio, "en", "transcribe", 6,
                            tokenizer=jtok, initial_prompt_ids=ids)
    ttext, _ = transcribe_longform(tsess, audio, "en", "transcribe", 6,
                                   tokenizer=ttok, initial_prompt_ids=ids)
    transcribe_longform(tsess, audio, "en", "transcribe", 6, tokenizer=plain)
    assert ttok.rows == jtok.rows and ttext == jtext
    assert ttok.rows != plain.rows


@pytest.fixture(scope="module")
def tokenizer_json(tmp_path_factory):
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
        vocab_size=400, initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    tok.train_from_iterator(["hello proper nouns like Kubernetes"], trainer)
    path = str(tmp_path_factory.mktemp("tok") / "tokenizer.json")
    tok.save(path)
    return path


@pytest.mark.parametrize("text", ["hello Kubernetes", "  proper nouns ",
                                  "likeé unseen words"])
def test_encode_text_equals_jax(tokenizer_json, text):
    ids = encode_text(tokenizer_json, text)
    assert ids and ids == jax_encode_text(tokenizer_json, text)


def test_encode_text_without_tokenizers_raises_its_message(monkeypatch,
                                                            tokenizer_json):
    import builtins

    real_import = builtins.__import__

    def no_tokenizers(name, *args, **kwargs):
        if name == "tokenizers":
            raise ImportError("no tokenizers")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_tokenizers)
    with pytest.raises(RuntimeError, match="needs the `tokenizers` package"):
        encode_text(tokenizer_json, "hello")
