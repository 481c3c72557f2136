"""The large family's other configurations on the port against the JAX
package, on the CPU: whisper-large-v3 with a distil-large-v3 draft,
whisper-large-v3 with beam 2, timestamps and translate, and
distil-large-v3's short serving batch.

The toys keep the family's 128 mels, the encoder's 1,500 positions and
the full 51,866-id vocabulary at d = 256 (heads of 64): the main model is
``tests/test_torch_large_family.py``'s (``_dims(128, 256, 2, 4, 2, 4,
51866)``, two decoder layers), the draft is distil-shaped (the same
encoder, one decoder layer).  Weights come from the JAX package's
``init_params`` and are carried across by the port's converter
(``save_params`` / ``load_params``); inputs are made from a seed with
numpy.  Special ids are large-v3's own (``<|translate|>`` 50359,
``<|transcribe|>`` 50360, ``<|notimestamps|>`` 50364, timestamps from
50365), passed through a recording tokenizer.  At x0 (fp32) tokens must be
EQUAL to JAX's, beam scores within 1e-4 (``tests/test_torch_beam.py``'s
bound).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import test_torch_large_family as family
from whisper_tpu.models import convert as jconvert
from whisper_tpu.models import registry as jregistry
from whisper_tpu.models import whisper as jw
from whisper_tpu.pipeline.longform import transcribe_longform as jax_longform
from whisper_tpu.runtime import timestamps as jts
from whisper_tpu.runtime.beam import beam_generate as jax_beam
from whisper_tpu.runtime.genconfig import GenerationCfg as JaxGenCfg
from whisper_tpu.runtime.session import RuntimeCfg as JaxCfg
from whisper_tpu.runtime.session import WhisperSession as JaxSession
from whisper_tpu.runtime.speculative import (
    speculative_generate as jax_speculative,
)
from whisper_tpu.variants.ladder import apply_variant as jax_apply_variant
from whisper_tpu_torch.frontend import golden
from whisper_tpu_torch.models import convert
from whisper_tpu_torch.models import registry
from whisper_tpu_torch.models import whisper as tw
from whisper_tpu_torch.pipeline.chunk import CHUNK_FRAMES
from whisper_tpu_torch.pipeline.longform import transcribe_longform
from whisper_tpu_torch.runtime import timestamps as ts
from whisper_tpu_torch.runtime.beam import beam_generate
from whisper_tpu_torch.runtime.genconfig import GenerationCfg
from whisper_tpu_torch.runtime.generate import (
    build_suppress_mask,
    greedy_generate,
)
from whisper_tpu_torch.runtime.session import RuntimeCfg, WhisperSession
from whisper_tpu_torch.runtime.speculative import speculative_generate
from whisper_tpu_torch.utils import hbm
from whisper_tpu_torch.variants.ladder import apply_variant

torch.set_num_threads(2)

# (n_mels, d, encoder layers, heads, decoder layers, heads, vocab)
MAIN = (128, 256, 2, 4, 2, 4, 51866)
DRAFT = (128, 256, 2, 4, 1, 4, 51866)
DIMS, DRAFT_DIMS = registry._dims(*MAIN), registry._dims(*DRAFT)
JDIMS, JDRAFT = jregistry._dims(*MAIN), jregistry._dims(*DRAFT)
EOT, TS_BEGIN = 50257, 50365
SPECIALS = dict(family.SPECIALS, **{"<|translate|>": 50359})
PROMPT = [50258, 50259, 50360, 50364]        # en, transcribe, no timestamps
TRANSLATE = [50258, 50259, 50359]            # en, translate, timestamps
TS_CFG = (TS_BEGIN, EOT, 50364)
SUPPRESS, BEGIN_SUPPRESS = family.SUPPRESS, family.BEGIN_SUPPRESS
MAX_NEW = 8
DRAFT_K = 4                                  # the verify pass's T = 5


class RecordingTok(family.RecordingTok):
    """large-v3's special ids, ``<|translate|>`` among them; ``decode``
    records each chunk's generated ids, timestamps included."""

    def token_to_id(self, t):
        return SPECIALS.get(t)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """{"main", "draft"}: JAX's ``init_params`` trees, each written by the
    port's ``save_params`` and read back by its ``load_params`` (numpy
    leaves for both packages)."""
    out = {}
    for name, dims, jdims, seed in (("main", DIMS, JDIMS, 3),
                                    ("draft", DRAFT_DIMS, JDRAFT, 5)):
        tree = jconvert.init_params(jdims, seed=seed)
        d = str(tmp_path_factory.mktemp(name))
        convert.save_params(convert._unflatten(
            {k: np.asarray(v, np.float32)
             for k, v in convert._flatten(tree).items()}), dims, d)
        out[name], got = convert.load_params(d)
        assert got == dims
    return out


def _pair(tree):
    """The tree as fp32 for both packages."""
    return (jconvert.cast_params(tree, jnp.float32),
            convert.params_from_numpy(tree, "cpu", torch.float32))


def _masks():
    return (build_suppress_mask(51866, SUPPRESS),
            build_suppress_mask(51866, SUPPRESS + BEGIN_SUPPRESS))


def _sessions(params, dims=DIMS, **over):
    """Sessions of both packages at x0 (fp32, the float32 wire; JAX at
    HIGHEST) with ``over`` of their configs."""
    jcfg, _ = jax_apply_variant(JaxCfg(), "x0")
    tcfg, _ = apply_variant(RuntimeCfg(), "x0")
    return (JaxSession(params, dims, dataclasses.replace(jcfg, **over)),
            WhisperSession(params, dims, dataclasses.replace(tcfg, **over),
                           device="cpu"))


# ---------------------------------------------------------------------------
# whisper-large-v3 with a distil-large-v3 draft
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("share_encoder", [False, True])
def test_speculative_generate_equals_jax(weights, share_encoder):
    """Draft-and-verify over two rows of encoder states, draft_k 4 (five
    queries a verify pass), the distil-shaped draft on its own encoder or
    on the main encoder's states (``share_encoder``), large-v3's prompt and
    suppress masks across the 51,866 ids: the tokens, the verify rounds and
    each row's committed tokens equal JAX's, and the tokens are the port's
    greedy ones (lossless)."""
    (jp, tp), (jd, td) = _pair(weights["main"]), _pair(weights["draft"])
    mel = np.random.default_rng(21).normal(0, 1, (2, 128, CHUNK_FRAMES)) \
        .astype(np.float32)
    jenc = jw.encoder_apply(jp, JDIMS, jnp.asarray(mel))
    tenc = tw.encoder_apply(tp, DIMS, torch.from_numpy(mel))
    if share_encoder:
        jenc_d, tenc_d = jenc, tenc
    else:
        jenc_d = jw.encoder_apply(jd, JDRAFT, jnp.asarray(mel))
        tenc_d = tw.encoder_apply(td, DRAFT_DIMS, torch.from_numpy(mel))
    base, first = _masks()
    jt, jr, jn = jax_speculative(
        jp, JDIMS, jd, JDRAFT, jenc, jenc_d, jnp.asarray(PROMPT, jnp.int32),
        jnp.asarray(base), jnp.asarray(first), max_new_tokens=MAX_NEW,
        eot_id=EOT, draft_k=DRAFT_K)
    tt, tr, tn = speculative_generate(
        tp, DIMS, td, DRAFT_DIMS, tenc, tenc_d, torch.tensor(PROMPT),
        torch.from_numpy(base), torch.from_numpy(first),
        max_new_tokens=MAX_NEW, eot_id=EOT, draft_k=DRAFT_K)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert int(tr) == int(jr)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    greedy = greedy_generate(tp, DIMS, tenc, torch.tensor(PROMPT),
                             torch.from_numpy(base), torch.from_numpy(first),
                             MAX_NEW, EOT)
    assert torch.equal(tt, greedy)


@pytest.mark.parametrize("share_encoder", [False, True])
def test_set_draft_model_longform_equals_jax(weights, share_encoder):
    """``set_draft_model(share_encoder=...)`` and ``transcribe_longform(
    speculative=True)`` on a 40 s clip (two chunks in a bucket of two) with
    large-v3's special ids: each chunk's tokens equal JAX's speculative
    ones and the port's greedy ones; the session's ``speculative_stats``
    hold the bucket's verify rounds (a random draft's proposals are
    rejected: at most one round a token after the first) and each row's
    committed tokens, and with the shared encoder the draft's encoder
    never reaches the device."""
    audio = family._audio()
    jsess, tsess = _sessions(weights["main"], max_batch=2)
    kw = dict(language="en", task="transcribe", max_new_tokens=MAX_NEW)
    greedy_tok = RecordingTok()
    transcribe_longform(tsess, audio, tokenizer=greedy_tok, **kw)
    jsess.set_draft_model(weights["draft"], JDRAFT,
                          share_encoder=share_encoder)
    tsess.set_draft_model(weights["draft"], DRAFT_DIMS,
                          share_encoder=share_encoder)
    assert (tsess._draft[0] is None) == share_encoder
    jtok, ttok = RecordingTok(), RecordingTok()
    jax_longform(jsess, audio, tokenizer=jtok, speculative=True,
                 draft_k=DRAFT_K, **kw)
    transcribe_longform(tsess, audio, tokenizer=ttok, speculative=True,
                        draft_k=DRAFT_K, **kw)
    assert len(ttok.rows) == 2
    assert ttok.rows == jtok.rows == greedy_tok.rows
    (rounds, committed), = tsess.speculative_stats
    assert 1 <= int(rounds) <= MAX_NEW - 1
    assert all(MAX_NEW <= n <= MAX_NEW + DRAFT_K for n in committed.tolist())


# ---------------------------------------------------------------------------
# whisper-large-v3 with beam 2, timestamps and translate
# ---------------------------------------------------------------------------

def test_beam_generate_with_the_grammar_equals_jax(weights):
    """Beam 2 over two rows of encoder states with the timestamp grammar at
    large-v3's ids (timestamps from 50365, <|notimestamps|> 50364) and the
    translate prompt: the tokens equal JAX's and the scores lie within
    1e-4; each row opens with a timestamp of at most 1.0 s, and its
    timestamps never decrease."""
    jp, tp = _pair(weights["main"])
    enc = np.random.default_rng(22).normal(
        0, 1, (2, 1500, 256)).astype(np.float32)
    base, first = _masks()
    jt, js = jax_beam(jp, JDIMS, jnp.asarray(enc),
                      jnp.asarray(TRANSLATE, jnp.int32), jnp.asarray(base),
                      jnp.asarray(first), MAX_NEW, EOT, 2,
                      ts_cfg=jts.TimestampCfg(*TS_CFG))
    tt, tsc = beam_generate(tp, DIMS, torch.from_numpy(enc),
                            torch.tensor(TRANSLATE), torch.from_numpy(base),
                            torch.from_numpy(first), MAX_NEW, EOT, 2,
                            ts_cfg=ts.TimestampCfg(*TS_CFG))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tsc.numpy(), np.asarray(js), rtol=0,
                               atol=1e-4)
    for row in tt.tolist():
        assert TS_BEGIN <= row[0] <= TS_BEGIN + 50
        stamps = [t for t in row if t >= TS_BEGIN]
        assert stamps == sorted(stamps)


def test_longform_beams_timestamps_translate_equal_jax(weights,
                                                       monkeypatch):
    """``transcribe_longform(num_beams=2, timestamps=True,
    task="translate")`` on the 40 s clip (two chunks, four beam rows
    against the cross cache tiled per beam) with large-v3's ids: the
    program's prompt is [<|startoftranscript|>, <|en|>, <|translate|>]
    (50359, no <|notimestamps|>), every chunk opens with a timestamp from
    50365 on, and each chunk's tokens, timestamps included, and the
    stitched text equal JAX's."""
    audio = family._audio()
    jsess, tsess = _sessions(weights["main"], max_batch=2)
    prompts = []
    call = tsess.transcribe_from_mel

    def recording(mel, starts, **kw):
        prompts.append(list(kw["prompt"]))
        return call(mel, starts, **kw)

    monkeypatch.setattr(tsess, "transcribe_from_mel", recording)
    kw = dict(language="en", task="translate", max_new_tokens=MAX_NEW,
              timestamps=True, num_beams=2)
    jtok, ttok = RecordingTok(), RecordingTok()
    jtext, _ = jax_longform(jsess, audio, tokenizer=jtok,
                            gen_cfg=JaxGenCfg(SUPPRESS, BEGIN_SUPPRESS), **kw)
    ttext, _ = transcribe_longform(
        tsess, audio, tokenizer=ttok,
        gen_cfg=GenerationCfg(SUPPRESS, BEGIN_SUPPRESS), **kw)
    assert prompts == [TRANSLATE]
    assert len(ttok.rows) == 2 and ttok.rows == jtok.rows
    assert all(TS_BEGIN <= row[0] <= TS_BEGIN + 50 for row in ttok.rows)
    assert ttext == jtext


# ---------------------------------------------------------------------------
# distil-large-v3 serving
# ---------------------------------------------------------------------------

def test_short_batch_at_the_distil_toy_equals_jax(weights):
    """The serving path's short batch at the distil-shaped toy (its own
    weights as the model): four clips of 1, 4.5, 11 and 29.5 s
    reflect-padded into the full 30 s window, one batch of four, large-v3's
    prompt and suppress masks across 51,866 ids: the tokens equal JAX's."""
    clips = [family._audio(s, seed=i)
             for i, s in enumerate((1.0, 4.5, 11.0, 29.5))]
    pad_len = CHUNK_FRAMES * 160 + 400
    audio = np.zeros((4, pad_len), np.float32)
    n_valid = np.zeros(4, np.int32)
    for i, c in enumerate(clips):
        p = golden.reflect_pad(c)
        audio[i, :len(p)] = p
        n_valid[i] = golden.num_frames(len(c))
    jsess, tsess = _sessions(weights["draft"], DRAFT_DIMS, max_batch=4)
    args = (audio, n_valid, PROMPT, MAX_NEW, EOT, SUPPRESS, BEGIN_SUPPRESS)
    want = np.asarray(jsess.transcribe_short_batch(*args))
    got = tsess.transcribe_short_batch(*args)
    assert got.shape == (4, MAX_NEW)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# The gate's price of a speculative program's pools, against the card's
# ---------------------------------------------------------------------------

# A speculative bucket program's memory pools on the card (NVIDIA H100 80GB
# HBM3, whisper-large-v3 at x5, bucket 16, with a distil-large-v3 draft;
# GiB), measured by chip_smoke.py's [large] (e) lines (PERF.md §6).  With
# its own encoder the draft's 32 layers run plain, their fp32 scores and
# probabilities [16, 20, 1500, 1500] held in the pool.
CARD_SPEC_POOLS = [(False, 7.785), (True, 1.076)]


@pytest.mark.parametrize("share_encoder, gib", CARD_SPEC_POOLS)
def test_program_pool_bytes_prices_the_drafts_plain_encoder(share_encoder,
                                                            gib):
    """``program_pool_bytes`` with a draft (``speculative_footprint``'s
    price of the program's pools before any key is captured) within 1.5x
    of what the card's program kept, either way; it once priced the
    draft's own encoder with the main encoder's fused attention, 3.3x
    low."""
    est = hbm.program_pool_bytes(
        registry.get_dims("openai/whisper-large-v3"), 16, 4, act_bytes=2,
        draft_dims=None if share_encoder else registry.get_dims(
            "distil-whisper/distil-large-v3")) / 2 ** 30
    assert gib / 1.5 <= est <= 1.5 * gib, (est, gib)
