"""The port's temperature sampling, decoding scores and fallback ladder
(``runtime.generate``, ``pipeline.fallback``) against the JAX package's
(CPU).

The quality gates are host code: equal to JAX's on a list of strings.  At
T = 0 the scores of ``greedy_generate(return_logprobs=True)`` at x0 fp32
are JAX's (``sum_lp`` within 1e-4 relative, ``n_tok`` equal) and the
tokens the plain loop's.  Sampling cannot match ``jax.random`` draw for
draw, so it is held to its distribution: 4,096 draws from fixed logits
(V = 8) fall on each id within 4 standard deviations of softmax(logits /
T), a suppressed id never, and a seeded ``torch.Generator`` repeats its
draws.  The ladder at (0.0,) gives JAX's text; impossible gates walk both
packages to the last rung.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from whisper_tpu.models import convert as jconvert
from whisper_tpu.pipeline import fallback as jfb
from whisper_tpu.runtime.generate import greedy_generate as jax_greedy
from whisper_tpu.runtime.session import RuntimeCfg as JaxCfg
from whisper_tpu.runtime.session import WhisperSession as JaxSession
from whisper_tpu_torch.models import convert
from whisper_tpu_torch.models.registry import WhisperDims
from whisper_tpu_torch.ops.sampling import generator_key
from whisper_tpu_torch.pipeline import fallback
from whisper_tpu_torch.runtime.generate import (
    build_suppress_mask,
    greedy_generate,
    pick,
)
from whisper_tpu_torch.runtime.session import RuntimeCfg, WhisperSession

torch.set_num_threads(2)

TEXTS = ["", "a", "the the the the the the the the " * 20,
         "an ordinary varied sentence with many distinct words",
         "a a a a a a a a a a a a " * 30, "ok text", "fine output here",
         "[TOKENS:299 299 299 299 299 299]", "héllo wörld ünïcode " * 3]


@pytest.mark.parametrize("text", TEXTS)
def test_quality_gates_equal_jax(text):
    assert fallback.compression_ratio(text) == jfb.compression_ratio(text)
    for lp in (-3.0, -1.0, -0.2):
        for thr in (2.4, 1.5):
            assert fallback.needs_fallback(text, lp, thr) == \
                jfb.needs_fallback(text, lp, thr)


DIMS = WhisperDims(n_mels=80, d_model=128, encoder_layers=2, encoder_heads=2,
                   decoder_layers=2, decoder_heads=2, vocab_size=320,
                   max_source_positions=96, max_target_positions=32)
SOT, EOT, LANG, TASK, NO_TS = 250, 251, 252, 253, 254
PROMPT = [SOT, LANG, TASK, NO_TS]


def _model(seed, b=3):
    rng = np.random.default_rng(seed)
    enc = rng.normal(0, 1, (b, 96, 128)).astype(np.float32)
    jp = jconvert.cast_params(jconvert.init_params(DIMS, seed), jnp.float32)
    tp = convert.params_from_numpy(convert.init_params(DIMS, seed), "cpu",
                                   torch.float32)
    return enc, jp, tp


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_t0_scores_equal_jax_and_tokens_the_plain_loops(seed):
    """EOT is made the greedy chain's third token of row 0, so rows stop
    at different steps and n_tok differs between them."""
    enc, jp, tp = _model(seed)
    zero = build_suppress_mask(DIMS.vocab_size, [])
    args = (tp, DIMS, torch.from_numpy(enc), torch.tensor(PROMPT),
            torch.from_numpy(zero), torch.from_numpy(zero), 10)
    eot = int(greedy_generate(*args, EOT)[0, 2])
    plain = greedy_generate(*args, eot)
    toks, sum_lp, n_tok = greedy_generate(*args, eot, return_logprobs=True)
    assert torch.equal(toks, plain)
    jt, jlp, jn = jax_greedy(jp, DIMS, jnp.asarray(enc),
                             jnp.asarray(PROMPT, jnp.int32),
                             jnp.asarray(zero), jnp.asarray(zero), 10, eot,
                             return_logprobs=True)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(n_tok.numpy(), np.asarray(jn))
    np.testing.assert_allclose(sum_lp.numpy(), np.asarray(jlp), rtol=1e-4,
                               atol=0)
    # n_tok counts each row's tokens up to and including its first EOT
    for row, n in zip(toks.numpy(), n_tok.numpy()):
        ends = np.nonzero(row == eot)[0]
        assert n == (ends[0] + 1 if ends.size else row.size)
    assert (n_tok.numpy() < 10).any()


@pytest.mark.parametrize("temperature", [0.5, 1.0, 2.0])
def test_sampled_frequencies_follow_the_softmax(temperature):
    """4,096 draws of one row of logits (one row per draw, one key):
    each id's count within 4 sigma of 4,096 * softmax(logits / T), the
    suppressed id never drawn; the log-probability is that of the masked
    distribution at T = 1."""
    n = 4096
    logits = torch.tensor([1.0, 0.5, -0.3, 2.0, 0.0, -1.0, 1.5, -np.inf])
    rows = logits.expand(n, -1).contiguous()
    key = generator_key(torch.Generator().manual_seed(3), "cpu")
    tok, lp = pick(rows, temperature, key, 1, True)
    counts = np.bincount(tok.numpy(), minlength=8)
    p = torch.softmax(logits / temperature, -1).double().numpy()
    sigma = np.sqrt(n * p * (1 - p))
    assert counts[7] == 0
    assert (np.abs(counts - n * p) <= 4 * sigma + 1e-9).all(), (counts, n * p)
    want_lp = torch.log_softmax(logits, -1)[tok]
    assert torch.equal(lp, want_lp)


def test_sampling_is_deterministic_per_seed_and_never_draws_a_suppressed_id():
    enc, _, tp = _model(4)
    suppress = list(range(0, 320, 3))
    base = torch.from_numpy(build_suppress_mask(DIMS.vocab_size, suppress))

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return greedy_generate(tp, DIMS, torch.from_numpy(enc),
                               torch.tensor(PROMPT), base, base, 12, EOT,
                               temperature=1.0, generator=g,
                               return_logprobs=True)

    a, b, c = run(7), run(7), run(8)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[0], c[0])
    assert not np.isin(a[0].numpy(), suppress).any()
    assert torch.isfinite(a[1]).all()
    with pytest.raises(ValueError, match="generator"):
        greedy_generate(tp, DIMS, torch.from_numpy(enc), torch.tensor(PROMPT),
                        base, base, 4, EOT, temperature=0.5)


# ---------------------------------------------------------------------------
# The session and the ladder
# ---------------------------------------------------------------------------

LONG = dataclasses.replace(DIMS, max_source_positions=1500)


class Tok:
    ids = {"<|startoftranscript|>": SOT, "<|endoftext|>": EOT,
           "<|en|>": LANG, "<|transcribe|>": TASK, "<|notimestamps|>": NO_TS}

    def token_to_id(self, t):
        return self.ids.get(t)

    def decode(self, ids, skip_special_tokens=True, **_):
        return " ".join(f"w{i}" for i in ids)


@pytest.fixture(scope="module")
def sessions():
    params = convert.init_params(LONG, seed=13)
    cfg = dict(dtype="float32", matmul_precision="highest", max_batch=4)
    return (JaxSession(params, LONG, JaxCfg(**cfg)),
            WhisperSession(params, LONG, RuntimeCfg(**cfg), device="cpu"))


def _audio(seconds=40.0):
    rng = np.random.default_rng(9)
    return (0.05 * rng.standard_normal(int(seconds * 16000))).astype(
        np.float32)


def test_session_scores_equal_jax(sessions):
    """``transcribe_from_mel(with_scores=True)`` at T = 0 over two chunks:
    JAX's tokens and counts, sums within 1e-4 relative, tokens the plain
    call's."""
    jsess, tsess = sessions
    from whisper_tpu_torch.frontend import golden
    from whisper_tpu_torch.pipeline.chunk import mel_frame_bucket

    audio = _audio()
    padded = golden.reflect_pad(audio)
    nv = golden.num_frames(len(audio))
    mel_t = tsess.compute_mel(padded, nv, mel_frame_bucket(nv))
    mel_j = jsess.compute_mel(padded, nv, mel_frame_bucket(nv))
    kw = dict(prompt=PROMPT, max_new_tokens=6, eot_id=EOT)
    toks, lp, nt = tsess.transcribe_from_mel(mel_t, [0, 2500], **kw,
                                             with_scores=True)
    jt, jlp, jnt = jsess.transcribe_from_mel(mel_j, [0, 2500], **kw,
                                             with_scores=True)
    np.testing.assert_array_equal(toks, tsess.transcribe_from_mel(
        mel_t, [0, 2500], **kw))
    np.testing.assert_array_equal(toks, jt)
    np.testing.assert_array_equal(nt, jnt)
    np.testing.assert_allclose(lp, jlp, rtol=1e-4, atol=0)


def test_ladder_at_t0_equals_jax(sessions):
    jsess, tsess = sessions
    audio = _audio()
    jtext, _, jinfo = jfb.transcribe_longform_fallback(
        jsess, audio, "en", "transcribe", 6, tokenizer=Tok(),
        temperatures=(0.0,))
    ttext, timing, tinfo = fallback.transcribe_longform_fallback(
        tsess, audio, "en", "transcribe", 6, tokenizer=Tok(),
        temperatures=(0.0,))
    assert ttext == jtext and tinfo == jinfo == {"accepted_at": [0.0, 0.0]}
    assert timing.end_to_end_s >= timing.model_only_s > 0


def test_impossible_gates_walk_both_packages_to_the_last_rung(sessions):
    """logprob_threshold = +inf fails every chunk at every rung: each rung
    decodes every chunk again (seed + rung), and both packages accept every
    chunk at the last one.  Two runs with one seed give the same tokens at
    each rung; another seed gives other tokens."""
    jsess, tsess = sessions
    audio = _audio()
    temps = (0.0, 0.5, 1.0)
    kw = dict(tokenizer=Tok(), temperatures=temps,
              logprob_threshold=float("inf"))
    _, _, jinfo = jfb.transcribe_longform_fallback(
        jsess, audio, "en", "transcribe", 5, **kw)
    runs = []
    for seed in (0, 0, 1):
        rungs = []
        _, _, info = fallback.transcribe_longform_fallback(
            tsess, audio, "en", "transcribe", 5, seed=seed,
            token_collector=rungs, **kw)
        assert info == jinfo == {"accepted_at": [1.0, 1.0]}
        assert [(t, idx) for t, idx, _ in rungs] == [(t, [0, 1])
                                                     for t in temps]
        runs.append([toks for _, _, toks in rungs])
    for a, b in zip(runs[0], runs[1]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(runs[0][0], runs[2][0])   # T = 0
    assert not all(np.array_equal(a, c) for a, c in zip(runs[0][1:],
                                                        runs[2][1:]))


@pytest.mark.parametrize("rung,overrides", [
    ("x5", {}), ("x7", {}), ("x4", {}),
    ("x5", dict(fused_decoder_step=True))])
def test_sampling_runs_on_every_decode_step(rung, overrides):
    """Sampling with scores through the kernel step (B3/B8 with B4/B6, their
    plain versions here) and the hybrid step (B10c's): the same seed gives
    the same tokens and sums, another seed other tokens, every sum
    finite."""
    from whisper_tpu_torch.variants.ladder import apply_variant

    cfg, _ = apply_variant(RuntimeCfg(max_batch=4), rung)
    sess = WhisperSession(convert.init_params(LONG, seed=13), LONG,
                          dataclasses.replace(cfg, **overrides), device="cpu")
    mel = torch.from_numpy(np.random.default_rng(0).normal(
        0, 1, (80, 6000)).astype(np.float32))

    def run(seed):
        return sess.transcribe_from_mel(mel, [0, 2500, 3000], PROMPT, 8, EOT,
                                        temperature=1.0, seed=seed,
                                        with_scores=True)

    a, b, c = run(5), run(5), run(6)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a[0], c[0])
    assert np.isfinite(a[1]).all() and (a[2] >= 1).all()
