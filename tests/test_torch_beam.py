"""The port's beam search (``runtime.beam``) against the JAX package's
(CPU).

Same weights (``init_params(dims, seed)``) and the same encoder states,
made from a seed with numpy, through ``whisper_tpu.runtime.beam`` and
``whisper_tpu_torch.runtime.beam`` at x0 fp32: tokens EQUAL, scores within
1e-4 (absolute, on sums of a few log-probabilities).  The model: d_model
128, two heads of 64, two decoder layers, vocab 320.  At x5 both sessions
run ``transcribe_longform(num_beams=2)`` (the cross-attention kernels' plain
versions at B*K rows) and give the same rows.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisper_tpu.models import convert as jconvert
from whisper_tpu.pipeline.longform import transcribe_longform as jax_longform
from whisper_tpu.runtime import timestamps as jts
from whisper_tpu.runtime.beam import beam_generate as jax_beam
from whisper_tpu.runtime.session import RuntimeCfg as JaxCfg
from whisper_tpu.runtime.session import WhisperSession as JaxSession
from whisper_tpu.variants.ladder import apply_variant as jax_apply_variant
from whisper_tpu_torch.models import convert
from whisper_tpu_torch.models.registry import WhisperDims
from whisper_tpu_torch.pipeline.longform import transcribe_longform
from whisper_tpu_torch.runtime import timestamps as ts
from whisper_tpu_torch.runtime.beam import beam_generate, top_k
from whisper_tpu_torch.runtime.generate import (
    build_suppress_mask,
    greedy_generate,
)
from whisper_tpu_torch.runtime.session import RuntimeCfg, WhisperSession
from whisper_tpu_torch.variants.ladder import apply_variant

torch.set_num_threads(2)

DIMS = WhisperDims(n_mels=80, d_model=128, encoder_layers=2, encoder_heads=2,
                   decoder_layers=2, decoder_heads=2, vocab_size=320,
                   max_source_positions=96, max_target_positions=32)
SOT, EOT, LANG, TASK, NO_TS = 250, 251, 252, 253, 254
TS_CFG = ts.TimestampCfg(NO_TS + 1, EOT, NO_TS)
PROMPT = [SOT, LANG, TASK, NO_TS]
SUPPRESS = [7, 8, 300]


def _inputs(seed, b=2):
    rng = np.random.default_rng(seed)
    enc = rng.normal(0, 1, (b, DIMS.max_source_positions,
                            DIMS.d_model)).astype(np.float32)
    jp = jconvert.cast_params(jconvert.init_params(DIMS, seed), jnp.float32)
    tp = convert.params_from_numpy(convert.init_params(DIMS, seed), "cpu",
                                   torch.float32)
    return enc, jp, tp


def _masks(suppress=SUPPRESS):
    base = build_suppress_mask(DIMS.vocab_size, suppress)
    first = build_suppress_mask(DIMS.vocab_size, list(suppress) + [EOT])
    return base, first


def _both(seed, k, *, b=2, max_new=8, prompt=PROMPT, eot=EOT,
          length_penalty=1.0, ts_cfg=None, suppress=SUPPRESS):
    enc, jp, tp = _inputs(seed, b)
    base, first = _masks(suppress)
    jt, js = jax_beam(jp, DIMS, jnp.asarray(enc),
                      jnp.asarray(prompt, jnp.int32), jnp.asarray(base),
                      jnp.asarray(first), max_new, eot, k, length_penalty,
                      ts_cfg=None if ts_cfg is None
                      else jts.TimestampCfg(*ts_cfg))
    tt, tsc = beam_generate(tp, DIMS, torch.from_numpy(enc),
                            torch.tensor(prompt), torch.from_numpy(base),
                            torch.from_numpy(first), max_new, eot, k,
                            length_penalty, ts_cfg=ts_cfg)
    return (tt.numpy(), tsc.numpy()), (np.asarray(jt), np.asarray(js))


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_beam_equals_jax_at_x0(k, seed):
    (tt, tsc), (jt, js) = _both(seed, k)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(tsc, js, rtol=0, atol=1e-4)


@pytest.mark.parametrize("k", [2, 3])
def test_finished_beams_extend_with_eot_only_as_in_jax(k):
    """EOT is the greedy chain's second token, so the best candidate of the
    first step ends a beam there, and the EOT-only extension and the frozen
    lengths take part in every later step and in the choice: still JAX's
    tokens and scores."""
    enc, _, tp = _inputs(2)
    zero = build_suppress_mask(DIMS.vocab_size, [])
    chain = greedy_generate(tp, DIMS, torch.from_numpy(enc),
                            torch.tensor(PROMPT), torch.from_numpy(zero),
                            torch.from_numpy(zero), 4, EOT).numpy()
    eot = int(chain[0, 1])
    (tt, tsc), (jt, js) = _both(2, k, eot=eot, suppress=[])
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(tsc, js, rtol=0, atol=1e-4)


def test_k1_equals_greedy():
    """One beam is greedy decoding on the same step."""
    enc, _, tp = _inputs(4, b=3)
    base, first = _masks()
    args = (tp, DIMS, torch.from_numpy(enc), torch.tensor(PROMPT),
            torch.from_numpy(base), torch.from_numpy(first), 10, EOT)
    toks, _ = beam_generate(*args, 1)
    np.testing.assert_array_equal(toks.numpy(),
                                  greedy_generate(*args).numpy())


def test_batch_rows_are_independent():
    enc, _, tp = _inputs(5, b=3)
    base, first = _masks()
    rest = (torch.tensor(PROMPT), torch.from_numpy(base),
            torch.from_numpy(first), 7, EOT, 3)
    together, scores = beam_generate(tp, DIMS, torch.from_numpy(enc), *rest)
    for r in range(3):
        alone, s = beam_generate(tp, DIMS, torch.from_numpy(enc[r:r + 1]),
                                 *rest)
        np.testing.assert_array_equal(alone.numpy()[0], together.numpy()[r])
        np.testing.assert_allclose(s.numpy()[0], scores.numpy()[r], rtol=0,
                                   atol=1e-5)


def test_length_penalty_changes_the_selection_as_in_jax():
    """With EOT favoured (beams of different lengths), a penalty of 0 picks
    by the raw score and 2 favours the longer beam: the choices differ, and
    each is JAX's."""
    enc, _, tp = _inputs(2)
    zero = build_suppress_mask(DIMS.vocab_size, [])
    chain = greedy_generate(tp, DIMS, torch.from_numpy(enc),
                            torch.tensor(PROMPT), torch.from_numpy(zero),
                            torch.from_numpy(zero), 4, EOT).numpy()
    eot = int(chain[0, 1])
    picks = {}
    for lp in (0.0, 2.0):
        (tt, tsc), (jt, js) = _both(2, 3, eot=eot, suppress=[],
                                    length_penalty=lp)
        np.testing.assert_array_equal(tt, jt)
        np.testing.assert_allclose(tsc, js, rtol=0, atol=1e-4)
        picks[lp] = tt
    assert not np.array_equal(picks[0.0], picks[2.0])


@pytest.mark.parametrize("k", [2, 3])
def test_timestamps_per_beam_equal_jax(k):
    """With the grammar each beam carries its own state, gathered with its
    parent: JAX's tokens and scores, and the chosen rows keep the grammar
    (the first token a timestamp at most 50 steps in, pairs closed,
    timestamps never decreasing)."""
    (tt, tsc), (jt, js) = _both(6 + k, k, prompt=[SOT, LANG, TASK],
                                ts_cfg=TS_CFG, max_new=10)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(tsc, js, rtol=0, atol=1e-4)
    tsb = TS_CFG.timestamp_begin
    for row in tt:
        gen = []
        for t in row:
            if t == EOT:
                break
            gen.append(int(t))
        assert tsb <= gen[0] <= tsb + 50 and NO_TS not in gen
        stamps = [t for t in gen if t >= tsb]
        assert stamps == sorted(stamps)
        for j in range(2, len(gen)):
            if gen[j - 1] >= tsb and gen[j - 2] < tsb:
                assert gen[j] >= EOT       # a pair closes: no text


def test_top_k_keeps_the_order_of_jax():
    """Ties everywhere: the larger value first, the lower index on a tie,
    as jax.lax.top_k orders them."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 4, (5, 40)).astype(np.float32)
    x[0] = -1e30
    x[1, :10] = -np.inf
    for k in (1, 3, 7):
        vals, idx = top_k(torch.from_numpy(x), k)
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


class RecordingTok:
    ids = {"<|startoftranscript|>": SOT, "<|endoftext|>": EOT,
           "<|en|>": LANG, "<|transcribe|>": TASK, "<|notimestamps|>": NO_TS}

    def __init__(self):
        self.rows = []

    def token_to_id(self, t):
        return self.ids.get(t)

    def decode(self, ids, skip_special_tokens=True, **_):
        self.rows.append([int(i) for i in ids])
        return " ".join(f"w{i}" for i in ids)


@pytest.mark.parametrize("rung,timestamps", [("x5", False), ("x5", True),
                                             ("x4", False)])
def test_longform_beams_equal_jax(rung, timestamps):
    """``transcribe_longform(num_beams=2)`` on 40 s (two chunks, one
    bucket of two, so four beam rows against a cross cache tiled per beam):
    JAX's rows, through the plain versions of B4 (x5) or B6 (x4)."""
    long = dataclasses.replace(DIMS, max_source_positions=1500)
    params = convert.init_params(long, seed=11)
    jcfg, _ = jax_apply_variant(JaxCfg(), rung)
    tcfg, _ = apply_variant(RuntimeCfg(), rung)
    rng = np.random.default_rng(5)
    audio = (0.05 * rng.standard_normal(40 * 16000)).astype(np.float32)
    jtok, ttok = RecordingTok(), RecordingTok()
    jtext, _ = jax_longform(JaxSession(params, long, jcfg), audio, "en",
                           "transcribe", 5, tokenizer=jtok,
                           timestamps=timestamps, num_beams=2)
    ttext, _ = transcribe_longform(
        WhisperSession(params, long, tcfg, device="cpu"), audio, "en",
        "transcribe", 5, tokenizer=ttok, timestamps=timestamps, num_beams=2)
    assert len(ttok.rows) == 2 and ttok.rows == jtok.rows
    assert ttext == jtext
