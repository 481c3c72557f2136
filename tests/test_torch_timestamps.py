"""The port's timestamp grammar (``runtime.timestamps``) and greedy
decoding with it, against the JAX package and HF's processor (CPU).

``apply_rules`` runs on random logits, histories and steps through both
packages: the same -inf pattern and the same finite values (the rules only
mask).  Its argmax is held against transformers'
``WhisperTimeStampLogitsProcessor`` as tests/test_timestamps.py holds the
JAX function.  ``greedy_generate(ts_cfg=...)`` at x0 fp32 gives JAX's
tokens token for token; through ``transcribe_longform(timestamps=True)``
both packages give the same rows at x0 and x5 (d_model 128, two heads of
64, two layers each side, the encoder's full 1,500 positions, a vocab of
320 with 65 timestamp ids above <|notimestamps|>).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from whisper_tpu.models import convert as jconvert
from whisper_tpu.pipeline.longform import transcribe_longform as jax_longform
from whisper_tpu.runtime import timestamps as jts
from whisper_tpu.runtime.generate import greedy_generate as jax_greedy
from whisper_tpu.runtime.session import RuntimeCfg as JaxCfg
from whisper_tpu.runtime.session import WhisperSession as JaxSession
from whisper_tpu.variants.ladder import apply_variant as jax_apply_variant
from whisper_tpu_torch.models import convert
from whisper_tpu_torch.models.registry import WhisperDims
from whisper_tpu_torch.pipeline.longform import transcribe_longform
from whisper_tpu_torch.runtime import timestamps as ts
from whisper_tpu_torch.runtime.generate import (
    build_suppress_mask,
    greedy_generate,
)
from whisper_tpu_torch.runtime.session import RuntimeCfg, WhisperSession
from whisper_tpu_torch.variants.ladder import apply_variant

torch.set_num_threads(2)

V = 120
EOT = 2
NO_TS = 90
TSB = 91
CFG = ts.TimestampCfg(timestamp_begin=TSB, eot_id=EOT, no_timestamps_id=NO_TS,
                      max_initial_timestamp_index=10)
JCFG = jts.TimestampCfg(*CFG)


def _both_states(histories):
    """The grammar state after each row's history, in both packages (the
    histories have one length: the step)."""
    b = len(histories)
    t_state = ts.init_state(b, EOT)
    j_state = jts.init_state(b, EOT)
    for col in zip(*histories):
        t_state = ts.update_state(t_state, torch.tensor(col), CFG)
        j_state = jts.update_state(j_state, jnp.asarray(col, jnp.int32),
                                   JCFG)
    return t_state, j_state


@pytest.mark.parametrize("step", [0, 1, 2, 3, 5])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_apply_rules_equals_jax(step, seed):
    """Eight rows of random histories (text, timestamps and the odd
    suppressed column) at one step: the same -inf pattern and the same
    finite values."""
    rng = np.random.default_rng(100 * step + seed)
    hist = []
    for _ in range(8):
        row = []
        for j in range(step):
            if j == 0 or rng.random() < 0.4:
                row.append(int(rng.integers(TSB, V)))
            else:
                row.append(int(rng.integers(3, NO_TS)))
        hist.append(row)
    logits = rng.normal(0, 3, (8, V)).astype(np.float32)
    logits[rng.random((8, V)) < 0.05] = -np.inf
    # a few rows where the timestamps' mass must win (rule 5)
    logits[:2, TSB:] += 4.0
    t_state, j_state = _both_states(hist)
    got = ts.apply_rules(torch.from_numpy(logits), t_state, step, CFG).numpy()
    want = np.asarray(jts.apply_rules(jnp.asarray(logits), j_state,
                                      jnp.int32(step), JCFG))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_array_equal(got[fin], want[fin])
    assert np.isfinite(got).any(axis=1).all()


def test_update_state_and_render_equal_jax():
    toks = [[TSB + 7, 5, TSB + 3, TSB + 9], [4, TSB, TSB, 6]]
    t_state, j_state = _both_states(toks)
    for a, b in zip(t_state, j_state):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for tid in (TSB, TSB + 75, TSB + 1499):
        assert ts.render_timestamp(tid, TSB) == jts.render_timestamp(tid, TSB)


def _hf_processor():
    transformers = pytest.importorskip("transformers")
    from transformers.generation.logits_process import (
        WhisperTimeStampLogitsProcessor,
    )

    gen_cfg = transformers.GenerationConfig(
        no_timestamps_token_id=NO_TS, max_initial_timestamp_index=10,
        eos_token_id=EOT, decoder_start_token_id=3)
    return WhisperTimeStampLogitsProcessor(gen_cfg, begin_index=4)


PROMPT_HF = [3, 50, 51, NO_TS]


def _argmax_after_rules(logits, hist):
    t_state, _ = _both_states([hist])
    return int(ts.apply_rules(torch.from_numpy(logits[None]), t_state,
                              len(hist), CFG)[0].argmax())


@pytest.mark.parametrize("hist", [[], [TSB], [TSB, 5, 6], [TSB, 5, 6, TSB + 8],
                                  [TSB, 5, TSB + 3, TSB + 3, 7]])
def test_argmax_equals_hf_processor(hist):
    """Random logits after five histories (first token, a segment just
    opened, inside text, a pair to close, after a closed pair), six draws
    each: the argmax of HF's processor."""
    proc = _hf_processor()
    rng = np.random.default_rng(len(hist))
    for _ in range(6):
        logits = rng.normal(0, 3, V).astype(np.float32)
        want = proc(torch.tensor([PROMPT_HF + hist]),
                    torch.from_numpy(logits.copy()[None])).numpy()[0]
        assert _argmax_after_rules(logits, hist) == int(want.argmax())


def test_eot_on_top_equals_hf_processor():
    """EOT the largest logit: at the first token (rule 4 bans it), mid-text
    with the timestamps' mass winning (rule 5 bans it with the text), and
    at a pair's close (EOT stays allowed), as HF's processor decides."""
    proc = _hf_processor()
    l0 = np.full(V, -2.0, np.float32)
    l0[EOT], l0[TSB + 2] = 4.0, 3.0
    l1 = np.full(V, -5.0, np.float32)
    l1[EOT], l1[10] = 4.0, 3.0
    l1[TSB + 5: TSB + 19] = 3.5
    l2 = np.full(V, -2.0, np.float32)
    l2[EOT] = 4.0
    for hist, logits in (([], l0), ([TSB, 5, 6], l1),
                         ([TSB, 5, 6, TSB + 8], l2)):
        want = proc(torch.tensor([PROMPT_HF + hist]),
                    torch.from_numpy(logits.copy()[None])).numpy()[0]
        assert _argmax_after_rules(logits, hist) == int(want.argmax())


# ---------------------------------------------------------------------------
# Greedy decoding with the grammar
# ---------------------------------------------------------------------------

SOT, EOT_M, LANG, TASK, NO_TS_M = 250, 251, 252, 253, 254
TSB_M = NO_TS_M + 1                     # <|0.00|>, as the long-form driver
M_CFG = ts.TimestampCfg(TSB_M, EOT_M, NO_TS_M)
DIMS = WhisperDims(n_mels=80, d_model=128, encoder_layers=2, encoder_heads=2,
                   decoder_layers=2, decoder_heads=2, vocab_size=320,
                   max_source_positions=96, max_target_positions=32)


def grammar_errors(row, cfg=M_CFG):
    """What a row (generated tokens) breaks of the grammar: the first
    token a timestamp at most 50 steps in, no <|notimestamps|>, pairs
    closed, timestamps never decreasing."""
    gen = []
    for t in row:
        if t == cfg.eot_id:
            break
        gen.append(int(t))
    errs = []
    tsb = cfg.timestamp_begin
    if not gen:
        return ["no first token"]
    if not tsb <= gen[0] <= tsb + cfg.max_initial_timestamp_index:
        errs.append(f"first token {gen[0]}")
    if cfg.no_timestamps_id in gen:
        errs.append("<|notimestamps|>")
    stamps = [t for t in gen if t >= tsb]
    if stamps != sorted(stamps):
        errs.append(f"timestamps decrease: {stamps}")
    for j in range(1, len(gen)):
        last_ts = gen[j - 1] >= tsb
        pen_ts = j < 2 or gen[j - 2] >= tsb
        if last_ts and pen_ts and gen[j] >= tsb:
            errs.append(f"a third timestamp at {j}")
        if last_ts and not pen_ts and gen[j] < cfg.eot_id:
            errs.append(f"an open pair at {j}")
    return errs


def _greedy_both(seed, b=3, max_new=12, suppress=(7, 8, 300)):
    rng = np.random.default_rng(seed)
    enc = rng.normal(0, 1, (b, DIMS.max_source_positions,
                            DIMS.d_model)).astype(np.float32)
    prompt = np.asarray([SOT, LANG, TASK], np.int64)
    base = build_suppress_mask(DIMS.vocab_size, list(suppress))
    first = build_suppress_mask(DIMS.vocab_size, list(suppress) + [EOT_M])
    jp = jconvert.cast_params(jconvert.init_params(DIMS, seed), jnp.float32)
    tp = convert.params_from_numpy(convert.init_params(DIMS, seed), "cpu",
                                   torch.float32)
    want = np.asarray(jax_greedy(
        jp, DIMS, jnp.asarray(enc), jnp.asarray(prompt, jnp.int32),
        jnp.asarray(base), jnp.asarray(first), max_new, EOT_M,
        ts_cfg=jts.TimestampCfg(*M_CFG)))
    got = greedy_generate(
        tp, DIMS, torch.from_numpy(enc), torch.from_numpy(prompt),
        torch.from_numpy(base), torch.from_numpy(first), max_new, EOT_M,
        ts_cfg=M_CFG).numpy()
    return got, want


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_with_the_grammar_equals_jax_at_x0(seed):
    """fp32 weights and encoder states: every row token for token, and
    every row keeps the grammar."""
    got, want = _greedy_both(seed)
    np.testing.assert_array_equal(got, want)
    for row in got:
        assert grammar_errors(row) == []


def test_greedy_without_the_grammar_is_unchanged():
    """ts_cfg=None is the plain loop: what the port gave before the grammar
    existed, so JAX's tokens without it."""
    rng = np.random.default_rng(3)
    enc = rng.normal(0, 1, (2, 96, 128)).astype(np.float32)
    prompt = np.asarray([SOT, LANG, TASK, NO_TS_M], np.int64)
    zero = build_suppress_mask(DIMS.vocab_size, [])
    jp = jconvert.cast_params(jconvert.init_params(DIMS, 3), jnp.float32)
    tp = convert.params_from_numpy(convert.init_params(DIMS, 3), "cpu",
                                   torch.float32)
    want = np.asarray(jax_greedy(jp, DIMS, jnp.asarray(enc),
                                 jnp.asarray(prompt, jnp.int32),
                                 jnp.asarray(zero), jnp.asarray(zero), 10,
                                 EOT_M))
    got = greedy_generate(tp, DIMS, torch.from_numpy(enc),
                          torch.from_numpy(prompt), torch.from_numpy(zero),
                          torch.from_numpy(zero), 10, EOT_M).numpy()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# transcribe_longform(timestamps=True) through both sessions
# ---------------------------------------------------------------------------

LONG = dataclasses.replace(DIMS, max_source_positions=1500)
MAX_NEW = 6


class RecordingTok:
    """Special ids that fit the small vocab; ``decode`` records the ids of
    every chunk it is given and renders timestamps as the detokenizer
    does."""

    ids = {"<|startoftranscript|>": SOT, "<|endoftext|>": EOT_M,
           "<|en|>": LANG, "<|transcribe|>": TASK,
           "<|notimestamps|>": NO_TS_M}

    def __init__(self):
        self.rows = []

    def token_to_id(self, t):
        return self.ids.get(t)

    def decode(self, ids, skip_special_tokens=True, timestamp_begin=None):
        self.rows.append([int(i) for i in ids])
        return " ".join(ts.render_timestamp(i, timestamp_begin)
                        if timestamp_begin is not None and i >= timestamp_begin
                        else f"w{i}" for i in ids)


def _audio(seconds=40.0, seed=5):
    rng = np.random.default_rng(seed)
    n = int(seconds * 16000)
    t = np.arange(n) / 16000.0
    x = (0.3 * np.sin(2 * np.pi * (180 + 60 * np.sin(2 * np.pi * 0.7 * t)) * t)
         + 0.15 * np.sin(2 * np.pi * 920 * t) + 0.04 * rng.standard_normal(n))
    return (0.5 * x).astype(np.float32)


@pytest.mark.parametrize("rung,overrides", [
    ("x0", {}), ("x5", {}), ("x7", {}),
    ("x5", dict(fused_encoder_block=True, fused_decoder_step=True))])
def test_longform_timestamps_equal_jax(rung, overrides):
    """Two 30 s chunks (one bucket of two): the rows JAX's session decodes
    with the grammar, token for token (x5 and x7 through the plain
    versions of B3/B8 and B4; the hybrid step through B10c's), the same
    text with its <|x.xx|> markers, and every row keeps the grammar."""
    params = convert.init_params(LONG, seed=11)
    jcfg, _ = jax_apply_variant(JaxCfg(), rung)
    tcfg, _ = apply_variant(RuntimeCfg(), rung)
    jcfg = dataclasses.replace(jcfg, **overrides)
    tcfg = dataclasses.replace(tcfg, **overrides)
    audio = _audio()
    jtok, ttok = RecordingTok(), RecordingTok()
    jtext, _ = jax_longform(JaxSession(params, LONG, jcfg), audio, "en",
                           "transcribe", MAX_NEW, tokenizer=jtok,
                           timestamps=True)
    tokens = []
    ttext, _ = transcribe_longform(
        WhisperSession(params, LONG, tcfg, device="cpu"), audio, "en",
        "transcribe", MAX_NEW, tokenizer=ttok, timestamps=True,
        token_collector=tokens)
    assert ttok.rows == jtok.rows and len(ttok.rows) == 2
    assert ttext == jtext and "<|" in ttext
    for row in tokens[0]:
        assert grammar_errors(row) == []
