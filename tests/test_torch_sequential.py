"""The port's sequential (seek-based) long-form mode
(``pipeline.sequential``) against the JAX package's (CPU).

``parse_segments`` gives JAX's segments on JAX's cases
(tests/test_sequential.py) and on random grammar rows.
``transcribe_sequential`` at x0 fp32 on ``test/whisper-nano`` (random
weights from a seed, a 65 s synthetic file: three or more windows, special
ids that fit the nano vocabulary): the same text, segments (times, tokens,
text), words and callback payloads as JAX's, plain, conditioned on the
previous text (left-padded prompts, ``pad_count`` on every window), with an
initial prompt (seeding the rolling context, or a static prefix), with beam
search, word timings and ``language="auto"``.  At x5 (head_dim 64 dims: the
plain versions of B3 and B4 on the kernel step) the conditioned run gives
the JAX session's segments (Pallas in interpret mode).
"""

import dataclasses

import numpy as np
import pytest
import torch

from whisper_tpu.pipeline import sequential as jseq
from whisper_tpu.runtime.session import RuntimeCfg as JaxCfg
from whisper_tpu.runtime.session import WhisperSession as JaxSession
from whisper_tpu.variants.ladder import apply_variant as jax_apply_variant
from whisper_tpu_torch.models import convert
from whisper_tpu_torch.models.registry import WhisperDims, get_dims
from whisper_tpu_torch.pipeline import sequential
from whisper_tpu_torch.runtime.session import RuntimeCfg, WhisperSession
from whisper_tpu_torch.variants.ladder import apply_variant

torch.set_num_threads(2)

TSB = 400


def _seg(s):
    return (s.start_s, s.end_s, list(s.tokens), s.text)


PARSE_CASES = {
    # JAX's cases (tests/test_sequential.py:13-38, 218)
    "paired": ([TSB + 0, 10, 11, TSB + 250, TSB + 250, 12, TSB + 400], 0.0,
               None),
    "unclosed_tail": ([TSB + 0, 10, 11], 0.0, None),
    "window_offset": ([TSB + 100, 5, TSB + 200], 25.0, None),
    "empty": ([], 0.0, None),
    "clamped_tail": ([TSB + 10, 7, 8], 30.0, 35.0),
    "unclamped_tail": ([TSB + 10, 7, 8], 30.0, None),
    "consecutive_stamps": ([TSB + 3, TSB + 9, 4, TSB + 12, TSB + 12], 1.0,
                           None),
    "text_before_stamp": ([4, 5, TSB + 2, 6, TSB + 7], 0.0, 20.0),
}


@pytest.mark.parametrize("case", sorted(PARSE_CASES))
def test_parse_segments_equals_jax(case):
    toks, offset, max_end = PARSE_CASES[case]
    got, got_last = sequential.parse_segments(toks, TSB, offset,
                                              max_end_s=max_end)
    want, want_last = jseq.parse_segments(toks, TSB, offset,
                                          max_end_s=max_end)
    assert [_seg(s) for s in got] == [_seg(s) for s in want]
    assert got_last == want_last


@pytest.mark.parametrize("seed", range(4))
def test_parse_segments_equals_jax_on_random_rows(seed):
    rng = np.random.default_rng(seed)
    toks = [int(t) for t in np.where(rng.random(40) < 0.3,
                                     TSB + np.sort(rng.integers(0, 1500, 40)),
                                     rng.integers(0, TSB, 40))]
    got = sequential.parse_segments(toks, TSB, 7.0, max_end_s=31.0)
    want = jseq.parse_segments(toks, TSB, 7.0, max_end_s=31.0)
    assert [_seg(s) for s in got[0]] == [_seg(s) for s in want[0]]
    assert got[1] == want[1]


class FakeTok:
    """Special ids that fit the nano vocabulary (JAX's test tokenizer, with
    <|notimestamps|> moved up so that half the ids are text); decodes ids
    as words."""

    _ids = {"<|startoftranscript|>": 3, "<|endoftext|>": 2, "<|en|>": 4,
            "<|transcribe|>": 5, "<|notimestamps|>": 499,
            "<|startofprev|>": 7}
    _tokens: list = []      # no token table: the sot+1.. language layout

    def token_to_id(self, t):
        return self._ids.get(t)

    def decode(self, ids, skip_special_tokens=True):
        return "".join(f" w{i}" for i in ids)


NANO = get_dims("test/whisper-nano")

SEQ_CASES = {
    "plain": {},
    "conditioned": dict(condition_on_prev_text=True, prev_context_tokens=16),
    "initial_prompt_conditioned": dict(condition_on_prev_text=True,
                                       prev_context_tokens=16,
                                       initial_prompt_ids=[30, 31, 32]),
    "initial_prompt_static": dict(initial_prompt_ids=[30, 31, 32]),
    "beams": dict(num_beams=2),
    "beams_conditioned": dict(num_beams=2, condition_on_prev_text=True,
                              prev_context_tokens=8),
    "words": dict(word_collector=True),
    "words_conditioned": dict(word_collector=True,
                              condition_on_prev_text=True,
                              prev_context_tokens=16),
    "language_auto": dict(language="auto"),
}


def _run(fn, sess, audio, kw):
    kw = dict(kw)
    language = kw.pop("language", "en")
    words = [] if kw.pop("word_collector", False) else None
    calls = []
    text, segs, timing = fn(sess, audio, language, "transcribe",
                            max_new_tokens=8, tokenizer=FakeTok(),
                            word_collector=words,
                            segment_callback=calls.append, **kw)
    return text, [_seg(s) for s in segs], words, calls, timing


@pytest.fixture(scope="module")
def nano():
    params = convert.init_params(NANO, seed=1)
    jcfg, _ = jax_apply_variant(JaxCfg(), "x0")
    tcfg, _ = apply_variant(RuntimeCfg(), "x0")
    audio = np.random.default_rng(2).normal(0, 0.1, 65 * 16000).astype(
        np.float32)
    return (JaxSession(params, NANO, dataclasses.replace(jcfg, max_batch=2)),
            WhisperSession(params, NANO, dataclasses.replace(tcfg,
                                                             max_batch=2),
                           device="cpu"),
            audio)


@pytest.mark.parametrize("case", sorted(SEQ_CASES))
def test_transcribe_sequential_equals_jax_at_x0(nano, case):
    jsess, tsess, audio = nano
    want = _run(jseq.transcribe_sequential, jsess, audio, SEQ_CASES[case])
    got = _run(sequential.transcribe_sequential, tsess, audio,
               SEQ_CASES[case])
    assert got[0] == want[0]                     # text
    assert got[1] == want[1] and got[1]          # segments
    assert got[3] == want[3]                     # callback payloads
    if got[2] is not None:                       # words
        assert got[2]
        assert [w["word"] for w in got[2]] == [w["word"] for w in want[2]]
        for a, b in zip(got[2], want[2]):
            assert abs(a["start"] - b["start"]) <= 0.01
            assert abs(a["end"] - b["end"]) <= 0.01
    starts = [s[0] for s in got[1]]
    assert starts == sorted(starts) and starts[0] >= 0.0
    assert got[4].end_to_end_s >= got[4].model_only_s > 0


def test_conditioned_windows_differ_from_plain_after_the_first(nano):
    """With nothing to condition on yet the first window decodes as the
    plain prompt; later windows see <|startofprev|> + the text so far."""
    _, tsess, audio = nano
    plain = _run(sequential.transcribe_sequential, tsess, audio, {})[1]
    cond = _run(sequential.transcribe_sequential, tsess, audio,
                SEQ_CASES["conditioned"])[1]
    assert cond[0] == plain[0] and cond != plain


SMALL = WhisperDims(80, 128, 1, 2, 2, 2, 256, max_source_positions=1500,
                    max_target_positions=48)


class SmallTok(FakeTok):
    _ids = {"<|startoftranscript|>": 100, "<|endoftext|>": 101, "<|en|>": 102,
            "<|transcribe|>": 103, "<|notimestamps|>": 105,
            "<|startofprev|>": 104}


@pytest.mark.parametrize("rung", ["x5", "x7"])
def test_conditioned_sequential_equals_jax_at_the_kernel_rungs(rung):
    """head_dim 64: the port's kernel step (B3 or B8 given ``pad_count``,
    then B4, their plain versions) against the JAX session's packed step
    (Pallas in interpret mode); a 40 s file, conditioned windows."""
    params = convert.init_params(SMALL, seed=3)
    jcfg, _ = jax_apply_variant(JaxCfg(), rung)
    tcfg, _ = apply_variant(RuntimeCfg(), rung)
    jsess = JaxSession(params, SMALL, jcfg)
    tsess = WhisperSession(params, SMALL, tcfg, device="cpu")
    assert tsess._kernel_step and tsess._int8_self == (rung == "x7")
    audio = np.random.default_rng(3).normal(0, 0.1, 40 * 16000).astype(
        np.float32)
    kw = dict(max_new_tokens=6, tokenizer=SmallTok(),
              condition_on_prev_text=True, prev_context_tokens=12,
              initial_prompt_ids=[7, 8, 9])
    want = jseq.transcribe_sequential(jsess, audio, "en", "transcribe", **kw)
    got = sequential.transcribe_sequential(tsess, audio, "en", "transcribe",
                                           **kw)
    assert [_seg(s) for s in got[1]] == [_seg(s) for s in want[1]]
    assert got[0] == want[0] and got[1]
