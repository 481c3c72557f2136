"""One program a bucket (``runtime.generate``: the chunk normalisation, the
encoder(s), the prefill and the first pick captured ahead of the decode
loop's while node, so a bucket is one graph launch from its input to its
tokens) on the CPU: ``generate._GraphLoop``, the schedule a card runs, with
the program's plain form in place of the graph (``_PlainGraph`` of
tests/test_torch_device_exit.py: the pre-node part once a launch, then the
step under the while node's condition).

- Through that schedule, the session against the JAX session at x0 fp32,
  token for token, on the same weights (``init_params``) and inputs made
  from a numpy seed: ``transcribe_from_mel`` over a file of two buckets,
  with ``chunk_norm_n_valid`` (the pipelined mode), with ``pad_count`` and
  the grammar at bucket 1 (the sequential mode), with beams K = 2,
  ``transcribe_short_batch`` at two ship lengths, and speculatively with a
  random draft.  Each key is then called a second time with other inputs
  (other audio, another sampling seed, another ``pad_count``, another
  prompt of the same length): every call gives its own eager result,
  bitwise, and no key is captured again.
- The ``_async`` forms read nothing on the host and queue one launch a
  bucket.
- Launch counts: the pre-node program's tally once a launch, the body's
  once an iteration that ran (the eager loop's steps); the capture's
  warm-up counts nowhere.
- Fault 3.1 (the memory gate): the port's ``decode_footprint`` equals the
  JAX package's term by term at its arguments; the graphed pricing (one
  cache copy, the active program's pools, the budget other keys may keep)
  warns where the priced total passes the budget; ``DecodeGraphs.trim``
  drops keys by state, inputs and pools.
"""

import dataclasses
import sys
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_device_exit import (  # noqa: F401 (fixtures)
    _PlainLoop,
    conditional,
    landed,
    queued,
)
from test_torch_graph_loop import no_host_reads  # noqa: F401 (a fixture)
from whisper_tpu.runtime import timestamps as jts
from whisper_tpu.runtime.session import RuntimeCfg as JaxCfg
from whisper_tpu.runtime.session import WhisperSession as JaxSession
from whisper_tpu.utils import hbm as jhbm
from whisper_tpu.variants.ladder import apply_variant as jax_apply_variant
from whisper_tpu_torch.frontend import golden
from whisper_tpu_torch.models import convert
from whisper_tpu_torch.models.registry import WhisperDims, get_dims
from whisper_tpu_torch.ops import common
from whisper_tpu_torch.pipeline.chunk import CHUNK_FRAMES
from whisper_tpu_torch.runtime import generate
from whisper_tpu_torch.runtime import timestamps as ts
from whisper_tpu_torch.runtime.session import RuntimeCfg, WhisperSession
from whisper_tpu_torch.utils import hbm
from whisper_tpu_torch.variants.ladder import apply_variant

torch.set_num_threads(2)

# test_torch_serve.py's model: two heads of 64, the encoder's 1500 positions
DIMS = WhisperDims(n_mels=80, d_model=128, encoder_layers=2, encoder_heads=2,
                   decoder_layers=2, decoder_heads=2, vocab_size=512,
                   max_source_positions=1500, max_target_positions=64)
EOT, SOT, LANG, TASK, SOT_PREV, NO_TS, TSB = 400, 401, 402, 405, 406, 407, 408
PROMPT = [SOT, LANG, TASK, NO_TS]
SUPPRESS = [8, 300]
PAD_LEN = CHUNK_FRAMES * 160 + 400     # the full 30 s window, reflect-padded
MAX_NEW = 6


def _sharp(tree):
    """Random weights decode every input into the same tokens: the
    cross-attention's queries and output scaled up (x100, x8) make its
    attention sharp and its share large, so that the tokens follow the
    audio and a value frozen into a program shows."""
    blocks = dict(tree["decoder"]["blocks"])
    blocks["xq_w"] = blocks["xq_w"] * np.float32(100.0)
    blocks["xo_w"] = blocks["xo_w"] * np.float32(8.0)
    return dict(tree, decoder=dict(tree["decoder"], blocks=blocks))


@pytest.fixture(scope="module")
def params():
    return _sharp(convert.init_params(DIMS, seed=0))


def _sessions(params, max_batch=2, draft=None, **over):
    """(JAX, port) sessions at x0 (fp32) on the same weights; with
    ``draft`` both attach it."""
    jcfg, _ = jax_apply_variant(JaxCfg(), "x0")
    tcfg, _ = apply_variant(RuntimeCfg(), "x0")
    jsess = JaxSession(params, DIMS, dataclasses.replace(
        jcfg, max_batch=max_batch, **over))
    tsess = WhisperSession(params, DIMS, dataclasses.replace(
        tcfg, max_batch=max_batch, **over), device="cpu")
    if draft is not None:
        jsess.set_draft_model(*draft)
        tsess.set_draft_model(*draft)
    return jsess, tsess


def _mel(seed, frames=7000):
    return np.random.default_rng(seed).normal(0, 1, (80, frames)).astype(
        np.float32)


def _clip(seconds, seed):
    rng = np.random.default_rng(seed)
    n = int(seconds * 16000)
    t = np.arange(n) / 16000.0
    return (0.2 * np.sin(2 * np.pi * (200 + 40 * seed) * t)
            + rng.normal(0, 0.05, n)).astype(np.float32)


def _rows(clips, ship_len):
    """The engine's tick layout: reflect-padded rows in [B, ship_len]."""
    audio = np.zeros((len(clips), ship_len), dtype=np.float32)
    n_valid = np.zeros(len(clips), dtype=np.int32)
    for i, c in enumerate(clips):
        p = golden.reflect_pad(c)
        audio[i, :len(p)] = p
        n_valid[i] = golden.num_frames(len(c))
    return audio, n_valid


def _grammar():
    return ts.TimestampCfg(TSB, EOT, NO_TS, max_initial_timestamp_index=10)


# the sequential mode's prompt: [pad slots | <|startofprev|> + tail | sot,
# lang, task], one static length; the second call's tail differs
def _seq_prompt(pads, tail_seed):
    tail = np.random.default_rng(tail_seed).integers(9, 399, 12 - pads)
    return [EOT] * pads + [SOT_PREV] + tail.tolist() + [SOT, LANG, TASK]


STARTS = [0, 2500, 5000]


def _call(case, sess, i, port: bool):
    """Case ``case``'s call ``i`` (0 or 1: other inputs at the same keys)
    on ``sess`` (the JAX session or the port's): tokens [C, MAX_NEW] on the
    host (with scores, (tokens, sum_lp, n_tok))."""
    mel_of = torch.from_numpy if port else jnp.asarray
    kw = dict(suppress_ids=SUPPRESS, begin_suppress_ids=[EOT])
    if case == "two buckets":
        return sess.transcribe_from_mel(mel_of(_mel(10 + i)), STARTS,
                                        PROMPT, MAX_NEW, EOT, **kw)
    if case == "chunk_norm_n_valid":
        return sess.transcribe_from_mel(mel_of(_mel(20 + i)), STARTS,
                                        PROMPT, MAX_NEW, EOT, **kw,
                                        chunk_norm_n_valid=(6100, 5200)[i])
    if case == "pad_count and the grammar at bucket 1":
        pads = (3, 5)[i]
        cfg = _grammar() if port else jts.TimestampCfg(*_grammar())
        return sess.transcribe_from_mel(
            mel_of(_mel(30 + i, 3400)), [0], _seq_prompt(pads, i), MAX_NEW,
            EOT, **kw, ts_cfg=cfg, pad_count=pads)
    if case == "beams K = 2":
        return sess.transcribe_from_mel(mel_of(_mel(40 + i)), STARTS[:2],
                                        PROMPT, MAX_NEW, EOT, **kw,
                                        num_beams=2)
    if case == "speculative, a random draft":
        return sess.transcribe_from_mel(mel_of(_mel(50 + i)), STARTS,
                                        PROMPT, MAX_NEW, EOT, **kw,
                                        speculative=True, draft_k=3)
    if case.startswith("short"):
        ship = PAD_LEN if case.endswith("full window") else PAD_LEN // 8
        clips = [_clip(s, 3 * i + j) for j, s in enumerate((1.0, 2.5))]
        # JAX ships the full window (its short program keys on the length)
        audio, n_valid = _rows(clips, ship if port else PAD_LEN)
        return sess.transcribe_short_batch(audio, n_valid, PROMPT, MAX_NEW,
                                           EOT, **kw)
    raise AssertionError(case)


CASES = ["two buckets", "chunk_norm_n_valid",
         "pad_count and the grammar at bucket 1", "beams K = 2",
         "short, full window", "short, 1/8 window",
         "speculative, a random draft"]


def _draft():
    ddims = dataclasses.replace(DIMS, encoder_layers=1, decoder_layers=1)
    return _sharp(convert.init_params(ddims, seed=3)), ddims


@pytest.mark.parametrize("case", CASES)
def test_the_program_equals_jax_and_each_call_its_own_eager_result(
        case, params, conditional):
    """The first call equals JAX token for token; a second call at the
    same keys with other inputs makes no new key; each call equals its own
    eager run (``eager_decode``) bitwise, and the two calls differ."""
    draft = _draft() if case.startswith("speculative") else None
    jsess, tsess = _sessions(params, draft=draft)
    got = [_call(case, tsess, 0, True)]
    np.testing.assert_array_equal(got[0], np.asarray(
        _call(case, jsess, 0, False)))
    keys = set(tsess.graphs.captures())
    assert keys
    got.append(_call(case, tsess, 1, True))
    assert set(tsess.graphs.captures()) == keys
    tsess.eager_decode = True
    for i in (0, 1):
        np.testing.assert_array_equal(got[i], _call(case, tsess, i, True))
    assert not np.array_equal(got[0], got[1])


def test_sampled_programs_take_each_calls_seed(params, conditional):
    """T = 0.5 with scores: the seed (the key) and the audio are the
    program's inputs, so a second call at the same key with another seed
    and other audio gives its own eager tokens and scores bitwise."""
    _, tsess = _sessions(params, max_batch=4)

    def run(i):
        return tsess.transcribe_from_mel(
            torch.from_numpy(_mel(60 + i)), STARTS, PROMPT, MAX_NEW, EOT,
            SUPPRESS, [EOT], temperature=0.5, seed=7 + i, with_scores=True)

    got = [run(0), run(1)]
    assert len(tsess.graphs.captures()) == 1
    tsess.eager_decode = True
    for i in (0, 1):
        assert all(np.array_equal(a, b) for a, b in zip(got[i], run(i)))
    assert not np.array_equal(got[0][0], got[1][0])


def test_the_program_key_holds_the_front_and_not_the_files_length(
        params, conditional):
    """Chunks of files of two lengths share a bucket's key (the gather is
    outside the program); chunk-normalised chunks, the short path's ship
    lengths and given encoder states each key a program of their own."""
    _, tsess = _sessions(params)
    for frames in (7000, 9000):
        tsess.transcribe_from_mel(torch.from_numpy(_mel(1, frames)),
                                  STARTS[:2], PROMPT, 3, EOT)
    keys = list(tsess.graphs.captures())
    assert len(keys) == 1 and keys[0].front[0] == "chunks"
    tsess.transcribe_from_mel(torch.from_numpy(_mel(1)), STARTS[:2], PROMPT,
                              3, EOT, chunk_norm_n_valid=5000)
    for ship in (PAD_LEN, PAD_LEN // 8):
        tsess.transcribe_short_batch(*_rows([_clip(1.0, 0)] * 2, ship),
                                     PROMPT, 3, EOT)
    kinds = [k.front[0] for k in tsess.graphs.captures()]
    assert kinds == ["chunks", "chunk-normalised chunks", "short audio",
                     "short audio"]


# ---------------------------------------------------------------------------
# the _async forms read nothing; one launch a bucket
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("form", ["greedy", "chunk_norm", "beams", "short"])
def test_async_programs_read_nothing_and_launch_once_a_bucket(
        form, params, conditional, queued, no_host_reads):  # noqa: F811
    _, tsess = _sessions(params)
    for _ in ("the capture's call", "a later one"):
        queued.clear()
        with no_host_reads():
            if form == "short":
                tsess.transcribe_short_batch_async(
                    *_rows([_clip(1.0, 0), _clip(2.0, 1)], PAD_LEN // 4),
                    PROMPT, 4, EOT)
            else:
                tsess.transcribe_from_mel_async(
                    torch.from_numpy(_mel(2)), STARTS, PROMPT, 4, EOT,
                    num_beams=2 if form == "beams" else 1,
                    chunk_norm_n_valid=6000 if form == "chunk_norm"
                    else None)
        assert len(queued) == (1 if form == "short" else 2)


# ---------------------------------------------------------------------------
# launch counts
# ---------------------------------------------------------------------------

def test_launches_count_the_pre_node_once_and_the_body_once_an_iteration(
        params, conditional, monkeypatch):
    """Stub tallies on the plain schedule: over a file of two buckets,
    twice (the capture's calls and later ones), the pre-node program counts
    once a launch and the body once an iteration that ran, which is the
    eager loop's steps; the capture's warm-up counts nowhere."""
    mod = sys.modules[__name__]
    mod.pre_launches = mod.body_launches = 0

    class Tallied(_PlainLoop):
        def _capture(self, pre, step, bound):
            super()._capture(pre, step, bound)
            self.pre_tally = {(mod, "pre_launches"): 1}
            self.tally = {(mod, "body_launches"): 1}

    monkeypatch.setattr(generate, "_GraphLoop", Tallied)
    steps = []
    make = generate._step_fn

    def counting(*a, **kw):
        step = make(*a, **kw)

        def run():
            steps.append(1)
            step()
        return run

    monkeypatch.setattr(generate, "_step_fn", counting)
    _, tsess = _sessions(params)
    args = (torch.from_numpy(_mel(3)), STARTS, PROMPT, MAX_NEW, EOT,
            SUPPRESS, [EOT])
    tsess.eager_decode = True
    want = tsess.transcribe_from_mel(*args)
    eager_steps = len(steps)
    tsess.eager_decode = False
    for call in (1, 2):
        np.testing.assert_array_equal(tsess.transcribe_from_mel(*args), want)
        common.settle_launches(wait=True)
        assert mod.pre_launches == 2 * call
        assert mod.body_launches == eager_steps * call


# ---------------------------------------------------------------------------
# fault 3.1: the memory gate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("copies", [1.0, 2.0])
@pytest.mark.parametrize("draft, int8", [(None, False), ("openai/whisper-tiny",
                                                         True)])
def test_decode_footprint_equals_jax_term_by_term(copies, draft, int8):
    dims = get_dims("openai/whisper-base")
    kw = dict(weight_bytes=2, kv_bytes=2, int8_cross=int8,
              cache_copies=copies)
    if draft is not None:
        kw["draft_dims"] = get_dims(draft)
    want = jhbm.decode_footprint(dims, 16, 132, **kw)
    got = hbm.decode_footprint(dims, 16, 132, **kw)
    assert got == want


def test_the_graphed_gate_prices_the_pools_and_the_kept_budget(
        params, monkeypatch):
    """``set_draft_model``'s gate on a graphed session (forced here):
    one cache copy beside the active program's pools and the budget other
    keys may keep; with WHISPER_TPU_HBM_GB between the eager total and the
    graphed one, only the graphed session warns."""
    _, tsess = _sessions(params)
    ddraft = _draft()
    eager = tsess.speculative_footprint(ddraft[1])
    assert "graph_pool" not in eager and "graph_kept" not in eager
    monkeypatch.setattr(generate, "graphed",
                        lambda device, mesh, eager: mesh is None and not eager)
    monkeypatch.setattr(generate, "_budget", lambda device: 3 << 30)
    graphed = tsess.speculative_footprint(ddraft[1])
    assert graphed["graph_kept"] == 3 << 30
    assert graphed["graph_pool"] == hbm.program_pool_bytes(
        DIMS, 2, 4, act_bytes=4, fused_attention=False, draft_dims=ddraft[1])
    assert graphed["kv_cache"] == eager["kv_cache"]     # one copy
    assert graphed["total"] == (eager["total"] + graphed["graph_pool"]
                                + graphed["graph_kept"])
    gib = (eager["total"] + graphed["total"]) / 2 / 0.95 / (1 << 30)
    monkeypatch.setenv("WHISPER_TPU_HBM_GB", str(gib))
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        tsess.set_draft_model(*ddraft)
    assert any(issubclass(w.category, ResourceWarning)
               and "graph_pool" in str(w.message) for w in seen)
    tsess.eager_decode = True
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        tsess.set_draft_model(*ddraft)
    assert not [w for w in seen if issubclass(w.category, ResourceWarning)]


def test_trim_drops_keys_by_state_inputs_and_pools(params, conditional,
                                                   monkeypatch):
    """Pool bytes stubbed (the CPU has no pools): each key keeps its state,
    its static inputs and its pools; with a budget of two and a half keys,
    three keys leave two, which the state and inputs alone would not
    have dropped."""
    pool = 50 << 20
    monkeypatch.setattr(generate, "_pool_bytes", lambda pools: pool)
    _, tsess = _sessions(params)
    mel = torch.from_numpy(_mel(4))

    def run(p):
        tsess.transcribe_from_mel(mel, STARTS[:2], [SOT] * (p - 3) + [
            LANG, TASK, NO_TS], 3, EOT)

    run(4)
    (one,) = tsess.graphs.kept().values()
    loop = next(iter(tsess.graphs._loops.values()))
    assert one == pool + generate._storage_bytes(
        loop.state.tensors() + list(loop.inputs))
    assert tsess.graphs.pools() == {k: pool for k in tsess.graphs.kept()}
    monkeypatch.setattr(generate, "_budget", lambda device: int(2.5 * one))
    for p in (5, 6):
        run(p)
    kept = tsess.graphs.kept()
    assert [k.prompt_len for k in kept] == [5, 6]
    assert 3 * (one - pool) < 2.5 * one     # without the pools all stay
