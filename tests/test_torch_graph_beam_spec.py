"""The port's in-place beam step and speculative round (``runtime.beam``,
``runtime.speculative``: the functions a CUDA graph captures on a card),
driven on the CPU by ``generate.run_loop``, against the JAX package.

- ``beam_generate`` over ``BeamState`` equals JAX ``beam_generate`` at x0
  fp32 for K = 1, 2 and 4, plain, with the timestamp grammar and with mixed
  pad counts: tokens token for token, scores within 1e-4 (absolute), as
  tests/test_torch_beam.py holds them.
- Run to max_new_tokens without an exit, and in blocks of 16 steps read one
  block behind, the beam loop returns the early-exit run's buffer, scores
  and lengths bitwise: steps past all-done change nothing.
- ``speculative_generate`` over ``SpecState`` equals JAX: tokens,
  ``n_rounds`` and ``n_committed`` exactly, plain and with the int8 cross
  cache (the kernels' plain versions); rounds run past all-done change none
  of the three.
- ``transcribe_from_mel_async(num_beams=4)`` reads nothing on the host.
- One ``DecodeGraphs`` holds every kind of loop under one budget; a new
  draft drops the speculative loops.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_graph_loop import no_host_reads  # noqa: F401 (a fixture)
from whisper_tpu.models import convert as jconvert
from whisper_tpu.runtime import timestamps as jts
from whisper_tpu.runtime.beam import beam_generate as jax_beam
from whisper_tpu.runtime.speculative import (
    speculative_generate as jax_speculative,
)
from whisper_tpu_torch.models import convert
from whisper_tpu_torch.models.registry import WhisperDims
from whisper_tpu_torch.runtime import beam, generate, speculative
from whisper_tpu_torch.runtime import timestamps as ts
from whisper_tpu_torch.runtime.beam import beam_generate
from whisper_tpu_torch.runtime.generate import build_suppress_mask
from whisper_tpu_torch.runtime.session import RuntimeCfg, WhisperSession
from whisper_tpu_torch.runtime.speculative import speculative_generate

torch.set_num_threads(2)

DIMS = WhisperDims(n_mels=80, d_model=128, encoder_layers=2, encoder_heads=2,
                   decoder_layers=2, decoder_heads=2, vocab_size=320,
                   max_source_positions=96, max_target_positions=48)
SOT, EOT, LANG, TASK, NO_TS = 250, 251, 252, 253, 254
TS_CFG = ts.TimestampCfg(NO_TS + 1, EOT, NO_TS)
PROMPT = [SOT, LANG, TASK, NO_TS]
# [pad slots | a previous-text region | sot, lang, task, notimestamps]
PADDED = [EOT] * 3 + [255, 17, 99, 140, 33, 61, 7] + PROMPT
PADS = [3, 5, 9]
SUPPRESS = [7, 8, 300]


def _inputs(seed, b=3, dims=DIMS):
    rng = np.random.default_rng(seed)
    enc = rng.normal(0, 1, (b, dims.max_source_positions,
                            dims.d_model)).astype(np.float32)
    jp = jconvert.cast_params(jconvert.init_params(dims, seed), jnp.float32)
    tp = convert.params_from_numpy(convert.init_params(dims, seed), "cpu",
                                   torch.float32)
    return enc, jp, tp


def _masks(suppress=SUPPRESS):
    return (build_suppress_mask(DIMS.vocab_size, suppress),
            build_suppress_mask(DIMS.vocab_size, list(suppress) + [EOT]))


# ---------------------------------------------------------------------------
# beam search
# ---------------------------------------------------------------------------

# case -> (prompt, ts_cfg, pads)
BEAM_CASES = {
    "plain": (PROMPT, None, None),
    "grammar": (PROMPT[:3], TS_CFG, None),
    "pads": (PADDED, None, PADS),
}


@pytest.mark.parametrize("k, case", [(1, "plain"), (2, "plain"),
                                     (4, "plain"), (2, "grammar"),
                                     (4, "grammar"), (2, "pads"),
                                     (4, "pads")])
def test_state_form_beam_equals_jax_at_x0(k, case):
    prompt, ts_cfg, pads = BEAM_CASES[case]
    enc, jp, tp = _inputs(10 + k)
    base, first = _masks()
    jt, js = jax_beam(
        jp, DIMS, jnp.asarray(enc), jnp.asarray(prompt, jnp.int32),
        jnp.asarray(base), jnp.asarray(first), 10, EOT, k,
        ts_cfg=None if ts_cfg is None else jts.TimestampCfg(*ts_cfg),
        pad_count=None if pads is None else jnp.asarray(pads, jnp.int32))
    for early_exit in (True, False):
        tt, tsc = beam_generate(
            tp, DIMS, torch.from_numpy(enc), torch.tensor(prompt),
            torch.from_numpy(base), torch.from_numpy(first), 10, EOT, k,
            ts_cfg=ts_cfg, early_exit=early_exit,
            pad_count=None if pads is None
            else torch.tensor(pads, dtype=torch.int32))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_allclose(tsc.numpy(), np.asarray(js), rtol=0,
                                   atol=1e-4)


@pytest.mark.parametrize("case", ["plain", "pads"])
def test_beam_steps_past_all_done_change_nothing(case, monkeypatch):
    """Three ids left, one of them EOT, so every beam of every row ends
    near step 20: the per-step exit, blocks of 16 read one block behind,
    and no exit (all 59 steps) return the same buffer, scores and lengths,
    bitwise; the per-step exit stopped at the last beam's end, the blocks
    within two blocks of it."""
    dims = dataclasses.replace(DIMS, max_target_positions=96)
    prompt, _, pads = BEAM_CASES[case]
    enc, _, tp = _inputs(3, dims=dims)
    eot, keep = 140, {17, 99, 140}
    base = torch.from_numpy(build_suppress_mask(
        dims.vocab_size, [i for i in range(dims.vocab_size) if i not in keep]))
    outs, steps = [], []
    run_loop, step_fn, drive = beam.run_loop, beam._step_fn, generate._drive

    def recording(*a, **kw):
        outs.append(run_loop(*a, **kw))
        return outs[-1]

    def counting(*a, **kw):
        step = step_fn(*a, **kw)

        def run():
            steps[-1] += 1
            step()
        return run

    monkeypatch.setattr(beam, "run_loop", recording)
    monkeypatch.setattr(beam, "_step_fn", counting)
    for block, early_exit in ((None, True), (16, True), (None, False)):
        monkeypatch.setattr(
            generate, "_drive",
            lambda step, first, n, done, every, block=block: drive(
                step, first, n, done, block if every and block else every))
        steps.append(0)
        beam_generate(tp, dims, torch.from_numpy(enc), torch.tensor(prompt),
                      base, base, 60, eot, 4, early_exit=early_exit,
                      pad_count=None if pads is None
                      else torch.tensor(pads, dtype=torch.int32))
    want = outs[0]
    for got in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    buf, _, lengths = want
    assert int(lengths.max()) == steps[0] + 1 < 30, steps
    assert steps[0] < steps[1] <= steps[0] + 32 < steps[2] == 59, steps
    assert (buf[:, :, steps[0] + 1:] == eot).all()


# ---------------------------------------------------------------------------
# speculative decoding
# ---------------------------------------------------------------------------

HD64 = WhisperDims(n_mels=80, d_model=128, encoder_layers=2, encoder_heads=2,
                   decoder_layers=2, decoder_heads=2, vocab_size=256,
                   max_source_positions=96, max_target_positions=64)
SPEC_EOT = 2

# case -> (draft seed, speculative_generate keywords)
SPEC_CASES = {
    "plain, a random draft": (99, {}),
    "plain, the model as its own draft": (0, {}),
    "int8 cross cache, B4 and B7 plain": (
        99, dict(int8_cross_kv=True, packed_draft=True, packed_main=True,
                 int8_mxu=True)),
    "int8 cross cache, B6 and B7 plain": (
        0, dict(int8_cross_kv=True, packed_draft=True, packed_main=True,
                int8_mxu=False)),
}


@pytest.mark.parametrize("case", list(SPEC_CASES))
def test_state_form_speculative_equals_jax(case, monkeypatch):
    """Tokens, n_rounds and n_committed equal to JAX's; then with five
    rounds run past the loop's end (a card's overrunning block), the same
    three, bitwise."""
    draft_seed, kw = SPEC_CASES[case]
    enc, jp, tp = _inputs(0, b=4, dims=HD64)
    _, jd, td = _inputs(draft_seed, b=4, dims=HD64)
    mask = build_suppress_mask(HD64.vocab_size, [7, 8])
    args = (torch.tensor([3, 5]), torch.from_numpy(mask),
            torch.from_numpy(mask))
    want = jax_speculative(
        jp, HD64, jd, HD64, jnp.asarray(enc), jnp.asarray(enc),
        jnp.asarray([3, 5], jnp.int32), jnp.asarray(mask), jnp.asarray(mask),
        max_new_tokens=12, eot_id=SPEC_EOT, draft_k=3, **kw)
    runs = []
    drive = generate._drive
    for extra in (0, 5):
        def overrun(step, first, n, done, every, extra=extra):
            drive(step, first, n, done, every)
            for _ in range(extra):
                step()

        monkeypatch.setattr(generate, "_drive", overrun)
        runs.append(speculative_generate(
            tp, HD64, td, HD64, torch.from_numpy(enc), torch.from_numpy(enc),
            *args, max_new_tokens=12, eot_id=SPEC_EOT, draft_k=3, **kw))
    for toks, rounds, n in runs:
        np.testing.assert_array_equal(toks.numpy(), np.asarray(want[0]))
        assert rounds == int(want[1])
        np.testing.assert_array_equal(n.numpy(), np.asarray(want[2]))
    assert rounds > 1


def test_a_round_with_every_row_done_commits_nothing(monkeypatch):
    """The round function over a state whose rows are all done: the round
    counter, the buffer, n_gen, last and done stay as they were."""
    enc, _, tp = _inputs(0, b=2, dims=HD64)
    states = []

    def capture(inputs, prepare, make_step, first, n, every, **kw):
        st = prepare(inputs, None)
        generate._drive(make_step(st), first, n, st.done, every)
        states.append((st, make_step))
        return st.outputs()

    monkeypatch.setattr(speculative, "run_loop", capture)
    mask = torch.zeros(HD64.vocab_size)
    speculative_generate(tp, HD64, tp, HD64, torch.from_numpy(enc),
                         torch.from_numpy(enc), torch.tensor([3]), mask, mask,
                         6, SPEC_EOT, draft_k=2)
    st, make_step = states[0]
    assert bool(st.done.all())
    before = [t.clone() for t in (st.rounds, st.buf, st.n_gen, st.last,
                                  st.done)]
    make_step(st)()
    after = (st.rounds, st.buf, st.n_gen, st.last, st.done)
    assert all(torch.equal(a, b) for a, b in zip(after, before))


# ---------------------------------------------------------------------------
# the session: beams read nothing in the _async form
# ---------------------------------------------------------------------------

LONG = dataclasses.replace(DIMS, max_source_positions=1500)


def test_beam_async_form_makes_no_host_read(no_host_reads):  # noqa: F811
    sess = WhisperSession(convert.init_params(LONG, 3), LONG,
                          RuntimeCfg(dtype="float32", max_batch=4),
                          device="cpu")
    rng = np.random.default_rng(0)
    mel = torch.from_numpy(rng.normal(0, 1, (80, 7000)).astype(np.float32))
    starts = [0, 2500, 5000]
    args = (mel, starts, PROMPT, 10, EOT, [8], [EOT])
    with no_host_reads():
        pieces = sess.transcribe_from_mel_async(*args, num_beams=4)
    got = sess.gather_tokens(pieces, len(starts), 10)
    np.testing.assert_array_equal(
        got, sess.transcribe_from_mel(*args, num_beams=4))
    with no_host_reads(), pytest.raises(AssertionError, match="host"):
        sess.transcribe_from_mel(*args, num_beams=4)


# ---------------------------------------------------------------------------
# one DecodeGraphs for every kind
# ---------------------------------------------------------------------------

def _keys(i):
    return (generate.GraphKey(4, 4 + i, 8, 1500, True, True, False, True,
                              False, None, False, False, False, EOT),
            beam.BeamKey(4, 2, 4 + i, 8, 1500, True, True, True, None, False,
                         EOT),
            speculative.SpecKey(4, 4 + i, 8, 3, 1500, 1500, True, True, True,
                                True, EOT))


def test_keys_of_two_loops_never_compare_equal():
    greedy, beams, spec = _keys(0)
    assert len({greedy, beams, spec}) == 3
    assert [k.kind for k in (greedy, beams, spec)] == [
        "greedy", "beam", "speculative"]


def test_decode_graphs_hold_every_kind_under_one_budget(monkeypatch):
    """Loops of the three kinds share the budget (the least recently used
    of any kind goes first); ``set_draft`` drops the speculative loops
    only; a speculative loop needs the draft the graphs hold."""
    monkeypatch.setattr(generate, "_budget", lambda device: 100)
    params, draft = {"decoder": {}}, {"decoder": {}}
    graphs = generate.DecodeGraphs(params, draft_params=draft)
    cpu = torch.device("cpu")
    for key in _keys(0):
        loop = graphs.loop(params, None, key, cpu,
                           draft if key.kind == "speculative" else None)
        loop.nbytes, loop.graph = 40, object()
        graphs.trim(key)
    assert [k.kind for k in graphs.captures()] == ["beam", "speculative"]
    assert graphs.nbytes() == 80
    with pytest.raises(ValueError, match="other weights"):
        graphs.loop(params, None, _keys(1)[2], cpu, {"decoder": {}})
    greedy = graphs.loop(params, None, _keys(1)[0], cpu)
    greedy.nbytes, greedy.graph = 10, object()
    new_draft = {"decoder": {}}
    graphs.set_draft(new_draft)
    assert [k.kind for k in graphs.captures()] == ["beam", "greedy"]
    assert graphs.loop(params, None, _keys(0)[2], cpu,
                       new_draft).graph is None
