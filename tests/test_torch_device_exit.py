"""The decode loops' exit on the device (``runtime.generate``: each graphed
greedy, beam and speculative decode one launch of a graph whose step
(round) is the body of a while node on "trips < bound and some row
undone") on the CPU: ``generate._GraphLoop``, the schedule a card runs,
every call queueing one launch and reading nothing before its end, with
the while node's plain form (a Python ``while`` on the same condition,
``_PlainGraph`` here) in place of the graph.

- Against the JAX package at x0 fp32, with an end-of-text id that every row
  emits at its own step before max_new_tokens: greedy tokens, ``n_tok``
  and ``sum_lp`` (within 1e-4 relative), beams K = 1, 2 and 4 with and
  without the timestamp grammar (scores within 1e-4 absolute), speculative
  rounds with a random draft and with the int8 cross cache (tokens,
  ``n_rounds``, committed counts); the steps (rounds) run, at the
  capture's call and at a later one, equal the JAX ``while_loop``'s trip
  count, the capture's call besides its one warm-up step (round), whose
  results its launch overwrites.  With no row ending every step runs.
- The graphed schedule is one launch a call and reads nothing on the host
  before its end: greedy, beams, speculative and the session's speculative
  ``_async`` form.
- Launch counts: a launch's tally counts once a body that ran
  (``ops.common.defer_launches``, ``settle_launches``).
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_graph_loop import no_host_reads  # noqa: F401 (a fixture)
from whisper_tpu.models import convert as jconvert
from whisper_tpu.runtime import timestamps as jts
from whisper_tpu.runtime.beam import beam_generate as jax_beam
from whisper_tpu.runtime.generate import greedy_generate as jax_greedy
from whisper_tpu.runtime.speculative import (
    speculative_generate as jax_speculative,
)
from whisper_tpu_torch.models import convert
from whisper_tpu_torch.models.registry import WhisperDims
from whisper_tpu_torch.ops import common
from whisper_tpu_torch.runtime import beam, generate, speculative
from whisper_tpu_torch.runtime import timestamps as ts
from whisper_tpu_torch.runtime.beam import beam_generate
from whisper_tpu_torch.runtime.generate import (
    build_suppress_mask,
    greedy_generate,
)
from whisper_tpu_torch.runtime.session import RuntimeCfg, WhisperSession
from whisper_tpu_torch.runtime.speculative import speculative_generate

torch.set_num_threads(2)

DIMS = WhisperDims(n_mels=80, d_model=128, encoder_layers=2, encoder_heads=2,
                   decoder_layers=2, decoder_heads=2, vocab_size=320,
                   max_source_positions=96, max_target_positions=64)
# head_dim 64 and an even head count: the cross-attention kernels' dims
HD64 = dataclasses.replace(DIMS, vocab_size=256)
SOT, LANG, TASK, NO_TS = 250, 252, 253, 254
TSB = 255                       # <|0.00|>: 65 timestamp ids above it
PROMPT = [SOT, LANG, TASK, NO_TS]
# [pad slots | a previous-text region | sot, lang, task, notimestamps]
PADDED = [251] * 3 + [255, 17, 99, 140, 33, 61, 7] + PROMPT
NEVER = 300                     # suppressed: a row with this EOT never ends
SUPPRESS = [8, NEVER]
MAX_NEW = 40


def _model(seed, dims=DIMS, b=3, spread=None):
    """Encoder states [b, T, d] and the JAX and port weights of ``seed``.
    With ``spread``, two chains: every row but the last holds row 0's
    states, the last those plus ``spread`` x noise (random weights decode
    their rows into runs of one id; rows that share an id then end at
    steps of their own when it is the end-of-text id)."""
    rng = np.random.default_rng(seed)
    enc = rng.normal(0, 1, (b, dims.max_source_positions,
                            dims.d_model)).astype(np.float32)
    if spread is not None:
        noise = np.random.default_rng(seed + 100).normal(
            0, 1, enc.shape[1:]).astype(np.float32)
        enc = np.stack([enc[0]] * (b - 1) + [enc[0] + spread * noise])
    jp = jconvert.cast_params(jconvert.init_params(dims, seed), jnp.float32)
    tp = convert.params_from_numpy(convert.init_params(dims, seed), "cpu",
                                   torch.float32)
    return enc, jp, tp


def _ends(toks: np.ndarray, eot: int, first: int = 1) -> list:
    """Each row's first step (column >= first) that holds ``eot``, or
    None."""
    out = []
    for row in toks:
        hit = np.nonzero(row[first:] == eot)[0]
        out.append(int(hit[0]) + first if hit.size else None)
    return out


def _early(ends, limit: int) -> bool:
    """Every row ends before ``limit``, at two steps or more."""
    return all(e is not None and e < limit for e in ends) and \
        len(set(ends)) > 1


def _ending_eot(decode, ids, limit: int, never: int = NEVER):
    """An id of ``ids`` that, declared end-of-text, ends every row at a
    step before ``limit``, at two steps or more: ``decode(eot)`` -> tokens
    [B, T] (numpy), ``decode(never)`` ending no row.  The ids whose first
    places in the never-ending decode qualify are tried in turn."""
    toks = decode(never)
    for eot in (i for i in ids if _early(_ends(toks, i), limit)):
        if _early(_ends(decode(eot), eot), limit):
            return eot
    raise AssertionError("no id ends every row early")


class _PlainGraph:
    """The program's plain form: a launch runs the pre-node part once (the
    front, the prefill, the first pick), then the step while the counter is
    under the bound and some row is undone (a Python ``while`` on the while
    node's condition); step None: the pre-node part alone."""

    def __init__(self, pre, step, done: torch.Tensor, trips: torch.Tensor,
                 bound: int):
        self.pre, self.step = pre, step
        self.done, self.trips, self.bound = done, trips, bound

    def replay(self) -> None:
        self.pre()
        while self.step is not None and int(self.trips) < self.bound \
                and not bool(self.done.all()):
            self.step()


class _PlainLoop(generate._GraphLoop):
    """``_GraphLoop`` with the plain form for its graph: the capture runs
    the warm-up (the pre-node part and a step), whose results the launch
    overwrites."""

    def _capture(self, pre, step, bound: int) -> None:
        pre()
        if step is not None:
            step()
        self.graph = _PlainGraph(pre, step, self.state.done,
                                 self.state.trips(), bound)


class _Landed:
    """A CUDA event whose work has run: on the CPU every copy lands at
    once."""

    def record(self, stream=None) -> None:
        pass

    def query(self) -> bool:
        return True

    def synchronize(self) -> None:
        pass


class _Stream:
    def wait_event(self, event) -> None:
        pass


@pytest.fixture
def landed(monkeypatch):
    """CUDA events and the current stream on the CPU (``_Landed``)."""
    monkeypatch.setattr(torch.cuda, "Event", _Landed)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _Stream())


@pytest.fixture
def conditional(monkeypatch, landed):
    """Run the graphed loops on the CPU: ``run_loop`` takes
    ``_PlainLoop``, whatever the device, with no bound on the state kept."""
    monkeypatch.setattr(generate, "graphed",
                        lambda device, mesh, eager: mesh is None
                        and not eager)
    monkeypatch.setattr(generate, "_GraphLoop", _PlainLoop)
    monkeypatch.setattr(generate, "_budget", lambda device: sys.maxsize)


@pytest.fixture
def jax_trips(monkeypatch):
    """The trip counts of the JAX ``lax.while_loop`` calls, in order."""
    trips = []
    real = jax.lax.while_loop

    def counting(cond, body, init):
        out, n = real(lambda c: cond(c[0]),
                      lambda c: (body(c[0]), c[1] + 1), (init, jnp.int32(0)))
        trips.append(int(n))
        return out

    monkeypatch.setattr(jax.lax, "while_loop", counting)
    return trips


def _counting(monkeypatch, module, name):
    """Wrap ``module.name`` (a step or round factory) so that every call of
    a step it makes adds one to the list returned."""
    runs = []
    make = getattr(module, name)

    def factory(*a, **kw):
        step = make(*a, **kw)

        def run():
            runs.append(1)
            step()
        return run

    monkeypatch.setattr(module, name, factory)
    return runs


# ---------------------------------------------------------------------------
# greedy
# ---------------------------------------------------------------------------

# case -> (prompt, the grammar, pad counts, seed, spread of the last row)
GREEDY_CASES = {
    "plain": (PROMPT, False, None, 6, 1.0),
    "grammar": (PROMPT[:3], True, None, 9, 0.2),
    "pads": (PADDED, False, [3, 3, 9], 6, 1.0),
}


def _ts_cfg(grammar: bool, eot: int):
    return ts.TimestampCfg(TSB, eot, NO_TS,
                           max_initial_timestamp_index=10) if grammar \
        else None


def _greedy_run(tp, enc, case, eot, max_new=MAX_NEW, **kw):
    prompt, grammar, pads = GREEDY_CASES[case][:3]
    base = torch.from_numpy(build_suppress_mask(DIMS.vocab_size, SUPPRESS))
    first = torch.from_numpy(build_suppress_mask(DIMS.vocab_size,
                                                 SUPPRESS + [eot]))
    return greedy_generate(
        tp, DIMS, torch.from_numpy(enc), torch.tensor(prompt), base, first,
        max_new, eot, ts_cfg=_ts_cfg(grammar, eot), return_logprobs=True,
        pad_count=None if pads is None
        else torch.tensor(pads, dtype=torch.int32), **kw)


@pytest.mark.parametrize("case", list(GREEDY_CASES))
def test_greedy_stops_where_the_while_loop_stops(case, conditional,
                                                 jax_trips, monkeypatch):
    """Tokens, n_tok and sum_lp equal JAX's; the capture's call and a
    later call each launch the program once and run the JAX trip count of
    steps under the plain while node (the capture's call one more before
    it: the warm-up, whose results the launch overwrites), and so does the
    eager loop that reads every step."""
    prompt, grammar, pads, seed, spread = GREEDY_CASES[case]
    enc, jp, tp = _model(seed, spread=spread)
    eot = _ending_eot(
        lambda e: _greedy_run(tp, enc, case, e, eager=True)[0].numpy(),
        range(TSB if grammar else DIMS.vocab_size), MAX_NEW - 4)
    base = build_suppress_mask(DIMS.vocab_size, SUPPRESS)
    first = build_suppress_mask(DIMS.vocab_size, SUPPRESS + [eot])
    jt, jlp, jn = jax_greedy(
        jp, DIMS, jnp.asarray(enc), jnp.asarray(prompt, jnp.int32),
        jnp.asarray(base), jnp.asarray(first), MAX_NEW, eot,
        ts_cfg=None if not grammar else jts.TimestampCfg(
            *_ts_cfg(True, eot)),
        pad_count=None if pads is None else jnp.asarray(pads, jnp.int32),
        return_logprobs=True)
    (trip,) = jax_trips
    assert trip < MAX_NEW - 4
    steps = _counting(monkeypatch, generate, "_step_fn")
    graphs = generate.DecodeGraphs(tp)
    for call in ("capture", "replay", "eager"):
        steps.clear()
        toks, sum_lp, n_tok = _greedy_run(tp, enc, case, eot, graphs=graphs,
                                          eager=call == "eager")
        np.testing.assert_array_equal(toks.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(n_tok.numpy(), np.asarray(jn))
        np.testing.assert_allclose(sum_lp.numpy(), np.asarray(jlp),
                                   rtol=1e-4, atol=0)
        warm = call == "capture"
        assert len(steps) == trip + warm, (call, len(steps), trip)
    assert len(graphs.captures()) == 1


def test_greedy_runs_every_step_when_no_row_ends(conditional, jax_trips,
                                                 monkeypatch):
    enc, jp, tp = _model(6, spread=1.0)
    mask = build_suppress_mask(DIMS.vocab_size, SUPPRESS)
    jt = jax_greedy(jp, DIMS, jnp.asarray(enc), jnp.asarray(PROMPT,
                                                            jnp.int32),
                    jnp.asarray(mask), jnp.asarray(mask), MAX_NEW, NEVER)
    assert jax_trips == [MAX_NEW - 1]
    steps = _counting(monkeypatch, generate, "_step_fn")
    toks = greedy_generate(tp, DIMS, torch.from_numpy(enc),
                           torch.tensor(PROMPT), torch.from_numpy(mask),
                           torch.from_numpy(mask), MAX_NEW, NEVER)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jt))
    # the capture's warm-up step, then the launch's MAX_NEW - 1
    assert len(steps) == 1 + MAX_NEW - 1


def test_sampled_draws_of_the_steps_that_run_are_the_eager_loops(
        conditional):
    """T = 0.7 with an end-of-text id that ends every row early (the first
    sampling seed from 5 whose draws have one): the while loop (the key in
    its state) gives the eager per-step loop's tokens, scores and counts,
    twice."""
    enc, _, tp = _model(6, spread=1.0)

    def run(eot, seed, **kw):
        return _greedy_run(tp, enc, "plain", eot, temperature=0.7,
                           generator=torch.Generator().manual_seed(seed),
                           **kw)

    for seed in range(5, 37):
        try:
            eot = _ending_eot(lambda e: run(e, seed, eager=True)[0].numpy(),
                              range(DIMS.vocab_size), MAX_NEW - 4)
            break
        except AssertionError:
            continue
    else:
        raise AssertionError("no sampling seed has an id ending every row")
    want = run(eot, seed, eager=True)
    graphs = generate.DecodeGraphs(tp)
    for _ in range(2):
        got = run(eot, seed, graphs=graphs)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


# ---------------------------------------------------------------------------
# beams
# ---------------------------------------------------------------------------

# two text ids left (and, with the grammar, the timestamps), one of them
# end-of-text, so every beam of every row ends early
KEEP, BEAM_EOT, BEAM_NEW = (17, 140), 140, 40


def _beam_masks(grammar: bool):
    keep = set(KEEP) | (set(range(TSB, DIMS.vocab_size)) if grammar
                        else set())
    base = build_suppress_mask(DIMS.vocab_size,
                               [i for i in range(DIMS.vocab_size)
                                if i not in keep])
    return base, base


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("grammar", [False, True])
def test_beams_stop_where_the_while_loop_stops(k, grammar, conditional,
                                               jax_trips, monkeypatch):
    """Tokens equal JAX's and scores within 1e-4; the capture's call (and
    its warm-up step), a later call and the eager per-step loop run the JAX
    trip count of steps, which ends before max_new_tokens."""
    enc, jp, tp = _model(6)
    prompt = PROMPT[:3] if grammar else PROMPT
    base, first = _beam_masks(grammar)
    cfg = _ts_cfg(grammar, BEAM_EOT)
    jt, js = jax_beam(
        jp, DIMS, jnp.asarray(enc), jnp.asarray(prompt, jnp.int32),
        jnp.asarray(base), jnp.asarray(first), BEAM_NEW, BEAM_EOT, k,
        ts_cfg=None if cfg is None else jts.TimestampCfg(*cfg))
    (trip,) = jax_trips
    assert 0 < trip < BEAM_NEW - 1
    steps = _counting(monkeypatch, beam, "_step_fn")
    graphs = generate.DecodeGraphs(tp)
    for call in ("capture", "replay", "eager"):
        steps.clear()
        tt, tsc = beam_generate(
            tp, DIMS, torch.from_numpy(enc), torch.tensor(prompt),
            torch.from_numpy(base), torch.from_numpy(first), BEAM_NEW,
            BEAM_EOT, k, ts_cfg=cfg, graphs=graphs, eager=call == "eager")
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_allclose(tsc.numpy(), np.asarray(js), rtol=0,
                                   atol=1e-4)
        assert len(steps) == trip + (call == "capture"), (call, len(steps))


# ---------------------------------------------------------------------------
# speculative rounds
# ---------------------------------------------------------------------------

SPEC_PROMPT = PROMPT
SPEC_NEW = 40
SPEC_NEVER = 255
# case -> (draft seed, speculative_generate keywords)
SPEC_CASES = {
    "a random draft": (99, {}),
    "int8 cross cache, B4 and B7 plain": (
        99, dict(int8_cross_kv=True, packed_draft=True, packed_main=True,
                 int8_mxu=True)),
    "the model as its own draft, B6 and B7 plain": (
        1, dict(int8_cross_kv=True, packed_draft=True, packed_main=True,
                int8_mxu=False)),
}


@pytest.mark.parametrize("case", list(SPEC_CASES))
def test_speculative_stops_where_the_while_loop_stops(case, conditional,
                                                      jax_trips,
                                                      monkeypatch):
    """Tokens, n_rounds and the committed counts equal JAX's; the rounds
    run, at the capture's call (besides its warm-up round), a later call
    and in the eager loop that reads every round, equal JAX's trip count
    and the rounds counted."""
    draft_seed, kw = SPEC_CASES[case]
    enc, jp, tp = _model(1, HD64, b=4, spread=1.0)
    _, jd, td = (_model(draft_seed, HD64) if draft_seed != 1
                 else (None, jp, tp))
    mask = build_suppress_mask(HD64.vocab_size, [7, 8, SPEC_NEVER])
    args = (torch.tensor(SPEC_PROMPT), torch.from_numpy(mask),
            torch.from_numpy(mask))

    def greedy(eot):
        return greedy_generate(tp, HD64, torch.from_numpy(enc), *args,
                               SPEC_NEW, eot, eager=True).numpy()

    eot = _ending_eot(greedy, range(9, HD64.vocab_size), SPEC_NEW - 4,
                      SPEC_NEVER)
    want = jax_speculative(
        jp, HD64, jd, HD64, jnp.asarray(enc), jnp.asarray(enc),
        jnp.asarray(SPEC_PROMPT, jnp.int32), jnp.asarray(mask),
        jnp.asarray(mask), max_new_tokens=SPEC_NEW, eot_id=eot, draft_k=3,
        **kw)
    (trip,) = jax_trips
    assert trip == int(want[1]) > 1
    rounds = _counting(monkeypatch, speculative, "_round_fn")
    graphs = generate.DecodeGraphs(tp, draft_params=td)
    for call in ("capture", "replay", "eager"):
        rounds.clear()
        toks, n_rounds, n = speculative_generate(
            tp, HD64, td, HD64, torch.from_numpy(enc), torch.from_numpy(enc),
            *args, max_new_tokens=SPEC_NEW, eot_id=eot, draft_k=3,
            graphs=graphs, eager=call == "eager", **kw)
        np.testing.assert_array_equal(toks.numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(n.numpy(), np.asarray(want[2]))
        assert torch.is_tensor(n_rounds) and n_rounds.shape == (1,)
        warm = call == "capture"
        assert int(n_rounds) == trip == len(rounds) - warm, (call,
                                                             len(rounds))
    assert (toks.numpy() == eot).any(axis=1).all()


# ---------------------------------------------------------------------------
# the graphed schedule reads nothing before its end
# ---------------------------------------------------------------------------

@pytest.fixture
def queued(monkeypatch):
    """The plain graph's launches recorded, not run (the body and its
    condition run on the card there): their count."""
    launches = []
    monkeypatch.setattr(_PlainGraph, "replay",
                        lambda self: launches.append(1))
    return launches


@pytest.mark.parametrize("loop", ["greedy", "beam", "speculative"])
def test_the_graphed_schedule_reads_nothing(loop, conditional, queued,
                                            no_host_reads):  # noqa: F811
    """The capture's call and a later one each queue one launch of the
    graph with no bool, item, tolist or cpu: the capture's call runs the
    prefill and its first step for real (the warm-up, as on the card) and
    then launches the program, prefill and every step, as a later call
    does."""
    enc, _, tp = _model(1, HD64)
    mask = torch.zeros(HD64.vocab_size)
    graphs = generate.DecodeGraphs(tp, draft_params=tp)
    n = 12

    def call():
        if loop == "greedy":
            return greedy_generate(tp, HD64, torch.from_numpy(enc),
                                   torch.tensor(PROMPT), mask, mask, n, 2,
                                   return_logprobs=True, graphs=graphs)
        if loop == "beam":
            return beam_generate(tp, HD64, torch.from_numpy(enc),
                                 torch.tensor(PROMPT), mask, mask, n, 2, 4,
                                 graphs=graphs)
        return speculative_generate(
            tp, HD64, tp, HD64, torch.from_numpy(enc), torch.from_numpy(enc),
            torch.tensor(PROMPT), mask, mask, n, 2, 3, graphs=graphs)

    for _ in ("the capture's call", "a later one"):
        queued.clear()
        with no_host_reads():
            call()
        assert len(queued) == 1


def test_the_speculative_async_form_reads_nothing(conditional, queued,
                                                  no_host_reads):  # noqa: F811
    """``transcribe_short_speculative_async`` on the graphed schedule: one
    launch queued, no read, so a serving tick with a draft returns at
    once."""
    long = dataclasses.replace(HD64, max_source_positions=1500)
    params = convert.init_params(long, 3)
    sess = WhisperSession(params, long,
                          RuntimeCfg(dtype="float32", max_batch=4),
                          device="cpu")
    sess.set_draft_model(params, long)
    rng = np.random.default_rng(0)
    audio = rng.normal(0, 0.1, (2, 480_400)).astype(np.float32)
    n_valid = np.asarray([3000, 900], np.int32)
    for _ in ("the capture's call", "a later one"):
        queued.clear()
        with no_host_reads():
            sess.transcribe_short_speculative_async(audio, n_valid, PROMPT,
                                                    10, 2, [7], [2])
        assert len(queued) == 1


# ---------------------------------------------------------------------------
# launch counts: a tally counts once a body that ran
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Toy(generate.InPlaceState):
    """Rows that end at given steps: a step advances the counter and marks
    the rows whose end it reached."""

    step: torch.Tensor            # [1]
    done: torch.Tensor            # [B]
    ends: torch.Tensor            # [B]

    def tensors(self):
        return [self.step, self.done, self.ends]

    def trips(self):
        return self.step

    def outputs(self):
        return self.step.clone()


class _Queued(_Landed):
    """A CUDA event whose work is still on the card until ``landed``."""

    landed = False

    def query(self) -> bool:
        return _Queued.landed


@pytest.fixture
def queued_events(monkeypatch, landed):
    monkeypatch.setattr(torch.cuda, "Event", _Queued)
    monkeypatch.setattr(_Queued, "landed", False)
    common.settle_launches(wait=True)


def test_a_replay_counts_its_tally_once_a_body_that_ran(queued_events):
    """Rows ending at steps 3 and 5 of a bound of 10: every call, the
    capture's too (its warm-up runs the pre-node part and step 1, whose
    launches count nowhere), is one launch of the program: the pre-node
    part's tally counts once at the launch, the body's once an iteration
    that ran, four a call, deferred while the count is on the card and
    added by ``settle_launches`` once it has landed.  The call's input (the
    rows' ends) reaches the program through the key's static copy."""
    mod = sys.modules[__name__]
    mod.toy_launches = 0
    mod.toy_pre_launches = 0

    class Tallied(_PlainLoop):
        def _capture(self, pre, step, bound):
            super()._capture(pre, step, bound)
            self.pre_tally = {(mod, "toy_pre_launches"): 2}
            self.tally = {(mod, "toy_launches"): 3}

    loop = Tallied(torch.device("cpu"))

    def prepare(xs, out=None):
        st = _Toy(torch.ones(1, dtype=torch.long),
                  torch.zeros(2, dtype=torch.bool), xs[0])
        return st if out is None else out.copy_(st)

    def make_step(st):
        def step():
            st.step.add_(1)
            st.done.logical_or_(st.ends <= st.step)
        return step

    total = 0
    for call, ends in enumerate(([3, 5], [2, 5])):
        _Queued.landed = False
        got = loop.run((torch.tensor(ends),), prepare, make_step, 1, 10)
        assert int(got) == 5
        common.settle_launches()
        assert mod.toy_pre_launches == 2 * (call + 1)
        assert mod.toy_launches == total        # still on the card
        _Queued.landed = True
        common.settle_launches()
        total += 3 * 4
        assert mod.toy_launches == total
    assert loop.inputs[0].tolist() == [2, 5]
    common.settle_launches(wait=True)
    assert mod.toy_launches == 24


def test_deferred_launches_add_tally_times_runs(queued_events):
    """tally x runs, added once the count has landed (or with ``wait``);
    a later deferral adds the landed ones itself, so the list of pending
    runs holds only runs still on the card."""
    mod = sys.modules[__name__]
    mod.deferred_launches = 0
    tally = {(mod, "deferred_launches"): 2}
    common.defer_launches(tally, torch.tensor([4]))
    common.defer_launches(tally, torch.tensor([0]))
    common.defer_launches({}, torch.tensor([7]))
    assert mod.deferred_launches == 0 and len(common._PENDING) == 2
    _Queued.landed = True
    common.settle_launches()
    assert mod.deferred_launches == 8 and not common._PENDING
    common.add_launches(tally, 3)
    assert mod.deferred_launches == 14
    _Queued.landed = False
    common.defer_launches(tally, torch.tensor([1]))
    common.settle_launches(wait=True)
    assert mod.deferred_launches == 16 and not common._PENDING
    _Queued.landed = False
    for _ in range(5):
        common.defer_launches(tally, torch.tensor([1]))
    assert len(common._PENDING) == 5
    _Queued.landed = True
    common.defer_launches(tally, torch.tensor([2]))
    assert mod.deferred_launches == 30 and not common._PENDING
