"""The greedy step's tail (``ops.loop_tail``: the loop state's update after
the pick, and in a while node's body the node's condition, one kernel on
a card) on the CPU.

- ``loop_tail_plain``, and the wrapper on CPU tensors, equal the PyTorch
  sequence the step ran before, on seeded states: rows done before the
  step, rows that end at it, step 0 and the last column, with and without
  scores; the wrapper counts no launch on the CPU.
- Greedy chains at x0 fp32 with scores, rows ending at steps of their own,
  equal the JAX package's ``greedy_generate`` token for token (``n_tok``
  equal, ``sum_lp`` within 1e-4 relative).
- ``runtime.generate._while_node``, through a fake kernel library (no card
  here): a body that ends in the tail kernel takes the node's handle and
  queues no condition kernel (C), a body of another loop ends in C, and a
  ``tail`` body that sets no condition (no tail, the tail's plain version,
  two tails) raises with its node ended in C; the launches tally where a
  graph launch and an iteration count them.
"""

import contextlib
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_graph_loop import DIMS, PROMPT, _model
from whisper_tpu.runtime.generate import greedy_generate as jax_greedy
from whisper_tpu_torch.ops import common, kernels, loop_tail
from whisper_tpu_torch.runtime import beam, generate, speculative
from whisper_tpu_torch.runtime.generate import (
    build_suppress_mask,
    greedy_generate,
)

torch.set_num_threads(2)

EOT = 7


def _state(seed: int, b: int, cols: int, step: int, scores: bool):
    """A seeded loop state before a step at column ``step``: (nxt, lp,
    done, buf, last, pos, step, sum_lp, n_tok).  Row r is done before the
    step, ends at it (picks EOT) or goes on, by (r + seed) % 3; with
    scores sum_lp holds -0.0 in a row and lp a NaN in another (a done row
    adds 0.0, an undone one its lp)."""
    rng = np.random.default_rng(seed)
    kind = (np.arange(b) + seed) % 3
    done = kind == 0
    nxt = rng.integers(0, 12, b)
    nxt[nxt == EOT] = EOT + 1
    nxt[kind == 1] = EOT
    nxt[done & (rng.random(b) < 0.5)] = EOT
    t = (torch.from_numpy(nxt), None, torch.from_numpy(done),
         torch.from_numpy(rng.integers(0, 50, (b, cols))),
         torch.from_numpy(rng.integers(0, 50, b)),
         torch.tensor([rng.integers(4, 60)], dtype=torch.int32),
         torch.tensor([step]), None, None)
    if not scores:
        return t
    lp = rng.normal(-2, 1, b).astype(np.float32)
    sum_lp = rng.normal(-20, 5, b).astype(np.float32)
    sum_lp[seed % b] = -0.0
    lp[(seed + 1) % b] = np.nan
    return (t[0], torch.from_numpy(lp), *t[2:7], torch.from_numpy(sum_lp),
            torch.from_numpy(rng.integers(1, 30, b)))


def _sequence(nxt, lp, done, buf, last, pos, step, sum_lp, n_tok, eot_id):
    """The step's update as it was written before the tail: the sequence
    of PyTorch operations after the pick."""
    nxt = torch.where(done, eot_id, nxt)
    if sum_lp is not None:
        sum_lp.add_(torch.where(done, 0.0, lp))
        n_tok.add_((~done).long())
    buf.index_copy_(1, step, nxt[:, None])
    done.logical_or_(nxt == eot_id)
    last.copy_(nxt)
    pos.add_(1)
    step.add_(1)


def _same(a, b) -> bool:
    """Tensors (or Nones) equal, floats by their bits."""
    def bits(t):
        return t.view(torch.int32) if t.is_floating_point() else t
    return all(x is None and y is None or torch.equal(bits(x), bits(y))
               for x, y in zip(a, b))


@pytest.mark.parametrize("scores", [False, True])
@pytest.mark.parametrize("b, cols, step", [(1, 8, 0), (5, 8, 3), (5, 8, 7),
                                           (16, 128, 0), (16, 128, 127),
                                           (64, 40, 39)])
@pytest.mark.parametrize("form", ["plain", "wrapper"])
def test_loop_tail_equals_the_sequence_it_replaces(form, b, cols, step,
                                                   scores):
    """Every tensor of the state bitwise (floats by their bits: -0.0 and
    NaN included) after the tail and after the sequence, on the same
    seeded state, each row done before the step, ending at it and going
    on over the three seeds; the wrapper on CPU tensors launches
    nothing."""
    for seed in range(3):
        want = [None if t is None else t.clone()
                for t in _state(seed, b, cols, step, scores)]
        got = [None if t is None else t.clone() for t in want]
        _sequence(*want, eot_id=EOT)
        before = loop_tail.launches
        fn = loop_tail.loop_tail_plain if form == "plain" \
            else loop_tail.loop_tail
        fn(*got, eot_id=EOT)
        assert loop_tail.launches == before
        assert _same(got, want), seed


# ---------------------------------------------------------------------------
# the greedy loop against JAX at x0 fp32, rows ending on their own steps
# ---------------------------------------------------------------------------

def _ends(toks, eot):
    return [int(np.nonzero(r[1:] == eot)[0][0]) + 1 if (r[1:] == eot).any()
            else None for r in toks]


@pytest.mark.parametrize("seed", [6, 9])
def test_greedy_chains_with_scores_and_early_ends_equal_jax(seed):
    """Two chains of two rows (rows 0-1 and 2-3 share their encoder
    states) with an end-of-text id that every row emits within 12 steps at
    steps of its own, at x0 fp32 with scores: tokens and n_tok equal to
    JAX's, sum_lp within 1e-4 relative; rows done early are EOT to the end
    and add nothing."""
    enc, jp, tp = _model(seed, b=2)
    enc = np.concatenate([enc[:1], enc[:1], enc[1:], enc[1:]])
    base = build_suppress_mask(DIMS.vocab_size, [8, 300])
    probe = greedy_generate(tp, DIMS, torch.from_numpy(enc),
                            torch.tensor(PROMPT), torch.from_numpy(base),
                            torch.from_numpy(base), 13, 319).numpy()
    firsts = {}                 # id -> the step each row first emits it
    for r in probe:
        seen = {}
        for i in range(1, 13):
            seen.setdefault(int(r[i]), i)
        for i, at in seen.items():
            firsts.setdefault(i, []).append(at)
    eot = next(i for i, at in sorted(firsts.items())
               if len(at) == 4 and len(set(at)) > 1 and i not in probe[:, 0])
    first = build_suppress_mask(DIMS.vocab_size, [8, 300, eot])
    jt, jlp, jn = jax_greedy(
        jp, DIMS, jnp.asarray(enc), jnp.asarray(PROMPT, jnp.int32),
        jnp.asarray(base), jnp.asarray(first), 16, eot, return_logprobs=True)
    toks, sum_lp, n_tok = greedy_generate(
        tp, DIMS, torch.from_numpy(enc), torch.tensor(PROMPT),
        torch.from_numpy(base), torch.from_numpy(first), 16, eot,
        return_logprobs=True)
    ends = _ends(toks.numpy(), eot)
    assert all(e is not None and e < 16 for e in ends) and len(set(ends)) > 1
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(n_tok.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(n_tok.numpy(), np.asarray(ends) + 1)
    np.testing.assert_allclose(sum_lp.numpy(), np.asarray(jlp), rtol=1e-4,
                               atol=0)


# ---------------------------------------------------------------------------
# the while node's condition, through a fake kernel library
# ---------------------------------------------------------------------------

HANDLE = 77


class _FakeLib:
    """The entry points ``_while_node`` and the tail call, recording what
    they are given: the node's handle (HANDLE), whether its end queues C,
    the handle each tail sets (0: none)."""

    def __init__(self):
        self.ends, self.tails = [], []

    def wt_while_node_begin(self, *args):
        args[-1]._obj.value = HANDLE
        return 0

    def wt_while_node_end(self, handle, *args):
        self.ends.append((handle, args[-2]))
        args[-1]._obj.value = 5
        return 0

    def wt_loop_tail(self, *args):
        self.tails.append(args[12] if args[13] else 0)
        return 0


class _Graph:
    pass


@pytest.fixture
def fake_card(monkeypatch):
    """``_while_node`` and the tail's kernel route on CPU tensors: a fake
    library, streams and memory pools that do nothing."""
    lib = _FakeLib()
    monkeypatch.setattr(kernels, "library", lambda: lib)
    monkeypatch.setattr(kernels, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, 1))
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    for name in ("_cuda_beginAllocateCurrentStreamToPool",
                 "_cuda_endAllocateToPool", "_cuda_releasePool"):
        monkeypatch.setattr(torch._C, name, lambda *a: None, raising=False)
    return lib


def _kernel_route(monkeypatch):
    monkeypatch.setattr(loop_tail, "route", lambda t: "kernel")


def _node(body_fn, state, tail):
    """``body_fn`` captured as the body of a while node on the state's done
    flags and step, under a tally: (the tally around the node, the info
    the node yields)."""
    done, step = state[2], state[6]
    with common.tally_launches() as outer:
        with generate._while_node(_Graph(), done, step, 8,
                                  types.SimpleNamespace(cuda_stream=0),
                                  tail=tail) as info:
            body_fn()
    return outer, info


def _tail(state):
    return lambda: loop_tail.loop_tail(*state, eot_id=EOT)


C = (loop_tail, "condition_launches")
TAIL = (loop_tail, "launches")


def test_a_body_ending_in_the_tail_sets_the_condition_and_queues_no_c(
        fake_card, monkeypatch):
    _kernel_route(monkeypatch)
    state = _state(0, 4, 8, 2, scores=True)
    outer, info = _node(_tail(state), state, tail=True)
    assert fake_card.tails == [HANDLE]
    assert fake_card.ends == [(HANDLE, 0)]          # no C at the body's end
    assert outer == {C: 1}                           # C ahead of the node
    assert info["tally"] == {TAIL: 1} and info["body_ops"] == 5
    # outside the node's body the tail sets nothing
    loop_tail.loop_tail(*state, eot_id=EOT)
    assert fake_card.tails == [HANDLE, 0]


def test_a_body_of_another_loop_ends_in_the_condition_kernel(fake_card,
                                                             monkeypatch):
    _kernel_route(monkeypatch)
    state = _state(1, 4, 8, 2, scores=False)
    outer, info = _node(_tail(state), state, tail=False)
    assert fake_card.tails == [0]
    assert fake_card.ends == [(HANDLE, 1)]
    assert outer == {C: 1} and info["tally"] == {TAIL: 1, C: 1}


@pytest.mark.parametrize("body", ["nothing", "the plain tail",
                                  "two tails"])
def test_a_tail_body_that_sets_no_condition_raises(body, fake_card,
                                                   monkeypatch):
    """The node is ended with C in its body, so that what was captured is
    sound, and the capture raises."""
    state = _state(2, 4, 8, 2, scores=False)
    fns = {"nothing": lambda: None, "the plain tail": _tail(state)}
    if body == "two tails":
        _kernel_route(monkeypatch)
        fns[body] = lambda: (_tail(state)(), _tail(state)())
    with pytest.raises(RuntimeError, match="loop tail"):
        _node(fns[body], state, tail=True)
    assert fake_card.ends == [(HANDLE, 1)]


def test_the_tail_refuses_another_nodes_condition(fake_card, monkeypatch):
    _kernel_route(monkeypatch)
    state = _state(3, 4, 8, 2, scores=False)
    other = list(state)
    other[2] = state[2].clone()
    with pytest.raises(ValueError, match="other done flags"):
        _node(_tail(other), state, tail=True)
    assert fake_card.tails == []


def test_only_the_greedy_step_ends_in_the_tail():
    assert generate.LoopState.sets_condition
    assert not beam.BeamState.sets_condition
    assert not speculative.SpecState.sets_condition


def test_the_wrapper_refuses_what_the_kernel_does_not_take(fake_card,
                                                          monkeypatch):
    _kernel_route(monkeypatch)
    state = list(_state(4, 4, 8, 2, scores=True))
    bad = {"pos": (5, state[5].long()), "lp": (1, None),
           "buf": (3, state[3].t())}
    for name, (i, t) in bad.items():
        args = list(state)
        args[i] = t
        with pytest.raises(ValueError, match="loop_tail"):
            loop_tail.loop_tail(*args, eot_id=EOT)
    assert fake_card.tails == []
