"""The sampled pick of a decode step (``ops.sampling``: a Gumbel-max draw
from a counter-based Philox keyed by the loop's state) on the CPU, where
``gumbel_pick`` takes its plain version; the kernel is held bitwise
against it on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

- The plain Philox4x32-10 gives Random123's published known-answer
  vectors.
- The uniforms lie in (0, 1), each an odd multiple of 2^-24.
- Sampled frequencies follow softmax(logits / T) at two temperatures.
- Draws are deterministic per key, two steps' noise differs, two seeds'
  and two offsets' differ, and a suppressed id is never drawn.
- A data rank's rows [lo, hi) draw that slice of the whole batch's draws.
- ``generator_key``: a seed of 64 bits keeps its bits; a CPU generator has
  offset 0; a generator on another device is refused.
- The sampled greedy loop equals JAX at T > 0 in what the two can share
  (the first token of a row whose logits leave one id finite) and is
  deterministic per seed; the loop's draws are ``gumbel_pick`` of the
  loop's key at each step.
- The trial capture's guard (``generate._NoRandomOps``) raises for an
  operation that draws from a torch generator and lets the rest through.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from whisper_tpu.models import convert as jconvert
from whisper_tpu.runtime.generate import greedy_generate as jax_greedy
from whisper_tpu_torch.models import convert
from whisper_tpu_torch.models.registry import WhisperDims
from whisper_tpu_torch.ops import sampling
from whisper_tpu_torch.runtime import generate
from whisper_tpu_torch.runtime.generate import (
    build_suppress_mask,
    greedy_generate,
)

torch.set_num_threads(2)

DIMS = WhisperDims(n_mels=80, d_model=128, encoder_layers=2, encoder_heads=2,
                   decoder_layers=2, decoder_heads=2, vocab_size=320,
                   max_source_positions=96, max_target_positions=48)
SOT, EOT, LANG, TASK, NO_TS = 250, 251, 252, 253, 254
PROMPT = [SOT, LANG, TASK, NO_TS]


def _key(seed: int, offset: int = 0) -> torch.Tensor:
    return torch.tensor([sampling._signed(seed), sampling._signed(offset)],
                        dtype=torch.int64)


def _step(s: int) -> torch.Tensor:
    return torch.full((1,), s, dtype=torch.int64)


# Random123's kat_vectors for philox4x32 with 10 rounds:
# (counter, key, output), each a list of 32-bit words
KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("counter, key, want", KAT)
def test_philox_gives_the_known_answer_vectors(counter, key, want):
    words = sampling.philox4x32_10(
        tuple(torch.tensor([c], dtype=torch.int64) for c in counter),
        tuple(torch.tensor([k], dtype=torch.int64) for k in key))
    assert [int(w) for w in words] == list(want)


def test_philox_of_many_counters_equals_one_at_a_time():
    """The broadcast form (the draws of a [B, V] batch) is the scalar form
    counter by counter."""
    rng = np.random.default_rng(0)
    c = [torch.from_numpy(rng.integers(0, 2**32, (5, 7), dtype=np.int64))
         for _ in range(4)]
    k = (123456789, 987654321)
    whole = sampling.philox4x32_10(c, k)
    for i, j in ((0, 0), (2, 5), (4, 6)):
        one = sampling.philox4x32_10([x[i, j] for x in c], k)
        assert [int(w[i, j]) for w in whole] == [int(w) for w in one]


def test_uniforms_are_odd_multiples_of_2_to_the_minus_24_in_0_1():
    u = sampling.uniforms_plain(4, 1001, _key(7), _step(3))
    assert u.dtype == torch.float32 and u.shape == (4, 1001)
    assert bool((u > 0).all() and (u < 1).all())
    m = (u.double() * 2**24)
    assert torch.equal(m, m.round()) and bool((m.long() % 2 == 1).all())
    # one Philox call serves four ids: ids 4g .. 4g + 3 share a counter
    assert len(set(u[0, :8].tolist())) == 8


@pytest.mark.parametrize("t", [0.6, 1.5])
def test_sampled_frequencies_follow_the_softmax(t):
    """8,192 rows of the same logits (each row its own counter): each id's
    count within 4 sigma of 8,192 * softmax(logits / T); the suppressed id
    never drawn."""
    n = 8192
    logits = torch.tensor([1.0, 0.5, -0.3, 2.0, 0.0, -1.0, 1.5,
                           -float("inf")])
    rows = logits.expand(n, -1).contiguous()
    tok = sampling.gumbel_pick(rows, torch.full((1,), t), _key(11),
                               _step(1))
    counts = np.bincount(tok.numpy(), minlength=8)
    p = torch.softmax(logits / t, -1).double().numpy()
    sigma = np.sqrt(n * p * (1 - p))
    assert counts[7] == 0
    assert (np.abs(counts - n * p) <= 4 * sigma + 1e-9).all(), (counts, n * p)


def test_draws_are_deterministic_per_key_and_differ_by_step_seed_offset():
    rng = np.random.default_rng(1)
    logits = torch.from_numpy(rng.normal(0, 1, (6, 320)).astype(np.float32))
    logits[:, ::3] = -float("inf")
    temp = torch.full((1,), 1.0)

    def draw(key, s):
        return sampling.gumbel_pick(logits, temp, key, _step(s),
                                    with_draws=True)

    a, b = draw(_key(5), 2), draw(_key(5), 2)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    for other in (draw(_key(5), 3), draw(_key(6), 2), draw(_key(5, 4), 2),
                  draw(_key(5, 1 << 40), 2)):
        assert not torch.equal(other[1], a[1])
    suppressed = torch.arange(0, 320, 3)
    for s in range(20):
        tok = draw(_key(5), s)[0]
        assert not torch.isin(tok, suppressed).any()
        assert bool(torch.isfinite(draw(_key(5), s)[2].gather(
            1, tok[:, None])).all())


@pytest.mark.parametrize("lo, hi", [(0, 3), (3, 8), (5, 6)])
def test_a_data_ranks_rows_draw_that_slice_of_the_batch(lo, hi):
    rng = np.random.default_rng(2)
    logits = torch.from_numpy(rng.normal(0, 2, (8, 257)).astype(np.float32))
    temp, key, step = torch.full((1,), 0.8), _key(9, 12), _step(4)
    whole = sampling.gumbel_pick(logits, temp, key, step, with_draws=True)
    part = sampling.gumbel_pick(logits[lo:hi].contiguous(), temp, key, step,
                                lo, with_draws=True)
    for w, p in zip(whole, part):
        assert torch.equal(w[lo:hi], p)
    tok, _ = generate.pick(logits[lo:hi].contiguous(), 0.8, key, 4, False,
                           row0=lo)
    assert torch.equal(tok, whole[0][lo:hi])


def test_generator_key_keeps_the_seeds_bits_and_refuses_another_device():
    g = torch.Generator().manual_seed(2**64 - 3)
    key = sampling.generator_key(g, "cpu")
    assert key.dtype == torch.int64 and key.shape == (2,)
    assert [int(x) for x in key] == [-3, 0]
    assert int(sampling.generator_key(torch.Generator().manual_seed(77),
                                      "cpu")[0]) == 77
    # the same draws from the key of a seed as from the seed's words
    u = sampling.uniforms_plain(2, 9, key, _step(1))
    assert torch.equal(u, sampling.uniforms_plain(2, 9, _key(2**64 - 3),
                                                  _step(1)))
    with pytest.raises(RuntimeError, match="generator on cpu"):
        sampling.generator_key(g, "meta")


def test_gumbel_pick_raises_on_a_device_without_a_kernel():
    logits = torch.zeros(2, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        sampling.gumbel_pick(logits, torch.ones(1), _key(0), _step(0))


def _model(seed, b=3):
    rng = np.random.default_rng(seed)
    enc = rng.normal(0, 1, (b, DIMS.max_source_positions,
                            DIMS.d_model)).astype(np.float32)
    jp = jconvert.cast_params(jconvert.init_params(DIMS, seed), jnp.float32)
    tp = convert.params_from_numpy(convert.init_params(DIMS, seed), "cpu",
                                   torch.float32)
    return enc, jp, tp


def test_one_id_left_is_drawn_by_jax_and_the_port_alike():
    """Every id but one suppressed at the first step and every id but
    EOT after it: at T = 0.9 JAX and the port (two different generators)
    draw the same tokens, the only ones they can draw, with the same
    scores within 1e-4; the sampled draws never leave the mask."""
    enc, jp, tp = _model(3)
    only = 77
    first = build_suppress_mask(DIMS.vocab_size,
                                [i for i in range(DIMS.vocab_size)
                                 if i != only])
    base = build_suppress_mask(DIMS.vocab_size,
                               [i for i in range(DIMS.vocab_size)
                                if i != EOT])
    import jax

    jt, jlp, jn = jax_greedy(jp, DIMS, jnp.asarray(enc),
                             jnp.asarray(PROMPT, jnp.int32),
                             jnp.asarray(base), jnp.asarray(first), 8, EOT,
                             temperature=0.9, rng_key=jax.random.PRNGKey(4),
                             return_logprobs=True)
    tt, tlp, tn = greedy_generate(tp, DIMS, torch.from_numpy(enc),
                                  torch.tensor(PROMPT),
                                  torch.from_numpy(base),
                                  torch.from_numpy(first), 8, EOT,
                                  temperature=0.9,
                                  generator=torch.Generator().manual_seed(4),
                                  return_logprobs=True)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), rtol=1e-4,
                               atol=1e-4)
    assert (tt.numpy()[:, 0] == only).all()


def test_the_loops_draws_are_the_keys_draws_at_each_step(monkeypatch):
    """T = 0.8: every call of ``gumbel_pick`` in the loop gets the loop's
    key (the caller's seed) and the step it writes, 0 for the first token
    and 1, 2, ... after; the generator itself is not advanced; two runs of
    one seed equal, another seed differs."""
    enc, _, tp = _model(5)
    mask = torch.from_numpy(build_suppress_mask(DIMS.vocab_size, [EOT]))
    seen = []
    real = sampling.gumbel_pick

    def spy(logits, temperature, key, step, row0=0, **kw):
        seen.append((key.clone(), int(step), row0))
        return real(logits, temperature, key, step, row0, **kw)

    monkeypatch.setattr(sampling, "gumbel_pick", spy)

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        state = g.get_state()
        out = greedy_generate(tp, DIMS, torch.from_numpy(enc),
                              torch.tensor(PROMPT), mask, mask, 6, EOT,
                              temperature=0.8, generator=g)
        assert torch.equal(g.get_state(), state)
        return out

    a = run(21)
    assert [s for _, s, _ in seen] == list(range(6))
    assert all(torch.equal(k, _key(21)) and r == 0 for k, _, r in seen)
    assert torch.equal(a, run(21))
    assert not torch.equal(a, run(22))


def test_the_loops_picks_share_the_states_zeroed_workspace(monkeypatch):
    """Every pick of one decode gets the workspace its loop's state carries
    (``LoopState.pick_ws``): one [B, 2] int64 tensor of zeros, made with
    the state, the same at every step; a greedy decode (T = 0) has none."""
    enc, _, tp = _model(5)
    mask = torch.from_numpy(build_suppress_mask(DIMS.vocab_size, [EOT]))
    seen = []
    real = sampling.gumbel_pick

    def spy(logits, temperature, key, step, row0=0, **kw):
        seen.append(kw.get("workspace"))
        return real(logits, temperature, key, step, row0, **kw)

    monkeypatch.setattr(sampling, "gumbel_pick", spy)

    def run(t):
        return greedy_generate(
            tp, DIMS, torch.from_numpy(enc), torch.tensor(PROMPT), mask,
            mask, 6, EOT, temperature=t,
            generator=torch.Generator().manual_seed(3))

    run(0.7)
    assert len(seen) == 6
    ws = seen[0]
    assert ws.dtype == torch.int64 and tuple(ws.shape) == (enc.shape[0], 2)
    assert all(w is ws for w in seen) and not ws.any()
    run(0.0)
    assert len(seen) == 6


@pytest.mark.parametrize("op", [
    lambda x: torch.rand(3),
    lambda x: torch.empty(3).exponential_(),
    lambda x: torch.randn(2, generator=torch.Generator().manual_seed(0)),
    lambda x: torch.multinomial(torch.ones(4), 2),
    lambda x: torch.nn.functional.dropout(x, 0.5, training=True),
])
def test_the_trial_capture_guard_raises_for_a_draw(op):
    x = torch.ones(4)
    with pytest.raises(RuntimeError, match="draws from a torch generator"):
        with generate._NoRandomOps():
            op(x)


def test_the_trial_capture_guard_lets_the_rest_through():
    """The plain pick (Philox in tensor arithmetic, sort, argmax, log) and
    ordinary operations pass the guard with their values unchanged."""
    logits = torch.randn(3, 50, generator=torch.Generator().manual_seed(1))
    args = (logits, torch.full((1,), 0.7), _key(3), _step(2))
    want = sampling.gumbel_pick(*args)
    with generate._NoRandomOps():
        got = sampling.gumbel_pick(*args)
        order = torch.sort(logits, -1).indices
    assert torch.equal(got, want)
    assert torch.equal(order, torch.sort(logits, -1).indices)
