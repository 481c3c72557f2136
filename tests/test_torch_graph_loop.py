"""The port's in-place greedy loop (``runtime.generate``: the step function
that a CUDA graph captures on a card) on the CPU, against the JAX package
and against the port's own host-int forms.

- ``decoder_step`` with ``pos`` a one-element int32 tensor is bitwise the
  int form on every route: plain, the kernel step (its plain versions) at
  x4, x5 and x7, the hybrid step, and with a ``pad_count``.
- The loop equals JAX ``greedy_generate`` at x0 fp32 token for token, plain,
  with the timestamp grammar and with left-padded prompts; ``sum_lp`` within
  1e-4 relative, as tests/test_torch_fallback.py holds it.
- ``apply_rules`` with the step as a device tensor equals the host-int form.
- The block-wise early exit (a read once 16 steps, one block behind) gives
  the per-step exit's tokens, scores and counts.
- The ``_async`` entry points read nothing on the host: ``bool``, ``item``,
  ``tolist`` and ``cpu`` raise during the call; after ``gather_tokens`` the
  tokens are the synchronous form's.
- Launches counted while a graph is captured are tallied, not counted.
"""

import dataclasses
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from whisper_tpu.models import convert as jconvert
from whisper_tpu.runtime import timestamps as jts
from whisper_tpu.runtime.generate import greedy_generate as jax_greedy
from whisper_tpu_torch.models import convert
from whisper_tpu_torch.models import whisper
from whisper_tpu_torch.models.registry import WhisperDims
from whisper_tpu_torch.ops import common, sampling
from whisper_tpu_torch.ops.decoder_kernels import (
    build_step_weights,
    decoder_step_hybrid,
)
from whisper_tpu_torch.runtime import generate
from whisper_tpu_torch.runtime import timestamps as ts
from whisper_tpu_torch.runtime.generate import (
    build_suppress_mask,
    greedy_generate,
)
from whisper_tpu_torch.runtime.session import RuntimeCfg, WhisperSession

torch.set_num_threads(2)

DIMS = WhisperDims(n_mels=80, d_model=128, encoder_layers=2, encoder_heads=2,
                   decoder_layers=2, decoder_heads=2, vocab_size=320,
                   max_source_positions=96, max_target_positions=48)
SOT, EOT, LANG, TASK, NO_TS = 250, 251, 252, 253, 254
TSB = 255                       # <|0.00|>: 65 timestamp ids above it
TS_CFG = ts.TimestampCfg(TSB, EOT, NO_TS, max_initial_timestamp_index=10)
PROMPT = [SOT, LANG, TASK, NO_TS]
# [pad slots | a previous-text region | sot, lang, task, notimestamps]
PADDED = [EOT] * 3 + [255, 17, 99, 140, 33, 61, 7] + PROMPT
PADS = [3, 5, 9]


def _model(seed, b=3, dtype=torch.float32, t_enc=96):
    rng = np.random.default_rng(seed)
    enc = rng.normal(0, 1, (b, t_enc, DIMS.d_model)).astype(np.float32)
    jp = jconvert.cast_params(jconvert.init_params(DIMS, seed), jnp.float32)
    tp = convert.params_from_numpy(convert.init_params(DIMS, seed), "cpu",
                                   dtype)
    return enc, jp, tp


# ---------------------------------------------------------------------------
# decoder_step: a device pos is the int pos
# ---------------------------------------------------------------------------

# (route, prefill int8 cross cache, decoder_step keywords, x7 self cache)
STEP_ROUTES = {
    "plain": (False, {}, False),
    "kernel x5": (True, dict(kernel_step=True, int8_mxu=True), False),
    "kernel x4": (True, dict(kernel_step=True, int8_mxu=False), False),
    "kernel x7": (True, dict(kernel_step=True, int8_mxu=True), True),
    "hybrid": (False, None, False),
}


# the hybrid step has no pad mask (greedy_generate refuses the pair)
@pytest.mark.parametrize("route, padded", [
    (r, pads) for r in STEP_ROUTES for pads in (False, True)
    if not (r == "hybrid" and pads)])
def test_decoder_step_with_a_device_pos_is_bitwise_the_int(route, padded):
    """Three steps from one prefill, twice: pos an int, and pos a
    one-element int32 tensor; every step's logits and the whole cache
    bitwise equal.  bf16, as the kernel rungs run."""
    int8, kw, x7 = STEP_ROUTES[route]
    enc, _, tp = _model(0, dtype=torch.bfloat16)
    prompt = PADDED if padded else PROMPT
    p = len(prompt)
    tokens = torch.tensor(prompt)[None].expand(3, -1)
    pads = torch.tensor(PADS, dtype=torch.int32) if padded else None
    mask = None if pads is None else (torch.arange(p)[None] >= pads[:, None])
    _, cache = whisper.decoder_prefill(tp, DIMS, tokens,
                                       torch.from_numpy(enc), p + 4,
                                       int8_cross_kv=int8, prompt_mask=mask)
    if x7:
        cache = whisper.quantize_self_kv(cache)
    sw = build_step_weights(tp, DIMS) if kw is None else None
    caches = [cache._replace(**{f: getattr(cache, f).clone()
                                for f in cache._fields
                                if getattr(cache, f) is not None})
              for _ in range(2)]
    last = torch.tensor([7, 99, 140])
    pos_t = torch.full((1,), p, dtype=torch.int32)
    for i in range(3):
        out = []
        for c, pos in zip(caches, (p + i, pos_t)):
            if sw is not None:
                logits, _ = decoder_step_hybrid(tp, sw, DIMS, last, pos, c)
            else:
                logits, _ = whisper.decoder_step(
                    tp, DIMS, last, pos, c, pad_count=pads,
                    cross_len=enc.shape[1] if int8 else None, **kw)
            out.append(logits)
        assert torch.equal(out[0], out[1]), i
        pos_t += 1
        last = out[0].float().argmax(-1)
    for f in cache._fields:
        a, b = (getattr(c, f) for c in caches)
        assert (a is None) == (b is None)
        assert a is None or torch.equal(a, b), f


def test_the_kernel_step_refuses_per_row_positions():
    enc, _, tp = _model(0, dtype=torch.bfloat16)
    tokens = torch.tensor(PROMPT)[None].expand(3, -1)
    _, cache = whisper.decoder_prefill(tp, DIMS, tokens,
                                       torch.from_numpy(enc), 8,
                                       int8_cross_kv=True)
    with pytest.raises(ValueError, match="one position for all rows"):
        whisper.decoder_step(tp, DIMS, torch.tensor([1, 2, 3]),
                             torch.tensor([4, 4, 4]), cache,
                             kernel_step=True, cross_len=enc.shape[1])


# ---------------------------------------------------------------------------
# the loop against JAX at x0 fp32
# ---------------------------------------------------------------------------

LOOP_CASES = {
    "plain": (PROMPT, None, None),
    "grammar": (PROMPT[:3], TS_CFG, None),
    "pads": (PADDED, None, PADS),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", list(LOOP_CASES))
def test_in_place_loop_equals_jax_at_x0(case, seed):
    """Tokens token for token, n_tok equal, sum_lp within 1e-4 relative."""
    prompt, ts_cfg, pads = LOOP_CASES[case]
    enc, jp, tp = _model(seed)
    base = build_suppress_mask(DIMS.vocab_size, [8, 300])
    first = build_suppress_mask(DIMS.vocab_size, [8, 300, EOT])
    jt, jlp, jn = jax_greedy(
        jp, DIMS, jnp.asarray(enc), jnp.asarray(prompt, jnp.int32),
        jnp.asarray(base), jnp.asarray(first), 12, EOT,
        ts_cfg=None if ts_cfg is None else jts.TimestampCfg(*ts_cfg),
        pad_count=None if pads is None else jnp.asarray(pads, jnp.int32),
        return_logprobs=True)
    toks, sum_lp, n_tok = greedy_generate(
        tp, DIMS, torch.from_numpy(enc), torch.tensor(prompt),
        torch.from_numpy(base), torch.from_numpy(first), 12, EOT,
        ts_cfg=ts_cfg,
        pad_count=None if pads is None else torch.tensor(pads,
                                                         dtype=torch.int32),
        return_logprobs=True)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(n_tok.numpy(), np.asarray(jn))
    np.testing.assert_allclose(sum_lp.numpy(), np.asarray(jlp), rtol=1e-4,
                               atol=0)


# ---------------------------------------------------------------------------
# the grammar's step on the device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 1, 2, 5])
def test_apply_rules_with_a_device_step_equals_the_host_step(step):
    """Random logits and histories of ``step`` tokens (text, timestamps and
    EOT mixed): the same masked logits, bitwise."""
    rng = np.random.default_rng(step)
    b, v = 6, DIMS.vocab_size
    logits = torch.from_numpy(rng.normal(0, 3, (b, v)).astype(np.float32))
    state = ts.init_state(b, EOT)
    for _ in range(step):
        col = rng.choice([rng.integers(0, EOT), rng.integers(TSB, v)], b)
        state = ts.update_state(state, torch.from_numpy(col), TS_CFG)
    want = ts.apply_rules(logits, state, step, TS_CFG)
    got = ts.apply_rules(logits, state,
                         torch.full((1,), step, dtype=torch.long), TS_CFG)
    assert torch.equal(got, want)


def test_update_state_in_place_equals_update_state():
    state = ts.init_state(3, EOT)
    for col in ([TSB + 2, 7, EOT], [TSB + 5, TSB + 1, EOT], [9, 7, EOT]):
        tok = torch.tensor(col)
        want = ts.update_state(ts.TimestampState(*(t.clone() for t in state)),
                               tok, TS_CFG)
        ts.update_state_(state, tok, TS_CFG)
        assert all(torch.equal(a, b) for a, b in zip(state, want))


# ---------------------------------------------------------------------------
# the block-wise early exit
# ---------------------------------------------------------------------------

def _ending_eot(tp, enc, base):
    """An id every row generates within its first 12 steps (so every row
    ends before step 16 when it is EOT), or None."""
    toks = greedy_generate(tp, DIMS, torch.from_numpy(enc),
                           torch.tensor(PROMPT), base, base, 13, 319)
    common_ids = set.intersection(*(set(r[1:13].tolist()) for r in toks))
    return min(common_ids) if common_ids else None


@pytest.mark.parametrize("ends", ["all before step 16", "none"])
def test_block_exit_equals_the_per_step_exit(ends, monkeypatch):
    """Tokens, sum_lp and n_tok of blocks of 16 (read one block behind)
    equal the per-step exit's and those of a loop that never reads; the
    steps run: the per-step exit stops at the last row's end, the blocks
    within two blocks of it, the loop without reads at max_new_tokens."""
    base = torch.zeros(DIMS.vocab_size)
    if ends == "none":
        enc, _, tp = _model(5, b=4)
        eot = 319
        base[eot] = float("-inf")
    else:
        # rows 0-1 and 2-3 share their encoder states: two chains
        for seed in range(5, 40):
            enc, _, tp = _model(seed, b=2)
            enc = np.concatenate([enc[:1], enc[:1], enc[1:], enc[1:]])
            eot = _ending_eot(tp, enc, base)
            if eot is not None:
                break
        assert eot is not None
    steps = []
    step_fn = generate._step_fn

    def counting(*a, **kw):
        step = step_fn(*a, **kw)

        def run():
            steps.append(1)
            step()
        return run

    drive = generate._drive
    monkeypatch.setattr(generate, "_step_fn", counting)
    runs = {}
    for name, block, kw in (("per step", None, {}),
                            ("blocks of 16", 16, {}),
                            ("no read", None, dict(early_exit=False))):
        # the CPU reads done once a step; the card's blocks, forced here
        monkeypatch.setattr(
            generate, "_drive",
            lambda step, first, n, done, every, block=block: drive(
                step, first, n, done, block if every and block else every))
        steps.clear()
        runs[name] = (greedy_generate(
            tp, DIMS, torch.from_numpy(enc), torch.tensor(PROMPT), base,
            base, 40, eot, return_logprobs=True, **kw), len(steps))
    (want, n_want) = runs["per step"]
    for name, (got, n) in runs.items():
        assert all(torch.equal(a, b) for a, b in zip(got, want)), name
    toks = want[0]
    if ends == "none":
        assert not (toks == eot).any()
        assert n_want == runs["blocks of 16"][1] == 39
    else:
        last_end = max(int((row == eot).nonzero()[0]) for row in toks)
        assert last_end < 16
        assert n_want == last_end
        assert last_end < runs["blocks of 16"][1] <= 32
    assert runs["no read"][1] == 39


# ---------------------------------------------------------------------------
# the _async entry points read nothing on the host
# ---------------------------------------------------------------------------

LONG = dataclasses.replace(DIMS, max_source_positions=1500)


def _session():
    cfg = RuntimeCfg(dtype="float32", max_batch=4)
    return WhisperSession(convert.init_params(LONG, 3), LONG, cfg,
                          device="cpu")


@pytest.fixture
def no_host_reads(monkeypatch):
    """Within ``with no_host_reads():`` a tensor's bool, item, tolist and
    cpu raise."""
    import contextlib

    def refuse(*_a, **_k):
        raise AssertionError("a host read inside an _async call")

    @contextlib.contextmanager
    def guard():
        with monkeypatch.context() as m:
            for name in ("__bool__", "item", "tolist", "cpu"):
                m.setattr(torch.Tensor, name, refuse)
            yield
    return guard


@pytest.mark.parametrize("entry", ["transcribe_from_mel_async",
                                   "transcribe_short_batch_async"])
def test_async_forms_make_no_host_read(entry, no_host_reads):
    sess = _session()
    rng = np.random.default_rng(0)
    if entry == "transcribe_from_mel_async":
        mel = torch.from_numpy(rng.normal(0, 1, (80, 7000))
                               .astype(np.float32))
        starts = [0, 2500, 5000]
        args = (mel, starts, PROMPT, 10, EOT, [8], [EOT])
        with no_host_reads():
            pieces = sess.transcribe_from_mel_async(*args)
        got = sess.gather_tokens(pieces, len(starts), 10)
        want = sess.transcribe_from_mel(*args)
        # the guard catches the synchronous form's reads of done
        with no_host_reads(), pytest.raises(AssertionError, match="host"):
            sess.transcribe_from_mel(*args)
    else:
        audio = rng.normal(0, 0.1, (3, 480_400)).astype(np.float32)
        n_valid = np.asarray([3000, 1200, 400], np.int32)
        args = (audio, n_valid, PROMPT, 10, EOT, [8], [EOT])
        with no_host_reads():
            toks = sess.transcribe_short_batch_async(*args)
        got = toks.cpu().numpy().astype(np.int32)
        want = sess.transcribe_short_batch(*args)
        with no_host_reads(), pytest.raises(AssertionError, match="host"):
            sess.transcribe_short_batch(*args)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# launch counts during a capture
# ---------------------------------------------------------------------------

def test_launches_in_a_capture_are_tallied_and_added_once_a_replay():
    mod = sys.modules[__name__]
    mod.test_launches = 0
    common.count_launch(mod, test_launches=1)
    with common.tally_launches() as tally:
        common.count_launch(mod, test_launches=1)
        common.count_launch(mod, test_launches=True)
    assert mod.test_launches == 1
    assert tally == {(mod, "test_launches"): 2}
    for _ in range(3):
        common.add_launches(tally)
    assert mod.test_launches == 7
    common.count_launch(mod, test_launches=False)
    assert mod.test_launches == 7


# ---------------------------------------------------------------------------
# what a key holds: one sampled graph for every T, state within a budget
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t", [0.2, 0.4, 0.6, 0.8, 1.0])
def test_pick_with_a_tensor_temperature_is_bitwise_the_float(t):
    """The loop's step divides by T held in a one-element tensor (so every
    T > 0 shares one graph) and draws at the step held in a tensor; on the
    CPU that is the float and int form's draw."""
    logits = torch.from_numpy(np.random.default_rng(int(t * 10)).normal(
        0, 3, (6, DIMS.vocab_size)).astype(np.float32))
    logits[:, ::7] = float("-inf")
    key = sampling.generator_key(torch.Generator().manual_seed(5), "cpu")
    got = generate.pick(logits, torch.full((1,), t), key,
                        torch.full((1,), 3), True)
    want = generate.pick(logits, t, key, 3, True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _key(i):
    return generate.GraphKey(1, 4 + i, 8, 1500, True, True, False, True,
                             False, None, False, False, False, EOT)


def test_decode_graphs_keep_their_state_within_the_budget(monkeypatch):
    """After a run that passes the budget the least recently used other
    loops are released (graph and state dropped) until the rest fit; the
    loop just run stays even alone over the budget."""
    monkeypatch.setattr(generate, "_budget", lambda device: 100)
    params = {"decoder": {}}
    graphs = generate.DecodeGraphs(params)
    cpu = torch.device("cpu")
    loops = []
    for i in range(3):
        loops.append(graphs.loop(params, None, _key(i), cpu))
        loops[-1].nbytes, loops[-1].graph = 40, object()
        graphs.trim(_key(i))
    # key 0 dropped at the third run; key 1 made recent again
    assert list(graphs.captures()) == [_key(1), _key(2)]
    assert loops[0].graph is None and loops[0].nbytes == 0
    assert graphs.loop(params, None, _key(1), cpu) is loops[1]
    big = graphs.loop(params, None, _key(3), cpu)
    big.nbytes, big.graph = 150, object()
    graphs.trim(_key(3))
    assert list(graphs.captures()) == [_key(3)]
    assert graphs.nbytes() == 150


def test_decode_graphs_refuse_other_weights():
    """A DecodeGraphs holds the weights it was made for: others (a
    different tree, or other hybrid-step weights) raise."""
    params, sw = {"decoder": {}}, object()
    graphs = generate.DecodeGraphs(params, sw)
    cpu = torch.device("cpu")
    assert graphs.loop(params, sw, _key(0), cpu) is graphs.loop(
        params, None, _key(0), cpu)
    with pytest.raises(ValueError, match="other weights"):
        graphs.loop({"decoder": {}}, None, _key(0), cpu)
    with pytest.raises(ValueError, match="other weights"):
        graphs.loop(params, object(), _key(0), cpu)
