"""The port's variant-quality judge (``variants.diagnose``) against the JAX
package's (CPU).

``teacher_forced_logits`` at x0 fp32 within 1e-5 of the JAX session's (one
prefill of prompt + chain through the session's own encoder); at x5 the
port's field (its B1/B2 plain versions, int8 cross K/V) within the bf16
scale of JAX's.  ``divergence_report`` gives JAX's divergences, margins and
verdicts on the same chains and fields: fields made from a seed
(monkeypatched into both modules), the late-stop case of
tests/test_parity_margins.py:101, and real x0 and x5 sessions judging an x5
chain against x0's.  ``KERNEL_EPS`` is JAX's.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from whisper_tpu.runtime.session import RuntimeCfg as JaxCfg
from whisper_tpu.runtime.session import WhisperSession as JaxSession
from whisper_tpu.variants import diagnose as jdiag
from whisper_tpu.variants.ladder import apply_variant as jax_apply_variant
from whisper_tpu_torch.models import convert
from whisper_tpu_torch.models.registry import WhisperDims
from whisper_tpu_torch.runtime.session import RuntimeCfg, WhisperSession
from whisper_tpu_torch.variants import diagnose
from whisper_tpu_torch.variants.ladder import apply_variant

torch.set_num_threads(2)

DIMS = WhisperDims(n_mels=80, d_model=128, encoder_layers=2, encoder_heads=2,
                   decoder_layers=2, decoder_heads=2, vocab_size=320,
                   max_source_positions=1500, max_target_positions=48)
PROMPT = [250, 252, 253, 254]
EOT = 251


def _astuple(diag):
    return (diag.name, diag.max_dlogit_chain, diag.p99_dlogit_chain,
            diag.median_x0_margin,
            [dataclasses.astuple(d) for d in diag.divergences],
            diag.all_tie_flips)


def test_kernel_eps_is_jaxs():
    assert diagnose.KERNEL_EPS == jdiag.KERNEL_EPS == 0.25


def _sessions(rung, params):
    jcfg, _ = jax_apply_variant(JaxCfg(), rung)
    tcfg, _ = apply_variant(RuntimeCfg(), rung)
    return (JaxSession(params, DIMS, jcfg),
            WhisperSession(params, DIMS, tcfg, device="cpu"))


def _mel(seed):
    return np.random.default_rng(seed).normal(0, 1, (80, 3000)).astype(
        np.float32)


@pytest.mark.parametrize("rung,tol", [("x0", 1e-5), ("x5", 0.1)])
def test_teacher_forced_logits_equal_jax(rung, tol):
    jsess, tsess = _sessions(rung, convert.init_params(DIMS, 1))
    mel = _mel(1)
    toks = PROMPT + np.random.default_rng(1).integers(0, 250, 12).tolist()
    want = jdiag.teacher_forced_logits(jsess, jnp.asarray(mel), toks)
    got = diagnose.teacher_forced_logits(tsess, torch.from_numpy(mel), toks)
    assert got.shape == want.shape == (16, 320) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=tol)


def _fake_fields(seed):
    """teacher_forced_logits stand-ins: a fixed random field per session
    name, the variant's within 0.3 of the reference's."""
    def fields(session, mel, seq):
        rng = np.random.default_rng([seed, len(seq)])
        base = rng.normal(0, 2, (len(seq), 40)).astype(np.float32)
        if session == "var":
            base = base + rng.normal(0, 0.15, base.shape).astype(np.float32)
        return base
    return fields


def _chains(seed):
    """Reference and variant chains per round: the variant follows the
    reference, then departs (or stops early, or runs late) by the seed."""
    rng = np.random.default_rng(seed)
    x0, var = [], []
    for r in range(3):
        c0 = rng.integers(0, 30, int(rng.integers(3, 9))).tolist()
        kind = (seed + r) % 4
        if kind == 0:                       # same chain
            cv = list(c0)
        elif kind == 1:                     # departs at a step
            k = int(rng.integers(0, len(c0)))
            cv = c0[:k] + [int((c0[k] + 1) % 30)] + c0[k + 1:]
        elif kind == 2:                     # stops early (EOT)
            cv = c0[:len(c0) // 2]
        else:                               # keeps going past x0's stop
            cv = c0 + [31, 32]
        x0.append(c0)
        var.append(cv)
    return x0, var


@pytest.mark.parametrize("seed", range(6))
def test_divergence_report_equals_jax_on_fields_from_a_seed(monkeypatch,
                                                           seed):
    fields = _fake_fields(seed)
    monkeypatch.setattr(diagnose, "teacher_forced_logits", fields)
    monkeypatch.setattr(jdiag, "teacher_forced_logits", fields)
    x0, var = _chains(seed)
    args = ("v", "x0", "var", None, None, [0, 1], x0, var)
    got = diagnose.divergence_report(*args, eot_id=39)
    want = jdiag.divergence_report(*args, eot_id=39)
    assert _astuple(got) == _astuple(want)
    assert got.divergences or all(a == b for a, b in zip(x0, var))


def test_late_stop_divergence_detected_as_in_jax(monkeypatch):
    """tests/test_parity_margins.py:101: a variant that keeps decoding past
    the reference's EOT diverges there, and it is drift, not a tie-flip."""
    v, eot = 8, 7

    def fake_logits(session, mel, seq):
        lg = np.full((len(seq), v), -5.0, dtype=np.float32)
        for i in range(len(seq)):
            lg[i, eot if i >= 3 else 3] = 5.0
        return lg + 0.01 if session != "x0" else lg

    monkeypatch.setattr(diagnose, "teacher_forced_logits", fake_logits)
    monkeypatch.setattr(jdiag, "teacher_forced_logits", fake_logits)
    args = ("xv", "x0", "var", None, None, [0, 1], [[3, 3]], [[3, 3, 4, 4]])
    got = diagnose.divergence_report(*args, eot_id=eot)
    assert _astuple(got) == _astuple(jdiag.divergence_report(*args,
                                                             eot_id=eot))
    (d,) = got.divergences
    assert (d.x0_token, d.var_token, d.step, d.tie_flip) == (eot, 4, 2, False)


def test_divergence_report_of_real_sessions_equals_jax():
    """x5's greedy chains judged against x0's, each package with its own
    sessions: the same divergences at the same steps, and the same
    verdicts."""
    params = convert.init_params(DIMS, 2)
    j0, t0 = _sessions("x0", params)
    j5, t5 = _sessions("x5", params)
    mel = _mel(2)
    chains = {}
    for name, sess in (("x0", t0), ("x5", t5)):
        toks = sess.transcribe_from_mel(torch.from_numpy(mel), [0], PROMPT,
                                        10, EOT)[0]
        chains[name] = [[int(t) for t in toks if t != EOT]]
    got = diagnose.divergence_report(
        "x5", t0, t5, torch.from_numpy(mel), torch.from_numpy(mel), PROMPT,
        chains["x0"], chains["x5"], eot_id=EOT)
    want = jdiag.divergence_report(
        "x5", j0, j5, jnp.asarray(mel), jnp.asarray(mel), PROMPT,
        chains["x0"], chains["x5"], eot_id=EOT)
    assert [(d.round_idx, d.step, d.x0_token, d.var_token, d.tie_flip)
            for d in got.divergences] == \
        [(d.round_idx, d.step, d.x0_token, d.var_token, d.tie_flip)
         for d in want.divergences]
    assert abs(got.max_dlogit_chain - want.max_dlogit_chain) < 0.1
    assert abs(got.median_x0_margin - want.median_x0_margin) < 1e-4
