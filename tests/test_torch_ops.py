"""The port's kernel modules (B1-B4) against the JAX package's Pallas kernels.

Each kernel module of ``whisper_tpu_torch.ops`` holds a CUDA kernel and its
plain PyTorch version.  On a CPU tensor the wrapper runs the plain version,
so these tests hold that version against the JAX kernel, run as the JAX
package's own tests run it on the CPU (Pallas in interpret mode), on the
same inputs made from a seed with numpy.  The CUDA kernels themselves are
compared with the plain versions on the card by ``chip_smoke.py``.

Tolerances: bf16 outputs are compared in units of the bf16 spacing
(2^-7 relative).  Both sides compute in fp32 and round to bf16 once or twice
(probabilities, then the output), but they sum in different orders and use
different exp implementations, so a value near a rounding boundary may land
one bf16 step apart, and a probability one step apart moves the output by
about one more.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from whisper_tpu.ops.attention import fused_attention as jax_fused_attention
from whisper_tpu.ops.cross_attention import (
    cross_attend_step_packed,
    pack_cross_kv,
    pack_cross_kv_t,
)
from whisper_tpu.ops.encoder_mlp import fused_encoder_mlp as jax_fused_mlp
from whisper_tpu.ops.self_attention import (
    pack_self_cache,
    self_attend_step_packed,
)
from whisper_tpu_torch.ops import attention as t_attention
from whisper_tpu_torch.ops import cross_attention as t_cross
from whisper_tpu_torch.ops import encoder_mlp as t_mlp
from whisper_tpu_torch.ops import kernels
from whisper_tpu_torch.ops import self_attention as t_self

torch.set_num_threads(2)

BF16_EPS = 2.0 ** -7  # spacing of bf16 values in [1, 2)


def _bf16_pair(x: np.ndarray):
    """The same bf16 values for both packages (both round to nearest even)."""
    x = np.asarray(x, np.float32)
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _assert_bf16_close(got, want, steps: float):
    """|got - want| <= steps bf16 spacings of the larger magnitude, with the
    mean magnitude of ``want`` as the floor near zero."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = np.maximum(np.maximum(np.abs(got), np.abs(want)),
                       np.abs(want).mean())
    err = np.abs(got - want) / (scale * BF16_EPS)
    assert err.max() <= steps, f"max error {err.max():.2f} bf16 steps"


# ---------------------------------------------------------------------------
# B1: encoder attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t", [1500, 200])
def test_b1_plain_matches_jax(t):
    """q pre-scaled, fp32 softmax normalized before the bf16 cast, fp32 PV.
    Tolerance: 2 bf16 steps (see the module docstring)."""
    rng = np.random.default_rng(t)
    b, h, dh = 1, 2, 64
    q, k, v = (rng.normal(0, 1, (b, h, t, dh)).astype(np.float32)
               for _ in range(3))
    q *= dh ** -0.5 * 4.0  # peaked rows, as trained attention has
    (qj, qt), (kj, kt), (vj, vt) = _bf16_pair(q), _bf16_pair(k), _bf16_pair(v)
    want = jax_fused_attention(qj, kj, vj, interpret=True)
    t_attention.launches = 0
    got = t_attention.fused_attention(qt, kt, vt)
    assert got.dtype == torch.bfloat16 and t_attention.launches == 0
    _assert_bf16_close(got, want, steps=2.0)


# ---------------------------------------------------------------------------
# B2: encoder MLP
# ---------------------------------------------------------------------------

def test_b2_plain_matches_jax_ragged_rows():
    """B*T = 74 rows, no multiple of any tile.  LN fp32 -> bf16, FC1 fp32,
    tanh GELU -> bf16, FC2 fp32, residual fp32 -> bf16.  Tolerance: 2 bf16
    steps (a GELU output one step apart moves one output by about one)."""
    rng = np.random.default_rng(7)
    b, t, d, f = 2, 37, 128, 512
    x = rng.normal(0, 1, (b, t, d))
    ln_s = 1.0 + 0.1 * rng.normal(size=d)
    ln_b = 0.1 * rng.normal(size=d)
    w1 = rng.normal(0, 0.05, (d, f))
    b1 = 0.1 * rng.normal(size=f)
    w2 = rng.normal(0, 0.05, (f, d))
    b2 = 0.1 * rng.normal(size=d)
    pairs = [_bf16_pair(a) for a in (x, ln_s, ln_b, w1, b1, w2, b2)]
    want = jax_fused_mlp(*[p[0] for p in pairs], interpret=True)
    t_mlp.launches = 0
    got = t_mlp.fused_encoder_mlp(*[p[1] for p in pairs])
    assert got.shape == (b, t, d) and t_mlp.launches == 0
    _assert_bf16_close(got, want, steps=2.0)


# ---------------------------------------------------------------------------
# B3: decode self-attention with the in-place cache insert
# ---------------------------------------------------------------------------

def _unpack_self(x, s):
    """[L, B, G, S_pad, 128] head-packed -> [L, B, H, S, 64]."""
    y = _np(x)
    l, b, g, sp, _ = y.shape
    y = np.swapaxes(y.reshape(l, b, g, sp, 2, 64), 3, 4)
    return y.reshape(l, b, 2 * g, sp, 64)[:, :, :, :s]


def test_b3_plain_matches_jax_and_updates_cache_in_place():
    """pos mid-cache, nonzero pad_count on some rows.  The updated cache,
    unpacked, must equal JAX's returned cache exactly; ctx within 2 bf16
    steps (each p*v product is rounded to bf16 on both sides; the fp32
    sums run in different orders)."""
    rng = np.random.default_rng(3)
    n_l, b, h, s, dh = 2, 3, 2, 20, 64
    layer, pos = 1, 9
    pads = np.array([0, 3, 0], np.int32)
    kc = rng.normal(0, 1, (n_l, b, h, s, dh))
    vc = rng.normal(0, 1, (n_l, b, h, s, dh))
    q = rng.normal(0, 1, (b, h, dh)) * dh ** -0.5
    kn, vn = rng.normal(0, 1, (b, h, dh)), rng.normal(0, 1, (b, h, dh))
    (kcj, kct), (vcj, vct) = _bf16_pair(kc), _bf16_pair(vc)
    (qj, qt), (knj, knt), (vnj, vnt) = (_bf16_pair(q), _bf16_pair(kn),
                                        _bf16_pair(vn))
    ctx_j, k_out, v_out = self_attend_step_packed(
        qj, knj, vnj, pack_self_cache(kcj), pack_self_cache(vcj),
        jnp.int32(layer), jnp.int32(pos), jnp.asarray(pads), interpret=True)
    t_self.launches = 0
    ctx_t = t_self.self_attend_step(qt, knt, vnt, kct, vct, layer, pos,
                                    torch.from_numpy(pads))
    assert t_self.launches == 0
    np.testing.assert_array_equal(_np(kct), _unpack_self(k_out, s))
    np.testing.assert_array_equal(_np(vct), _unpack_self(v_out, s))
    _assert_bf16_close(ctx_t, ctx_j, steps=2.0)


# ---------------------------------------------------------------------------
# B4: decode cross-attention, int8 x int8
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s_valid", [96, 1500])
def test_b4_plain_matches_jax(s_valid):
    """Quantized q, int32 dots, 7-bit probabilities, int32 PV.  The integer
    parts are exact on both sides; exp and the sum of e may differ in the
    last fp32 bits, which can move one p8 by one step.  Tolerance: 2 bf16
    steps."""
    rng = np.random.default_rng(s_valid)
    n_l, b, h, dh = 2, 2, 2, 64
    layer = 1
    k8 = rng.integers(-127, 128, (n_l, b, h, s_valid, dh), dtype=np.int8)
    v8 = rng.integers(-127, 128, (n_l, b, h, s_valid, dh), dtype=np.int8)
    ks = rng.uniform(0.001, 0.02, (n_l, b, h)).astype(np.float32)
    vs = rng.uniform(0.001, 0.02, (n_l, b, h)).astype(np.float32)
    qj, qt = _bf16_pair(rng.normal(0, 1, (b, h, dh)) * dh ** -0.5)
    want = cross_attend_step_packed(
        qj, pack_cross_kv_t(jnp.asarray(k8)), pack_cross_kv(jnp.asarray(v8)),
        jnp.asarray(ks), jnp.asarray(vs), jnp.int32(layer), s_valid=s_valid,
        int8_mxu=True, interpret=True)
    t_cross.launches = 0
    got = t_cross.cross_attend_step(
        qt, torch.from_numpy(k8), torch.from_numpy(v8), torch.from_numpy(ks),
        torch.from_numpy(vs), layer, s_valid=s_valid)
    assert got.dtype == torch.bfloat16 and t_cross.launches == 0
    _assert_bf16_close(got, want, steps=2.0)


def test_b4_quantize_q_matches_jax_wrapper():
    """Per-head absmax/127 scale, round half to even, clip +-127."""
    rng = np.random.default_rng(11)
    q = rng.normal(0, 1, (3, 4, 64)).astype(np.float32)
    q[0, 0, :4] = [1.5, 2.5, -0.5, 127.0]  # ties against a scale of 1
    q8, qs = t_cross.quantize_q(torch.from_numpy(q))
    absmax = np.max(np.abs(q), axis=-1, keepdims=True)
    scale = np.maximum(absmax, 1e-12) / np.float32(127.0)
    want = np.clip(np.round(q / scale), -127, 127).astype(np.int8)
    np.testing.assert_array_equal(q8.numpy(), want)
    np.testing.assert_array_equal(qs.numpy(), scale[..., 0])


def test_b4_probs_round_ties_to_even():
    """p8 = round(127 * e) rounds exact halves to even, like jnp.round
    (floor(x + 0.5) would round 0.5 -> 1 and 2.5 -> 3)."""
    cands = (np.arange(0, 127, dtype=np.float32) + 0.5) / np.float32(127.0)
    ties = cands[cands * np.float32(127.0) == np.arange(0, 127) + 0.5]
    assert ties.size >= 10
    got = t_cross.quantize_probs(torch.from_numpy(ties)).numpy()
    want = np.asarray(jnp.round(jnp.asarray(ties) * 127.0)).astype(np.int8)
    np.testing.assert_array_equal(got, want)
    assert np.all(got % 2 == 0)


# ---------------------------------------------------------------------------
# The wrappers' routing and the build
# ---------------------------------------------------------------------------

def test_wrappers_refuse_other_devices():
    """Only a CPU tensor takes the plain version; a tensor on any device
    that is neither CPU nor CUDA raises instead of being routed anywhere."""
    q = torch.empty((1, 1, 8, 64), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        t_attention.fused_attention(q, q, q)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """Building the kernels on a machine without nvcc raises; it never
    hands back a plain version."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(kernels, "DEFAULT_NVCC", str(tmp_path / "nvcc"))
    monkeypatch.setattr(kernels, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.library()


def test_source_hash_covers_every_source():
    """The build key changes with any kernel source, so an edited kernel is
    rebuilt; every source file named for the build exists."""
    for name in kernels.HEADERS + kernels.SOURCES:
        assert (kernels.CSRC / name).is_file(), name
    assert sorted(p.name for p in kernels.CSRC.glob("*.cu")) == sorted(
        kernels.SOURCES)
    assert len(kernels.source_hash()) == 16
