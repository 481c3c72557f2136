"""The port's kernel modules (B1-B6) against the JAX package's Pallas kernels.

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
from whisper_tpu.ops.encoder_mlp import chunk_plan
from whisper_tpu.ops.encoder_mlp import fused_encoder_mlp as jax_fused_mlp
from whisper_tpu.ops.pallas_mel import log_mel_pallas
from whisper_tpu.ops.self_attention import (
    pack_self_cache,
    self_attend_step_packed,
)
from whisper_tpu_torch.ops import attention as t_attention
from whisper_tpu_torch.ops import cross_attention as t_cross
from whisper_tpu_torch.ops import encoder_mlp as t_mlp
from whisper_tpu_torch.frontend import golden
from whisper_tpu_torch.ops import kernels
from whisper_tpu_torch.ops import log_mel as t_mel
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


@pytest.mark.parametrize("t", [100, 65])
def test_b1_plain_matches_jax_ragged_lengths(t):
    """T no multiple of 16, 64 or 128: the lengths at which the card's kernel
    masks a partly filled key tile and a partly filled depth step of P.V.
    The rows are less peaked than above.  Tolerance: 1 bf16 step."""
    rng = np.random.default_rng(t)
    b, h, dh = 2, 3, 64
    q, k, v = (rng.normal(0, 1, (b, h, t, dh)).astype(np.float32)
               for _ in range(3))
    q *= dh ** -0.5
    (qj, qt), (kj, kt), (vj, vt) = _bf16_pair(q), _bf16_pair(k), _bf16_pair(v)
    want = jax_fused_attention(qj, kj, vj, interpret=True)
    got = t_attention.fused_attention_plain(qt, kt, vt)
    assert got.shape == (b, h, t, dh) and got.dtype == torch.bfloat16
    _assert_bf16_close(got, want, steps=1.0)


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


@pytest.mark.parametrize("rows", [127, 128, 129])
def test_b2_plain_matches_jax_around_the_row_tile(rows):
    """Row counts that straddle the 128-row tile of the card's products: one
    row short of a tile, a whole tile, one row into the next.  Tolerance: 2
    bf16 steps, as above."""
    rng = np.random.default_rng(rows)
    d, f = 128, 256
    arrays = (rng.normal(0, 1, (1, rows, d)), 1.0 + 0.1 * rng.normal(size=d),
              0.1 * rng.normal(size=d), rng.normal(0, 0.05, (d, f)),
              0.1 * rng.normal(size=f), rng.normal(0, 0.05, (f, d)),
              0.1 * rng.normal(size=d))
    pairs = [_bf16_pair(a) for a in arrays]
    want = jax_fused_mlp(*[p[0] for p in pairs], interpret=True)
    got = t_mlp.fused_encoder_mlp_plain(*[p[1] for p in pairs])
    assert got.shape == (1, rows, d) and got.dtype == torch.bfloat16
    _assert_bf16_close(got, want, steps=2.0)


def test_b2_plain_matches_jax_chunked_kernel_at_medium_width():
    """whisper-medium's d=1024, f=4096, which the JAX package runs through
    its FFN-chunked kernel (``_fused_mlp_chunked``, f_block from
    ``chunk_plan``; B2c).  The port's one kernel and plain version take
    every width.  Tolerance: 2 bf16 steps, as above."""
    rng = np.random.default_rng(12)
    b, t, d, f = 1, 40, 1024, 4096
    blk = chunk_plan(d, f, jnp.bfloat16)
    assert blk is not None and blk < f
    x = rng.normal(0, 1, (b, t, d))
    ln_s = 1.0 + 0.1 * rng.normal(size=d)
    ln_b = 0.1 * rng.normal(size=d)
    w1 = rng.normal(0, 0.03, (d, f))
    b1 = 0.1 * rng.normal(size=f)
    w2 = rng.normal(0, 0.02, (f, d))
    b2 = 0.1 * rng.normal(size=d)
    pairs = [_bf16_pair(a) for a in (x, ln_s, ln_b, w1, b1, w2, b2)]
    want = jax_fused_mlp(*[p[0] for p in pairs], interpret=True, f_block=blk)
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


@pytest.mark.parametrize("pos,pads", [(0, [0, 0, 0]), (9, [0, 3, 9]),
                                      (19, [18, 0, 5])])
def test_b3_pos_as_tensor_matches_int_and_jax(pos, pads):
    """``pos`` as a one-element int32 tensor (what the card's kernel reads
    from device memory) at the first row, mid-cache and the last row, with
    mixed ``pad_count``: the plain version and the wrapper on CPU tensors
    give the int form's output and caches bitwise, and the JAX kernel's
    within 1 bf16 step (rows less peaked than a trained model's; both sides
    round each p*v product to bf16)."""
    rng = np.random.default_rng(100 + pos)
    n_l, b, h, s, dh = 2, 3, 2, 20, 64
    layer = 1
    pads = np.array(pads, np.int32)
    kc = rng.normal(0, 1, (n_l, b, h, s, dh))
    vc = rng.normal(0, 1, (n_l, b, h, s, dh))
    (kcj, kct), (vcj, vct) = _bf16_pair(kc), _bf16_pair(vc)
    (qj, qt), (knj, knt), (vnj, vnt) = (
        _bf16_pair(rng.normal(0, 1, (b, h, dh)) * dh ** -0.5),
        _bf16_pair(rng.normal(0, 1, (b, h, dh))),
        _bf16_pair(rng.normal(0, 1, (b, h, dh))))
    ctx_j, k_out, v_out = self_attend_step_packed(
        qj, knj, vnj, pack_self_cache(kcj), pack_self_cache(vcj),
        jnp.int32(layer), jnp.int32(pos), jnp.asarray(pads), interpret=True)
    pad_t = torch.from_numpy(pads)
    pos_t = torch.tensor([pos], dtype=torch.int32)
    outs = []
    for fn, p in ((t_self.self_attend_step_plain, pos),
                  (t_self.self_attend_step_plain, pos_t),
                  (t_self.self_attend_step, pos_t)):
        k_, v_ = kct.clone(), vct.clone()
        outs.append((fn(qt, knt, vnt, k_, v_, layer, p, pad_t), k_, v_))
    for ctx, k_, v_ in outs[1:]:
        assert torch.equal(ctx, outs[0][0])
        assert torch.equal(k_, outs[0][1]) and torch.equal(v_, outs[0][2])
    np.testing.assert_array_equal(_np(outs[0][1]), _unpack_self(k_out, s))
    np.testing.assert_array_equal(_np(outs[0][2]), _unpack_self(v_out, s))
    _assert_bf16_close(outs[0][0], ctx_j, steps=1.0)


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


@pytest.mark.parametrize("h,s,s_valid", [(2, 200, 193), (6, 200, 200),
                                         (6, 96, 90)])
def test_b4_plain_matches_jax_masked_tail_and_six_heads(h, s, s_valid):
    """What the card's split kernel leans on: columns [s_valid, S) masked
    (their e exactly 0) with S no multiple of its 192-row segments, and six
    heads (whisper-tiny as a draft).  Tolerance: 2 bf16 steps, as above."""
    rng = np.random.default_rng(1000 * h + s_valid)
    n_l, b, dh = 2, 2, 64
    layer = 1
    k8 = rng.integers(-127, 128, (n_l, b, h, s, dh), dtype=np.int8)
    v8 = rng.integers(-127, 128, (n_l, b, h, s, dh), dtype=np.int8)
    ks = rng.uniform(0.001, 0.02, (n_l, b, h)).astype(np.float32)
    vs = rng.uniform(0.001, 0.02, (n_l, b, h)).astype(np.float32)
    qj, qt = _bf16_pair(rng.normal(0, 1, (b, h, dh)) * dh ** -0.5)
    want = cross_attend_step_packed(
        qj, pack_cross_kv_t(jnp.asarray(k8)), pack_cross_kv(jnp.asarray(v8)),
        jnp.asarray(ks), jnp.asarray(vs), jnp.int32(layer), s_valid=s_valid,
        int8_mxu=True, interpret=True)
    got = t_cross.cross_attend_step_plain(
        qt, torch.from_numpy(k8), torch.from_numpy(v8), torch.from_numpy(ks),
        torch.from_numpy(vs), layer, s_valid=s_valid)
    assert got.shape == (b, h, dh)
    _assert_bf16_close(got, want, steps=2.0)
    # the masked rows do not reach the output
    k8[:, :, :, s_valid:] = 127
    v8[:, :, :, s_valid:] = -127
    again = t_cross.cross_attend_step_plain(
        qt, torch.from_numpy(k8), torch.from_numpy(v8), torch.from_numpy(ks),
        torch.from_numpy(vs), layer, s_valid=s_valid)
    assert torch.equal(got, again)


def test_b4_quantize_q_divides_as_the_jax_wrapper():
    """``quantize_q`` takes its scale through ``div127`` (a true fp32
    division): q8 and the scales equal the JAX wrapper's arithmetic
    (``jnp.maximum(absmax, 1e-12) / 127.0``, ``jnp.round(q / scale)``) on
    8,192 heads of bf16 values, ties included."""
    rng = np.random.default_rng(5)
    q = rng.normal(0, 1, (1024, 8, 64)).astype(np.float32)
    q[:, 0, :3] = [2.5, -3.5, 127.0]          # ties against a scale of 1
    qj, qt = _bf16_pair(q)
    q8, qs = t_cross.quantize_q(qt)
    q32 = qj.astype(jnp.float32)
    scale = jnp.maximum(jnp.max(jnp.abs(q32), axis=-1, keepdims=True),
                        1e-12) / 127.0
    want = jnp.clip(jnp.round(q32 / scale), -127, 127).astype(jnp.int8)
    np.testing.assert_array_equal(q8.numpy(), np.asarray(want))
    np.testing.assert_array_equal(qs.numpy(), np.asarray(scale[..., 0]))
    assert q8[0, 0, 0] == 2 and q8[0, 0, 1] == -4


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
# B6: decode cross-attention, int8 cache dequantized in the kernel (x4)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,s_valid", [
    pytest.param(1500, 1500, id="1500"), pytest.param(1500, 1001, id="1001"),
    (192, 192), (193, 193), (2000, 384), (2000, 1999)])
def test_b6_plain_matches_jax(s, s_valid):
    """fp32 scores times k_scale, fp32 softmax normalized before the bf16
    cast, bf16 p * bf16(V8) products summed in fp32, times v_scale; a
    1500-row cache, all valid or masked from row 1001, and the edges of the
    card's 192-row segments: exactly one, one row more, eleven masked at a
    segment boundary (384) and inside the last segment (1,999).  Tolerance:
    2 bf16 steps.  The port rounds each product to bf16, as the JAX kernel is
    written (``(pm * v).astype(f32)`` on bf16 operands); XLA on the CPU
    keeps those products in fp32 (``xla_allow_excess_precision``), and
    1,500 rounded products move the sum by up to ~1.5 bf16 steps of the
    output.  With XLA_FLAGS=--xla_allow_excess_precision=false the JAX
    kernel in interpret mode and this plain version agree bitwise on
    these inputs."""
    rng = np.random.default_rng(s_valid if s == 1500 else s + s_valid)
    n_l, b, h, dh = 2, 2, 4, 64
    layer = 1
    k8 = rng.integers(-127, 128, (n_l, b, h, s, dh), dtype=np.int8)
    v8 = rng.integers(-127, 128, (n_l, b, h, s, dh), dtype=np.int8)
    ks = rng.uniform(0.001, 0.02, (n_l, b, h)).astype(np.float32)
    vs = rng.uniform(0.001, 0.02, (n_l, b, h)).astype(np.float32)
    qj, qt = _bf16_pair(rng.normal(0, 1, (b, h, dh)) * dh ** -0.5)
    want = cross_attend_step_packed(
        qj, pack_cross_kv(jnp.asarray(k8)), pack_cross_kv(jnp.asarray(v8)),
        jnp.asarray(ks), jnp.asarray(vs), jnp.int32(layer), s_valid=s_valid,
        int8_mxu=False, interpret=True)
    t_cross.dequant_launches = 0
    got = t_cross.cross_attend_step_dequant(
        qt, torch.from_numpy(k8), torch.from_numpy(v8), torch.from_numpy(ks),
        torch.from_numpy(vs), layer, s_valid=s_valid)
    assert got.dtype == torch.bfloat16 and t_cross.dequant_launches == 0
    _assert_bf16_close(got, want, steps=2.0)


# ---------------------------------------------------------------------------
# B5: the one-shot log-mel front end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seconds,n_mels,wire,extra", [
    (3.71, 80, "int16", 13),     # 371 frames: one full 256-frame block + tail
    (2.003, 128, "float32", 0),  # large-v3's 128 mels, float32 upload
    (0.05, 80, "float32", 250),  # 5 frames, most of the capacity past the end
])
def test_b5_plain_matches_jax(seconds, n_mels, wire, extra):
    """Reflect-padded audio of a ragged length (and frame capacity past the
    valid frames, which read zeros and are zeroed), int16 PCM or float32,
    80 or 128 mels, against ``log_mel_pallas`` in interpret mode.
    Tolerance 1e-4 on the normalized mel: the fp32 DFT sums run in another
    order on each side, and a quiet bin, whose power comes out of
    cancelling terms, keeps few correct digits through log10.  The JAX
    package's own two front ends (``log_mel_jax`` and ``log_mel_pallas``)
    differ by up to 4.5e-5 on such clips, this version from the Pallas one
    by up to 6.9e-5 (128 mels, float32); the ROADMAP bound against the
    golden mel is 2e-4."""
    rng = np.random.default_rng(int(seconds * 1000))
    n = int(seconds * 16000)
    t = np.arange(n) / 16000.0
    audio = (0.3 * np.sin(2 * np.pi * 440 * t)
             + 0.05 * rng.standard_normal(n)).astype(np.float32)
    padded = golden.reflect_pad(audio)
    if wire == "int16":
        padded = np.round(np.clip(padded, -1, 1) * 32767.0).astype(np.int16)
    nv = golden.num_frames(n)
    n_frames = nv + extra
    want = np.asarray(log_mel_pallas(jnp.asarray(padded), jnp.int32(nv),
                                     n_mels=n_mels, n_frames=n_frames,
                                     interpret=True))
    t_mel.launches = 0
    got = t_mel.log_mel(torch.from_numpy(padded), nv, n_mels=n_mels,
                        n_frames=n_frames).numpy()
    assert got.shape == want.shape == (n_mels, n_frames)
    assert t_mel.launches == 0
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert np.all(got[:, nv:] == 0.0)


def test_b5_twiddles_are_fp64_cos_sin_rounded_once():
    """The FFT's one twiddle table holds cos and sin of 2 pi k / 400 for
    k = 0..399, each computed in float64 and rounded to float32 once (the
    radix-8 and radix-5 constants are its entries 50, 80 and 160); the
    window is the plain version's Hann window; the device tables are these
    and ``mel_bands``'s."""
    tw, win = t_mel.fft_tables()
    assert tw.dtype == np.float32 and tw.shape == (400, 2)
    ang = 2.0 * np.pi * np.arange(400) / 400.0
    np.testing.assert_array_equal(tw[:, 0], np.cos(ang).astype(np.float32))
    np.testing.assert_array_equal(tw[:, 1], np.sin(ang).astype(np.float32))
    assert tw[50, 0] == np.float32(np.cos(np.pi / 4))
    np.testing.assert_array_equal(win, golden.hann_window_periodic(400))
    on_device = t_mel._device_tables(torch.device("cpu"), 80)
    for got, want in zip(on_device, (tw, win) + t_mel.mel_bands(80)):
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_b5_mel_bands_cover_every_nonzero_and_sum_as_the_dense(n_mels):
    """Each filter's band (first bin, count) holds every nonzero weight of
    its row of ``fb_t`` and only those; the banded sum of a power spectrum,
    in increasing k, equals the dense sum over all 201 bins in the same
    order bit for bit (an exact 0 weight adds +0 to a non-negative sum)."""
    fb_t = t_mel._constants(n_mels)[2]                   # [201, n_mels]
    bands, weights = t_mel.mel_bands(n_mels)
    assert bands.shape == (n_mels, 3) and weights.dtype == np.float32
    assert weights.size == np.count_nonzero(fb_t)
    rebuilt = np.zeros_like(fb_t)
    for m, (first, count, off) in enumerate(bands):
        rebuilt[first:first + count, m] = weights[off:off + count]
        assert np.all(fb_t[first:first + count, m] != 0)
    np.testing.assert_array_equal(rebuilt, fb_t)
    rng = np.random.default_rng(n_mels)
    power = (rng.standard_normal((64, 201)) ** 2
             * 10.0 ** rng.uniform(-6, 3, (64, 1))).astype(np.float32)
    dense = np.zeros((64, n_mels), np.float32)
    for k in range(201):
        dense = dense + power[:, k:k + 1] * fb_t[k][None, :]
    banded = np.zeros((64, n_mels), np.float32)
    for m, (first, count, off) in enumerate(bands):
        for i in range(count):
            banded[:, m] = (banded[:, m]
                            + power[:, first + i] * weights[off + i])
    np.testing.assert_array_equal(banded, dense)


def test_b5_kernel_entry_refuses_cpu_tensors():
    """The raw kernel entry launches or raises; a CPU tensor goes through
    ``log_mel``, which routes it to the plain version."""
    with pytest.raises(ValueError, match="CUDA kernel"):
        t_mel.log_spec(torch.zeros(1000), 80, 3)


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


def test_every_csrc_file_is_named_for_the_build():
    """Every file under csrc/ is a source or a header of the build, so that
    ``source_hash`` sees it: a header left out would be edited without a
    rebuild."""
    named = sorted(kernels.HEADERS + kernels.SOURCES)
    assert len(set(named)) == len(named)
    assert sorted(p.name for p in kernels.CSRC.iterdir()) == named
    assert set(kernels.SIGNATURES) >= {"wt_fused_encoder_mlp",
                                       "wt_self_attend_step",
                                       "wt_launch_floor"}


@pytest.mark.parametrize("kernel,source", [
    ("B1", "attention.cu"), ("B4", "cross_attention.cu"),
    ("B2", "encoder_mlp.cu"), ("B3", "self_attention.cu"),
    ("B6", "cross_attention_dequant.cu"),
    ("B7-dq", "cross_attention_multi.cu"),
    ("B7-i8", "cross_attention_multi.cu"), ("B10c", "decoder_mlp.cu"),
    ("B10a", "decoder_self_block.cu"), ("B10b", "decoder_cross_block.cu"),
    ("B9a", "encoder_block.cu"), ("B9b", "encoder_block.cu"),
    ("B8", "self_attention_int8.cu"), ("B5", "log_mel.cu"),
    ("pick", "gumbel_pick.cu")])
def test_kernel_variants_cut_the_sources_as_they_are(kernel, source):
    """``kernel_variants`` makes its timed variants by replacing text of the
    CUDA sources; every replacement must still find its text, and each
    variant must differ from the others."""
    from whisper_tpu_torch import kernel_variants as kv

    cut, names = {"B1": (kv.b1_source, kv.B1_VARIANTS),
                  "B4": (kv.b4_source, kv.B4_VARIANTS),
                  "B2": (kv.b2_source, kv.B2_VARIANTS),
                  "B3": (kv.b3_source, kv.B3_VARIANTS),
                  "B6": (kv.dq_source, kv.DQ_VARIANTS),
                  "B7-dq": (kv.dq_source, kv.DQ_VARIANTS),
                  "B7-i8": (kv.i8_source, kv.I8_VARIANTS),
                  "B10c": (kv.b10c_source, kv.B10C_VARIANTS),
                  "B10a": (kv.b10_source, kv.B10_VARIANTS),
                  "B10b": (kv.b10_source, kv.B10_VARIANTS),
                  "B9a": (kv.b9_source, kv.B9_VARIANTS),
                  "B9b": (kv.b9_source, kv.B9_VARIANTS),
                  "B8": (kv.b8_source, kv.B8_VARIANTS),
                  "B5": (kv.b5_source, kv.B5_VARIANTS),
                  "pick": (kv.pick_source, kv.PICK_VARIANTS)}[kernel]
    text = (kernels.CSRC / source).read_text()
    variants = {name: cut(text, name) for name in names}
    assert variants["as_built"].count("WT_EXPORT") == text.count("WT_EXPORT")
    assert len(set(variants.values())) == len(names)


def test_profile_ladder_reads_the_x4_kernels():
    """``profile_ladder`` runs x4 greedy and x4 decoded speculatively, and
    names the kernels of those runs (B6, B7-dq) from the device's names."""
    from whisper_tpu_torch import profile_ladder as pl

    assert ("x4", "x4", {}) in pl.CONFIGS
    assert [v for _, v in pl.SPECULATIVE] == ["x5", "x4"]
    names = {"B6": "(anonymous namespace)::cross_dequant_kernel("
                   "__nv_bfloat16 const*, float const*)",
             "B7-dq": "(anonymous namespace)::cross_multi_dequant_kernel("
                      "__nv_bfloat16 const*)",
             "B7-i8": "(anonymous namespace)::cross_multi_int8_kernel("
                      "__nv_bfloat16 const*, float const*)",
             "B4": "(anonymous namespace)::cross_step_kernel(int)",
             "B10c (FC1)": "(anonymous namespace)::fc1_kernel("
                           "__nv_bfloat16 const*)",
             "B10c (FC2)": "(anonymous namespace)::fc2_kernel("
                           "__nv_bfloat16 const*)"}
    for label, name in names.items():
        assert pl._kernel_of(name) == label, name
    # the names it looks for are the kernels' names in the sources
    for fn, src in (
            ("cross_dequant_kernel", "cross_attention_dequant.cu"),
            ("cross_multi_dequant_kernel", "cross_attention_multi.cu"),
            ("cross_multi_int8_kernel", "cross_attention_multi.cu"),
            ("fc1_kernel", "decoder_mlp.cu"), ("fc2_kernel", "decoder_mlp.cu"),
            ("self_attn_kernel", "decoder_self_block.cu"),
            ("cross_attn_kernel", "decoder_cross_block.cu"),
            ("ln_gemm_kernel", "decoder_block.cuh"),
            ("out_proj_kernel", "decoder_block.cuh")):
        assert f"\n{fn}(" in (kernels.CSRC / src).read_text()
        assert fn in pl.KERNELS


def test_profile_ladder_tells_b9_from_b2():
    """B9a and B9b run B2's pieces (a LayerNorm kernel a warp a row, the
    gemm_sm90.cuh product) under names of their own, so that a trace of a
    run with the fused encoder block, where whisper-medium runs B9a and B2
    side by side, gives each its own time; a call of B9a or B9b is read as
    the span of its kernels."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    from whisper_tpu_torch import profile_ladder as pl

    gemm = ("void gemm::gemm_kernel<{}, (anonymous namespace)::{}>("
            "CUtensorMap, CUtensorMap, int, int, int, int, "
            "(anonymous namespace)::{})")
    ln = ("void (anonymous namespace)::{}<{}>({} const*, __nv_bfloat16 "
          "const*, __nv_bfloat16 const*, __nv_bfloat16*, int)")
    names = {"B2 (LayerNorm)": ln.format("mlp_ln_kernel", 512,
                                         "__nv_bfloat16"),
             "B9a (LayerNorm)": ln.format("qkv_ln_kernel", 1024,
                                          "__nv_bfloat16"),
             "B9b (LayerNorm)": ln.format("out_ln_kernel", 512, "float"),
             "B2 (FC1 product)": gemm.format(2, "BiasGelu", "BiasGelu"),
             "B2 (FC2 product)": gemm.format(1, "BiasResidual",
                                             "BiasResidual"),
             "B9a (QKV product)": gemm.format(2, "QkvBias", "QkvBias"),
             "B9b (O product)": gemm.format(2, "OutProjResidual",
                                            "OutProjResidual"),
             "B9b (FC1 product)": gemm.format(2, "OutFc1Gelu", "OutFc1Gelu"),
             "B9b (FC2 product)": gemm.format(1, "OutFc2Residual",
                                              "OutFc2Residual")}
    for label, name in names.items():
        assert pl._kernel_of(name) == label, name
    assert pl.CALLS["B9a"] == ("qkv_ln_kernel", "QkvBias")
    assert pl.CALLS["B9b"] == ("OutProjResidual", "out_ln_kernel",
                               "OutFc1Gelu", "OutFc2Residual")
    events = [SimpleNamespace(name=names[label], device_type=DeviceType.CUDA,
                              time_range=SimpleNamespace(start=s, end=e))
              for label, s, e in (
                  ("B9a (LayerNorm)", 0, 1), ("B9a (QKV product)", 1, 4),
                  ("B2 (LayerNorm)", 4, 5), ("B9b (O product)", 10, 12),
                  ("B9b (LayerNorm)", 12, 13), ("B9b (FC1 product)", 13, 17),
                  ("B9b (FC2 product)", 17, 20))]
    spans = pl.call_spans(SimpleNamespace(events=lambda: events))
    assert spans == {"B9a": {"calls": 1, "mean_ms": 4e-3},
                     "B9b": {"calls": 1, "mean_ms": 10e-3}}
    # the names it looks for are the kernels' and epilogues' in the source
    text = (kernels.CSRC / "encoder_block.cu").read_text()
    for fn in pl.CALLS["B9a"] + pl.CALLS["B9b"]:
        assert f"\n{fn}(" in text or f"struct {fn} {{" in text, fn
        assert fn in pl.KERNELS


@pytest.mark.parametrize("name,label", [
    ("(anonymous namespace)::attn_kernel(CUtensorMap)", "B1"),
    ("(anonymous namespace)::self_attn_kernel(float const*, int)",
     "B10a (attention)"),
    ("(anonymous namespace)::cross_attn_kernel(float const*, int)",
     "B10b (attention)"),
    ("(anonymous namespace)::self_step_kernel(int)", "B3"),
    ("(anonymous namespace)::self_step_int8_kernel(int)", "B8"),
    ("(anonymous namespace)::log_mel_kernel<short>(short const*)", "B5"),
    ("void (anonymous namespace)::mel_spectrum_kernel<short>(short const*, "
     "long long)", "B5 (spectrum)"),
    ("(anonymous namespace)::mel_normalize_kernel(float*, int)",
     "B5 (normalization)"),
    ("void gemm::gemm_kernel<128, (anonymous namespace)::BiasGelu>(int)",
     "B2 (FC1 product)")])
def test_profile_ladder_tells_kernels_whose_names_overlap(name, label):
    """A kernel's name counts only whole: B1's attn_kernel is not the end of
    B10a's self_attn_kernel or B10b's cross_attn_kernel."""
    from whisper_tpu_torch import profile_ladder as pl

    assert pl._kernel_of(name) == label


def test_profile_ladder_reads_b5_and_b8_by_their_names():
    """The names ``profile_ladder`` looks for are B8's and B5's two kernels'
    names in the sources, and the first ports' names stay, so that the file
    run by its path against an older tree times that tree; a call of B5 is
    the span of its two kernels (the normalization, a programmatic
    dependent, starts before the spectrum kernel ends)."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    from whisper_tpu_torch import profile_ladder as pl

    assert pl.CALLS["B5"] == ("mel_spectrum_kernel", "mel_normalize_kernel")
    for fn, src in (("mel_spectrum_kernel", "log_mel.cu"),
                    ("mel_normalize_kernel", "log_mel.cu"),
                    ("self_step_int8_kernel", "self_attention_int8.cu")):
        assert f"\n{fn}(" in (kernels.CSRC / src).read_text()
        assert fn in pl.KERNELS
    assert pl.KERNELS["log_mel_kernel"] == "B5"
    assert pl.KERNELS["self_step_int8_kernel"] == "B8"

    def ev(name, start, end):
        return SimpleNamespace(name=f"void (anonymous namespace)::{name}(int)",
                               device_type=DeviceType.CUDA,
                               time_range=SimpleNamespace(start=start,
                                                          end=end))

    events = [ev("mel_spectrum_kernel<short>", 0, 10),
              ev("mel_normalize_kernel", 8, 12),
              ev("mel_spectrum_kernel<float>", 20, 30),
              ev("mel_normalize_kernel", 29, 33)]
    assert pl.call_spans(SimpleNamespace(events=lambda: events)) == {
        "B5": {"calls": 2, "mean_ms": 12.5e-3}}


def test_profile_ladder_spans_a_call_of_several_kernels():
    """``call_spans`` reads a call of B10a, B10b or B10c from its kernels as
    they follow each other on the stream: from the first one's start to the
    last one's end, B10c's overlapping FC1 and FC2 counted once."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    from whisper_tpu_torch import profile_ladder as pl

    def ev(name, start, end, dev=DeviceType.CUDA):
        return SimpleNamespace(name=f"(anonymous namespace)::{name}(int)",
                               device_type=dev,
                               time_range=SimpleNamespace(start=start,
                                                          end=end))

    events = [ev("ln_gemm_kernel", 0, 2), ev("self_attn_kernel", 2, 5),
              ev("out_proj_kernel", 5, 6), ev("ln_gemm_kernel", 6, 7),
              ev("cross_attn_kernel", 7, 12), ev("out_proj_kernel", 12, 13),
              ev("fc1_kernel", 13, 17), ev("fc2_kernel", 14, 19),
              ev("argmax", 19, 20), ev("fc1_kernel", 30, 33, DeviceType.CPU),
              ev("fc1_kernel", 40, 43), ev("fc2_kernel", 41, 45)]
    spans = pl.call_spans(SimpleNamespace(events=lambda: events[::-1]))
    assert spans == {"B10a": {"calls": 1, "mean_ms": 6e-3},
                     "B10b": {"calls": 1, "mean_ms": 7e-3},
                     "B10c": {"calls": 2, "mean_ms": 5.5e-3}}
