"""The port's kernel modules B8, B9a, B9b and B10c, and the W8A8 product of
rung x6, against the JAX package (CPU).

As in ``test_torch_ops.py``: on a CPU tensor each wrapper runs its plain
version, which is held here against the JAX Pallas kernel run in interpret
mode on the same inputs, made from a seed with numpy.  The CUDA kernels are
compared with the plain versions on the card (``chip_smoke.py``,
``tests/test_torch_cuda.py``).

Tolerances: bf16 outputs within 1 bf16 spacing (2^-7 relative) of the
larger magnitude; both sides compute in fp32 and round at the same points
but sum in another order.  The int8 rows B8 inserts and what the W8A8
product accumulates are integers: equal.  The scales B8 inserts are one
division: equal to the port's own and to the JAX package's ``_quant_rows``,
and within one fp32 place of the interpret-mode kernel's (see
``test_b8_plain_matches_jax``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from whisper_tpu.models.whisper import _dense as jax_dense
from whisper_tpu.ops.decoder_kernels import mlp_block as jax_mlp_block
from whisper_tpu.ops.encoder_block import fused_ln_qkv as jax_ln_qkv
from whisper_tpu.ops.encoder_block import fused_out_mlp as jax_out_mlp
from whisper_tpu.ops.self_attention import (
    PACK,
    quantize_pack_self,
    self_attend_step_packed_int8,
)
from whisper_tpu.variants.quant import QTensor as JaxQTensor
from whisper_tpu_torch.models.whisper import _dense
from whisper_tpu_torch.ops import decoder_kernels as t_dec
from whisper_tpu_torch.ops import encoder_block as t_block
from whisper_tpu_torch.ops import self_attention as t_self
from whisper_tpu_torch.variants.quant import QTensor, int8_matmul

torch.set_num_threads(2)

BF16_EPS = 2.0 ** -7


def _bf16_pair(x: np.ndarray):
    x = np.asarray(x, np.float32)
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _assert_bf16_close(got, want, steps: float):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = np.maximum(np.maximum(np.abs(got), np.abs(want)),
                       np.abs(want).mean())
    err = np.abs(got - want) / (scale * BF16_EPS)
    assert err.max() <= steps, f"max error {err.max():.2f} bf16 steps"


# ---------------------------------------------------------------------------
# B8: int8 self-attention step
# ---------------------------------------------------------------------------

L, B, H, DH, S = 2, 3, 4, 64, 19


def _unpack_kv(x8):
    """JAX's head-packed [L,B,G,S_pad,128] -> [L,B,H,S,64]."""
    y = np.asarray(x8)
    l, b, g, sp, _ = y.shape
    y = y.reshape(l, b, g, sp, PACK, DH)
    return np.swapaxes(y, 3, 4).reshape(l, b, g * PACK, sp, DH)[:, :, :, :S]


def _unpack_scale(sc):
    """JAX's [L,B,G,S_pad,2] -> [L,B,H,S]."""
    y = np.swapaxes(np.asarray(sc), 3, 4)
    l, b, g, p, sp = y.shape
    return y.reshape(l, b, g * p, sp)[..., :S]


def _b8_inputs(seed):
    rng = np.random.default_rng(seed)
    k = _bf16_pair(rng.normal(0, 1, (L, B, H, S, DH)))
    v = _bf16_pair(rng.normal(0, 1, (L, B, H, S, DH)))
    q = _bf16_pair(rng.normal(0, 1, (B, H, DH)) * DH ** -0.5 * 3.0)
    kn = _bf16_pair(rng.normal(0, 1, (B, H, DH)))
    vn = _bf16_pair(rng.normal(0, 1, (B, H, DH)))
    return k, v, q, kn, vn


def test_quantize_self_cache_equals_jax():
    """Per-row absmax/127 with the 1e-12 floor: int8 values and scales equal
    the JAX package's after undoing its head packing and its padding of S."""
    k, v, *_ = _b8_inputs(0)
    k[1][0, 0, 0, 3] = 0.0                       # an all-zero row: the floor
    jk = k[0].at[0, 0, 0, 3].set(0.0)
    jk8, jv8, jks, jvs = quantize_pack_self(jk, v[0])
    k8, v8, ks, vs = t_self.quantize_self_cache(k[1], v[1])
    assert k8.dtype == torch.int8 and ks.dtype == torch.float32
    assert ks.shape == (L, B, H, S)
    np.testing.assert_array_equal(k8.numpy(), _unpack_kv(jk8))
    np.testing.assert_array_equal(v8.numpy(), _unpack_kv(jv8))
    np.testing.assert_array_equal(ks.numpy(), _unpack_scale(jks))
    np.testing.assert_array_equal(vs.numpy(), _unpack_scale(jvs))
    assert float(ks[0, 0, 0, 3]) == np.float32(1e-12) / np.float32(127.0)


@pytest.mark.parametrize("pos", [0, 9, S - 1])
@pytest.mark.parametrize("pad", [None, [0, 4, 9]])
def test_b8_plain_matches_jax(pos, pad):
    """After the step the int8 buffers equal JAX's everywhere (the inserted
    rows bit for bit, every other row untouched) and the scale planes equal
    JAX's outside the inserted row; ctx is within 1 bf16 step.  The
    inserted scales equal the port's ``quant_rows`` (a true division,
    absmax/127) bit for bit and the interpret-mode kernel's within one fp32
    place: compiled for the CPU, that kernel's own scales differ from the
    JAX package's ``_quant_rows`` by as much (its tests hold rtol 1e-6)."""
    if pad is not None and pos < max(pad):
        pad = [min(p, pos) for p in pad]
    k, v, q, kn, vn = _b8_inputs(1 + pos)
    layer = 1
    jbuf = quantize_pack_self(k[0], v[0])
    jctx, *jout = self_attend_step_packed_int8(
        q[0], kn[0], vn[0], *jbuf, jnp.int32(layer), jnp.int32(pos),
        None if pad is None else jnp.asarray(pad, jnp.int32), interpret=True)
    tbuf = t_self.quantize_self_cache(k[1], v[1])
    t_self.int8_launches = 0
    ctx = t_self.self_attend_step_int8(
        q[1], kn[1], vn[1], *tbuf, layer, pos,
        None if pad is None else torch.tensor(pad, dtype=torch.int32))
    assert t_self.int8_launches == 0 and ctx.dtype == torch.bfloat16
    np.testing.assert_array_equal(tbuf[0].numpy(), _unpack_kv(jout[0]))
    np.testing.assert_array_equal(tbuf[1].numpy(), _unpack_kv(jout[1]))
    for mine, theirs in ((tbuf[2], jout[2]), (tbuf[3], jout[3])):
        mine, theirs = mine.numpy().copy(), _unpack_scale(theirs).copy()
        np.testing.assert_allclose(mine[layer, :, :, pos],
                                   theirs[layer, :, :, pos], rtol=2.0 ** -23,
                                   atol=0)
        mine[layer, :, :, pos] = theirs[layer, :, :, pos] = 0
        np.testing.assert_array_equal(mine, theirs)
    kn8, kns = t_self.quant_rows(kn[1])
    assert torch.equal(tbuf[0][layer, :, :, pos], kn8)
    assert torch.equal(tbuf[2][layer, :, :, pos], kns)
    vn8, vns = t_self.quant_rows(vn[1])
    assert torch.equal(tbuf[1][layer, :, :, pos], vn8)
    assert torch.equal(tbuf[3][layer, :, :, pos], vns)
    _assert_bf16_close(ctx, jctx, steps=1.0)


@pytest.mark.parametrize("pos", [0, 5, 11])
def test_b8_pos_as_tensor_matches_int_and_jax(pos):
    """``pos`` as a one-element int32 tensor (what the card's kernel reads
    from device memory) at the first row, mid-cache and a later row, with
    mixed ``pad_count``: the plain version and the wrapper on CPU tensors
    give the int form's output and four buffers bit for bit, and the
    interpret-mode kernel's ctx within 1 bf16 step, as
    ``test_b8_plain_matches_jax`` holds the int form."""
    k, v, q, kn, vn = _b8_inputs(40 + pos)
    layer, pad = 1, np.array([0, min(4, pos), pos], np.int32)
    jbuf = quantize_pack_self(k[0], v[0])
    jctx, *_ = self_attend_step_packed_int8(
        q[0], kn[0], vn[0], *jbuf, jnp.int32(layer), jnp.int32(pos),
        jnp.asarray(pad), interpret=True)
    pad_t = torch.from_numpy(pad)
    pos_t = torch.tensor([pos], dtype=torch.int32)
    outs = []
    for fn, p in ((t_self.self_attend_step_int8_plain, pos),
                  (t_self.self_attend_step_int8_plain, pos_t),
                  (t_self.self_attend_step_int8, pos_t)):
        bufs = list(t_self.quantize_self_cache(k[1], v[1]))
        outs.append((fn(q[1], kn[1], vn[1], *bufs, layer, p, pad_t), bufs))
    for ctx, bufs in outs[1:]:
        assert torch.equal(ctx, outs[0][0])
        assert all(torch.equal(a, b) for a, b in zip(bufs, outs[0][1]))
    _assert_bf16_close(outs[0][0], jctx, steps=1.0)


def test_b8_masked_rows_hold_anything():
    """Rows after ``pos`` and before ``pad_count`` get exactly zero weight
    whatever stale int8 and scale they hold."""
    k, v, q, kn, vn = _b8_inputs(5)
    pos, pad = 10, torch.tensor([0, 4, 9], dtype=torch.int32)
    a = t_self.quantize_self_cache(k[1], v[1])
    b = [t.clone() for t in a]
    b[0][:, :, :, pos + 1:] = 127
    b[1][:, :, :, pos + 1:] = -127
    b[2][:, :, :, pos + 1:] = 1e6
    b[3][:, :, :, pos + 1:] = 1e6
    b[1][:, 1, :, :4] = 127
    b[3][:, 1, :, :4] = 1e6
    got_a = t_self.self_attend_step_int8(q[1], kn[1], vn[1], *a, 0, pos, pad)
    got_b = t_self.self_attend_step_int8(q[1], kn[1], vn[1], *b, 0, pos, pad)
    assert torch.equal(got_a, got_b)


# ---------------------------------------------------------------------------
# B9a, B9b: the fused encoder block's kernels
# ---------------------------------------------------------------------------

def _block_inputs(seed, b, t, d, f):
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.normal(0, 1, (b, t, d)), ctx=rng.normal(0, 1, (b, t, d)),
        lns=1.0 + 0.1 * rng.normal(size=d), lnb=0.1 * rng.normal(size=d),
        w_qkv=rng.normal(0, 0.05, (d, 3 * d)),
        b_qkv=0.1 * rng.normal(size=3 * d),
        o_w=rng.normal(0, 0.05, (d, d)), o_b=0.1 * rng.normal(size=d),
        w1=rng.normal(0, 0.05, (d, f)), b1=0.1 * rng.normal(size=f),
        w2=rng.normal(0, 0.05, (f, d)), b2=0.1 * rng.normal(size=d))


@pytest.mark.parametrize("c_block", [None, 128])
def test_b9a_plain_matches_jax_ragged_rows(c_block):
    """B*T = 74 rows, no multiple of any tile; the JAX kernel whole and
    column-chunked (c_block): the port's one version gives both."""
    a = _block_inputs(3, 2, 37, 128, 512)
    pairs = [_bf16_pair(a[k]) for k in ("x", "lns", "lnb", "w_qkv", "b_qkv")]
    want = jax_ln_qkv(*[p[0] for p in pairs], interpret=True, c_block=c_block)
    t_block.ln_qkv_launches = 0
    got = t_block.fused_ln_qkv(*[p[1] for p in pairs])
    assert got.shape == (2, 37, 384) and t_block.ln_qkv_launches == 0
    _assert_bf16_close(got, want, steps=1.0)


def test_b9a_plain_matches_jax_at_medium_width():
    a = _block_inputs(4, 1, 21, 1024, 4096)
    blk = t_block.qkv_chunk_plan(1024, torch.bfloat16)
    pairs = [_bf16_pair(a[k]) for k in ("x", "lns", "lnb", "w_qkv", "b_qkv")]
    want = jax_ln_qkv(*[p[0] for p in pairs], interpret=True, c_block=blk)
    got = t_block.fused_ln_qkv(*[p[1] for p in pairs])
    _assert_bf16_close(got, want, steps=1.0)


def test_b9b_plain_matches_jax_ragged_rows():
    """LN2 on the unrounded fp32 residual, the final residual on its bf16
    rounding, tanh GELU."""
    a = _block_inputs(5, 2, 37, 128, 512)
    keys = ("x", "ctx", "o_w", "o_b", "lns", "lnb", "w1", "b1", "w2", "b2")
    pairs = [_bf16_pair(a[k]) for k in keys]
    want = jax_out_mlp(*[p[0] for p in pairs], interpret=True)
    t_block.out_mlp_launches = 0
    got = t_block.fused_out_mlp(*[p[1] for p in pairs])
    assert got.shape == (2, 37, 128) and t_block.out_mlp_launches == 0
    _assert_bf16_close(got, want, steps=1.0)


def test_b9b_residual_uses_rounded_y():
    """The two roundings that set B9b apart from (O-projection, then B2):
    adding the unrounded y32 in the final residual gives other values."""
    a = _block_inputs(6, 1, 64, 128, 512)
    keys = ("x", "ctx", "o_w", "o_b", "lns", "lnb", "w1", "b1", "w2", "b2")
    t = [_bf16_pair(a[k])[1] for k in keys]
    got = t_block.fused_out_mlp_plain(*t)
    x, ctx, o_w, o_b, lns, lnb, w1, b1, w2, b2 = t
    y32 = x.float() + (ctx.float() @ o_w.float() + o_b.float())
    from whisper_tpu_torch.ops.encoder_mlp import fused_encoder_mlp_plain
    z = got.float() - y32.to(torch.bfloat16).float()
    unrounded = (y32 + z).to(torch.bfloat16)
    assert not torch.equal(unrounded, got)
    # and LN2 reads y32, not its rounding: B2 on bf16(y32) differs too
    assert not torch.equal(
        fused_encoder_mlp_plain(y32.to(torch.bfloat16)[None][0], lns, lnb, w1,
                                b1, w2, b2), got)


@pytest.mark.parametrize("d,f,dtype,mode", [
    (512, 2048, torch.bfloat16, "whole"),      # whisper-base
    (384, 1536, torch.float32, "whole"),       # whisper-tiny fp32
    (512, 2048, torch.float32, "chunked"),     # whisper-base fp32
    (1024, 4096, torch.bfloat16, "chunked"),   # whisper-medium
    (1280, 5120, torch.bfloat16, "chunked"),   # whisper-large
    (1056, 4224, torch.bfloat16, None),        # 3d no multiple of 128
])
def test_fused_block_mode_follows_jax_predicates(d, f, dtype, mode):
    from whisper_tpu.ops import encoder_block as jeb
    from whisper_tpu.ops import encoder_mlp as jem

    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    assert t_block.fits_vmem(d, f, dtype) == jeb.fits_vmem(d, f, jdt)
    assert t_block.qkv_chunk_plan(d, dtype) == jeb.qkv_chunk_plan(d, jdt)
    assert t_block.mlp_fits_vmem(d, f, dtype) == jem.fits_vmem(d, f, jdt)
    assert t_block.mlp_chunk_plan(d, f, dtype) == jem.chunk_plan(d, f, jdt)
    assert t_block.fused_block_mode(d, f, dtype) == mode


# ---------------------------------------------------------------------------
# B10c: the decoder MLP block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,d", [(1, 128), (16, 128), (16, 512), (17, 512)])
def test_b10c_plain_matches_jax(b, d):
    """A narrow model, and whisper-base's width (f = 2,048) at one and at two
    tiles of 16 rows."""
    rng = np.random.default_rng(20 + b)
    f = 4 * d
    x = _bf16_pair(rng.normal(0, 1, (b, d)))
    ln = _bf16_pair(np.stack([1.0 + 0.1 * rng.normal(size=d),
                              0.1 * rng.normal(size=d)]))
    w1 = _bf16_pair(rng.normal(0, 0.05, (d, f)))
    b1 = _bf16_pair(0.1 * rng.normal(size=(1, f)))
    w2 = _bf16_pair(rng.normal(0, 0.05, (f, d)))
    b2 = _bf16_pair(0.1 * rng.normal(size=(1, d)))
    args = (x, ln, w1, b1, w2, b2)
    want = jax_mlp_block(*[a[0] for a in args], interpret=True)
    t_dec.launches = 0
    got = t_dec.mlp_block(*[a[1] for a in args])
    assert got.shape == (b, d) and t_dec.launches == 0
    _assert_bf16_close(got, want, steps=1.0)


# ---------------------------------------------------------------------------
# x6: the W8A8 dense product
# ---------------------------------------------------------------------------

def test_int8_matmul_exact_at_k_2048():
    """Every |value| 127 and K = 2,048: the sum 127^2 * 2,048 = 33,032,192
    is past 2^24, where an fp32 product would round."""
    xq = torch.full((3, 2048), 127, dtype=torch.int8)
    xq[1] = -127
    xq[2, ::2] = 126
    wq = torch.full((2048, 8), 127, dtype=torch.int8)
    wq[:, 1] = -127
    wq[5, 2] = 1
    got = int8_matmul(xq, wq)
    want = xq.to(torch.int64) @ wq.to(torch.int64)
    assert got.dtype == torch.int32
    assert torch.equal(got.to(torch.int64), want)
    assert int(got[0, 0]) == 127 * 127 * 2048 > 2 ** 24
    # leading axes are kept
    assert int8_matmul(xq.reshape(3, 1, 2048), wq).shape == (3, 1, 8)


@pytest.mark.parametrize("k", [64, 2048])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_dense_w8a8_matches_jax(k, dtype):
    """``_dense(int8_act=True)``: per-row activation scale taken in x's
    dtype, an exact int32 accumulation, fp32 rescale, bias in x's dtype.
    fp32: equal up to the last place of the fp32 rescale (rtol 1e-6); bf16:
    within 1 bf16 step after the final cast."""
    rng = np.random.default_rng(k)
    n = 96
    x = rng.normal(0, 1, (2, 5, k)).astype(np.float32)
    x[0, 0] = 0.0                                  # the 1e-12 floor
    wq = rng.integers(-127, 128, (k, n)).astype(np.int8)
    ws = (rng.uniform(0.5, 2.0, (1, n)) * 1e-3).astype(np.float32)
    bias = rng.normal(0, 0.1, n).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = jax_dense(jnp.asarray(x, jdt),
                     JaxQTensor(jnp.asarray(wq), jnp.asarray(ws)),
                     jnp.asarray(bias, jdt), None, int8_act=True)
    got = _dense(torch.from_numpy(x).to(tdt),
                 QTensor(torch.from_numpy(wq), torch.from_numpy(ws)),
                 torch.from_numpy(bias).to(tdt), int8_act=True)
    assert got.dtype == tdt and got.shape == (2, 5, n)
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-7)
    else:
        _assert_bf16_close(got, want, steps=1.0)
    # without int8_act the weight is dequantized: other values
    plain = _dense(torch.from_numpy(x).to(tdt),
                   QTensor(torch.from_numpy(wq), torch.from_numpy(ws)),
                   torch.from_numpy(bias).to(tdt))
    assert not torch.equal(plain, got)
