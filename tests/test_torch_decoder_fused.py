"""The port's fused decoder-step blocks (B10a, B10b) and
``decoder_step_fused`` against the JAX package (CPU).

Same weights (``init_params(dims, seed)``) and same inputs, made from a seed
with numpy, through ``whisper_tpu.ops.decoder_kernels`` (Pallas kernels in
interpret mode, as its own tests run them) and through
``whisper_tpu_torch.ops.decoder_kernels`` (the kernels' plain versions,
which a CPU tensor takes).  fp32, at the tolerances of the JAX package's own
test of these kernels (tests/test_decoder_kernels.py): logits and block
outputs 2e-4, cache rows 2e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from whisper_tpu.models import convert as jconvert
from whisper_tpu.models import whisper as jw
from whisper_tpu.ops import decoder_kernels as jdk
from whisper_tpu_torch.models import convert
from whisper_tpu_torch.models import whisper as tw
from whisper_tpu_torch.models.registry import WhisperDims
from whisper_tpu_torch.ops import decoder_kernels as tdk

torch.set_num_threads(2)

OUT_TOL, CACHE_TOL = 2e-4, 2e-5


def _dims(t_enc=96, d=128, heads=2, layers=2):
    return WhisperDims(n_mels=80, d_model=d, encoder_layers=1,
                       encoder_heads=heads, decoder_layers=layers,
                       decoder_heads=heads, vocab_size=256,
                       max_source_positions=t_enc, max_target_positions=32)


def _params(dims, seed):
    jp = jconvert.cast_params(jconvert.init_params(dims, seed), jnp.float32)
    tp = convert.params_from_numpy(convert.init_params(dims, seed), "cpu",
                                   torch.float32)
    return jp, tp


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _layer_args(dims, seed):
    """One layer's pre-fused weights in both packages, and x [B, d]."""
    jp, tp = _params(dims, seed)
    jsw, tsw = jdk.build_step_weights(jp, dims), \
        tdk.build_step_weights(tp, dims)
    rng = np.random.default_rng(seed + 1)
    x = rng.normal(0, 1, (3, dims.d_model)).astype(np.float32)
    return jsw, tsw, x, rng


@pytest.mark.parametrize("pos", [0, 5, 11])
def test_self_attn_block_plain_matches_jax(pos):
    """B10a: the output and both cache buffers (rows <= pos hold data, row
    pos is written, rows > pos stay as they were)."""
    dims = _dims()
    jsw, tsw, x, rng = _layer_args(dims, 2)
    s_max, b, d = 12, 3, dims.d_model
    ck = rng.normal(0, 1, (s_max, b, d)).astype(np.float32)
    cv = rng.normal(0, 1, (s_max, b, d)).astype(np.float32)
    names = ("ln1", "qkv_w", "qkv_b", "o_w", "o_b")
    want, wk, wv = jdk.self_attn_block(
        jnp.asarray(x), *(jsw[n][1] for n in names), jnp.asarray(ck),
        jnp.asarray(cv), pos, dims.decoder_heads, interpret=True)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    tdk.self_block_launches = 0
    got, gk, gv = tdk.self_attn_block(
        torch.from_numpy(x), *(tsw[n][1] for n in names), tk, tv, pos,
        dims.decoder_heads)
    assert tdk.self_block_launches == 0   # a CPU tensor: the plain version
    assert gk is tk and gv is tv          # written in place
    np.testing.assert_allclose(_np(got), _np(want), atol=OUT_TOL, rtol=0)
    np.testing.assert_allclose(_np(gk), _np(wk), atol=CACHE_TOL, rtol=0)
    np.testing.assert_allclose(_np(gv), _np(wv), atol=CACHE_TOL, rtol=0)
    untouched = [r for r in range(s_max) if r != pos]
    assert np.array_equal(_np(gk)[untouched], ck[untouched])
    assert np.array_equal(_np(gv)[untouched], cv[untouched])
    assert not np.array_equal(_np(gk)[pos], ck[pos])


def _self_block_inputs(seed=2):
    dims = _dims()
    jsw, tsw, x, rng = _layer_args(dims, seed)
    s_max, b, d = 12, 3, dims.d_model
    ck = rng.normal(0, 1, (s_max, b, d)).astype(np.float32)
    cv = rng.normal(0, 1, (s_max, b, d)).astype(np.float32)
    return dims, jsw, tsw, x, ck, cv


SELF_NAMES = ("ln1", "qkv_w", "qkv_b", "o_w", "o_b")


@pytest.mark.parametrize("pos", [0, 5, 11])
def test_self_attn_block_tensor_pos_matches_jax(pos):
    """B10a with ``pos`` as a one-element int32 tensor (what the kernel reads
    on the card) against the JAX kernel with ``pos`` as an array (its SMEM
    scalar): the output and both cache buffers."""
    dims, jsw, tsw, x, ck, cv = _self_block_inputs()
    want, wk, wv = jdk.self_attn_block(
        jnp.asarray(x), *(jsw[n][1] for n in SELF_NAMES), jnp.asarray(ck),
        jnp.asarray(cv), jnp.asarray([pos], jnp.int32), dims.decoder_heads,
        interpret=True)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    got, gk, gv = tdk.self_attn_block(
        torch.from_numpy(x), *(tsw[n][1] for n in SELF_NAMES), tk, tv,
        torch.tensor([pos], dtype=torch.int32), dims.decoder_heads)
    assert gk is tk and gv is tv
    np.testing.assert_allclose(_np(got), _np(want), atol=OUT_TOL, rtol=0)
    np.testing.assert_allclose(_np(gk), _np(wk), atol=CACHE_TOL, rtol=0)
    np.testing.assert_allclose(_np(gv), _np(wv), atol=CACHE_TOL, rtol=0)


@pytest.mark.parametrize("pos", [0, 5, 11])
def test_self_attn_block_tensor_pos_is_bitwise_the_int(pos):
    """The two forms of ``pos`` give the same output and caches, bit for
    bit."""
    dims, _, tsw, x, ck, cv = _self_block_inputs(7)
    outs = []
    for p_ in (pos, torch.tensor([pos], dtype=torch.int32)):
        tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
        outs.append(tdk.self_attn_block(
            torch.from_numpy(x), *(tsw[n][1] for n in SELF_NAMES), tk, tv,
            p_, dims.decoder_heads))
    for a, b_ in zip(*outs):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("bad,match", [
    (torch.tensor([3], dtype=torch.int64), "torch.int64"),
    (torch.tensor([3, 4], dtype=torch.int32), "one int32"),
    (torch.tensor([3], dtype=torch.int32, device="meta"), "on cpu"),
    (12, "outside the cache")])
def test_self_attn_block_refuses_a_pos_it_cannot_take(bad, match):
    """A tensor ``pos`` must be one int32 on x's device (the kernel reads 4
    bytes there); an int must lie inside the cache.  Both are checked before
    the device is chosen, so the CPU path refuses what the card would."""
    dims, _, tsw, x, ck, cv = _self_block_inputs()
    with pytest.raises(ValueError, match=match):
        tdk.self_attn_block(
            torch.from_numpy(x), *(tsw[n][1] for n in SELF_NAMES),
            torch.from_numpy(ck), torch.from_numpy(cv), bad,
            dims.decoder_heads)


@pytest.mark.parametrize("t_enc", [96, 64, 100, 40])
def test_cross_attn_block_plain_matches_jax(t_enc):
    """B10b at T a multiple of 64, not a multiple, and under one block."""
    dims = _dims(t_enc)
    jsw, tsw, x, rng = _layer_args(dims, 3)
    shape = (3, dims.decoder_heads, t_enc, dims.head_dim)
    ck = rng.normal(0, 1, shape).astype(np.float32)
    cv = rng.normal(0, 1, shape).astype(np.float32)
    names = ("ln2", "xq_w", "xq_b", "xo_w", "xo_b")
    want = jdk.cross_attn_block(
        jnp.asarray(x), *(jsw[n][0] for n in names), jnp.asarray(ck),
        jnp.asarray(cv), dims.decoder_heads, interpret=True)
    tdk.cross_block_launches = 0
    got = tdk.cross_attn_block(
        torch.from_numpy(x), *(tsw[n][0] for n in names),
        torch.from_numpy(ck), torch.from_numpy(cv), dims.decoder_heads)
    assert tdk.cross_block_launches == 0
    np.testing.assert_allclose(_np(got), _np(want), atol=OUT_TOL, rtol=0)
    # the online softmax is a softmax: equal to one pass over all keys
    q = tdk._dot_exact(tdk._ln_exact(torch.from_numpy(x), tsw["ln2"][0]),
                       tsw["xq_w"][0], tsw["xq_b"][0]) * dims.head_dim ** -0.5
    q = q.reshape(3, dims.decoder_heads, 1, dims.head_dim)
    p = torch.softmax(q @ torch.from_numpy(ck).transpose(-1, -2), dim=-1)
    ctx = (p @ torch.from_numpy(cv)).reshape(3, -1)
    ref = ctx @ tsw["xo_w"][0] + tsw["xo_b"][0][0] + torch.from_numpy(x)
    np.testing.assert_allclose(_np(got), _np(ref), atol=OUT_TOL, rtol=0)


def test_time_major_round_trip_is_exact():
    rng = np.random.default_rng(4)
    c = rng.normal(0, 1, (2, 3, 2, 7, 64)).astype(np.float32)
    tm = tdk.cache_to_time_major(torch.from_numpy(c))
    assert tuple(tm.shape) == (2, 7, 3, 128) and tm.is_contiguous()
    assert np.array_equal(_np(tm), _np(jdk.cache_to_time_major(jnp.asarray(c))))
    back = tdk.cache_from_time_major(tm, 2)
    assert np.array_equal(_np(back), c)
    assert np.array_equal(
        _np(back), _np(jdk.cache_from_time_major(jnp.asarray(_np(tm)), 2)))


@pytest.mark.parametrize("t_enc", [96, 72])
def test_decoder_step_fused_three_step_chain_matches_jax(t_enc):
    """Prefill (bf16-free: fp32, no int8 cross cache), the self cache made
    time-major, then three fused steps chained on their own tokens: logits
    and caches against the JAX function, and logits against the port's own
    plain decoder_step within the same tolerance plus the tanh GELU's."""
    dims = _dims(t_enc)
    jp, tp = _params(dims, 5)
    rng = np.random.default_rng(6)
    enc = rng.normal(0, 1, (2, t_enc, dims.d_model)).astype(np.float32)
    prompt = np.asarray([[3, 5, 7]] * 2)
    jl, jc = jw.decoder_prefill(jp, dims, jnp.asarray(prompt, jnp.int32),
                                jnp.asarray(enc), 8)
    tl, tc = tw.decoder_prefill(tp, dims, torch.from_numpy(prompt),
                                torch.from_numpy(enc), 8)
    jsw, tsw = jdk.build_step_weights(jp, dims), \
        tdk.build_step_weights(tp, dims)
    jk, jv = jdk.cache_to_time_major(jc.self_k), \
        jdk.cache_to_time_major(jc.self_v)
    tk, tv = tdk.cache_to_time_major(tc.self_k), \
        tdk.cache_to_time_major(tc.self_v)
    tok = np.asarray(jl[:, -1].argmax(-1))
    for pos in (3, 4, 5):
        jl, jk, jv = jdk.decoder_step_fused(
            jp, jsw, dims, jnp.asarray(tok, jnp.int32), jnp.int32(pos), jk, jv,
            jc.cross_k, jc.cross_v, interpret=True)
        tl, tk2, tv2 = tdk.decoder_step_fused(
            tp, tsw, dims, torch.from_numpy(tok.copy()), pos, tk, tv,
            tc.cross_k, tc.cross_v)
        assert tk2 is tk and tv2 is tv
        assert tl.dtype == torch.float32 and tuple(tl.shape) == (2, 256)
        np.testing.assert_allclose(_np(tl), _np(jl), atol=OUT_TOL, rtol=0)
        np.testing.assert_allclose(_np(tk), _np(jk), atol=CACHE_TOL, rtol=0)
        np.testing.assert_allclose(_np(tv), _np(jv), atol=CACHE_TOL, rtol=0)
        # the plain step on the same cache (exact erf GELU there)
        plain_cache = tc._replace(
            self_k=tdk.cache_from_time_major(tk, dims.decoder_heads).clone(),
            self_v=tdk.cache_from_time_major(tv, dims.decoder_heads).clone())
        pl, _ = tw.decoder_step(tp, dims, torch.from_numpy(tok.copy()), pos,
                                plain_cache)
        np.testing.assert_allclose(_np(tl), _np(pl), atol=0.1, rtol=0)
        tok = np.asarray(jl.argmax(-1))
    assert tdk.self_block_launches == tdk.cross_block_launches == 0


@pytest.mark.parametrize("t_enc", [96, 72])
def test_decoder_step_fused_tensor_pos_chain_equals_the_int_chain(t_enc):
    """Three fused steps chained on their own tokens with ``pos`` as a
    one-element int32 tensor advanced in place (as a CUDA graph of the step
    replays it) give the int chain's tokens, logits and caches, bit for
    bit."""
    dims = _dims(t_enc)
    _, tp = _params(dims, 8)
    rng = np.random.default_rng(9)
    enc = torch.from_numpy(
        rng.normal(0, 1, (2, t_enc, dims.d_model)).astype(np.float32))
    prompt = torch.from_numpy(np.asarray([[3, 5, 7]] * 2))
    tsw = tdk.build_step_weights(tp, dims)
    chains = []
    for as_tensor in (False, True):
        logits, cache = tw.decoder_prefill(tp, dims, prompt, enc, 8)
        tk = tdk.cache_to_time_major(cache.self_k)
        tv = tdk.cache_to_time_major(cache.self_v)
        tok = logits[:, -1].argmax(-1)
        pos = torch.tensor([3], dtype=torch.int32) if as_tensor else 3
        toks, outs = [], []
        for _ in range(3):
            lg, _, _ = tdk.decoder_step_fused(tp, tsw, dims, tok, pos, tk, tv,
                                              cache.cross_k, cache.cross_v)
            tok = lg.argmax(-1)
            toks.append(tok)
            outs.append(lg)
            if as_tensor:
                pos.add_(1)
            else:
                pos += 1
        chains.append((torch.stack(toks, 1), outs, tk, tv))
    (ti, li, ki, vi), (tt, lt, kt, vt) = chains
    assert torch.equal(ti, tt)
    assert all(torch.equal(a, b_) for a, b_ in zip(li, lt))
    assert torch.equal(ki, kt) and torch.equal(vi, vt)


def test_fused_blocks_refuse_what_the_kernels_do_not_take():
    """On a device that is neither the CPU nor a CUDA card the wrappers
    raise: no path leads to a plain version from there."""
    x = torch.zeros((2, 128), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        tdk.self_attn_block(x, x, x, x, x, x, x, x, 0, 2)
    with pytest.raises(ValueError, match="no kernel for device"):
        tdk.cross_attn_block(x, x, x, x, x, x, x, x, 2)
