"""The port's CUDA kernels (B1-B10c) against their plain versions, on the
card.

These tests need an NVIDIA card and nvcc; elsewhere they skip.  Run them on
the card with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest sets up JAX, which this file does
not use).  ``chip_smoke.py`` checks the kernels at the main path's shapes;
these cover the edges it does not reach: ragged sequence lengths, a
nonzero ``pad_count``, a padded cross cache, the other model widths, the
front end at 1 to 30,000 frames and the wrapper's refusals.  Tolerance: 2
bf16 steps (2^-7 relative) of each value, the mean magnitude as the floor
near zero; both sides round at the same points, and sum in another order.
The front end (B5, fp32 out) is held to 1e-4 on the normalized mel, the
card-vs-CPU mel bound of ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from whisper_tpu_torch.frontend import golden
from whisper_tpu_torch.frontend.mel import normalize
from whisper_tpu_torch.ops import attention, cross_attention, encoder_mlp
from whisper_tpu_torch.ops import decoder_kernels, encoder_block
from whisper_tpu_torch.ops import log_mel, self_attention
from whisper_tpu_torch.ops.common import disable_tf32

pytestmark = pytest.mark.cuda

BF = torch.bfloat16


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card, see the docstring)")
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape, scale=1.0):
    return (torch.randn(*shape, generator=gen, device="cuda")
            * scale).to(BF)


def _assert_close(got, want, steps=2.0):
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    scale = torch.maximum(torch.maximum(got.abs(), want.abs()),
                          want.abs().mean())
    err = float(((got - want).abs() / (scale * 2.0 ** -7)).max())
    assert err <= steps, f"{err:.2f} bf16 steps"


def _device_ops(call, calls=3):
    """{operation: count} that ``calls`` calls of ``call`` put on the card,
    by torch.profiler.  A trace with no device activity at all is taken once
    more: the profiler now and then records none for a whole session, which
    says nothing of what the wrapper launched."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                call()
            torch.cuda.synchronize()
        ops = {e.key: e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA}
        if ops:
            break
    return ops


@pytest.mark.parametrize("bh", [(2, 3), (16, 8)])
@pytest.mark.parametrize("t", [1500, 1499, 200, 100, 65, 64, 17, 1])
def test_b1_kernel_matches_plain(gen, t, bh):
    """A whole number of 128-key tiles and not, one tile, one key; T no
    multiple of 16 (the last P.V depth step) and of 8; 6 and 128 heads.  q
    has scale 0.5 (sharply peaked rows) at 6 heads and the encoder's 64^-0.5
    at 128: over the 12.3 M outputs of 128 peaked heads the plain version
    itself lies more than 2 steps from the exactly computed contract
    (``python -m whisper_tpu_torch.kernel_variants`` prints both distances)."""
    b, h = bh
    q = _randn(gen, b, h, t, 64, scale=0.5 if b * h < 100 else 0.125)
    k, v = _randn(gen, b, h, t, 64), _randn(gen, b, h, t, 64)
    before = attention.launches
    got = attention.fused_attention(q, k, v)
    assert attention.launches == before + 1
    _assert_close(got, attention.fused_attention_plain(q, k, v))


def test_b1_peaked_scores(gen):
    """Scores up to 128 apart within a row (p from 1 down to 2^-92 and an
    exact 0 on the masked tail), T = 100: one tile, the last depth step of
    P.V partly past T."""
    t = 100
    idx = torch.arange(t, device="cuda")
    q = torch.zeros(1, 1, t, 64, device="cuda", dtype=BF)
    k = torch.zeros(1, 1, t, 64, device="cuda", dtype=BF)
    q[0, 0, idx, idx % 64] = 64.0
    k[0, 0, idx, idx % 64] = 1.0 + (idx // 64).to(BF)
    v = _randn(gen, 1, 1, t, 64)
    _assert_close(attention.fused_attention(q, k, v),
                  attention.fused_attention_plain(q, k, v))


@pytest.mark.parametrize("b,t,d,f", [(2, 37, 512, 2048), (1, 1500, 384, 1536),
                                     (2, 100, 1024, 4096), (3, 5, 1280, 5120),
                                     (1, 1, 512, 2048), (16, 1500, 512, 2048),
                                     (1, 129, 128, 512), (1, 1500, 768, 3072),
                                     (1, 300, 128, 192)])
def test_b2_kernel_matches_plain(gen, b, t, d, f):
    """Every width of the kernel; one row, one row past a 128-row tile, a
    ragged last tile (1,500 = 11 tiles and 92 rows), the main path's 24,000
    rows (128 x 256 column tiles) and an f that is a multiple of 64 only (the
    last column tile half outside the matrix)."""
    args = (_randn(gen, b, t, d), 1.0 + _randn(gen, d, scale=0.1),
            _randn(gen, d, scale=0.1), _randn(gen, d, f, scale=0.04),
            _randn(gen, f, scale=0.1), _randn(gen, f, d, scale=0.04),
            _randn(gen, d, scale=0.1))
    before = encoder_mlp.launches
    got = encoder_mlp.fused_encoder_mlp(*args)
    assert encoder_mlp.launches == before + 1
    _assert_close(got, encoder_mlp.fused_encoder_mlp_plain(*args))


@pytest.mark.parametrize("pos,pads", [(70, [0, 5, 70, 1]), (0, [0, 0, 0, 0]),
                                      (131, [3, 0, 131, 130]), (70, None),
                                      (447, [0, 440, 1, 447])])
@pytest.mark.parametrize("pos_on_device", [False, True])
def test_b3_kernel_matches_plain_and_inserts_in_place(gen, pos, pads,
                                                      pos_on_device):
    """Mixed pads and none (a null pointer), the first and the last row, a
    cache of 448 rows (more shared memory than a launch gets unasked), ``pos``
    as an int and as a tensor the kernel reads."""
    n_l, b, h, s = 3, 4, 6, 448 if pos > 131 else 132
    q = _randn(gen, b, h, 64, scale=0.125)
    kn, vn = _randn(gen, b, h, 64), _randn(gen, b, h, 64)
    kc, vc = _randn(gen, n_l, b, h, s, 64), _randn(gen, n_l, b, h, s, 64)
    kc2, vc2 = kc.clone(), vc.clone()
    pad = None if pads is None else torch.tensor(pads, dtype=torch.int32,
                                                 device="cuda")
    p = (torch.tensor([pos], dtype=torch.int32, device="cuda")
         if pos_on_device else pos)
    before = self_attention.launches
    got = self_attention.self_attend_step(q, kn, vn, kc, vc, 2, p, pad)
    assert self_attention.launches == before + 1
    want = self_attention.self_attend_step_plain(q, kn, vn, kc2, vc2, 2, pos,
                                                 pad)
    _assert_close(got, want)
    assert torch.equal(kc, kc2) and torch.equal(vc, vc2)
    assert torch.equal(kc[2, :, :, pos], kn) and torch.equal(vc[2, :, :, pos],
                                                              vn)


def test_b3_pos_tensor_is_bitwise_the_int_and_out_of_range_is_nan(gen):
    """The two forms of ``pos`` give the same bits; a ``pos`` tensor of S or
    of -1 leaves both caches as they were and returns NaN (the wrapper
    refuses such an int); a tensor of another type or place is refused."""
    n_l, b, h, s = 2, 4, 8, 132
    q = _randn(gen, b, h, 64, scale=0.125)
    kn, vn = _randn(gen, b, h, 64), _randn(gen, b, h, 64)
    kc, vc = _randn(gen, n_l, b, h, s, 64), _randn(gen, n_l, b, h, s, 64)
    pad = torch.tensor([0, 2, 0, 9], dtype=torch.int32, device="cuda")
    for pos in (9, 70, 131):
        a, a2 = [x.clone() for x in (kc, vc)], [x.clone() for x in (kc, vc)]
        p = torch.tensor([pos], dtype=torch.int32, device="cuda")
        got = self_attention.self_attend_step(q, kn, vn, *a, 1, pos, pad)
        got2 = self_attention.self_attend_step(q, kn, vn, *a2, 1, p, pad)
        torch.cuda.synchronize()
        assert torch.equal(got, got2)
        assert torch.equal(a[0], a2[0]) and torch.equal(a[1], a2[1])
    for bad in (s, -1):
        a = [x.clone() for x in (kc, vc)]
        p = torch.tensor([bad], dtype=torch.int32, device="cuda")
        got = self_attention.self_attend_step(q, kn, vn, *a, 1, p, pad)
        torch.cuda.synchronize()
        assert torch.isnan(got.float()).all()
        assert torch.equal(a[0], kc) and torch.equal(a[1], vc)
        with pytest.raises(ValueError, match="outside the cache"):
            self_attention.self_attend_step(q, kn, vn, *a, 1, bad, pad)
    for p in (torch.tensor([3], dtype=torch.int64, device="cuda"),
              torch.tensor([3], dtype=torch.int32),
              torch.tensor([3, 4], dtype=torch.int32, device="cuda")):
        with pytest.raises(ValueError, match="pos: a tensor"):
            self_attention.self_attend_step(q, kn, vn, kc, vc, 1, p, pad)


def test_b3_launches_one_device_operation(gen):
    """With and without ``pad_count``, with ``pos`` in either form, the
    wrapper's launch is all it puts on the card."""
    n_l, b, h, s = 2, 16, 8, 132
    q = _randn(gen, b, h, 64, scale=0.125)
    kn, vn = _randn(gen, b, h, 64), _randn(gen, b, h, 64)
    kc, vc = _randn(gen, n_l, b, h, s, 64), _randn(gen, n_l, b, h, s, 64)
    pad = torch.zeros(b, dtype=torch.int32, device="cuda")
    p = torch.tensor([70], dtype=torch.int32, device="cuda")
    for pos, pads in ((70, None), (70, pad), (p, None), (p, pad)):
        ops = _device_ops(lambda: self_attention.self_attend_step(
            q, kn, vn, kc, vc, 1, pos, pads))
        assert sum(ops.values()) == 3 and len(ops) == 1, ops


def _cross_cache(gen, n_l, b, h, s):
    k8 = torch.randint(-127, 128, (n_l, b, h, s, 64), generator=gen,
                       device="cuda", dtype=torch.int8)
    v8 = torch.randint(-127, 128, (n_l, b, h, s, 64), generator=gen,
                       device="cuda", dtype=torch.int8)
    ks = torch.rand(n_l, b, h, generator=gen, device="cuda") * 0.02 + 1e-3
    vs = torch.rand(n_l, b, h, generator=gen, device="cuda") * 0.02 + 1e-3
    return k8, v8, ks, vs


@pytest.mark.parametrize("b,h", [(1, 6), (3, 8), (16, 8)])
@pytest.mark.parametrize("s,s_valid", [(96, 96), (192, 192), (193, 193),
                                       (1500, 1500), (1501, 1501),
                                       (1504, 1500), (2000, 1900)])
def test_b4_kernel_matches_plain(gen, s, s_valid, b, h):
    """One segment of 192 rows, exactly one, one row more, eight (the last
    one short), an odd S (a row is 64 bytes, so every segment's bulk copy
    is a multiple of 16 bytes on a 16-byte boundary whatever S is), a masked
    tail, and more segments than a cluster has blocks (S = 2000: eleven, so
    three blocks walk two)."""
    n_l = 2
    q = _randn(gen, b, h, 64, scale=0.125)
    k8, v8, ks, vs = _cross_cache(gen, n_l, b, h, s)
    before = cross_attention.launches
    got = cross_attention.cross_attend_step(q, k8, v8, ks, vs, 1,
                                            s_valid=s_valid)
    assert cross_attention.launches == before + 1
    _assert_close(got, cross_attention.cross_attend_step_plain(
        q, k8, v8, ks, vs, 1, s_valid=s_valid))
    again = cross_attention.cross_attend_step(q, k8, v8, ks, vs, 1,
                                              s_valid=s_valid)
    assert torch.equal(got, again)


def test_b4_launches_one_device_operation(gen):
    """The wrapper's launch is all it puts on the card: the kernel quantizes
    q and combines the scales itself."""
    q = _randn(gen, 16, 8, 64, scale=0.125)
    k8, v8, ks, vs = _cross_cache(gen, 2, 16, 8, 1500)
    ops = _device_ops(lambda: cross_attention.cross_attend_step(
        q, k8, v8, ks, vs, 1, s_valid=1500))
    assert sum(ops.values()) == 3 and len(ops) == 1, ops


def test_b4_quantizes_q_as_quantize_q_does(gen):
    """The kernel's q quantization against ``quantize_q``, read from the
    output.  Per head q has one dominant element (-127 s, s a power of two,
    so the scale is s exactly) and ties (n + 0.5) s elsewhere, which only a
    true division and round-half-to-even send to the even neighbour.  K8 row
    r is the unit vector of column r and V8 row r likewise, so scores are
    q8[r] / 2 and out[r] is proportional to p8[r] = rint(127 e^((q8[r] -
    max) / 2)): levels far from any tie, a different level for each q8.  The
    plain version (``quantize_q``) on the same tensors must give the same
    output; the same arithmetic fed q8 rounded half away from zero must
    not."""
    b, h, s = 2, 8, 64
    n = torch.randint(0, 7, (b, h, 64), generator=gen, device="cuda")
    sc = 2.0 ** -torch.randint(5, 9, (b, h, 1), generator=gen, device="cuda")
    q = (n + 0.5) * sc
    q[:, :, 63] = -127.0 * sc[..., 0]
    q = q.to(BF)
    eye = torch.eye(64, device="cuda", dtype=torch.int8)
    k8 = eye.expand(1, b, h, s, 64).contiguous()
    v8 = k8.clone()
    ks = (0.5 / sc[..., 0])[None].contiguous()
    vs = torch.ones(1, b, h, device="cuda")
    q8, qs = cross_attention.quantize_q(q)
    assert torch.equal(qs, sc[..., 0]) and bool((q8[..., :63] % 2 == 0).all())
    got = cross_attention.cross_attend_step(q, k8, v8, ks, vs, 0, s_valid=s)
    want = cross_attention.cross_attend_step_plain(q, k8, v8, ks, vs, 0,
                                                   s_valid=s)
    _assert_close(got, want, steps=0.51)
    # the same arithmetic on q8 rounded half away from zero (n + 1
    # everywhere) lands far from the kernel's output
    away = (n + 1).float()
    away[:, :, 63] = -127.0
    e = torch.exp((away - away.amax(-1, keepdim=True)) * 0.5)
    wrong = torch.round(127.0 * e) / (127.0 * e.sum(-1, keepdim=True))
    moved = (got.float() - wrong).abs() > 4 * 2.0 ** -8 * wrong.abs()
    assert float(moved[..., :63].float().mean()) > 0.25


def test_b4_takes_a_layer_slice_off_the_16_byte_grid(gen):
    """Six heads at bucket 1 (whisper-tiny as a draft): layer 1's slice of
    the [L, B, H] scales starts 24 bytes in; the kernel reads one scale a
    block and takes it."""
    n_l, b, h, s = 3, 1, 6, 200
    q = _randn(gen, b, h, 64, scale=0.125)
    k8, v8, ks, vs = _cross_cache(gen, n_l, b, h, s)
    assert vs[1].data_ptr() % 16
    _assert_close(
        cross_attention.cross_attend_step(q, k8, v8, ks, vs, 1, s_valid=s),
        cross_attention.cross_attend_step_plain(q, k8, v8, ks, vs, 1,
                                                s_valid=s))


@pytest.mark.parametrize("b,h", [(3, 8), (16, 8), (1, 6)])
@pytest.mark.parametrize("s,s_valid", [(1500, 1500), (1500, 1001), (96, 96),
                                       (192, 192), (193, 193), (1504, 1500),
                                       (2000, 1999)])
def test_b6_kernel_matches_plain(gen, s, s_valid, b, h):
    """B6's cluster at its segment edges: one segment short and exactly
    one (a cluster of one block), one row more, eight with the last 156
    rows, a masked tail, and eleven segments (three blocks of the cluster
    own two); at bucket 1 with six heads, layer 1's slice of the scales
    starts 24 bytes in (off the 16-byte grid).  Two calls bitwise equal."""
    n_l = 2
    q = _randn(gen, b, h, 64, scale=0.125)
    k8, v8, ks, vs = _cross_cache(gen, n_l, b, h, s)
    before = cross_attention.dequant_launches
    got = cross_attention.cross_attend_step_dequant(q, k8, v8, ks, vs, 1,
                                                    s_valid=s_valid)
    assert cross_attention.dequant_launches == before + 1
    _assert_close(got, cross_attention.cross_attend_step_dequant_plain(
        q, k8, v8, ks, vs, 1, s_valid=s_valid))
    again = cross_attention.cross_attend_step_dequant(q, k8, v8, ks, vs, 1,
                                                      s_valid=s_valid)
    assert torch.equal(got, again)


@pytest.mark.parametrize("multi", [False, "dequant", "int8"])
def test_b6_and_b7_dequant_launch_one_device_operation(gen, multi):
    """B6's and B7's wrappers (B7-dq and B7-i8) put their kernel on the card
    and nothing else (torch.profiler)."""
    k8, v8, ks, vs = _cross_cache(gen, 2, 16, 8, 1500)
    if multi:
        q = _randn(gen, 16, 5, 8, 64, scale=0.125)

        def call():
            return cross_attention.cross_attend_multi(
                q, k8, v8, ks, vs, 1, s_valid=1500,
                int8_mxu=multi == "int8")
    else:
        q = _randn(gen, 16, 8, 64, scale=0.125)

        def call():
            return cross_attention.cross_attend_step_dequant(
                q, k8, v8, ks, vs, 1, s_valid=1500)
    ops = _device_ops(call)
    assert sum(ops.values()) == 3 and len(ops) == 1, ops


@pytest.mark.parametrize("frames,n_mels,wire", [
    (1, 80, "float32"), (257, 128, "int16"), (257, 80, "float32"),
    (7680, 80, "int16"), (30000, 128, "float32")])
def test_b5_kernel_matches_plain(gen, frames, n_mels, wire):
    """Reflect-padded noise-and-tone audio, the last 5% of the frame
    capacity past the signal (zero samples, zeroed frames)."""
    disable_tf32()
    rng = np.random.default_rng(frames)
    valid = max(1, frames - frames // 20)
    n = valid * golden.HOP
    t = np.arange(n) / 16000.0
    audio = (0.3 * np.sin(2 * np.pi * 440 * t)
             + 0.05 * rng.standard_normal(n)).astype(np.float32)
    padded = golden.reflect_pad(audio)
    if wire == "int16":
        padded = np.round(np.clip(padded, -1, 1) * 32767.0).astype(np.int16)
    x = torch.from_numpy(padded).cuda()
    before = log_mel.launches
    got = log_mel.log_mel(x, valid, n_mels=n_mels, n_frames=frames)
    assert log_mel.launches == before + 1
    want = log_mel.log_mel_plain(x, valid, n_mels=n_mels, n_frames=frames)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (n_mels, frames)
    assert torch.isfinite(got).all()
    err = float((got - want).abs().max())
    assert err <= 1e-4, err
    assert bool((got[:, valid:] == 0).all())


@pytest.mark.parametrize("pos,pads", [(70, [0, 5, 70, 1]), (0, [0, 0, 0, 0]),
                                      (131, [3, 0, 131, 130])])
def test_b8_kernel_matches_plain_and_inserts_in_place(gen, pos, pads):
    """The int8 rows and the scales of the inserted row equal the plain
    version's bit for bit (a true division, ties to even); ctx within 2
    bf16 steps (the sums of e and the exp differ in the last place, which
    can move a p8 by one)."""
    n_l, b, h, s = 3, 4, 6, 132
    q = _randn(gen, b, h, 64, scale=0.125)
    kn, vn = _randn(gen, b, h, 64), _randn(gen, b, h, 64)
    k8, v8, ks, vs = self_attention.quantize_self_cache(
        _randn(gen, n_l, b, h, s, 64), _randn(gen, n_l, b, h, s, 64))
    mine = [t.clone() for t in (k8, v8, ks, vs)]
    pad = torch.tensor(pads, dtype=torch.int32, device="cuda")
    before = self_attention.int8_launches
    got = self_attention.self_attend_step_int8(q, kn, vn, *mine, 2, pos, pad)
    assert self_attention.int8_launches == before + 1
    want = self_attention.self_attend_step_int8_plain(q, kn, vn, k8, v8, ks,
                                                      vs, 2, pos, pad)
    _assert_close(got, want)
    for a, b_ in zip(mine, (k8, v8, ks, vs)):
        assert torch.equal(a, b_)
    kn8, kns = self_attention.quant_rows(kn)
    assert torch.equal(mine[0][2, :, :, pos], kn8)
    assert torch.equal(mine[2][2, :, :, pos], kns)


def _b8_inputs(gen, n_l, b, h, s):
    q = _randn(gen, b, h, 64, scale=0.125)
    kn, vn = _randn(gen, b, h, 64), _randn(gen, b, h, 64)
    bufs = self_attention.quantize_self_cache(
        _randn(gen, n_l, b, h, s, 64), _randn(gen, n_l, b, h, s, 64))
    return q, kn, vn, bufs


@pytest.mark.parametrize("s", [131, 132, 448])
@pytest.mark.parametrize("mixed_pads", [False, True])
def test_b8_pos_tensor_is_bitwise_the_int_at_every_edge(gen, s, mixed_pads):
    """At pos 0, 70 and S - 1, with mixed pads or none (a null pointer), in
    caches of 131 rows (the scale planes off the 16-byte grid), 132 and 448
    (more shared memory than a launch gets unasked): ``pos`` as an int and
    as a tensor give the same output and buffers bit for bit, the four
    buffers equal the plain version's bit for bit, ctx within 2 bf16 steps
    of it."""
    n_l, b, h = 3, 4, 6
    q, kn, vn, bufs = _b8_inputs(gen, n_l, b, h, s)
    for pos in (0, 70, s - 1):
        pad = (torch.tensor([0, min(5, pos), pos, pos // 3], dtype=torch.int32,
                            device="cuda") if mixed_pads else None)
        copies = [[x.clone() for x in bufs] for _ in range(3)]
        pos_t = torch.tensor([pos], dtype=torch.int32, device="cuda")
        before = self_attention.int8_launches
        got = self_attention.self_attend_step_int8(q, kn, vn, *copies[0], 1,
                                                   pos, pad)
        got_t = self_attention.self_attend_step_int8(q, kn, vn, *copies[1], 1,
                                                     pos_t, pad)
        assert self_attention.int8_launches == before + 2
        want = self_attention.self_attend_step_int8_plain(
            q, kn, vn, *copies[2], 1, pos_t, pad)
        _assert_close(got, want)
        assert torch.equal(got, got_t)
        for a, b_, c in zip(*copies):
            assert torch.equal(a, b_) and torch.equal(a, c)


def test_b8_pos_outside_the_cache_writes_nothing_and_gives_nan(gen):
    """A ``pos`` tensor of S or of -1 leaves the four buffers as they were
    and returns NaN (the wrapper refuses such an int); a tensor of another
    type or place is refused."""
    n_l, b, h, s = 2, 4, 8, 131
    q, kn, vn, bufs = _b8_inputs(gen, n_l, b, h, s)
    pad = torch.tensor([0, 2, 0, 9], dtype=torch.int32, device="cuda")
    for bad in (s, -1):
        a = [x.clone() for x in bufs]
        p = torch.tensor([bad], dtype=torch.int32, device="cuda")
        got = self_attention.self_attend_step_int8(q, kn, vn, *a, 1, p, pad)
        torch.cuda.synchronize()
        assert torch.isnan(got.float()).all()
        assert all(torch.equal(x, y) for x, y in zip(a, bufs))
        with pytest.raises(ValueError, match="outside the cache"):
            self_attention.self_attend_step_int8(q, kn, vn, *a, 1, bad, pad)
    for p in (torch.tensor([3], dtype=torch.int64, device="cuda"),
              torch.tensor([3], dtype=torch.int32),
              torch.tensor([3, 4], dtype=torch.int32, device="cuda")):
        with pytest.raises(ValueError, match="pos: a tensor"):
            self_attention.self_attend_step_int8(q, kn, vn, *bufs, 1, p, pad)


def test_b8_launches_one_device_operation(gen):
    """With and without ``pad_count``, with ``pos`` in either form, the
    wrapper's launch is all it puts on the card: no zero ``pad_count`` is
    made."""
    n_l, b, h, s = 2, 16, 8, 132
    q, kn, vn, bufs = _b8_inputs(gen, n_l, b, h, s)
    pad = torch.zeros(b, dtype=torch.int32, device="cuda")
    p = torch.tensor([70], dtype=torch.int32, device="cuda")
    for pos, pads in ((70, None), (70, pad), (p, None), (p, pad)):
        ops = _device_ops(lambda: self_attention.self_attend_step_int8(
            q, kn, vn, *bufs, 1, pos, pads))
        assert sum(ops.values()) == 3 and len(ops) == 1, ops


def test_b8_replays_in_a_cuda_graph(gen):
    """One step captured in a CUDA graph with ``pos`` a device tensor and
    replayed at other positions (the tensor and new q, k_new, v_new copied
    in): each replay's output and buffers equal an eager call's at that
    position bit for bit."""
    n_l, b, h, s = 2, 16, 8, 132
    q, kn, vn, bufs = _b8_inputs(gen, n_l, b, h, s)
    eager_bufs = [x.clone() for x in bufs]
    pos_t = torch.tensor([0], dtype=torch.int32, device="cuda")
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):   # built and warm before the capture
        self_attention.self_attend_step_int8(
            q, kn, vn, *[x.clone() for x in bufs], 1, pos_t)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = self_attention.self_attend_step_int8(q, kn, vn, *bufs, 1,
                                                        pos_t)
    for pos in (3, 4, 70, 131):
        fresh = [_randn(gen, b, h, 64, scale=sc) for sc in (0.125, 1.0, 1.0)]
        for x, y in zip((q, kn, vn), fresh):
            x.copy_(y)
        pos_t.fill_(pos)
        graph.replay()
        eager = self_attention.self_attend_step_int8(*fresh, *eager_bufs, 1,
                                                     pos)
        torch.cuda.synchronize()
        assert torch.equal(captured, eager)
        assert all(torch.equal(x, y) for x, y in zip(bufs, eager_bufs))


def _b5_wire(valid, wire, seed):
    rng = np.random.default_rng(seed)
    n = valid * golden.HOP
    t = np.arange(n) / 16000.0
    audio = (0.3 * np.sin(2 * np.pi * 440 * t)
             + 0.05 * rng.standard_normal(n)).astype(np.float32)
    padded = golden.reflect_pad(audio)
    if wire == "int16":
        padded = np.round(np.clip(padded, -1, 1) * 32767.0).astype(np.int16)
    return torch.from_numpy(padded).cuda()


@pytest.mark.parametrize("valid,n_frames", [
    (1, 3000), (16, 3000), (17, 3000), (3000, 3000), (1, 12000),
    (16, 12000), (17, 12000), (3000, 12000), (7680, 12000)])
@pytest.mark.parametrize("n_mels", [80, 128])
@pytest.mark.parametrize("wire", ["int16", "float32"])
def test_b5_edges_match_plain_and_repeat(gen, valid, n_frames, n_mels, wire):
    """One valid frame, a tile of 16 and one frame more, a whole bucket of
    3,000 and the one-shot limit of 7,680 in a bucket of 12,000, both wires,
    80 and 128 mels: within 1e-4 of the plain version on the normalized
    mel, or, where the plain version itself stands farther than 1e-4 from
    its function evaluated in float64 (``log_mel_float64``: cuBLAS orders
    its fp32 sums by the shape), within 1e-4 of that; the frames past
    ``valid`` exactly 0; two calls bitwise equal; the spectrum kernel alone
    (``log_spec``) normalized as the plain version normalizes gives the
    call's output bit for bit."""
    disable_tf32()
    x = _b5_wire(valid, wire, valid + n_frames)
    got = log_mel.log_mel(x, valid, n_mels=n_mels, n_frames=n_frames)
    want = log_mel.log_mel_plain(x, valid, n_mels=n_mels, n_frames=n_frames)
    again = log_mel.log_mel(x, valid, n_mels=n_mels, n_frames=n_frames)
    exact = log_mel.log_mel_float64(x, valid, n_mels, n_frames)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (n_mels, n_frames)
    assert torch.isfinite(got).all()
    err, err64, plain64 = (float((a - b).abs().max())
                           for a, b in ((got, want), (got, exact),
                                        (want, exact)))
    assert err <= 1e-4 or (plain64 > 1e-4 and err64 <= 1e-4), (
        err, err64, plain64)
    assert bool((got[:, valid:] == 0).all())
    assert torch.equal(got, again)
    raw = log_mel.log_spec(x, n_mels, n_frames, valid)
    assert torch.equal(normalize(raw, raw[:, :valid].amax(), valid), got)
    assert bool((raw[:, valid:] == 0).all())


def test_b5_launches_its_two_kernels(gen):
    """A call puts the spectrum kernel and the normalization kernel on the
    card and nothing else."""
    x = _b5_wire(7680, "int16", 0)
    ops = _device_ops(lambda: log_mel.log_mel(x, 7680, n_mels=80,
                                              n_frames=12000))
    assert sum(ops.values()) == 6 and len(ops) == 2, ops
    assert any("mel_spectrum_kernel" in k for k in ops), ops
    assert any("mel_normalize_kernel" in k for k in ops), ops


@pytest.mark.parametrize("rows,d", [(1, 512), (1499, 512), (24000, 512),
                                    (1499, 1024), (77, 384), (130, 1280),
                                    (1, 128), (257, 128), (1501, 768)])
def test_b9a_kernel_matches_plain(gen, rows, d):
    args = (_randn(gen, 1, rows, d), 1.0 + _randn(gen, d, scale=0.1),
            _randn(gen, d, scale=0.1), _randn(gen, d, 3 * d, scale=0.04),
            _randn(gen, 3 * d, scale=0.1))
    before = encoder_block.ln_qkv_launches
    got = encoder_block.fused_ln_qkv(*args)
    assert encoder_block.ln_qkv_launches == before + 1
    assert got.shape == (1, rows, 3 * d)
    _assert_close(got, encoder_block.fused_ln_qkv_plain(*args))


def _b9b_args(gen, rows, d):
    f = 4 * d
    return (_randn(gen, 1, rows, d), _randn(gen, 1, rows, d),
            _randn(gen, d, d, scale=0.04), _randn(gen, d, scale=0.1),
            1.0 + _randn(gen, d, scale=0.1), _randn(gen, d, scale=0.1),
            _randn(gen, d, f, scale=0.04), _randn(gen, f, scale=0.1),
            _randn(gen, f, d, scale=0.04), _randn(gen, d, scale=0.1))


@pytest.mark.parametrize("rows,d", [(1, 512), (1499, 512), (24000, 512),
                                    (77, 384), (130, 768), (1, 128),
                                    (257, 128), (1, 384), (1501, 768)])
def test_b9b_kernel_matches_plain(gen, rows, d):
    args = _b9b_args(gen, rows, d)
    before = encoder_block.out_mlp_launches
    got = encoder_block.fused_out_mlp(*args)
    assert encoder_block.out_mlp_launches == before + 1
    _assert_close(got, encoder_block.fused_out_mlp_plain(*args))


@pytest.mark.parametrize("which", ["B9a", "B9b"])
def test_b9_two_calls_are_bitwise_equal_and_launch_their_kernels(gen, which):
    """No sum of B9a's or B9b's products depends on timing: two calls give
    the same bits.  B9a puts its two kernels on the card a call, B9b its
    four, each under a name of its own."""
    if which == "B9a":
        d = 512
        args = (_randn(gen, 1, 1499, d), 1.0 + _randn(gen, d, scale=0.1),
                _randn(gen, d, scale=0.1), _randn(gen, d, 3 * d, scale=0.04),
                _randn(gen, 3 * d, scale=0.1))
        call, want = encoder_block.fused_ln_qkv, ("qkv_ln_kernel", "QkvBias")
    else:
        args = _b9b_args(gen, 1499, 512)
        call = encoder_block.fused_out_mlp
        want = ("OutProjResidual", "out_ln_kernel", "OutFc1Gelu",
                "OutFc2Residual")
    assert torch.equal(call(*args), call(*args))
    ops = _device_ops(lambda: call(*args))
    assert sum(ops.values()) == 3 * len(want), ops
    for fn in want:
        assert sum(n for k, n in ops.items() if fn in k) == 3, (fn, ops)


def test_b9_wrappers_raise_on_a_misaligned_or_strided_operand(gen):
    """A CUDA operand the kernels cannot read in vectors (off the 16-byte
    grid, or not contiguous) raises; nothing falls back to the plain
    version."""
    d = 512
    qkv = [_randn(gen, 1, 64, d), 1.0 + _randn(gen, d, scale=0.1),
           _randn(gen, d, scale=0.1), _randn(gen, d, 3 * d, scale=0.04),
           _randn(gen, 3 * d, scale=0.1)]
    out_mlp = list(_b9b_args(gen, 64, d))
    before = (encoder_block.ln_qkv_launches, encoder_block.out_mlp_launches)
    for call, args in ((encoder_block.fused_ln_qkv, qkv),
                       (encoder_block.fused_out_mlp, out_mlp)):
        x = args[0]
        flat = torch.empty(x.numel() + 8, dtype=BF, device="cuda")
        off = flat[1:1 + x.numel()].view(x.shape)   # 2 bytes off the grid
        off.copy_(x)
        with pytest.raises(ValueError, match="16-byte"):
            call(off, *args[1:])
        i = 3 if call is encoder_block.fused_ln_qkv else 2  # a weight
        strided = args[i].T.contiguous().T     # same shape, transposed
        bad = args[:i] + [strided] + args[i + 1:]
        with pytest.raises(ValueError, match="contiguous"):
            call(*bad)
    assert (encoder_block.ln_qkv_launches,
            encoder_block.out_mlp_launches) == before


@pytest.mark.parametrize("b,d", [(1, 512), (16, 512), (17, 512), (5, 1024),
                                 (33, 384), (17, 1280)])
def test_b10c_kernel_matches_plain(gen, b, d):
    """One row, one tile of 16, two tiles (17), whisper-medium's and
    whisper-large's widths (f = 5,120: FC1's 320 blocks, FC2's quarters of
    1,280); two calls bitwise equal (no atomics, one order of every sum)."""
    f = 4 * d
    ln = torch.stack([1.0 + _randn(gen, d, scale=0.1),
                      _randn(gen, d, scale=0.1)])
    args = (_randn(gen, b, d), ln, _randn(gen, d, f, scale=0.04),
            _randn(gen, 1, f, scale=0.1), _randn(gen, f, d, scale=0.04),
            _randn(gen, 1, d, scale=0.1))
    before = decoder_kernels.launches
    got = decoder_kernels.mlp_block(*args)
    assert decoder_kernels.launches == before + 1
    _assert_close(got, decoder_kernels.mlp_block_plain(*args))
    assert torch.equal(got, decoder_kernels.mlp_block(*args))


@pytest.mark.parametrize("b,d", [(16, 512), (17, 1280)])
def test_b10c_replays_in_a_cuda_graph(gen, b, d):
    """FC2 is a programmatic dependent launch of FC1: captured in a CUDA
    graph and replayed (new inputs copied into the captured ones), the
    output equals the eager call's bitwise."""
    f = 4 * d
    ln = torch.stack([1.0 + _randn(gen, d, scale=0.1),
                      _randn(gen, d, scale=0.1)])
    args = [_randn(gen, b, d), ln, _randn(gen, d, f, scale=0.04),
            _randn(gen, 1, f, scale=0.1), _randn(gen, f, d, scale=0.04),
            _randn(gen, 1, d, scale=0.1)]
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        decoder_kernels.mlp_block(*args)   # built and warm before capture
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = decoder_kernels.mlp_block(*args)
    fresh = _randn(gen, b, d)
    args[0].copy_(fresh)
    graph.replay()
    torch.cuda.synchronize()
    eager = decoder_kernels.mlp_block(fresh, *args[1:])
    assert torch.equal(captured, eager)
    _assert_close(captured, decoder_kernels.mlp_block_plain(fresh, *args[1:]))


@pytest.mark.parametrize("int8_mxu", [True, False])
@pytest.mark.parametrize("t,s,s_valid,b,h", [
    (1, 1500, 1500, 2, 8), (5, 1500, 1500, 3, 6), (9, 1504, 1500, 1, 8),
    (3, 96, 96, 2, 2), (2, 2000, 1999, 1, 2), (17, 1500, 1500, 2, 8),
    (17, 2000, 1999, 1, 6), (8, 193, 193, 2, 4), (1, 2000, 384, 1, 8),
    (5, 1731, 1731, 2, 8), (5, 2000, 1999, 3, 6)])
def test_b7_queries_are_bitwise_the_single_token_kernels(gen, t, s, s_valid,
                                                         b, h, int8_mxu):
    """Every query of B7 bit for bit what B4 (int8_mxu) or B6 gives for it:
    both kernels with T past one chunk of eight queries (9, 17), exactly one
    chunk (8), at one segment short, one row past one, eight and eleven
    segments (S = 1,731 to 2,000: three blocks own two), with masked tails;
    and the whole within 2 bf16 steps of the plain version."""
    n_l = 2
    q = _randn(gen, b, t, h, 64, scale=0.125)
    k8 = torch.randint(-127, 128, (n_l, b, h, s, 64), generator=gen,
                       device="cuda", dtype=torch.int8)
    v8 = torch.randint(-127, 128, (n_l, b, h, s, 64), generator=gen,
                       device="cuda", dtype=torch.int8)
    ks = torch.rand(n_l, b, h, generator=gen, device="cuda") * 0.02 + 1e-3
    vs = torch.rand(n_l, b, h, generator=gen, device="cuda") * 0.02 + 1e-3
    before = cross_attention.multi_launches
    got = cross_attention.cross_attend_multi(q, k8, v8, ks, vs, 1,
                                             s_valid=s_valid,
                                             int8_mxu=int8_mxu)
    assert cross_attention.multi_launches == before + 1
    one = cross_attention.cross_attend_step if int8_mxu \
        else cross_attention.cross_attend_step_dequant
    for i in range(t):
        assert torch.equal(got[:, i], one(q[:, i].contiguous(), k8, v8, ks,
                                          vs, 1, s_valid=s_valid))
    _assert_close(got, cross_attention.cross_attend_multi_plain(
        q, k8, v8, ks, vs, 1, s_valid=s_valid, int8_mxu=int8_mxu))


def _block_weights(gen, d, n):
    ln = torch.stack([1.0 + _randn(gen, d, scale=0.1),
                      _randn(gen, d, scale=0.1)])
    return (ln, _randn(gen, d, n, scale=0.04), _randn(gen, 1, n, scale=0.1),
            _randn(gen, d, d, scale=0.04), _randn(gen, 1, d, scale=0.1))


def _pos(pos, form):
    return (torch.tensor([pos], dtype=torch.int32, device="cuda")
            if form == "tensor" else pos)


@pytest.mark.parametrize("pos_form", ["int", "tensor"])
@pytest.mark.parametrize("b,d,s,pos", [
    (16, 512, 132, 70), (1, 512, 132, 0), (5, 384, 40, 39),
    (33, 1280, 448, 300), (16, 512, 137, 136), (17, 768, 132, 131),
    (5, 1024, 64, 10), (1, 1280, 448, 447), (33, 384, 132, 1)])
def test_b10a_kernel_matches_plain_and_writes_the_cache_bitwise(gen, b, d, s,
                                                                pos,
                                                                pos_form):
    """The output within 2 bf16 steps; both cache buffers bit for bit the
    plain version's (rows > pos and < pos untouched, row pos written), with
    ``pos`` as an int and as a device tensor; two calls bitwise equal."""
    h = d // 64
    x = _randn(gen, b, d)
    w = _block_weights(gen, d, 3 * d)
    ck, cv = _randn(gen, s, b, d), _randn(gen, s, b, d)
    mine, theirs = [ck.clone(), cv.clone()], [ck.clone(), cv.clone()]
    again = [ck.clone(), cv.clone()]
    before = decoder_kernels.self_block_launches
    got, gk, gv = decoder_kernels.self_attn_block(x, *w, *mine,
                                                  _pos(pos, pos_form), h)
    assert decoder_kernels.self_block_launches == before + 1
    assert gk is mine[0] and gv is mine[1]
    want, _, _ = decoder_kernels.self_attn_block_plain(x, *w, *theirs, pos, h)
    _assert_close(got, want)
    for a, b_, orig in zip(mine, theirs, (ck, cv)):
        assert torch.equal(a, b_)
        assert torch.equal(a[:pos], orig[:pos])
        assert torch.equal(a[pos + 1:], orig[pos + 1:])
        assert not torch.equal(a[pos], orig[pos])
    second, _, _ = decoder_kernels.self_attn_block(x, *w, *again,
                                                   _pos(pos, pos_form), h)
    assert torch.equal(got, second)
    assert all(torch.equal(a, b_) for a, b_ in zip(mine, again))


@pytest.mark.parametrize("pos", [-1, 132, 1000])
def test_b10a_pos_outside_the_cache_writes_nothing_and_gives_nan(gen, pos):
    """A device ``pos`` outside [0, S) (the wrapper cannot see it) writes no
    cache row and makes every output NaN; an int there raises."""
    b, d, s = 16, 512, 132
    x = _randn(gen, b, d)
    w = _block_weights(gen, d, 3 * d)
    ck, cv = _randn(gen, s, b, d), _randn(gen, s, b, d)
    mine = [ck.clone(), cv.clone()]
    got, _, _ = decoder_kernels.self_attn_block(x, *w, *mine,
                                                _pos(pos, "tensor"), 8)
    torch.cuda.synchronize()
    assert torch.isnan(got.float()).all()
    assert torch.equal(mine[0], ck) and torch.equal(mine[1], cv)
    with pytest.raises(ValueError, match="outside the cache"):
        decoder_kernels.self_attn_block(x, *w, *mine, pos, 8)


@pytest.mark.parametrize("b,d,t", [
    (16, 512, 1500), (1, 512, 96), (3, 384, 100), (20, 768, 1),
    (2, 1024, 63), (4, 512, 513), (5, 1280, 1731), (17, 512, 1731),
    (33, 384, 1500), (1, 768, 513), (16, 1024, 100), (5, 512, 1),
    (1, 1280, 63)])
def test_b10b_kernel_matches_plain(gen, b, d, t):
    """T a multiple of the 64-key block, not a multiple, one key, fewer key
    blocks than a cluster has blocks (T = 63, 100), a split that leaves a
    short last key block (1,731: three keys); two calls bitwise equal."""
    h = d // 64
    x = _randn(gen, b, d)
    w = _block_weights(gen, d, d)
    ck, cv = _randn(gen, b, h, t, 64), _randn(gen, b, h, t, 64)
    before = decoder_kernels.cross_block_launches
    got = decoder_kernels.cross_attn_block(x, *w, ck, cv, h)
    assert decoder_kernels.cross_block_launches == before + 1
    _assert_close(got, decoder_kernels.cross_attn_block_plain(x, *w, ck, cv,
                                                              h))
    assert torch.equal(got, decoder_kernels.cross_attn_block(x, *w, ck, cv,
                                                             h))


def _b10_call(gen, which, b, d):
    """A B10a (tensor pos) or B10b call on fresh inputs: (call, x, caches
    it writes)."""
    h = d // 64
    x = _randn(gen, b, d)
    if which == "B10a":
        w = _block_weights(gen, d, 3 * d)
        ck, cv = _randn(gen, 132, b, d), _randn(gen, 132, b, d)
        pos = torch.tensor([70], dtype=torch.int32, device="cuda")
        return (lambda: decoder_kernels.self_attn_block(x, *w, ck, cv, pos,
                                                        h)[0]), x, (ck, cv)
    w = _block_weights(gen, d, d)
    ck, cv = _randn(gen, b, h, 1500, 64), _randn(gen, b, h, 1500, 64)
    return (lambda: decoder_kernels.cross_attn_block(x, *w, ck, cv, h)), x, ()


@pytest.mark.parametrize("which", ["B10a", "B10b"])
@pytest.mark.parametrize("b,d", [(16, 512), (17, 1280), (5, 384)])
def test_b10a_b10b_replay_in_a_cuda_graph_in_three_operations(gen, which, b,
                                                              d):
    """Each call puts at most three operations on the card (its three
    kernels, the attention kernel launched as a programmatic dependent of
    the product before it; no copy, no memset), and replays in a captured
    CUDA graph: a new x copied into the captured one gives the eager call's
    output bit for bit, and B10a's cache rows."""
    call, x, caches = _b10_call(gen, which, b, d)
    ops = _device_ops(call, calls=3)
    assert sum(ops.values()) <= 3 * 3, ops   # three calls
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        call()                      # built and warm before capture
    torch.cuda.current_stream().wait_stream(stream)
    saved = [c.clone() for c in caches]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = call()
    x.copy_(_randn(gen, b, d))
    graph.replay()
    torch.cuda.synchronize()
    replayed = [c.clone() for c in caches]
    for c, s_ in zip(caches, saved):
        c.copy_(s_)
    eager = call()
    assert torch.equal(captured, eager)
    assert all(torch.equal(r, c) for r, c in zip(replayed, caches))


def test_speculative_tokens_do_not_depend_on_the_draft(gen):
    """Through the kernels (B4 for the draft's steps, B7 for the verify
    pass) at a small width: a random draft and the main model's own weights
    as draft commit the same tokens, and the second needs fewer rounds."""
    from whisper_tpu_torch.models import convert
    from whisper_tpu_torch.models.registry import WhisperDims
    from whisper_tpu_torch.runtime.session import RuntimeCfg, WhisperSession
    from whisper_tpu_torch.variants.ladder import apply_variant

    dims = WhisperDims(n_mels=80, d_model=128, encoder_layers=2,
                       encoder_heads=2, decoder_layers=2, decoder_heads=2,
                       vocab_size=256, max_source_positions=1500,
                       max_target_positions=64)
    cfg, _ = apply_variant(RuntimeCfg(max_batch=4), "x5")
    params = convert.init_params(dims, seed=0)
    sess = WhisperSession(params, dims, cfg, device="cuda")
    mel = torch.randn(80, 6000, generator=gen, device="cuda")
    args = (mel, [0, 2500, 3000], [3, 5], 24, 2)
    runs = []
    for draft in (convert.init_params(dims, seed=99), params):
        sess.set_draft_model(draft, dims)
        before = cross_attention.multi_launches
        toks = sess.transcribe_from_mel(*args, speculative=True, draft_k=3)
        rounds = sum(r for r, _ in sess.speculative_stats)
        assert cross_attention.multi_launches == before + 2 * rounds
        runs.append((toks, rounds))
    assert (runs[0][0] == runs[1][0]).all()
    assert runs[1][1] <= runs[0][1]


def test_int8_scales_are_true_divisions_on_the_card(gen):
    """A division by the Python number 127.0 becomes, on the card, a product
    with its reciprocal: one place off the true division for some values
    (asserted here on the very absmax values, 131,072 heads, so the test
    shows the fault).  ``quantize_q`` and ``quantize_cross_kv`` divide
    truly (``div127``): on the card they equal their CPU results bit for
    bit, scales and int8 values."""
    from whisper_tpu_torch.models.whisper import KVCache, quantize_cross_kv

    q = torch.randn(16384, 8, 64, generator=gen, device="cuda")
    absmax = q.abs().amax(dim=-1)
    assert not torch.equal((absmax / 127.0).cpu(), absmax.cpu() / 127.0)
    q8, qs = cross_attention.quantize_q(q)
    q8_cpu, qs_cpu = cross_attention.quantize_q(q.cpu())
    assert torch.equal(qs.cpu(), qs_cpu) and torch.equal(q8.cpu(), q8_cpu)

    kv = [torch.randn(16, 128, 64, 4, 64, generator=gen, device="cuda")
          for _ in range(2)]
    absmax = kv[0].abs().amax(dim=(3, 4))
    assert not torch.equal((absmax / 127.0).cpu(), absmax.cpu() / 127.0)
    empty = torch.empty(0)
    got = quantize_cross_kv(KVCache(empty, empty, *kv))
    want = quantize_cross_kv(KVCache(empty, empty, *(x.cpu() for x in kv)))
    for name in ("cross_k", "cross_v", "cross_k_scale", "cross_v_scale"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), name


def test_int8_matmul_is_exact_on_the_card(gen):
    """The W8A8 product (rung x6) at K = 2,048, past the 1,040 where an
    fp32 product stops being exact, and at 3 rows (padded for _int_mm)."""
    from whisper_tpu_torch.variants.quant import int8_matmul

    for m in (3, 1500):
        x = torch.randint(-127, 128, (m, 2048), generator=gen, device="cuda",
                          dtype=torch.int8)
        w = torch.randint(-127, 128, (2048, 512), generator=gen,
                          device="cuda", dtype=torch.int8)
        got = int8_matmul(x, w)
        assert got.dtype == torch.int32 and got.shape == (m, 512)
        assert torch.equal(got.cpu(), int8_matmul(x.cpu(), w.cpu()))


def test_wrappers_raise_on_what_the_kernels_do_not_take(gen):
    """A CUDA tensor reaches its kernel or raises: no plain fallback."""
    q = _randn(gen, 1, 2, 16, 32)  # head_dim 32
    with pytest.raises(ValueError, match="head_dim 64"):
        attention.fused_attention(q, q, q)
    q = _randn(gen, 1, 2, 16, 64)
    with pytest.raises(ValueError, match="dtype"):
        attention.fused_attention(q, q.float(), q)
    with pytest.raises(ValueError, match="contiguous"):
        attention.fused_attention(q, q.transpose(2, 3).contiguous()
                                  .transpose(2, 3), q)
    x = _randn(gen, 1, 4, 200)
    w = _randn(gen, 200, 800)
    with pytest.raises(ValueError, match="d=200"):
        encoder_mlp.fused_encoder_mlp(x, x[0, 0], x[0, 0], w, w[0],
                                      w.T.contiguous(), x[0, 0])
    with pytest.raises(ValueError, match="d=200"):
        encoder_block.fused_ln_qkv(x, x[0, 0], x[0, 0], w, w[0])
    x = _randn(gen, 1, 4, 1024)  # B9b is instantiated up to d=768
    w = _randn(gen, 1024, 1024)
    with pytest.raises(ValueError, match="d=1024"):
        encoder_block.fused_out_mlp(x, x, w, w[0], w[0], w[0], w, w[0], w,
                                    w[0])
    q = _randn(gen, 2, 3, 4, 32)  # B7: head_dim 32
    with pytest.raises(ValueError, match="head_dim 64"):
        cross_attention.cross_attend_multi(q, q, q, q, q, 0, s_valid=1)
    x = _randn(gen, 2, 192)       # B10a, B10b: d no multiple of 128
    with pytest.raises(ValueError, match="multiple of 128"):
        decoder_kernels.self_attn_block(x, x, x, x, x, x, x, x, 0, 3)
    with pytest.raises(ValueError, match="multiple of 128"):
        decoder_kernels.cross_attn_block(x, x, x, x, x, x, x, x, 3)
    with pytest.raises(ValueError, match="d=192"):  # B10c: d no multiple of 64
        decoder_kernels.mlp_block(x, x, x, x, x, x)


# ---------------------------------------------------------------------------
# The decoding options on the card: beam rows, sampling
# ---------------------------------------------------------------------------

def _beam_cache(gen, n_l, b, k, h, s):
    """The int8 cross cache of b rows tiled per beam as ``beam_generate``
    tiles it: [L, B*K, H, S, 64] and scales [L, B*K, H, 1, 1], each beam
    of row r at r*K + j; the kernels take the scales' [..., 0, 0] views."""
    k8, v8, ks, vs = _cross_cache(gen, n_l, b, h, s)
    tiled = [x.repeat_interleave(k, dim=1) for x in (k8, v8)]
    scales = [x[..., None, None].repeat_interleave(k, dim=1)[..., 0, 0]
              for x in (ks, vs)]
    return (k8, v8, ks, vs), (*tiled, *scales)


@pytest.mark.parametrize("dequant", [False, True])
@pytest.mark.parametrize("b,k,h,s", [(16, 4, 8, 1500), (3, 3, 8, 1500),
                                     (16, 4, 6, 193)])
def test_b4_b6_at_beam_rows(gen, b, k, h, s, dequant):
    """B4 (x5) and B6 (x4) at B*K rows against the cache tiled per beam,
    the scales as views of a [L, B*K, H, 1, 1] tensor: each beam's row is
    bitwise the kernel's row on the untiled cache, and the whole within 2
    bf16 steps of the plain version (B4 bitwise at the path's inputs,
    PERF.md)."""
    n_l = 2
    step = cross_attention.cross_attend_step_dequant if dequant \
        else cross_attention.cross_attend_step
    plain = cross_attention.cross_attend_step_dequant_plain if dequant \
        else cross_attention.cross_attend_step_plain
    untiled, tiled = _beam_cache(gen, n_l, b, k, h, s)
    q = _randn(gen, b * k, h, 64, scale=0.125)
    got = step(q, *tiled, 1, s_valid=s)
    _assert_close(got, plain(q, *tiled, 1, s_valid=s))
    for j in range(k):
        rows = torch.arange(b, device="cuda") * k + j
        one = step(q[rows].contiguous(), *untiled, 1, s_valid=s)
        assert torch.equal(got[rows], one), j


def _small_model(seed=0):
    from whisper_tpu_torch.models import convert
    from whisper_tpu_torch.models.registry import WhisperDims

    dims = WhisperDims(n_mels=80, d_model=128, encoder_layers=2,
                       encoder_heads=2, decoder_layers=2, decoder_heads=2,
                       vocab_size=320, max_source_positions=1500,
                       max_target_positions=64)
    tree = convert.params_from_numpy(convert.init_params(dims, seed), "cuda",
                                     BF)
    return dims, tree


def test_sampled_step_with_a_cuda_generator(gen):
    """temperature > 0 through the x5 kernel step: a generator on the card
    repeats its draws per seed, another seed draws others, no suppressed id
    is drawn, and a generator on the CPU is refused by the draw itself."""
    from whisper_tpu_torch.runtime.generate import (
        build_suppress_mask,
        greedy_generate,
    )

    dims, tree = _small_model()
    enc = _randn(gen, 4, 1500, 128)
    suppress = list(range(0, 320, 3))
    mask = torch.from_numpy(build_suppress_mask(320, suppress)).cuda()
    prompt = torch.tensor([250, 252, 253, 254], device="cuda")

    def run(g):
        return greedy_generate(tree, dims, enc, prompt, mask, mask, 16, 251,
                               int8_cross_kv=True, kernel_step=True,
                               temperature=1.0, generator=g,
                               return_logprobs=True)

    a, b, c = (run(torch.Generator(device="cuda").manual_seed(s))
               for s in (7, 7, 8))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert not torch.isin(a[0], torch.tensor(suppress, device="cuda")).any()
    assert torch.isfinite(a[1]).all()
    with pytest.raises(RuntimeError):
        run(torch.Generator().manual_seed(7))


def test_beam_k1_equals_greedy_on_the_same_step(gen):
    """One beam against greedy decoding over the step beam search takes
    (plain self-attention, B4 against the int8 cross cache), on the card:
    the same tokens."""
    from whisper_tpu_torch.models import whisper
    from whisper_tpu_torch.runtime.beam import beam_generate

    dims, tree = _small_model(1)
    enc = _randn(gen, 4, 1500, 128)
    zero = torch.zeros(320, device="cuda")
    prompt = torch.tensor([250, 252, 253, 254], device="cuda")
    toks, _ = beam_generate(tree, dims, enc, prompt, zero, zero, 12, 251, 1,
                            int8_cross_kv=True, packed_cross=True,
                            int8_mxu=True)
    logits, cache = whisper.decoder_prefill(tree, dims, prompt.expand(4, -1),
                                            enc, 16, int8_cross_kv=True)
    want = [logits[:, -1].float().argmax(-1)]
    done = want[0] == 251
    for i in range(1, 12):
        lg, cache = whisper.decoder_step(tree, dims, want[-1], 3 + i, cache,
                                         cross_len=1500, int8_mxu=True)
        nxt = torch.where(done, 251, lg.float().argmax(-1))
        done = done | (nxt == 251)
        want.append(nxt)
    assert torch.equal(toks, torch.stack(want, dim=1))


@pytest.mark.parametrize("int8_self", [False, True], ids=["b3", "b8"])
def test_left_padded_prompt_through_b3_and_b8_gives_the_unpadded_tokens(
        gen, int8_self):
    """A conditioned prompt left-padded to one length (three pad counts
    across rows) through the x5 kernel step (B3, B4) or x7's (B8, B4): each
    row's tokens equal its unpadded prompt's, and every step launched B3
    or B8 with the [B] int32 ``pad_count`` on the card."""
    from whisper_tpu_torch.runtime.generate import greedy_generate

    dims, tree = _small_model(2)
    enc = _randn(gen, 3, 1500, 128)
    prompt = [251] * 4 + [255, 17, 99, 140, 33, 61] + [250, 252, 253, 254]
    pads = [4, 6, 9]
    zero = torch.zeros(320, device="cuda")

    def decode(rows, row_prompt, pad_count=None):
        return greedy_generate(
            tree, dims, enc[rows], torch.tensor(row_prompt, device="cuda"),
            zero, zero, 12, 251, int8_cross_kv=True, kernel_step=True,
            int8_mxu=True, int8_self=int8_self, pad_count=pad_count)

    self_attention.padded_launches = self_attention.int8_padded_launches = 0
    padded = decode([0, 1, 2], prompt,
                    torch.tensor(pads, dtype=torch.int32, device="cuda"))
    launched = (self_attention.int8_padded_launches if int8_self
                else self_attention.padded_launches)
    assert launched > 0 and launched % dims.decoder_layers == 0
    for r, pad in enumerate(pads):
        assert torch.equal(padded[r], decode([r], prompt[pad:])[0]), r


def test_alignment_weights_rows_sum_to_one_on_the_card(gen):
    """The session's teacher-forced alignment pass at x5 on the card (B1 in
    the encoder, plain products after): [L, H, P_pad, T_enc] fp32, every
    row a distribution over the encoder's positions within 1e-3."""
    from whisper_tpu_torch.models import convert
    from whisper_tpu_torch.runtime.session import RuntimeCfg, WhisperSession
    from whisper_tpu_torch.variants.ladder import apply_variant

    dims, _ = _small_model()
    cfg, _ = apply_variant(RuntimeCfg(), "x5")
    sess = WhisperSession(convert.init_params(dims, 3), dims, cfg,
                          device="cuda")
    mel = torch.randn(80, 3000, generator=gen, device="cuda")
    attention.launches = 0
    w = sess.alignment_weights(mel, [250, 252, 253, 254], list(range(5, 26)))
    assert attention.launches == dims.encoder_layers
    assert w.shape == (2, 2, 32, 1500) and w.dtype == np.float32
    assert np.isfinite(w).all() and np.abs(w.sum(-1) - 1.0).max() <= 1e-3


def test_encode_text_raises_its_message_without_tokenizers(gen, tmp_path,
                                                          monkeypatch):
    """Where ``tokenizers`` cannot be imported (hidden here if the card's
    machine has it), encode_text, what --initial-prompt needs, raises its
    message."""
    import builtins

    from whisper_tpu_torch.tokenizer.bpe import encode_text

    real_import = builtins.__import__

    def no_tokenizers(name, *args, **kwargs):
        if name.split(".")[0] == "tokenizers":
            raise ImportError(f"no module named {name!r}")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_tokenizers)
    with pytest.raises(RuntimeError, match="needs the `tokenizers` package"):
        encode_text(str(tmp_path / "tokenizer.json"), "hello")


def test_b3_b8_launch_where_static_and_dynamic_memory_cross_48_kb(gen):
    """B3 at pos 180-190 (dynamic shared memory 47.4-50.0 KB) and B8 at
    340-352, each in order in a fresh process, so that no earlier launch has
    raised the limit: where the dynamic memory fits in 48 KB and the
    kernel's static memory does not, the launch must still go (B3 failed at
    pos 183-186 when only the dynamic bytes were weighed)."""
    import os
    import subprocess
    import sys

    code = """
import torch
from whisper_tpu_torch.ops import self_attention as sa
g = torch.Generator(device="cuda").manual_seed(0)
r = lambda *s: torch.randn(*s, generator=g, device="cuda").to(torch.bfloat16)
pad = torch.tensor([3, 0], dtype=torch.int32, device="cuda")
kc, vc = r(1, 2, 2, 448, 64), r(1, 2, 2, 448, 64)
for pos in range(180, 191):
    sa.self_attend_step(r(2, 2, 64), r(2, 2, 64), r(2, 2, 64), kc, vc, 0,
                        pos, pad)
k8 = torch.zeros((1, 2, 2, 448, 64), dtype=torch.int8, device="cuda")
v8, ks, vs = k8.clone(), torch.ones((1, 2, 2, 448), device="cuda"), \\
    torch.ones((1, 2, 2, 448), device="cuda")
for pos in range(340, 353):
    sa.self_attend_step_int8(r(2, 2, 64), r(2, 2, 64), r(2, 2, 64), k8, v8,
                             ks, vs, 0, pos, pad)
torch.cuda.synchronize()
print("launched", sa.launches, sa.int8_launches)
"""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, cwd=repo)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "launched 11 13" in proc.stdout


def test_b3_b8_two_threads_raise_the_limit_at_once(gen):
    """The serving engine's lanes launch from two threads.  In a fresh
    process (no limit raised yet), two threads launch B3 at once, one
    walking pos 100 and 150-179 (under 48 KB), the other 180-447 (over
    it), then B8 the same way across its edge (250-339 against 340-447),
    each launch 8 times, with a switch interval of a microsecond: no launch
    may fail, every output must be bitwise the same call's alone, and the
    launch counters must count every launch (the lock around `+=`)."""
    import os
    import subprocess
    import sys

    code = """
import sys, threading, torch
from whisper_tpu_torch.ops import self_attention as sa
sys.setswitchinterval(1e-6)
g = torch.Generator(device="cuda").manual_seed(0)
r = lambda *s: torch.randn(*s, generator=g, device="cuda").to(torch.bfloat16)
S, REPS = 448, 8
pad = torch.tensor([3, 0], dtype=torch.int32, device="cuda")
kc, vc = r(1, 2, 2, S, 64), r(1, 2, 2, S, 64)
k8 = torch.randint(-127, 128, (1, 2, 2, S, 64), generator=g, device="cuda",
                   dtype=torch.int8)
v8 = k8.flip(-1).contiguous()
ks = torch.rand((1, 2, 2, S), generator=g, device="cuda") / 64
vs = torch.rand((1, 2, 2, S), generator=g, device="cuda") / 64
qkv = {p: (r(2, 2, 64), r(2, 2, 64), r(2, 2, 64)) for p in range(S)}

def b3(p):
    return sa.self_attend_step(*qkv[p], kc.clone(), vc.clone(), 0, p, pad)

def b8(p):
    return sa.self_attend_step_int8(*qkv[p], k8.clone(), v8.clone(),
                                    ks.clone(), vs.clone(), 0, p, pad)

def race(step, lanes):
    outs, errors = [{} for _ in lanes], []
    start = threading.Barrier(len(lanes))
    def lane(i):
        try:
            start.wait()
            for p in lanes[i]:
                for _ in range(REPS):
                    out = step(p)
                    first = outs[i].setdefault(p, out)
                    if not torch.equal(out, first):
                        errors.append(f"pos {p}: two calls differ")
        except Exception as e:
            errors.append(repr(e))
    threads = [threading.Thread(target=lane, args=(i,))
               for i in range(len(lanes))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive(), "a lane hung"
    torch.cuda.synchronize()
    assert not errors, errors[:5]
    for got in outs:
        for p, out in got.items():
            assert torch.equal(out, step(p)), f"pos {p}: not the lone call"
    return sum(len(lanes[i]) for i in range(len(lanes))) * REPS

n3 = race(b3, [[100] + list(range(150, 180)), list(range(180, S))])
n8 = race(b8, [list(range(250, 340)), list(range(340, S))])
assert sa.launches == n3 + 299, (sa.launches, n3)
assert sa.int8_launches == n8 + 198, (sa.int8_launches, n8)
print("raced", n3, n8)
"""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, cwd=repo)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "raced 2392 1584" in proc.stdout


def test_chunk_norm_on_the_card_zeroes_a_ragged_buckets_padding_rows(gen):
    """The pipelined mode's per-chunk normalization on the card: a bucket
    of 8 with 3 real windows of a raw slab (the last ragged past the valid
    frames) and 5 padding rows that start at the slab's width.  The real
    rows within 1e-6 of a float64 numpy evaluation of the same windows on
    the host; the padding rows all zeros and finite (their max is -inf)."""
    from whisper_tpu_torch.pipeline.chunk import CHUNK_FRAMES
    from whisper_tpu_torch.runtime.session import chunk_norm

    n_frames, n_valid = 7_000, 6_400
    raw = torch.randn(80, n_frames, generator=gen, device="cuda") * 3 - 5
    starts = [0, 2_500, 5_000] + [n_frames] * 5
    mel_pad = torch.nn.functional.pad(raw, (0, CHUNK_FRAMES))
    chunks = torch.stack([mel_pad[:, s:s + CHUNK_FRAMES] for s in starts])
    out = chunk_norm(chunks, starts, n_valid)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert (out[3:] == 0).all()
    host = np.pad(raw.cpu().numpy().astype(np.float64),
                  ((0, 0), (0, CHUNK_FRAMES)))
    for i, s in enumerate(starts[:3]):
        win = host[:, s:s + CHUNK_FRAMES]
        valid = s + np.arange(CHUNK_FRAMES) < n_valid
        want = (np.maximum(win, win[:, valid].max() - 8.0) + 4.0) / 4.0
        want[:, ~valid] = 0.0
        np.testing.assert_allclose(out[i].cpu().numpy(), want, atol=1e-6,
                                   rtol=0)


def test_a_model_dir_written_and_read_without_the_safetensors_package(
        gen, tmp_path):
    """``save_params`` (numpy ``write_safetensors``) and ``load_params``
    (``read_safetensors``) on the card's machine, whisper-base with its
    int8 copy: the tree read back equals the tree written, value for value,
    and on the card through ``params_from_numpy``; the ``safetensors``
    package is never imported."""
    import sys

    from whisper_tpu_torch.models import convert
    from whisper_tpu_torch.models.registry import get_dims
    from whisper_tpu_torch.variants.quant import quantize_params

    dims = get_dims("openai/whisper-base")
    params = convert.init_params(dims, seed=0)
    for name, tree in (("f32", params), ("int8", quantize_params(params))):
        d = str(tmp_path / name)
        convert.save_params(tree, dims, d)
        back, dims2 = convert.load_params(d)
        assert dims2 == dims
        flat, flat_back = convert._flatten(tree), convert._flatten(back)
        assert sorted(flat) == sorted(flat_back)
        for k, v in flat.items():
            assert flat_back[k].dtype == v.dtype
            np.testing.assert_array_equal(flat_back[k], v, err_msg=k)
        on_card = convert.params_from_numpy(back, "cuda", torch.float32)
        w = on_card["decoder"]["blocks"]["fc1_w"]
        w = w.q if hasattr(w, "q") else w
        assert w.is_cuda
    assert "safetensors" not in sys.modules
