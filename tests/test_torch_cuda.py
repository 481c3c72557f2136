"""The port's CUDA kernels (B1-B10c) against their plain versions, on the
card.

These tests need an NVIDIA card and nvcc; elsewhere they skip.  Run them on
the card with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest sets up JAX, which this file does
not use).  ``chip_smoke.py`` checks the kernels at the main path's shapes;
these cover the edges it does not reach: ragged sequence lengths, a
nonzero ``pad_count``, a padded cross cache, the other model widths, the
front end at 1 to 30,000 frames, the upload wires (the card's decode
bitwise the CPU's, B5 under each, a short-lane program a wire) and the
wrappers' refusals.  Tolerance: 2
bf16 steps (2^-7 relative) of each value, the mean magnitude as the floor
near zero; both sides round at the same points, and sum in another order.
The front end (B5, fp32 out) is held to 1e-4 on the normalized mel, the
card-vs-CPU mel bound of ``chip_smoke.py``.
"""

import contextlib

import numpy as np
import pytest
import torch

from whisper_tpu_torch.frontend import golden
from whisper_tpu_torch.frontend.mel import normalize
from whisper_tpu_torch.ops import attention, cross_attention, encoder_mlp
from whisper_tpu_torch.ops import decoder_kernels, encoder_block
from whisper_tpu_torch.ops import log_mel, loop_tail, sampling
from whisper_tpu_torch.ops import self_attention
from whisper_tpu_torch.ops.common import disable_tf32, settle_launches

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


def _device_ops(call, calls=3, traces=3):
    """{operation: count} that ``calls`` calls of ``call`` put on the card,
    by torch.profiler: each operation's largest count over ``traces``
    traces.  The profiler now and then drops events of a short trace (one
    held 2 of 3 launches of a kernel), and now and then records none for a
    whole session; a dropped event can only undercount, so the largest
    count is the one the wrapper launched."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    ops: dict = {}
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                call()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                ops[e.key] = max(ops.get(e.key, 0), e.count)
    return ops


def _device_events(call, traces=4):
    """The device operations (kernels, copies, fills) one call of ``call``
    puts on the card, by torch.profiler, whatever they are named: (the
    largest total over ``traces`` traces; every trace's total).  For eager
    work: late in a long process traces of a graph miss most of the
    graph's kernels, so a graph's operations are read from its nodes
    instead (``_GraphLoop.body_ops``).  A trace now and then holds fewer
    events than the call put there, never more: its first few operations
    go unrecorded (a trace of an eager decode of 24 tokens missed one or
    two of its first fills in 3 of 8 traces, and the same loss in every
    trace of a call once left the largest of five totals 1-3 short).  So
    each trace opens with 32 launches of the library's empty kernel
    (``wt_launch_floor``), not counted, which take the place of the
    operations a trace's start loses, and the largest total is the
    call's."""
    from torch.profiler import ProfilerActivity, profile

    from whisper_tpu_torch.ops import kernels

    lib = kernels.library()
    stream = kernels.stream_ptr(torch.device("cuda"))
    call()
    torch.cuda.synchronize()
    totals = []
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(32):
                kernels.check(lib.wt_launch_floor(stream), "launch_floor")
            torch.cuda.synchronize()
            call()
            torch.cuda.synchronize()
        totals.append(sum(
            e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "empty_kernel" not in e.key))
    return max(totals), totals


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


# ---------------------------------------------------------------------------
# The upload wires: the card's decode, B5 under each, the short lane's keys
# ---------------------------------------------------------------------------

WIRE_ENCODINGS = ("int16", "dint16", "dint16p", "ulaw8", "pcm12", "pcm14")


def _wire_bytes(audio: np.ndarray, mode: str) -> np.ndarray:
    from whisper_tpu_torch.audio.resample import ulaw_encode
    from whisper_tpu_torch.utils.pcmpack import encode_wire

    return ulaw_encode(audio) if mode == "ulaw8" else encode_wire(audio,
                                                                  mode)


def _wire_tag(mode: str) -> str:
    return mode if mode in ("pcm12", "pcm14") else "auto"


@pytest.mark.parametrize("shape", [(160_001,), (3, 30_007)], ids=str)
@pytest.mark.parametrize("mode", WIRE_ENCODINGS)
def test_wire_decode_on_the_card_is_the_cpus_bitwise(gen, mode, shape):
    """The same wire bytes decoded on the card and on the CPU: the same
    float32 bits (the integer wires' products by float32 reciprocals, their
    running sums in int64; ulaw8 by its table)."""
    from whisper_tpu_torch.frontend.mel import decode_transfer

    rng = np.random.default_rng(sum(shape))
    audio = np.clip(rng.normal(0, 0.4, shape), -1.2, 1.2).astype(np.float32)
    host = torch.from_numpy(_wire_bytes(audio, mode))
    want = decode_transfer(host, _wire_tag(mode))
    got = decode_transfer(host.cuda(), _wire_tag(mode))
    torch.cuda.synchronize()
    assert got.device.type == "cuda" and got.dtype == torch.float32
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("valid,n_frames", [(17, 3000), (7680, 12000)])
@pytest.mark.parametrize("mode", WIRE_ENCODINGS + ("float32",))
def test_b5_under_each_wire_matches_plain(gen, mode, valid, n_frames):
    """B5's wrapper given each wire (``transfer`` naming pcm12 and pcm14):
    float32 and int16 straight to its kernels, the others decoded ahead of
    the launch; one launch a call, within 1e-4 of the plain version on the
    same bytes (or of its float64 evaluation where the plain version is
    farther), the invalid frames 0."""
    disable_tf32()
    x = _b5_wire(valid, "float32", valid + 7)
    if mode != "float32":
        x = torch.from_numpy(_wire_bytes(x.cpu().numpy(), mode)).cuda()
    tag = _wire_tag(mode)
    before = log_mel.launches
    got = log_mel.log_mel(x, valid, 80, n_frames, transfer=tag)
    assert log_mel.launches == before + 1
    want = log_mel.log_mel_plain(x, valid, 80, n_frames, transfer=tag)
    exact = log_mel.log_mel_float64(x, valid, 80, n_frames, transfer=tag)
    torch.cuda.synchronize()
    err, err64, plain64 = (float((a - b).abs().max())
                           for a, b in ((got, want), (got, exact),
                                        (want, exact)))
    assert err <= 1e-4 or (plain64 > 1e-4 and err64 <= 1e-4), (
        err, err64, plain64)
    assert bool((got[:, valid:] == 0).all())


def test_short_lane_keys_a_program_per_wire(gen):
    """One session's short lane at bucket 2 under ulaw8 (rows of 12,000
    samples), then pcm12, int16 and dint16 (rows of 8,000): ulaw8 and pcm12
    both ship 2 x 12,000 uint8 bytes, and each wire captures a program of
    its own, whose tokens are its eager run's bitwise; dint16's tokens are
    int16's."""
    import dataclasses

    from whisper_tpu_torch.models import convert
    from whisper_tpu_torch.models.registry import get_dims
    from whisper_tpu_torch.runtime.session import RuntimeCfg, WhisperSession

    dims = get_dims("test/whisper-nano")
    sess = WhisperSession(convert.init_params(dims, seed=0), dims,
                          RuntimeCfg(dtype="float32", max_batch=2),
                          device="cuda")
    rng = np.random.default_rng(5)
    rows = {n: rng.normal(0, 0.2, (2, n)).astype(np.float32)
            for n in (12_000, 8_000)}
    toks = {}
    for mode, n in (("ulaw8", 12_000), ("pcm12", 8_000), ("int16", 8_000),
                    ("dint16", 8_000)):
        sess.cfg = dataclasses.replace(sess.cfg, audio_transfer=mode)
        nv = np.array([n // 160 - 3, n // 320], np.int32)
        keys = len(sess.graphs.captures())
        toks[mode] = sess.transcribe_short_batch(rows[n], nv, [1, 2, 3], 6, 5)
        assert len(sess.graphs.captures()) == keys + 1, mode
        sess.eager_decode = True
        eager = sess.transcribe_short_batch(rows[n], nv, [1, 2, 3], 6, 5)
        sess.eager_decode = False
        np.testing.assert_array_equal(toks[mode], eager)
    assert len({k.front for k in sess.graphs.captures()}) == 4
    np.testing.assert_array_equal(toks["dint16"], toks["int16"])


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
    (5, 1731, 1731, 2, 8), (5, 2000, 1999, 3, 6), (5, 1500, 1500, 16, 20),
    (5, 1504, 1499, 16, 20)])
def test_b7_queries_are_bitwise_the_single_token_kernels(gen, t, s, s_valid,
                                                         b, h, int8_mxu):
    """Every query of B7 bit for bit what B4 (int8_mxu) or B6 gives for it:
    both kernels with T past one chunk of eight queries (9, 17), exactly one
    chunk (8), at one segment short, one row past one, eight and eleven
    segments (S = 1,731 to 2,000: three blocks own two), with masked tails;
    at whisper-large-v3's verify pass (16 rows, 20 heads, T = 5) with all
    1,500 columns valid and with 1,499 of a cache padded to 1,504; and the
    whole within 2 bf16 steps of the plain version."""
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
        rounds = int(sum(r for r, _ in sess.speculative_stats))
        # B7 once a layer and round run: the graphed rounds stop on the
        # card where the last row ends, so every round run is counted
        run = (cross_attention.multi_launches - before) / 2
        assert run == int(run), run
        assert run == rounds, (run, rounds)
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
                                     (16, 4, 6, 193), (16, 2, 20, 1500)])
def test_b4_b6_at_beam_rows(gen, b, k, h, s, dequant):
    """B4 (x5) and B6 (x4) at B*K rows against the cache tiled per beam,
    the scales as views of a [L, B*K, H, 1, 1] tensor: each beam's row is
    bitwise the kernel's row on the untiled cache, and the whole within 2
    bf16 steps of the plain version (B4 bitwise at the path's inputs,
    PERF.md); whisper-large-v3's beam 2 at bucket 16 is 32 rows of 20
    heads."""
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
    is drawn, and a generator on the CPU is refused (its key would have
    no offset)."""
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
    settle_launches(wait=True)      # the graph's bodies that ran
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


# ---------------------------------------------------------------------------
# A tensor-parallel rank's shard (parallel.mesh): 4 of whisper-base's 8 heads
# ---------------------------------------------------------------------------

TP_SHARD = 4      # whisper-base's 8 decoder heads at tensor_parallel 2


def _mesh():
    from whisper_tpu_torch.parallel.mesh import Mesh

    return Mesh(data=1, model=2, model_index=1)


def test_stream_ptr_launches_on_the_tensors_own_card(gen):
    """stream_ptr makes the tensor's card the library's current device
    (index 0 here, and PyTorch's current card for a bare "cuda"), then a
    kernel launches there; where a second card is in sight, B3 launches
    on cuda:1 and agrees with its plain version."""
    from whisper_tpu_torch.ops import kernels

    lib = kernels.library()
    assert kernels.stream_ptr(torch.device("cuda", 0)) == \
        torch.cuda.current_stream(0).cuda_stream
    assert kernels.stream_ptr(torch.device("cuda")) == \
        torch.cuda.current_stream().cuda_stream
    assert lib.wt_set_device(torch.cuda.device_count()) != 0  # no such card
    assert lib.wt_set_device(0) == 0
    # the refusal does not stay behind as the next launch's error
    assert lib.wt_launch_floor(kernels.stream_ptr(torch.device("cuda"))) == 0
    if torch.cuda.device_count() < 2:
        return
    dev = torch.device("cuda", 1)
    q, kn, vn = (_randn(gen, 2, TP_SHARD, 64).to(dev) for _ in range(3))
    kc, vc = (_randn(gen, 2, 2, TP_SHARD, 16, 64).to(dev) for _ in range(2))
    kc2, vc2 = kc.clone(), vc.clone()
    got = self_attention.self_attend_step(q, kn, vn, kc, vc, 1, 5)
    want = self_attention.self_attend_step_plain(q, kn, vn, kc2, vc2, 1, 5)
    assert got.device == dev
    _assert_close(got.to(0), want.to(0))


@pytest.mark.parametrize("pos", [0, 70, 131])
def test_b3_b8_sharded_at_a_tp_shard_of_heads(gen, pos):
    """B3 and B8 through their sharded wrappers on a rank's 4 heads (the
    whisper-base bucket of 16 at tp 2): within 2 bf16 steps of their plain
    versions, the buffers they write bitwise; a shard of the wrong head
    count raises."""
    b, s_max, layers = 16, 132, 6
    q, kn, vn = (_randn(gen, b, TP_SHARD, 64) for _ in range(3))
    kc, vc = (_randn(gen, layers, b, TP_SHARD, s_max, 64) for _ in range(2))
    # a row's pad slots lie before its first real token: at most pos
    pads = torch.randint(0, min(3, pos + 1), (b,), device="cuda",
                         dtype=torch.int32)
    kw = dict(mesh=_mesh(), heads=8)
    k2, v2 = kc.clone(), vc.clone()
    got = self_attention.self_attend_step_sharded(q, kn, vn, kc, vc, 2, pos,
                                                  pads, **kw)
    want = self_attention.self_attend_step_plain(q, kn, vn, k2, v2, 2, pos,
                                                 pads)
    _assert_close(got, want)
    assert torch.equal(kc, k2) and torch.equal(vc, v2)
    k8, v8, ks, vs = self_attention.quantize_self_cache(kc, vc)
    bufs = [t.clone() for t in (k8, v8, ks, vs)]
    got = self_attention.self_attend_step_int8_sharded(
        q, kn, vn, k8, v8, ks, vs, 2, pos, pads, **kw)
    want = self_attention.self_attend_step_int8_plain(q, kn, vn, *bufs, 2,
                                                      pos, pads)
    _assert_close(got, want)
    for a, w in zip((k8, v8, ks, vs), bufs):
        assert torch.equal(a, w)
    with pytest.raises(ValueError, match="heads"):
        self_attention.self_attend_step_sharded(q, kn, vn, kc, vc, 2, pos,
                                                pads, mesh=_mesh(), heads=6)


@pytest.mark.parametrize("int8_mxu", [True, False])
def test_b4_b6_b7_sharded_at_a_tp_shard_of_heads(gen, int8_mxu):
    """B4 (int8_mxu) or B6, and B7 at T = 5, through their sharded
    wrappers on a rank's 4 heads of the bucket of 16: within 2 bf16 steps
    of their plain versions, each B7 query bitwise the single-token
    kernel's."""
    b, s, layers = 16, 1500, 6
    k8 = torch.randint(-127, 128, (layers, b, TP_SHARD, s, 64),
                       device="cuda", dtype=torch.int8, generator=gen)
    v8 = torch.randint(-127, 128, (layers, b, TP_SHARD, s, 64),
                       device="cuda", dtype=torch.int8, generator=gen)
    ks = torch.rand(layers, b, TP_SHARD, device="cuda", generator=gen) * .01
    vs = torch.rand(layers, b, TP_SHARD, device="cuda", generator=gen) * .01
    q = _randn(gen, b, TP_SHARD, 64, scale=0.125)
    kw = dict(mesh=_mesh(), heads=8)
    got = cross_attention.cross_attend_step_sharded(
        q, k8, v8, ks, vs, 3, s_valid=s, int8_mxu=int8_mxu, **kw)
    plain = (cross_attention.cross_attend_step_plain if int8_mxu
             else cross_attention.cross_attend_step_dequant_plain)
    _assert_close(got, plain(q, k8, v8, ks, vs, 3, s_valid=s))
    qm = _randn(gen, b, 5, TP_SHARD, 64, scale=0.125)
    multi = cross_attention.cross_attend_multi_sharded(
        qm, k8, v8, ks, vs, 3, s_valid=s, int8_mxu=int8_mxu, **kw)
    one = (cross_attention.cross_attend_step if int8_mxu
           else cross_attention.cross_attend_step_dequant)
    for t in range(5):
        assert torch.equal(multi[:, t], one(qm[:, t].contiguous(), k8, v8, ks,
                                            vs, 3, s_valid=s))
    _assert_close(multi, cross_attention.cross_attend_multi_plain(
        qm, k8, v8, ks, vs, 3, s_valid=s, int8_mxu=int8_mxu))
    with pytest.raises(ValueError, match="heads"):
        cross_attention.cross_attend_multi_sharded(
            qm, k8, v8, ks, vs, 3, s_valid=s, mesh=_mesh(), heads=16)


# ---------------------------------------------------------------------------
# The greedy loop replayed from a CUDA graph (runtime.generate)
# ---------------------------------------------------------------------------

# rung -> greedy_generate keywords (whisper-base-like small model, bf16)
GRAPH_RUNGS = {
    "x4": dict(int8_cross_kv=True, kernel_step=True, int8_mxu=False),
    "x5": dict(int8_cross_kv=True, kernel_step=True, int8_mxu=True),
    "x7": dict(int8_cross_kv=True, kernel_step=True, int8_mxu=True,
               int8_self=True),
}
GRAPH_CASES = [("x4", ""), ("x5", ""), ("x7", ""), ("x5", "pads"),
               ("x7", "pads"), ("x5", "grammar"), ("x5", "scores"),
               ("x5", "sampled")]
# kernels of the greedy step, as the profiler names them
STEP_KERNELS = ("self_step_kernel", "self_step_int8_kernel",
                "cross_step_kernel", "cross_dequant_kernel")


def _graph_inputs(gen, case):
    from whisper_tpu_torch.runtime.generate import build_suppress_mask
    from whisper_tpu_torch.runtime.timestamps import TimestampCfg

    dims, tree = _small_model(5)
    enc = _randn(gen, 4, 1500, 128)
    # sampled: end-of-text (251) suppressed too, so that no row ends
    mask = torch.from_numpy(build_suppress_mask(
        320, [8, 251, 300] if case == "sampled" else [8, 300])).cuda()
    prompt = [250, 252, 253, 254]
    kw = {}
    if case == "pads":
        prompt = [251] * 4 + [255, 17, 99, 140, 33, 61] + prompt
        kw["pad_count"] = torch.tensor([4, 6, 9, 0], dtype=torch.int32,
                                       device="cuda")
    elif case == "grammar":
        prompt = prompt[:3]
        kw["ts_cfg"] = TimestampCfg(255, 251, 254, 10)
    elif case == "scores":
        kw["return_logprobs"] = True
    elif case == "sampled":
        kw.update(temperature=0.7, return_logprobs=True,
                  generator=torch.Generator(device="cuda").manual_seed(3))
    return dims, tree, enc, mask, torch.tensor(prompt, device="cuda"), kw


def _step_counts():
    settle_launches(wait=True)      # the graphs' bodies that ran
    return (self_attention.launches, self_attention.int8_launches,
            self_attention.padded_launches,
            self_attention.int8_padded_launches, cross_attention.launches,
            cross_attention.dequant_launches, sampling.launches,
            loop_tail.launches)


@contextlib.contextmanager
def _graph_launches():
    """Within the block every launch of a CUDA graph
    (``CUDAGraph.replay``) adds one to the list yielded."""
    launches = []
    replay = torch.cuda.CUDAGraph.replay

    def counted(graph):
        launches.append(1)
        replay(graph)

    torch.cuda.CUDAGraph.replay = counted
    try:
        yield launches
    finally:
        torch.cuda.CUDAGraph.replay = replay


@pytest.mark.parametrize("rung, case", GRAPH_CASES)
def test_graphed_loop_is_bitwise_the_eager_loop(gen, rung, case):
    """The same decode eagerly (reading ``done`` every step) and from a
    CUDA graph (captured at the first call, launched again at the second):
    tokens (and scores; sampled draws too, the key in the loop's state)
    bitwise, the launch counters equal (the graph's settled), one graph
    launch a call; under torch.profiler each step kernel's eager launches
    are its counter's (``_device_ops``), the greedy tail's too (one a
    step), the while node's condition kernel ahead of the node is traced,
    and an iteration of the while node puts on the card what an eager step
    does less two operations: the step's operations, which end in the
    tail kernel that sets the node's condition, without the eager loop's
    read of ``done`` (a reduction and a copy to the host).  The eager step's operations are the profiler's
    (``_device_events``); an iteration's are the body graph's kernel, copy
    and fill nodes (``_GraphLoop.body_ops``), which no dropped event can
    change.  Those are held by their number: torch.profiler misnames a
    conditional body's kernels (B3 for B8 at x7; with the grammar or
    scores no B3 at all; the condition kernel of one iteration under
    another kernel's name) and shows the body's copies as kernels, so the
    names of what runs in the body are not held."""
    from whisper_tpu_torch.runtime.generate import (
        DecodeGraphs,
        greedy_generate,
    )

    dims, tree, enc, mask, prompt, kw = _graph_inputs(gen, case)
    graphs = DecodeGraphs(tree)
    kw.update(GRAPH_RUNGS[rung])

    def run(eager, n=24):
        # the eager loop reads every step: it stops where the graph does
        return greedy_generate(tree, dims, enc, prompt, mask, mask, n, 251,
                               eager=eager, graphs=graphs, **kw)

    counts = {}
    outs = {}
    for eager in (True, False, False):
        before = _step_counts()
        with _graph_launches() as launches:
            outs.setdefault(eager, []).append(run(eager))
        assert len(launches) == (0 if eager else 1), launches
        settle_launches(wait=True)
        counts.setdefault(eager, []).append(
            tuple(a - b for a, b in zip(_step_counts(), before)))
    assert len(graphs.captures()) == 1
    want = outs[True][0]
    for got in outs[False]:
        if kw.get("return_logprobs"):
            assert all(torch.equal(a, b) for a, b in zip(got, want))
        else:
            assert torch.equal(got, want)
    assert counts[False] == [counts[True][0]] * 2, counts
    ops = {e: _device_ops(lambda e=e: run(e), calls=1) for e in (True, False)}

    def traced(e, name):
        return sum(c for k, c in ops[e].items() if name + "(" in k
                   or k.endswith(name) or f"{name}<" in k)

    for name, at in zip(STEP_KERNELS + ("loop_tail_kernel",),
                        (0, 1, 4, 5, 7)):
        assert traced(True, name) == counts[True][0][at], (name, ops[True])
    assert counts[True][0][7] == 23          # the tail once a step
    assert traced(False, "set_condition_kernel") >= 1, ops[False]
    assert traced(True, "set_condition_kernel") == 0
    toks = want[0] if kw.get("return_logprobs") else want
    assert not (toks == 251).any()      # no row ends: 23 steps each
    assert (counts[True][0][6] > 0) == (case == "sampled")   # the pick
    # 24 tokens against 12: twelve steps more, what a call does outside its
    # loop the same; every key's body (24 and 12 tokens) an eager step less
    # the read of ``done``, two operations: no condition kernel ends it
    run(False, 12)
    body_ops = {k: loop.body_ops for k, loop in graphs._loops.items()}
    counted = {n: _device_events(lambda n=n: run(True, n)) for n in (24, 12)}
    more = counted[24][0] - counted[12][0]
    if any(12 * ops != more - 24 for ops in body_ops.values()):
        # what differs, by name: the eager run's operations, 24 less 12
        ops24, ops12 = (_device_ops(lambda n=n: run(True, n), calls=1)
                        for n in (24, 12))
        by_name = {k: ops24.get(k, 0) - ops12.get(k, 0)
                   for k in set(ops24) | set(ops12)
                   if ops24.get(k, 0) != ops12.get(k, 0)}
        raise AssertionError(f"an iteration's operations {body_ops}, the "
                             f"eager loop's at 24 tokens less 12: {more} "
                             f"(want 12 iterations, each an eager step less "
                             f"two): {counted}; eager by name {by_name}")


def test_graphed_sampling_repeats_per_seed(gen):
    """T = 1 through the x5 step, the key (the caller's seed) in the loop's
    state: one seed twice equal, another seed different, no suppressed id
    drawn, and the graphed draws bitwise those of the eager loop that
    reads every step."""
    from whisper_tpu_torch.runtime.generate import (
        DecodeGraphs,
        build_suppress_mask,
        greedy_generate,
    )

    dims, tree = _small_model(6)
    enc = _randn(gen, 4, 1500, 128)
    suppress = list(range(0, 320, 3))
    mask = torch.from_numpy(build_suppress_mask(320, suppress)).cuda()
    prompt = torch.tensor([250, 252, 253, 254], device="cuda")
    graphs = DecodeGraphs(tree)

    def run(seed, eager=False):
        return greedy_generate(
            tree, dims, enc, prompt, mask, mask, 16, 251, int8_cross_kv=True,
            kernel_step=True, temperature=1.0, return_logprobs=True,
            generator=torch.Generator(device="cuda").manual_seed(seed),
            eager=eager, graphs=graphs)

    a, b, c = run(7), run(7), run(8)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert not torch.isin(a[0], torch.tensor(suppress, device="cuda")).any()
    assert all(torch.equal(x, y) for x, y in zip(a, run(7, eager=True)))


def test_a_32_layer_body_is_bitwise_the_eager_loop(gen):
    """whisper-large-v3's deepest body at a narrow width: a toy of its shape
    (128 mels, 32 decoder layers, four heads of 64 at d = 256, vocab
    51,866) at x5, bucket 4, 24 tokens: the graphed decode (a while node
    whose body holds 32 layers of B3 and B4) bitwise the eager loop, one
    graph launch a call and one capture, the launch counters equal, B3 and
    B4 32 a step and the greedy tail once a step."""
    from whisper_tpu_torch.models import convert
    from whisper_tpu_torch.models.registry import _dims
    from whisper_tpu_torch.runtime.generate import (
        DecodeGraphs,
        build_suppress_mask,
        greedy_generate,
    )

    dims = _dims(128, 256, 2, 4, 32, 4, 51866)
    tree = convert.params_from_numpy(convert.init_params(dims, 7), "cuda",
                                     BF)
    enc = _randn(gen, 4, 1500, 256)
    mask = torch.from_numpy(build_suppress_mask(51866, [8, 300])).cuda()
    prompt = torch.tensor([50258, 50259, 50359, 50363], device="cuda")
    graphs = DecodeGraphs(tree)

    def run(eager):
        return greedy_generate(tree, dims, enc, prompt, mask, mask, 24, 50257,
                               eager=eager, graphs=graphs,
                               **GRAPH_RUNGS["x5"])

    outs, counts = {}, {}
    for eager in (True, False, False):
        before = _step_counts()
        with _graph_launches() as launches:
            outs.setdefault(eager, []).append(run(eager))
        assert len(launches) == (0 if eager else 1), launches
        counts.setdefault(eager, []).append(
            tuple(a - b for a, b in zip(_step_counts(), before)))
    assert len(graphs.captures()) == 1
    (loop,) = graphs._loops.values()
    assert loop.body_ops > 0
    for got in outs[False]:
        assert torch.equal(got, outs[True][0])
    assert counts[False] == [counts[True][0]] * 2, counts
    b3, b4, tail = (counts[True][0][i] for i in (0, 4, 7))
    assert tail >= 1 and b3 == b4 == 32 * tail, counts


def test_every_temperature_shares_one_graph(gen):
    """The fallback ladder's temperatures through the x5 step with scores:
    one sampled key, captured once; each T's tokens and scores bitwise the
    eager loop's at that T."""
    from whisper_tpu_torch.runtime.generate import (
        DecodeGraphs,
        greedy_generate,
    )

    dims, tree = _small_model(9)
    enc = _randn(gen, 4, 1500, 128)
    zero = torch.zeros(320, device="cuda")
    prompt = torch.tensor([250, 252, 253, 254], device="cuda")
    graphs = DecodeGraphs(tree)

    def run(t, eager=False):
        return greedy_generate(
            tree, dims, enc, prompt, zero, zero, 16, 251, int8_cross_kv=True,
            kernel_step=True, temperature=t, return_logprobs=True,
            generator=torch.Generator(device="cuda").manual_seed(11),
            eager=eager, graphs=graphs)

    for t in (0.2, 0.4, 0.6, 0.8, 1.0):
        got, want = run(t), run(t, eager=True)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), t
    assert len(graphs.captures()) == 1


def test_decode_graphs_keep_their_state_within_the_budget(gen, monkeypatch):
    """Six prompt lengths (six keys) through a DecodeGraphs whose budget
    holds two keys (state, static inputs and graph pools): two loops stay,
    and the bytes the allocator holds for live tensors after the runs, less
    before, are their counted state and inputs (within 1 MiB; the pools
    hold no live tensor between launches); once the graphs go, they are
    back where they were.  Read as requested bytes, not
    ``memory_allocated()``, which counts whole blocks: the allocator does
    not split a cached block whose rest is under 1 MiB, so each tensor may
    hold up to 1 MiB more than it asked for."""
    from whisper_tpu_torch.runtime import generate
    from whisper_tpu_torch.runtime.generate import (
        DecodeGraphs,
        greedy_generate,
    )

    dims, tree = _small_model(10)
    enc = _randn(gen, 4, 1500, 128)
    zero = torch.zeros(320, device="cuda")

    def run(p, graphs):
        prompt = torch.tensor([250] * (p - 3) + [252, 253, 254],
                              device="cuda")
        greedy_generate(tree, dims, enc, prompt, zero, zero, 16, 251,
                        int8_cross_kv=True, kernel_step=True,
                        early_exit=False, graphs=graphs)

    def held():
        return torch.cuda.memory_stats()["requested_bytes.all.current"]

    one = DecodeGraphs(tree)
    run(9, one)
    budget = int(2.5 * one.nbytes())
    del one
    torch.cuda.synchronize()
    before = held()
    monkeypatch.setattr(generate, "_budget", lambda device: budget)
    graphs = DecodeGraphs(tree)
    for p in range(4, 10):
        run(p, graphs)
    torch.cuda.synchronize()
    kept = graphs.captures()
    assert len(kept) == 2 and [k.prompt_len for k in kept] == [8, 9]
    counted = graphs.nbytes()
    pools = sum(graphs.pools().values())
    assert counted <= budget and pools > 0
    kept_mem = held() - before
    del graphs
    torch.cuda.synchronize()
    left = held() - before
    print(f"counted {counted} B, of it pools {pools} B; held after the runs "
          f"{kept_mem} B, after the graphs went {left} B")
    assert abs(kept_mem - left - (counted - pools)) <= 2**20
    assert left <= 2**20


def test_two_threads_capture_and_replay_at_once(gen):
    """Two threads at once, as the serving engine's lanes: each captures a
    loop of its own (two captures in flight) and then both replay one
    shared loop, eight times each; every result bitwise the loop's alone,
    no error, and the counters count every replay's launches."""
    import threading

    from whisper_tpu_torch.runtime.generate import (
        DecodeGraphs,
        greedy_generate,
    )

    dims, tree = _small_model(7)
    encs = [_randn(gen, 4, 1500, 128) for _ in range(2)]
    zero = torch.zeros(320, device="cuda")
    prompt = torch.tensor([250, 252, 253, 254], device="cuda")
    shared = DecodeGraphs(tree)

    def run(enc, graphs):
        return greedy_generate(tree, dims, enc, prompt, zero, zero, 20, 251,
                               int8_cross_kv=True, kernel_step=True,
                               early_exit=False, graphs=graphs)

    want = [run(e, DecodeGraphs(tree)) for e in encs]
    torch.cuda.synchronize()
    settle_launches(wait=True)
    before = self_attention.launches
    errors, outs = [], [[], []]
    start = threading.Barrier(2)

    def lane(i):
        try:
            start.wait()
            outs[i].append(run(encs[i], DecodeGraphs(tree)))   # a capture
            for _ in range(8):
                outs[i].append(run(encs[i], shared))
        except Exception as e:   # noqa: BLE001 (reported below)
            errors.append(repr(e))

    threads = [threading.Thread(target=lane, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive(), "a lane hung"
    torch.cuda.synchronize()
    settle_launches(wait=True)
    assert not errors, errors
    for i in (0, 1):
        assert len(outs[i]) == 9
        assert all(torch.equal(o, want[i]) for o in outs[i]), i
    assert self_attention.launches - before == 2 * 9 * 19 * 2


def test_a_failed_capture_raises_and_nothing_falls_back(gen, monkeypatch):
    """A step that reads the host cannot be captured: greedy_generate
    raises (no eager loop in its place), and the key captures at the next
    call once the step is whole again."""
    from whisper_tpu_torch.runtime import generate

    dims, tree = _small_model(8)
    enc = _randn(gen, 2, 1500, 128)
    zero = torch.zeros(320, device="cuda")
    prompt = torch.tensor([250, 252, 253, 254], device="cuda")
    graphs = generate.DecodeGraphs(tree)
    pick = generate.pick

    def reading_pick(logits, *a, **k):
        if logits.sum().item() != logits.sum().item():     # a host read
            pass
        return pick(logits, *a, **k)

    def run():
        return generate.greedy_generate(
            tree, dims, enc, prompt, zero, zero, 12, 251, int8_cross_kv=True,
            kernel_step=True, graphs=graphs)

    monkeypatch.setattr(generate, "pick", reading_pick)
    with pytest.raises(RuntimeError):
        run()
    monkeypatch.setattr(generate, "pick", pick)
    torch.cuda.synchronize()
    got = run()
    assert len(graphs.captures()) == 1
    assert torch.equal(got, generate.greedy_generate(
        tree, dims, enc, prompt, zero, zero, 12, 251, int8_cross_kv=True,
        kernel_step=True, eager=True))


# ---------------------------------------------------------------------------
# Beam search and speculative rounds replayed from CUDA graphs
# (runtime.beam, runtime.speculative)
# ---------------------------------------------------------------------------

# rung -> the cross-attention kernel of a beam step or a draft step
BEAM_RUNGS = {"x4": False, "x5": True}      # int8_mxu: B6 or B4


def _cross_counts():
    settle_launches(wait=True)      # the graphs' bodies that ran
    return (cross_attention.launches, cross_attention.dequant_launches,
            cross_attention.multi_launches, self_attention.launches,
            self_attention.int8_launches)


@pytest.mark.parametrize("rung", list(BEAM_RUNGS))
@pytest.mark.parametrize("case", ["", "grammar", "pads"])
def test_graphed_beam_loop_is_bitwise_the_eager_loop(gen, rung, case):
    """K = 4 at 16 beam rows: the eager loop (reading ``done`` every
    step), then the capture's call and a replay: tokens and scores
    bitwise, the launch counters equal, one key captured, and B4 (x5) or
    B6 (x4) launched, never B3."""
    from whisper_tpu_torch.runtime.beam import beam_generate
    from whisper_tpu_torch.runtime.generate import DecodeGraphs

    dims, tree, enc, mask, prompt, kw = _graph_inputs(gen, case)
    graphs = DecodeGraphs(tree)

    def run(eager):
        before = _cross_counts()
        out = beam_generate(
            tree, dims, enc, prompt, mask, mask, 24, 251, 4,
            ts_cfg=kw.get("ts_cfg"), pad_count=kw.get("pad_count"),
            int8_cross_kv=True, packed_cross=True, int8_mxu=BEAM_RUNGS[rung],
            eager=eager, graphs=graphs)
        settle_launches(wait=True)
        return out, tuple(a - b for a, b in zip(_cross_counts(), before))

    (want, want_s), want_c = run(True)
    for _ in range(2):
        (got, got_s), got_c = run(False)
        assert torch.equal(got, want) and torch.equal(got_s, want_s)
        assert got_c == want_c, (got_c, want_c)
    assert len(graphs.captures()) == 1
    on = 0 if BEAM_RUNGS[rung] else 1
    assert want_c[on] > 0 and want_c[1 - on] == 0 and want_c[3] == 0, want_c
    assert want_c[on] % dims.decoder_layers == 0


def _spec_inputs(gen, draft_seed):
    from whisper_tpu_torch.models import convert
    from whisper_tpu_torch.variants.quant import quantize_params

    dims, tree = _small_model(12)
    draft = (convert.params_from_numpy(quantize_params(
        convert.init_params(dims, 12)), "cuda", BF) if draft_seed is None
        else _small_model(draft_seed)[1])
    enc = _randn(gen, 4, 1500, 128)
    zero = torch.zeros(320, device="cuda")
    prompt = torch.tensor([250, 252, 253, 254], device="cuda")
    return dims, tree, draft, enc, zero, prompt


@pytest.mark.parametrize("rung", list(BEAM_RUNGS))
@pytest.mark.parametrize("draft", ["random", "own int8 weights"])
def test_graphed_speculative_loop_is_bitwise_the_eager_loop(gen, rung,
                                                            draft):
    """draft_k 3, 40 tokens: the eager rounds (reading ``done`` every
    round), then the capture's call and a replay: tokens, rounds and
    committed counts bitwise, the launch counters equal; B7 launched once
    a layer and round run, the rounds run the rounds counted; the tokens
    those of the other draft too."""
    from whisper_tpu_torch.runtime import speculative
    from whisper_tpu_torch.runtime.generate import DecodeGraphs

    dims, tree, d_tree, enc, zero, prompt = _spec_inputs(
        gen, 13 if draft == "random" else None)
    graphs = DecodeGraphs(tree, draft_params=d_tree)

    def run(eager, d=d_tree, g=graphs):
        before = _cross_counts()
        out = speculative.speculative_generate(
            tree, dims, d, dims, enc, enc, prompt, zero, zero, 40, 251, 3,
            int8_cross_kv=True, packed_draft=True, packed_main=True,
            int8_mxu=BEAM_RUNGS[rung], eager=eager, graphs=g)
        settle_launches(wait=True)
        return out, tuple(a - b for a, b in zip(_cross_counts(), before))

    (want, rounds, n), want_c = run(True)
    for _ in range(2):
        (got, got_r, got_n), got_c = run(False)
        assert torch.equal(got, want) and torch.equal(got_r, rounds)
        assert torch.equal(got_n, n)
        assert got_c == want_c, (got_c, want_c)
    assert len(graphs.captures()) == 1
    run_rounds = want_c[2] // dims.decoder_layers
    assert want_c[2] == run_rounds * dims.decoder_layers
    assert run_rounds == int(rounds)
    assert want_c[3] == want_c[4] == 0           # no B3/B8
    other = _small_model(14)[1]
    (other_toks, _, _), _ = run(False, other, None)
    assert torch.equal(other_toks, want)


def test_a_new_draft_recaptures_and_never_replays_the_old(gen):
    """A session's graphs after ``set_draft``: the speculative loop of the
    old draft is gone, the next call captures a loop of its own, and its
    rounds are the eager rounds with the new draft."""
    from whisper_tpu_torch.runtime import speculative
    from whisper_tpu_torch.runtime.generate import DecodeGraphs

    dims, tree, old, enc, zero, prompt = _spec_inputs(gen, 15)
    new = _spec_inputs(gen, None)[2]
    graphs = DecodeGraphs(tree, draft_params=old)

    def run(d, eager=False):
        return speculative.speculative_generate(
            tree, dims, d, dims, enc, enc, prompt, zero, zero, 32, 251, 4,
            int8_cross_kv=True, packed_draft=True, packed_main=True,
            int8_mxu=True, eager=eager, graphs=graphs)

    run(old)
    (key, _), = graphs.captures().items()
    old_loop = graphs.loop(tree, None, key, enc.device, old)
    graphs.set_draft(new)
    assert not graphs.captures() and old_loop.graph is None
    with pytest.raises(ValueError, match="other weights"):
        run(old)
    got = run(new)
    assert graphs.loop(tree, None, key, enc.device, new) \
        is not old_loop
    want = run(new, eager=True)
    assert torch.equal(got[0], want[0]) and int(got[1]) == int(want[1])
    # its own weights: fewer rounds
    assert int(got[1]) < int(run(old, eager=True)[1])


@pytest.mark.parametrize("loop", ["beam", "speculative"])
def test_a_failed_beam_or_round_capture_raises(gen, monkeypatch, loop):
    """A step (a round) that reads the host cannot be captured: the call
    raises, nothing falls back, and the key captures at the next call once
    the step is whole again, its tokens the eager loop's."""
    from whisper_tpu_torch.runtime import beam, speculative
    from whisper_tpu_torch.runtime.generate import DecodeGraphs

    dims, tree, d_tree, enc, zero, prompt = _spec_inputs(gen, 16)
    graphs = DecodeGraphs(tree, draft_params=d_tree)
    mod, name = ((beam, "top_k") if loop == "beam"
                 else (speculative, "_verify_pass"))
    whole = getattr(mod, name)

    def reading(*a, **k):
        x = next(t for t in a if torch.is_tensor(t))
        if x.sum().item() != x.sum().item():          # a host read
            pass
        return whole(*a, **k)

    def run(eager=False):
        if loop == "beam":
            return beam.beam_generate(
                tree, dims, enc, prompt, zero, zero, 12, 251, 4,
                int8_cross_kv=True, packed_cross=True, int8_mxu=True,
                eager=eager, graphs=graphs)[0]
        return speculative.speculative_generate(
            tree, dims, d_tree, dims, enc, enc, prompt, zero, zero, 12, 251,
            3, int8_cross_kv=True, packed_draft=True, packed_main=True,
            int8_mxu=True, eager=eager, graphs=graphs)[0]

    monkeypatch.setattr(mod, name, reading)
    with pytest.raises(RuntimeError):
        run()
    monkeypatch.setattr(mod, name, whole)
    torch.cuda.synchronize()
    got = run()
    assert len(graphs.captures()) == 1
    assert torch.equal(got, run(eager=True))


# ---------------------------------------------------------------------------
# The loops' exit on the card: each graphed greedy step, beam step and
# speculative round under a conditional node (runtime.generate)
# ---------------------------------------------------------------------------

NEVER = 300          # suppressed by EXIT_MASK: a row with this EOT never ends
EXIT_RUNGS = {"x4": False, "x5": True}      # int8_mxu


def _exit_mask(keep=None):
    from whisper_tpu_torch.runtime.generate import build_suppress_mask

    ids = [8, NEVER] if keep is None else [i for i in range(320)
                                           if i not in keep]
    return torch.from_numpy(build_suppress_mask(320, ids)).cuda()


def _chains(seed, spread):
    """Encoder states [4, 1500, 128]: rows 0-2 one state, row 3 that state
    plus ``spread`` x noise (random weights decode a row into runs of one
    id, so two chains that share an id end at steps of their own)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    base = torch.randn(1500, 128, generator=g, device="cuda")
    noise = torch.randn(1500, 128, generator=g, device="cuda")
    return torch.stack([base] * 3 + [base + spread * noise]).to(BF)


def _first_ends(toks, eot):
    """Each row's first step >= 1 that holds ``eot``, or None."""
    out = []
    for row in toks.tolist():
        hits = [i for i, t in enumerate(row) if i >= 1 and t == eot]
        out.append(hits[0] if hits else None)
    return out


def _early(ends, limit):
    return all(e is not None and e < limit for e in ends) and \
        len(set(ends)) > 1


def _ending_inputs(decode, limit):
    """(encoder states, eot, each row's end): an id that, declared
    end-of-text, ends every row of ``decode(enc, eot)`` (tokens) before
    ``limit``, at two steps or more; searched over chains of encoder
    states."""
    for seed in range(16):
        for spread in (1.0, 0.2):
            enc = _chains(seed, spread)
            toks = decode(enc, NEVER)
            for eot in sorted(set(toks[:, 1:].flatten().tolist())):
                if _early(_first_ends(toks, eot), limit):
                    ends = _first_ends(decode(enc, eot), eot)
                    if _early(ends, limit):
                        return enc, eot, ends
    pytest.fail("no id ends every row early")


@pytest.mark.parametrize("rung", list(EXIT_RUNGS))
@pytest.mark.parametrize("loop", ["greedy", "beam", "speculative"])
def test_graphed_loops_stop_where_the_while_loop_stops(gen, loop, rung):
    """Rows that end at steps of their own before max_new_tokens: the eager
    loop that reads ``done`` every step (the ``while_loop``'s exit), then
    the capture's call and a replay, bitwise (tokens, scores or counts,
    rounds), with equal launch counts, so equal steps (rounds) run: the
    last row's end for greedy, fewer than the bound for beams and rounds.
    Beams keep only the ids the rows decode before they end, so that every
    beam ends."""
    from whisper_tpu_torch.models import convert
    from whisper_tpu_torch.runtime import beam, speculative
    from whisper_tpu_torch.runtime.generate import (
        DecodeGraphs,
        greedy_generate,
    )
    from whisper_tpu_torch.variants.quant import quantize_params

    dims, tree = _small_model(5)
    mxu = EXIT_RUNGS[rung]
    prompt = torch.tensor([250, 252, 253, 254], device="cuda")
    new = 24
    kw = dict(int8_cross_kv=True)
    mask = _exit_mask()

    def greedy(enc, eot, **k):
        return greedy_generate(tree, dims, enc, prompt, mask, mask, new, eot,
                               kernel_step=True, int8_mxu=mxu,
                               return_logprobs=True, **kw, **k)

    enc, eot, ends = _ending_inputs(
        lambda e, i: greedy(e, i, eager=True)[0], new - 4)
    # the ids those rows decode first, every other suppressed: every beam
    # then ends too
    firsts = greedy(enc, NEVER, eager=True)[0][:, :max(ends) + 1]
    keep = _exit_mask(set(firsts.flatten().tolist()) | {eot})
    if loop == "greedy":
        graphs = DecodeGraphs(tree)

        def run(eager):
            return greedy(enc, eot, eager=eager, graphs=graphs)
    elif loop == "beam":
        graphs = DecodeGraphs(tree)

        def run(eager):
            return beam.beam_generate(
                tree, dims, enc, prompt, keep, keep, new, eot, 4,
                packed_cross=True, int8_mxu=mxu, eager=eager,
                graphs=graphs, **kw)
    else:
        draft = convert.params_from_numpy(quantize_params(
            convert.init_params(dims, 5)), "cuda", BF)
        graphs = DecodeGraphs(tree, draft_params=draft)

        def run(eager):
            return speculative.speculative_generate(
                tree, dims, draft, dims, enc, enc, prompt, mask, mask, new,
                eot, 3, packed_draft=True, packed_main=True, int8_mxu=mxu,
                eager=eager, graphs=graphs, **kw)

    def counted(eager):
        settle_launches(wait=True)
        before = _cross_counts()
        out = run(eager)
        settle_launches(wait=True)
        return out, tuple(a - b for a, b in zip(_cross_counts(), before))

    want, want_c = counted(True)
    for _ in range(2):                  # the capture's call, a replay
        got, got_c = counted(False)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert got_c == want_c, (got_c, want_c)
    assert len(graphs.captures()) == 1
    on = 0 if mxu else 1
    if loop == "speculative":
        run_rounds = want_c[2] // dims.decoder_layers
        assert run_rounds == int(want[1]) < new, (run_rounds, want[1])
    else:
        steps = want_c[on] // dims.decoder_layers
        if loop == "greedy":
            assert steps == max(ends) == int(want[2].max()) - 1, steps
            assert want_c[3] == steps * dims.decoder_layers
        else:
            assert 0 < steps < new - 1, steps
    print(f"{loop} {rung}: ends {ends} (eot {eot}); launches {want_c}")


@pytest.mark.parametrize("draft", ["random", "own int8 weights"])
def test_speculative_async_returns_before_its_loop_ends(gen, draft):
    """The session's speculative ``_async`` form (the serving tick's leg)
    over 48 tokens, with a random draft (47 rounds or so) and with the
    model's own int8 weights sharing its encoder (a dozen rounds run, the
    rest skipped): an event recorded right after it returns has not yet
    been reached; the tokens are then the synchronous form's."""
    import time

    from whisper_tpu_torch.models import convert
    from whisper_tpu_torch.models.registry import WhisperDims
    from whisper_tpu_torch.runtime.session import RuntimeCfg, WhisperSession
    from whisper_tpu_torch.variants.ladder import apply_variant
    from whisper_tpu_torch.variants.quant import quantize_params

    dims = WhisperDims(n_mels=80, d_model=128, encoder_layers=2,
                       encoder_heads=2, decoder_layers=2, decoder_heads=2,
                       vocab_size=256, max_source_positions=1500,
                       max_target_positions=64)
    cfg, _ = apply_variant(RuntimeCfg(max_batch=4), "x5")
    params = convert.init_params(dims, seed=0)
    sess = WhisperSession(params, dims, cfg, device="cuda")
    if draft == "random":
        sess.set_draft_model(convert.init_params(dims, seed=99), dims)
    else:
        sess.set_draft_model(quantize_params(params), dims,
                             share_encoder=True)
    rng = np.random.default_rng(0)
    audio = rng.normal(0, 0.1, (4, 480_400)).astype(np.float32)
    n_valid = np.asarray([3000, 2000, 1000, 3000], np.int32)
    args = (audio, n_valid, [3, 5], 48, 2)
    want = sess.transcribe_short_speculative(*args)        # captures
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = sess.transcribe_short_speculative_async(*args)
    host_s = time.perf_counter() - t0
    event = torch.cuda.Event()
    event.record()
    pending = not event.query()
    t1 = time.perf_counter()
    event.synchronize()
    span_s = time.perf_counter() - t1
    print(f"returned after {host_s * 1e3:.3f} ms, the card busy "
          f"{span_s * 1e3:.3f} ms after")
    assert pending
    np.testing.assert_array_equal(toks.cpu().numpy(), want)


def test_no_if_node_support_raises(gen, monkeypatch):
    """A runtime that refuses the conditional (while) node
    (cudaErrorNotSupported from ``wt_while_node_begin``): the graphed call
    raises, nothing falls back to the eager loop, to per-step launches or
    to reads of ``done``, and once the node is made again the key captures
    and gives the eager loop's tokens."""
    from whisper_tpu_torch.ops import kernels
    from whisper_tpu_torch.runtime import generate

    dims, tree = _small_model(8)
    enc = _randn(gen, 2, 1500, 128)
    zero = torch.zeros(320, device="cuda")
    prompt = torch.tensor([250, 252, 253, 254], device="cuda")
    graphs = generate.DecodeGraphs(tree)

    def run(eager=False):
        return generate.greedy_generate(
            tree, dims, enc, prompt, zero, zero, 12, 251, int8_cross_kv=True,
            kernel_step=True, graphs=graphs, eager=eager)

    lib = kernels.library()
    monkeypatch.setattr(lib, "wt_while_node_begin", lambda *a: 801)
    with pytest.raises(RuntimeError, match="wt_while_node_begin"):
        run()
    assert not graphs.captures()
    monkeypatch.undo()
    torch.cuda.synchronize()
    got = run()
    assert len(graphs.captures()) == 1
    assert torch.equal(got, run(eager=True))


# ---------------------------------------------------------------------------
# One graph launch a decode: the while node (runtime.generate), and the
# sampled pick kernel (ops.sampling)
# ---------------------------------------------------------------------------

def _loop_call(loop, tree, dims, enc, prompt, mask, eot, new, graphs,
               eager=False, draft=None):
    """One call of ``loop`` (greedy, beam, speculative) at x5."""
    from whisper_tpu_torch.runtime import beam, speculative
    from whisper_tpu_torch.runtime.generate import greedy_generate

    kw = dict(int8_cross_kv=True, int8_mxu=True, eager=eager, graphs=graphs)
    if loop == "greedy":
        return greedy_generate(tree, dims, enc, prompt, mask, mask, new, eot,
                               kernel_step=True, **kw)
    if loop == "beam":
        return beam.beam_generate(tree, dims, enc, prompt, mask, mask, new,
                                  eot, 4, packed_cross=True, **kw)[0]
    return speculative.speculative_generate(
        tree, dims, draft, dims, enc, enc, prompt, mask, mask, new, eot, 3,
        packed_draft=True, packed_main=True, **kw)[0]


@pytest.mark.parametrize("loop", ["greedy", "beam", "speculative"])
def test_each_graphed_call_is_one_graph_launch(gen, loop):
    """The capture's call (its warm-up step, then the graph) and every
    later call launch the graph once, nothing else, and give the eager
    loop's tokens."""
    from whisper_tpu_torch.runtime.generate import DecodeGraphs

    dims, tree, draft, enc, zero, prompt = _spec_inputs(gen, 17)
    graphs = DecodeGraphs(tree, draft_params=draft)
    want = _loop_call(loop, tree, dims, enc, prompt, zero, 251, 24, graphs,
                      eager=True, draft=draft)
    for _ in range(3):
        with _graph_launches() as launches:
            got = _loop_call(loop, tree, dims, enc, prompt, zero, 251, 24,
                             graphs, draft=draft)
        assert len(launches) == 1
        assert torch.equal(got, want)
    assert len(graphs.captures()) == 1


@pytest.mark.parametrize("loop", ["greedy", "beam"])
def test_with_no_row_ending_the_bound_ends_the_loop(gen, loop):
    """End-of-text suppressed: no row ends, and the while node's
    ``trips < bound`` term stops the loop after exactly n - first = 23
    steps (B4 once a layer and step), as the eager loop, in the capture's
    call and a later one; the card is then free."""
    from whisper_tpu_torch.runtime.generate import DecodeGraphs

    dims, tree, draft, enc, _, prompt = _spec_inputs(gen, 17)
    mask = _exit_mask()                          # 8 and NEVER suppressed
    graphs = DecodeGraphs(tree)
    for eager in (True, False, False):
        settle_launches(wait=True)
        before = cross_attention.launches
        _loop_call(loop, tree, dims, enc, prompt, mask, NEVER, 24, graphs,
                   eager=eager)
        torch.cuda.synchronize()
        settle_launches(wait=True)
        steps = (cross_attention.launches - before) // dims.decoder_layers
        assert steps == 24 - 1, (eager, steps)


@pytest.mark.parametrize("draw", ["default generator", "own generator"])
def test_a_body_that_draws_from_a_torch_generator_raises(gen, monkeypatch,
                                                         draw):
    """A step that draws from a torch generator would repeat its draws in
    every iteration of the while node: the trial capture raises (nothing
    captured, nothing falls back), and once the step is whole again the key
    captures and gives the eager loop's tokens."""
    from whisper_tpu_torch.runtime import generate

    dims, tree = _small_model(8)
    enc = _randn(gen, 2, 1500, 128)
    zero = torch.zeros(320, device="cuda")
    prompt = torch.tensor([250, 252, 253, 254], device="cuda")
    graphs = generate.DecodeGraphs(tree)
    pick = generate.pick
    own = torch.Generator(device="cuda").manual_seed(1)

    def drawing_pick(logits, *a, **k):
        noise = torch.rand(logits.shape, device=logits.device,
                           generator=own if draw == "own generator" else None)
        return pick(logits + 0 * noise, *a, **k)

    def run(eager=False):
        return generate.greedy_generate(
            tree, dims, enc, prompt, zero, zero, 12, 251, int8_cross_kv=True,
            kernel_step=True, graphs=graphs, eager=eager)

    monkeypatch.setattr(generate, "pick", drawing_pick)
    with pytest.raises(RuntimeError):
        run()
    assert not graphs.captures()
    monkeypatch.setattr(generate, "pick", pick)
    torch.cuda.synchronize()
    got = run()
    assert len(graphs.captures()) == 1
    assert torch.equal(got, run(eager=True))


# (rows, vocabulary, row0, T): the main path's shapes, then every
# vocabulary that ends a row on each remainder mod 4 at 1, 16 and 64 rows
PICK_CASES = [(16, 51865, 0, 0.5), (16, 51865, 0, 1.0), (1, 51865, 7, 0.2),
              (3, 320, 0, 1.3), (5, 4097, 11, 0.7)] + [
    (b, v, 13 if b == 16 else 0, 0.9)
    for v in (1, 3, 4, 5, 4097, 51864, 51865, 51866) for b in (1, 16, 64)]


@pytest.mark.parametrize("b,v,row0,t", PICK_CASES)
def test_pick_kernel_is_bitwise_its_plain_version(gen, b, v, row0, t):
    """The uniforms, the scores and the ids of the kernel equal the plain
    version's bit for bit, with suppressed ids (-inf) never drawn, at two
    steps and under the key of a generator that has been used (offset >
    0); two calls equal; one launch a call.  Each row is split across
    blocks (one at the smallest vocabularies), so this holds the merge of
    the blocks' bests too, and a row's last group of 1-3 ids."""
    logits = torch.randn(b, v, generator=gen, device="cuda") * 3.0
    if v > 1:
        logits[:, ::9] = float("-inf")
    temp = torch.full((1,), t, device="cuda")
    used = torch.Generator(device="cuda").manual_seed(2**63 + 5)
    torch.rand(1000, generator=used, device="cuda")
    assert used.get_offset() > 0
    for key in (sampling.generator_key(
            torch.Generator(device="cuda").manual_seed(3), "cuda"),
            sampling.generator_key(used, "cuda")):
        for s in (1, 97):
            step = torch.full((1,), s, dtype=torch.int64, device="cuda")
            before = sampling.launches
            got = sampling.gumbel_pick(logits, temp, key, step, row0,
                                       with_draws=True)
            assert sampling.launches == before + 1
            plain = sampling.gumbel_scores_plain(logits, temp, key, step,
                                                 row0)
            torch.cuda.synchronize()
            assert torch.equal(got[1], plain[0])
            assert torch.equal(got[2], plain[1])
            assert torch.equal(got[0], torch.argmax(plain[1], -1))
            assert torch.equal(got[0], sampling.gumbel_pick(
                logits, temp, key, step, row0))
            assert torch.isfinite(logits.gather(1, got[0][:, None])).all()
            assert bool((got[1] > 0).all() and (got[1] < 1).all())


def test_pick_wrapper_refuses_what_the_kernel_does_not_take(gen):
    logits = torch.randn(4, 320, generator=gen, device="cuda")
    temp = torch.full((1,), 0.5, device="cuda")
    key = torch.zeros(2, dtype=torch.int64, device="cuda")
    step = torch.zeros(1, dtype=torch.int64, device="cuda")
    for bad in ((logits.t(), temp, key, step), (logits.half(), temp, key,
                                                step),
                (logits, temp.double(), key, step),
                (logits, temp, key.int(), step), (logits, temp, key[:1], step),
                (logits, temp, key, step.cpu())):
        with pytest.raises(ValueError):
            sampling.gumbel_pick(*bad)
    ws = sampling.pick_workspace(4, "cuda")
    for bad_ws in (ws[:3], ws.int(), ws.cpu(), ws.t(),
                   sampling.pick_workspace(4, "cuda")[:, :1]):
        with pytest.raises(ValueError, match="workspace"):
            sampling.gumbel_pick(logits, temp, key, step, workspace=bad_ws)


def _pick_blocks(rows, vocab):
    """The ids each block of the pick takes (4 x its groups)."""
    from whisper_tpu_torch.ops import kernels

    return 4 * kernels.library().wt_gumbel_pick_groups_per_block(rows, vocab)


def test_pick_merges_the_blocks_bests_as_torch_argmax(gen):
    """Bucket 16 over 51,865 ids, each row split across blocks, with what
    the merge across blocks must order as ``torch.argmax`` does: an equal
    largest score in two blocks (2^30 at T = 1: every score there rounds to
    exactly 2^30), the higher id's block first or last; a NaN in the last
    block; NaNs in two blocks; a NaN beside +inf; one id left of a -inf
    row; a row all -inf; +inf in two blocks.  Ids, uniforms and scores
    bitwise the plain version's, each row's id the one expected, and the
    workspace left zero."""
    b, v = 16, 51865
    per = _pick_blocks(b, v)
    assert 3 * per < v - 3, "too few blocks a row to plant in"
    big, inf, nan = 2.0 ** 30, float("inf"), float("nan")
    # row: (-inf everywhere first?, {id: logit}, the id expected)
    plants = [(False, {per + 5: big, 3 * per + 1: big}, per + 5),
              (False, {2: big, v - 2: big}, 2),
              (False, {v - 3: nan}, v - 3),
              (False, {per + 9: nan, 2 * per: nan}, per + 9),
              (False, {1: inf, v - 1: nan}, v - 1),
              (True, {2 * per + 17: 0.5}, 2 * per + 17),
              (True, {}, 0),
              (False, {v - 1: inf, per: inf}, per)]
    logits = torch.randn(b, v, generator=gen, device="cuda") * 3.0
    for r, (masked, ids, _) in enumerate(plants):
        if masked:
            logits[r] = -inf
        for i, x in ids.items():
            logits[r, i] = x
    temp = torch.ones(1, device="cuda")
    key = sampling.generator_key(
        torch.Generator(device="cuda").manual_seed(9), "cuda")
    ws = sampling.pick_workspace(b, "cuda")
    for s_ in (0, 41):
        step = torch.full((1,), s_, dtype=torch.int64, device="cuda")
        tok, u, sc = sampling.gumbel_pick(logits, temp, key, step,
                                          with_draws=True, workspace=ws)
        pu, ps = sampling.gumbel_scores_plain(logits, temp, key, step)
        torch.cuda.synchronize()
        # bit for bit, the NaNs' too (torch.equal holds no NaN equal)
        assert torch.equal(u, pu)
        assert torch.equal(sc.view(torch.int32), ps.view(torch.int32))
        assert torch.equal(tok, torch.argmax(ps, -1))
        assert torch.equal(tok, sampling.gumbel_pick(logits, temp, key, step,
                                                     workspace=ws))
        for r, (_, ids, want) in enumerate(plants):
            assert int(tok[r]) == want, (r, int(tok[r]), want)
            if r < 2:                           # the tie is a tie
                assert all(sc[r, i] == big for i in ids)
        assert not ws.any()


def test_pick_in_a_while_node_resets_its_tickets(gen):
    """128 iterations of one CUDA-graph while node whose body picks at the
    loop's step (``runtime.generate._while_node``), launched twice: every
    iteration's ids bitwise the plain version's at that step, so every
    launch of the kernel found its slots and tickets zero, and the
    workspace is zero after each launch of the graph."""
    from whisper_tpu_torch.runtime.generate import _while_node

    b, v, n = 16, 51865, 128
    logits = torch.randn(b, v, generator=gen, device="cuda") * 3.0
    logits[:, ::9] = float("-inf")
    temp = torch.full((1,), 0.8, device="cuda")
    key = sampling.generator_key(
        torch.Generator(device="cuda").manual_seed(4), "cuda")
    step = torch.zeros(1, dtype=torch.int64, device="cuda")
    done = torch.zeros(b, dtype=torch.bool, device="cuda")
    buf = torch.full((b, n), -1, dtype=torch.int64, device="cuda")
    ws = sampling.pick_workspace(b, "cuda")

    def body():
        tok = sampling.gumbel_pick(logits, temp, key, step, workspace=ws)
        buf.index_copy_(1, step, tok[:, None])
        step.add_(1)

    main = torch.cuda.current_stream()
    side, inner = torch.cuda.Stream(), torch.cuda.Stream()
    side.wait_stream(main)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        body()                          # warm: the library loaded
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            with _while_node(graph, done, step, n, inner):
                body()
        finally:
            graph.capture_end()
    main.wait_stream(side)
    for _ in range(2):
        step.zero_()
        buf.fill_(-1)
        graph.replay()
        torch.cuda.synchronize()
        assert int(step) == n
        assert not ws.any()
        for i in range(n):
            at = torch.full((1,), i, dtype=torch.int64, device="cuda")
            assert torch.equal(buf[:, i], sampling.gumbel_pick_plain(
                logits, temp, key, at)), i


# ---------------------------------------------------------------------------
# The greedy step's tail (ops.loop_tail) and the while node's condition
# ---------------------------------------------------------------------------

TAIL_EOT = 50257


def _tail_state(gen, b, cols, step, scores, seed):
    """A loop state on the card before a step at column ``step``: [nxt,
    lp, done, buf, last, pos, step, sum_lp, n_tok]; row r is done before
    the step, ends at it (picks EOT) or goes on, by (r + seed) % 3; with
    scores sum_lp holds -0.0 in row 0 and lp a NaN in the last row."""
    kind = (torch.arange(b, device="cuda") + seed) % 3
    nxt = torch.randint(0, 50000, (b,), generator=gen, device="cuda")
    st = [torch.where(kind == 1, TAIL_EOT, nxt), None, kind == 0,
          torch.randint(0, 51865, (b, cols), generator=gen, device="cuda"),
          torch.randint(0, 51865, (b,), generator=gen, device="cuda"),
          torch.full((1,), 4 + step, dtype=torch.int32, device="cuda"),
          torch.full((1,), step, dtype=torch.int64, device="cuda"), None,
          None]
    if scores:
        st[1] = torch.randn(b, generator=gen, device="cuda") - 3.0
        st[1][-1] = float("nan")
        st[7] = torch.randn(b, generator=gen, device="cuda") * 10.0 - 30.0
        st[7][0] = -0.0
        st[8] = torch.randint(1, 128, (b,), generator=gen, device="cuda")
    return st


def _bits_equal(a, b) -> bool:
    """Tensors (or Nones) equal, floats by their bits."""
    def bits(t):
        return t.view(torch.int32) if t.is_floating_point() else t
    return all(x is None and y is None or torch.equal(bits(x), bits(y))
               for x, y in zip(a, b))


@pytest.mark.parametrize("scores", [False, True])
@pytest.mark.parametrize("step", ["first", "last"])
@pytest.mark.parametrize("b", [1, 16, 64, 1025])
def test_loop_tail_kernel_is_bitwise_its_plain_version(gen, b, step,
                                                       scores):
    """One block, rows in turn past its 128 threads (1,025 rows: nine
    turns); step 0 and the last column of 128; over three seeds each row
    done before the step, ending at it and going on; every tensor of the
    state bitwise the plain version's (sum_lp by its bits: -0.0 + 0.0 and
    NaN), one launch a call."""
    at = 0 if step == "first" else 127
    for seed in range(3):
        got = _tail_state(gen, b, 128, at, scores, seed)
        want = [None if t is None else t.clone() for t in got]
        before = loop_tail.launches
        loop_tail.loop_tail(*got, eot_id=TAIL_EOT)
        loop_tail.loop_tail_plain(*want, eot_id=TAIL_EOT)
        torch.cuda.synchronize()
        assert loop_tail.launches == before + 1
        assert _bits_equal(got, want), seed


def test_loop_tail_is_one_kernel_and_refuses_what_it_does_not_take(gen):
    """One call puts the tail kernel on the card and nothing else, counted
    without the profiler (whose traces late in a long process held no tail
    kernel at all): the call captured as a while node's body
    (``runtime.generate._while_node`` with ``tail``, which raises unless
    the body launched one tail kernel that took the node's handle) leaves
    one device operation in the body graph, read from its kernel, copy and
    fill nodes as ``_GraphLoop.body_ops`` reads them, and tallies one
    launch, the tail's; the wrapper refuses operands the kernel does not
    take."""
    from whisper_tpu_torch.runtime.generate import _while_node

    st = _tail_state(gen, 16, 128, 0, True, 1)

    def call():
        loop_tail.loop_tail(*st, eot_id=TAIL_EOT)

    main = torch.cuda.current_stream()
    side, inner = torch.cuda.Stream(), torch.cuda.Stream()
    side.wait_stream(main)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        call()                          # warm: the library loaded
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            with _while_node(graph, st[2], st[6], 128, inner,
                             tail=True) as info:
                call()
        finally:
            graph.capture_end()
    main.wait_stream(side)
    torch.cuda.synchronize()
    assert info["body_ops"] == 1, info
    assert info["tally"] == {(loop_tail, "launches"): 1}, info
    bad = {"pos as int64": (5, st[5].long()), "lp alone missing": (1, None),
           "buf transposed": (3, st[3].t()), "nxt on the CPU":
           (0, st[0].cpu()), "nxt as int32": (0, st[0].int())}
    for label, (i, t) in bad.items():
        args = list(st)
        args[i] = t
        with pytest.raises(ValueError, match="loop_tail"):
            loop_tail.loop_tail(*args, eot_id=TAIL_EOT)


@pytest.mark.parametrize("case", ["rows ending at steps of their own",
                                  "no row ending",
                                  "every row done before the node"])
def test_a_tail_ended_while_node_stops_where_the_eager_loop_stops(gen,
                                                                   case):
    """A while node (``runtime.generate._while_node`` with ``tail``) whose
    body gathers the step's ids from a table and ends in the tail kernel,
    which sets the node's condition: no condition kernel in the body (two
    operations), and two launches each stop where the eager loop (the
    plain condition read on the host, the tail a step) stops, with every
    tensor of the state bitwise its."""
    from whisper_tpu_torch.runtime.generate import _while_node

    b, n = 16, 64
    ids = torch.randint(0, TAIL_EOT, (b, n), generator=gen, device="cuda")
    ends = torch.randint(2, 40, (b,), generator=gen, device="cuda")
    if case != "no row ending":
        ids.scatter_(1, ends[:, None], TAIL_EOT)
    st = _tail_state(gen, b, n, 1, True, 0)
    st[2].fill_(case == "every row done before the node")
    start = [None if t is None else t.clone() for t in st]
    eager = [None if t is None else t.clone() for t in st]
    nxt = torch.empty(b, 1, dtype=torch.int64, device="cuda")

    def body():
        torch.index_select(ids, 1, st[6], out=nxt)
        loop_tail.loop_tail(nxt.view(b), *st[1:], eot_id=TAIL_EOT)

    main = torch.cuda.current_stream()
    side, inner = torch.cuda.Stream(), torch.cuda.Stream()
    side.wait_stream(main)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        body()                          # warm: the library loaded
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            with _while_node(graph, st[2], st[6], n, inner,
                             tail=True) as info:
                body()
        finally:
            graph.capture_end()
    main.wait_stream(side)
    assert info["body_ops"] == 2        # the gather and the tail: no C
    steps = 0
    while bool(loop_tail.condition_plain(eager[2], eager[6], n)):
        loop_tail.loop_tail(ids[:, int(eager[6])].contiguous(), *eager[1:],
                            eot_id=TAIL_EOT)
        steps += 1
    want_steps = {"rows ending at steps of their own": int(ends.max()),
                  "no row ending": n - 1,
                  "every row done before the node": 0}[case]
    assert steps == want_steps
    for _ in range(2):
        for mine, first in zip(st[1:], start[1:]):
            if mine is not None:
                mine.copy_(first)
        graph.replay()
        torch.cuda.synchronize()
        assert int(st[6]) - 1 == steps
        assert _bits_equal(st[1:], eager[1:])


def test_pick_on_two_streams_at_once(gen):
    """Two streams, each with its own logits and workspace, held back by a
    sleep so that their picks queue up and then run at the same time: 20
    picks each at steps of their own, every id bitwise the plain
    version's."""
    b, v, n = 16, 51865, 20
    temp = torch.full((1,), 0.6, device="cuda")
    key = sampling.generator_key(
        torch.Generator(device="cuda").manual_seed(5), "cuda")
    lanes = []
    for _ in range(2):
        lanes.append((torch.cuda.Stream(),
                      torch.randn(b, v, generator=gen, device="cuda") * 3.0,
                      sampling.pick_workspace(b, "cuda"),
                      [torch.full((1,), i, dtype=torch.int64, device="cuda")
                       for i in range(n)]))
    main = torch.cuda.current_stream()
    for stream, *_ in lanes:
        stream.wait_stream(main)
        with torch.cuda.stream(stream):
            torch.cuda._sleep(2_000_000)
    got = [[], []]
    for i in range(n):
        for k, (stream, logits, ws, steps) in enumerate(lanes):
            with torch.cuda.stream(stream):
                got[k].append(sampling.gumbel_pick(logits, temp, key,
                                                   steps[i], workspace=ws))
    torch.cuda.synchronize()
    for k, (_, logits, ws, steps) in enumerate(lanes):
        assert not ws.any()
        for i in range(n):
            assert torch.equal(got[k][i], sampling.gumbel_pick_plain(
                logits, temp, key, steps[i])), (k, i)


# ---------------------------------------------------------------------------
# One program a bucket (runtime.generate: the chunk normalisation, the
# encoder(s), the prefill and the decode loop in one graph)
# ---------------------------------------------------------------------------

PROGRAM_FORMS = ["greedy", "pipelined", "sequential", "beams",
                 "speculative", "short", "short speculative"]
PROGRAM_STARTS = [0, 2500, 5000, 6000, 3000]   # buckets of 4 and 1


def _program_session(rung):
    from whisper_tpu_torch.models import convert
    from whisper_tpu_torch.models.registry import WhisperDims
    from whisper_tpu_torch.runtime.session import RuntimeCfg, WhisperSession
    from whisper_tpu_torch.variants.ladder import apply_variant

    dims = WhisperDims(n_mels=80, d_model=128, encoder_layers=2,
                       encoder_heads=2, decoder_layers=2, decoder_heads=2,
                       vocab_size=320, max_source_positions=1500,
                       max_target_positions=64)
    cfg, _ = apply_variant(RuntimeCfg(max_batch=4), rung)
    sess = WhisperSession(convert.init_params(dims, seed=4), dims, cfg,
                          device="cuda")
    sess.set_draft_model(convert.init_params(dims, seed=99), dims)
    return sess


def _program_call(sess, form, i):
    """Form ``form``'s call ``i`` (0, 1: other inputs at the same keys):
    its results on the host, as a tuple."""
    from whisper_tpu_torch.runtime.timestamps import TimestampCfg

    rng = np.random.default_rng(10 + i)
    prompt, eot = [250, 252, 253, 254], 251
    sup = ([8, 300], [eot])
    if form.startswith("short"):
        ship = 480_400 // 4 if form == "short" else 480_400
        audio = rng.normal(0, 0.1, (4, ship)).astype(np.float32)
        n_valid = np.asarray([300, 700, 200, 750], np.int32) * (i + 1)
        if form == "short":
            return (sess.transcribe_short_batch(audio, n_valid, prompt, 16,
                                                eot, *sup),)
        return (sess.transcribe_short_speculative(audio, n_valid, prompt, 16,
                                                  eot, *sup, draft_k=3),)
    mel = torch.from_numpy(rng.normal(0, 1, (80, 9000)).astype(
        np.float32)).cuda()
    if form == "sequential":
        pads = (3, 5)[i]
        tail = rng.integers(9, 249, 12 - pads).tolist()
        return sess.transcribe_from_mel(
            mel, [0], [eot] * pads + [255] + tail + prompt[:3], 16, eot,
            *sup, ts_cfg=TimestampCfg(255, eot, 254, 10), pad_count=pads,
            with_scores=True)
    kw = {"greedy": dict(with_scores=True, temperature=0.5, seed=3 + i),
          "pipelined": dict(chunk_norm_n_valid=(8500, 7000)[i],
                            with_scores=True),
          "beams": dict(num_beams=2),
          "speculative": dict(speculative=True, draft_k=3)}[form]
    out = sess.transcribe_from_mel(mel, PROGRAM_STARTS, prompt, 16, eot,
                                   *sup, **kw)
    return out if isinstance(out, tuple) else (out,)


def _all_counts():
    settle_launches(wait=True)
    mods = (attention, encoder_mlp, encoder_block, self_attention,
            cross_attention, sampling, log_mel, decoder_kernels)
    return {f"{m.__name__.rsplit('.', 1)[-1]}.{name}": getattr(m, name)
            for m in mods for name in dir(m) if name.endswith("launches")
            and isinstance(getattr(m, name), int)}


@pytest.mark.parametrize("rung", ["x4", "x5", "x7"])
@pytest.mark.parametrize("form", PROGRAM_FORMS)
def test_the_bucket_program_is_bitwise_the_eager_path(gen, rung, form):
    """A session's graphed call, long-form (two buckets), pipelined,
    sequential (the grammar and pad_count at bucket 1), beams,
    speculative, short (two ship lengths) and short speculative: tokens
    (and scores; the greedy form sampled at T = 0.5) bitwise the eager
    path's and every launch counter equal, one graph launch a bucket, whose
    capture tallied the encoder's kernels (B1, B2) ahead of its loop; a
    second call at the same keys with other inputs (other audio, another
    pad_count, prompt and seed) gives its own eager result and captures
    nothing (the scores of the forms that return them differ between the
    two inputs)."""
    sess = _program_session(rung)
    buckets = 1 if form.startswith("short") or form == "sequential" else 2
    runs = {}
    keys = None
    for mode, i in (("eager", 0), ("graphed", 0), ("graphed", 0),
                    ("graphed", 1), ("eager", 1)):
        sess.eager_decode = mode == "eager"
        if mode == "graphed" and i == 1:
            keys = set(sess.graphs.captures())
        before = _all_counts()
        with _graph_launches() as launches:
            out = _program_call(sess, form, i)
        after = _all_counts()
        counts = {k: after[k] - before[k] for k in after}
        assert len(launches) == (0 if mode == "eager" else buckets), (
            mode, launches)
        runs.setdefault((mode, i), []).append((out, counts))
    assert set(sess.graphs.captures()) == keys
    for i in (0, 1):
        (want, want_c), = runs[("eager", i)]
        for got, c in runs[("graphed", i)]:
            assert all(np.array_equal(a, b) for a, b in zip(got, want)), i
            assert c == want_c, (i, c, want_c)
        assert want_c["attention.launches"] > 0
    for loop in sess.graphs._loops.values():
        tally = {n for (_, n) in loop.pre_tally}
        assert "launches" in tally, loop.pre_tally
    if form in ("greedy", "pipelined", "sequential"):
        # the scores follow the inputs (random weights decode most inputs
        # into the same tokens): a value frozen into the program shows
        assert not np.array_equal(runs[("eager", 0)][0][0][1],
                                  runs[("eager", 1)][0][0][1])


def test_a_graphed_call_holds_one_cache_and_counts_its_pools(gen):
    """The key's state is written in place by the program's prefill: the
    caching allocator's live bytes after the capturing call, less after an
    eager call, are the state and static inputs counted (within 2 MiB),
    not a second cache; the pools counted are reserved by the capture."""
    sess = _program_session("x5")
    mel = torch.randn(80, 9000, device="cuda")
    args = (mel, PROGRAM_STARTS[:4], [250, 252, 253, 254], 16, 251)
    sess.eager_decode = True
    sess.transcribe_from_mel(*args)                # builds, warms
    sess.eager_decode = False
    torch.cuda.synchronize()
    held0 = torch.cuda.memory_stats()["requested_bytes.all.current"]
    reserved0 = torch.cuda.memory_reserved()
    sess.transcribe_from_mel(*args)
    torch.cuda.synchronize()
    held = torch.cuda.memory_stats()["requested_bytes.all.current"] - held0
    reserved = torch.cuda.memory_reserved() - reserved0
    (loop,) = sess.graphs._loops.values()
    state = loop.nbytes - loop.pool_nbytes
    print(f"live {held} B, state and inputs counted {state} B, pools "
          f"{loop.pool_nbytes} B, reserved {reserved} B")
    assert abs(held - state) <= 2 * 2**20
    assert 0 < loop.pool_nbytes <= reserved


# ---------------------------------------------------------------------------
# A mesh rank's program (runtime.generate.graphed): a world of one over
# NCCL in this process, the only NCCL world one card allows (NCCL refuses
# two ranks on one card)
# ---------------------------------------------------------------------------

@pytest.fixture
def nccl_world(gen):
    """A process group of one over NCCL on a free localhost port, and its
    mesh (``make_mesh(1, 1)``: every group a communicator of this rank on
    this card); the group is destroyed after the test."""
    import socket

    import torch.distributed as dist

    from whisper_tpu_torch.parallel import mesh as pm

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    pm.init_distributed(f"127.0.0.1:{port}", 1, 0, backend="nccl",
                        timeout_s=120)
    try:
        yield pm.make_mesh(1, 1)
    finally:
        dist.destroy_process_group()


def _mesh_call(loop, tree, dims, draft, enc, zero, prompt, mesh, graphs,
               eager=False):
    """One x5 call of ``loop`` (greedy, greedy sampled at T = 0.5, beams
    K = 4, speculative) under ``mesh``: its tokens."""
    from whisper_tpu_torch.runtime import beam, speculative
    from whisper_tpu_torch.runtime.generate import greedy_generate

    kw = dict(int8_cross_kv=True, int8_mxu=True, mesh=mesh, eager=eager,
              graphs=graphs)
    if loop.startswith("greedy"):
        if loop == "greedy sampled":
            kw.update(temperature=0.5, generator=torch.Generator(
                device="cuda").manual_seed(3))
        return greedy_generate(tree, dims, enc, prompt, zero, zero, 24, 251,
                               kernel_step=True, **kw)
    if loop == "beam":
        return beam.beam_generate(tree, dims, enc, prompt, zero, zero, 24,
                                  251, 4, packed_cross=True, **kw)[0]
    return speculative.speculative_generate(
        tree, dims, draft, dims, enc, enc, prompt, zero, zero, 24, 251, 3,
        packed_draft=True, packed_main=True, **kw)[0]


@pytest.mark.parametrize("loop", ["greedy", "greedy sampled", "beam",
                                  "speculative"])
def test_a_world_of_one_over_nccl_runs_a_call_in_one_launch(gen, nccl_world,
                                                            loop):
    """The mesh code path over NCCL (the sharded wrappers, the
    row-parallel branches, whose sums over one rank make no call) graphs
    by the rule: the capture's call and a later one launch the graph once
    each, nothing else, and give the same mesh's eager tokens, which are
    the tokens of the decode without a mesh, graphed."""
    from whisper_tpu_torch.runtime.generate import DecodeGraphs, graphed

    mesh = nccl_world
    dims, tree, draft, enc, zero, prompt = _spec_inputs(gen, 17)
    assert mesh.model_backend == "nccl" and graphed(enc.device, mesh, False)
    graphs = DecodeGraphs(tree, draft_params=draft)
    args = (loop, tree, dims, draft, enc, zero, prompt)
    want = _mesh_call(*args, mesh, graphs, eager=True)
    for _ in range(2):
        with _graph_launches() as launches:
            got = _mesh_call(*args, mesh, graphs)
        assert len(launches) == 1
        assert torch.equal(got, want)
    assert len(graphs.captures()) == 1
    assert torch.equal(_mesh_call(*args, None, DecodeGraphs(
        tree, draft_params=draft)), want)


def test_an_nccl_all_reduce_in_a_while_node_body(gen, nccl_world):
    """One ``dist.all_reduce`` on the world's NCCL group in a while node's
    body, beside the body's arithmetic and its counter: the trial capture
    holds no node a body may not hold, and one launch of the node's graph
    runs the bound's trips with x bitwise an eager loop of the same steps,
    twice."""
    import torch.distributed as dist

    from whisper_tpu_torch.parallel import mesh as pm
    from whisper_tpu_torch.runtime.generate import _bad_body_node, _while_node

    group = nccl_world.group(pm.MODEL_AXIS)
    x0 = torch.randn(16, 512, generator=gen, device="cuda")
    x = x0.clone()
    trips = torch.zeros(1, dtype=torch.long, device="cuda")
    done = torch.zeros(1, dtype=torch.bool, device="cuda")
    bound = 40

    def body():
        y = x * 0.75 + 0.125
        dist.all_reduce(y, group=group)
        x.copy_(y)
        trips.add_(1)

    want = x0.clone()
    for _ in range(bound):                 # the communicator made eagerly
        want = want * 0.75 + 0.125
        dist.all_reduce(want, group=group)
    side, inner = torch.cuda.Stream(), torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    trial = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        trial.capture_begin(capture_error_mode="thread_local")
        try:
            body()
            bad = _bad_body_node(side)
        finally:
            trial.capture_end()
    assert bad is None
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            with _while_node(graph, done, trips, bound, inner) as info:
                body()
        finally:
            graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    print(f"body operations {info['body_ops']}")
    for _ in range(2):
        x.copy_(x0)
        trips.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert int(trips) == bound
        assert torch.equal(x, want)


def test_a_body_holding_a_node_no_body_may_hold_raises(gen, monkeypatch):
    """A step that records an external event (an event record node, which
    a while node's body may not hold) raises in its trial capture, naming
    the node's type, before a node is made: nothing captured, nothing falls
    back; once the step is whole again the key captures and gives the
    eager loop's tokens."""
    from whisper_tpu_torch.runtime import generate

    dims, tree = _small_model(8)
    enc = _randn(gen, 2, 1500, 128)
    zero = torch.zeros(320, device="cuda")
    prompt = torch.tensor([250, 252, 253, 254], device="cuda")
    graphs = generate.DecodeGraphs(tree)
    make = generate._step_fn
    events = []      # alive while a graph holds their nodes

    def recording(*a, **kw):
        step = make(*a, **kw)

        def run():
            step()
            events.append(torch.cuda.Event(external=True))
            events[-1].record()
        return run

    def run(eager=False):
        return generate.greedy_generate(
            tree, dims, enc, prompt, zero, zero, 12, 251, int8_cross_kv=True,
            kernel_step=True, graphs=graphs, eager=eager)

    monkeypatch.setattr(generate, "_step_fn", recording)
    with pytest.raises(RuntimeError, match='type "event record"'):
        run()
    assert not graphs.captures()
    monkeypatch.setattr(generate, "_step_fn", make)
    torch.cuda.synchronize()
    got = run()
    assert len(graphs.captures()) == 1
    assert torch.equal(got, run(eager=True))


# ---------------------------------------------------------------------------
# Serving at the large family's dims
# ---------------------------------------------------------------------------

def test_distil_large_v3_warmup_leaves_no_capture_to_a_live_tick(
        gen, monkeypatch):
    """The serving engine at distil-large-v3's dims (128 mels, d = 1,280, a
    32-layer encoder, 20 heads, 2 decoder layers, 51,866 ids; random
    weights) at x5, max_batch 4: ``warmup`` captures buckets 1, 2 and 4 at
    its four ship lengths, twelve programs, and keeps them all; live ticks
    of one to four clips of 1-30 s then capture nothing, and every request
    resolves to the tokenizer-less text of its ids (empty where a row's
    first token ends it)."""
    from whisper_tpu_torch.models.convert import init_params
    from whisper_tpu_torch.models.registry import get_dims
    from whisper_tpu_torch.runtime import generate
    from whisper_tpu_torch.runtime.session import RuntimeCfg, WhisperSession
    from whisper_tpu_torch.serve.engine import EngineConfig, StreamingEngine
    from whisper_tpu_torch.variants.ladder import apply_variant

    dims = get_dims("distil-whisper/distil-large-v3")
    cfg, _ = apply_variant(RuntimeCfg(max_batch=4), "x5")
    session = WhisperSession(init_params(dims, seed=1), dims, cfg,
                             device="cuda")
    eng = StreamingEngine(session, cfg=EngineConfig(max_new_tokens=16,
                                                    batch_window_ms=20))
    try:
        eng.warmup()
        warm = session.graphs.captures()
        assert len(warm) == 12 and set(session.graphs.kept()) == set(warm)
        captured = []
        capture = generate._GraphLoop._capture

        def counted(self, *a, **kw):
            captured.append(1)
            return capture(self, *a, **kw)

        monkeypatch.setattr(generate._GraphLoop, "_capture", counted)
        rng = np.random.default_rng(3)
        clips = [(0.1 * rng.standard_normal(int(s * 16000)))
                 .astype(np.float32) for s in (1.0, 3.5, 7.0, 12.0, 29.5)]
        texts = [eng.transcribe(c, timeout=300) for c in clips]   # bucket 1
        for group in (clips[:4], clips[1:4], clips[3:]):         # 4, 4, 2
            futs = [eng.submit(c) for c in group]
            texts += [f.result(timeout=300) for f in futs]
        assert not captured
        assert session.graphs.captures() == warm
        assert len(texts) == 14 and all(
            not t or (t.startswith("[TOKENS:") and t.endswith("]"))
            for t in texts)
    finally:
        eng.close()
