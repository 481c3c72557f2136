"""The port's CUDA kernels (B1-B6) against their plain versions, on the card.

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
from whisper_tpu_torch.ops import attention, cross_attention, encoder_mlp
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


@pytest.mark.parametrize("t", [1500, 200, 64, 1])
def test_b1_kernel_matches_plain(gen, t):
    q = _randn(gen, 2, 3, t, 64, scale=0.5)
    k, v = _randn(gen, 2, 3, t, 64), _randn(gen, 2, 3, t, 64)
    before = attention.launches
    got = attention.fused_attention(q, k, v)
    assert attention.launches == before + 1
    _assert_close(got, attention.fused_attention_plain(q, k, v))


@pytest.mark.parametrize("b,t,d,f", [(2, 37, 512, 2048), (1, 1500, 384, 1536),
                                     (2, 100, 1024, 4096), (3, 5, 1280, 5120)])
def test_b2_kernel_matches_plain(gen, b, t, d, f):
    args = (_randn(gen, b, t, d), 1.0 + _randn(gen, d, scale=0.1),
            _randn(gen, d, scale=0.1), _randn(gen, d, f, scale=0.04),
            _randn(gen, f, scale=0.1), _randn(gen, f, d, scale=0.04),
            _randn(gen, d, scale=0.1))
    before = encoder_mlp.launches
    got = encoder_mlp.fused_encoder_mlp(*args)
    assert encoder_mlp.launches == before + 1
    _assert_close(got, encoder_mlp.fused_encoder_mlp_plain(*args))


@pytest.mark.parametrize("pos,pads", [(70, [0, 5, 70, 1]), (0, [0, 0, 0, 0]),
                                      (131, [3, 0, 131, 130])])
def test_b3_kernel_matches_plain_and_inserts_in_place(gen, pos, pads):
    n_l, b, h, s = 3, 4, 6, 132
    q = _randn(gen, b, h, 64, scale=0.125)
    kn, vn = _randn(gen, b, h, 64), _randn(gen, b, h, 64)
    kc, vc = _randn(gen, n_l, b, h, s, 64), _randn(gen, n_l, b, h, s, 64)
    kc2, vc2 = kc.clone(), vc.clone()
    pad = torch.tensor(pads, dtype=torch.int32, device="cuda")
    got = self_attention.self_attend_step(q, kn, vn, kc, vc, 2, pos, pad)
    want = self_attention.self_attend_step_plain(q, kn, vn, kc2, vc2, 2, pos,
                                                 pad)
    _assert_close(got, want)
    assert torch.equal(kc, kc2) and torch.equal(vc, vc2)
    assert torch.equal(kc[2, :, :, pos], kn) and torch.equal(vc[2, :, :, pos],
                                                              vn)


@pytest.mark.parametrize("s,s_valid", [(96, 96), (1504, 1500), (1500, 1500)])
def test_b4_kernel_matches_plain(gen, s, s_valid):
    n_l, b, h = 2, 3, 8
    q = _randn(gen, b, h, 64, scale=0.125)
    k8 = torch.randint(-127, 128, (n_l, b, h, s, 64), generator=gen,
                       device="cuda", dtype=torch.int8)
    v8 = torch.randint(-127, 128, (n_l, b, h, s, 64), generator=gen,
                       device="cuda", dtype=torch.int8)
    ks = torch.rand(n_l, b, h, generator=gen, device="cuda") * 0.02 + 1e-3
    vs = torch.rand(n_l, b, h, generator=gen, device="cuda") * 0.02 + 1e-3
    before = cross_attention.launches
    got = cross_attention.cross_attend_step(q, k8, v8, ks, vs, 1,
                                            s_valid=s_valid)
    assert cross_attention.launches == before + 1
    _assert_close(got, cross_attention.cross_attend_step_plain(
        q, k8, v8, ks, vs, 1, s_valid=s_valid))


@pytest.mark.parametrize("s,s_valid", [(1500, 1500), (1500, 1001),
                                       (96, 96)])
def test_b6_kernel_matches_plain(gen, s, s_valid):
    n_l, b, h = 2, 3, 8
    q = _randn(gen, b, h, 64, scale=0.125)
    k8 = torch.randint(-127, 128, (n_l, b, h, s, 64), generator=gen,
                       device="cuda", dtype=torch.int8)
    v8 = torch.randint(-127, 128, (n_l, b, h, s, 64), generator=gen,
                       device="cuda", dtype=torch.int8)
    ks = torch.rand(n_l, b, h, generator=gen, device="cuda") * 0.02 + 1e-3
    vs = torch.rand(n_l, b, h, generator=gen, device="cuda") * 0.02 + 1e-3
    before = cross_attention.dequant_launches
    got = cross_attention.cross_attend_step_dequant(q, k8, v8, ks, vs, 1,
                                                    s_valid=s_valid)
    assert cross_attention.dequant_launches == before + 1
    _assert_close(got, cross_attention.cross_attend_step_dequant_plain(
        q, k8, v8, ks, vs, 1, s_valid=s_valid))


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
