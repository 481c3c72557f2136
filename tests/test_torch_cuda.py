"""The port's CUDA kernels (B1-B4) against their plain versions, on the card.

These tests need an NVIDIA card and nvcc; elsewhere they skip.  Run them on
the card with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest sets up JAX, which this file does
not use).  ``chip_smoke.py`` checks the kernels at the main path's shapes;
these cover the edges it does not reach: ragged sequence lengths, a
nonzero ``pad_count``, a padded cross cache, the other model widths and the
wrapper's refusals.  Tolerance: 2 bf16 steps (2^-7 relative) of each value,
the mean magnitude as the floor near zero; both sides round at the same
points, and sum in another order.
"""

import pytest
import torch

from whisper_tpu_torch.ops import attention, cross_attention, encoder_mlp
from whisper_tpu_torch.ops import self_attention

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
