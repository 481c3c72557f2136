"""The port's weights, front end and model against the JAX package (CPU).

Both packages get the same inputs, made from a seed with numpy, at a small
size: d_model 128, two heads of 64, two encoder and two decoder layers,
vocab 256.  The JAX side runs as its own tests run it on the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisper_tpu.frontend import golden as jgolden
from whisper_tpu.models import convert as jconvert
from whisper_tpu.models import whisper as jw
from whisper_tpu.ops.self_attention import pack_self_cache
from whisper_tpu.runtime.session import RuntimeCfg as JaxCfg
from whisper_tpu.runtime.session import WhisperSession as JaxSession
from whisper_tpu.variants import quant as jquant
from whisper_tpu_torch.frontend import golden
from whisper_tpu_torch.frontend.mel import log_mel_torch
from whisper_tpu_torch.models import convert
from whisper_tpu_torch.models import whisper as tw
from whisper_tpu_torch.models.registry import WhisperDims
from whisper_tpu_torch.pipeline.chunk import mel_frame_bucket
from whisper_tpu_torch.runtime.session import RuntimeCfg, WhisperSession
from whisper_tpu_torch.variants import quant

torch.set_num_threads(2)

DIMS = WhisperDims(n_mels=80, d_model=128, encoder_layers=2, encoder_heads=2,
                   decoder_layers=2, decoder_heads=2, vocab_size=256,
                   max_source_positions=96, max_target_positions=32)
HIGHEST = jax.lax.Precision.HIGHEST


def _leaves(tree, prefix=""):
    """{path: leaf} of a nested dict (QTensor pairs as two leaves)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        elif hasattr(v, "q") and hasattr(v, "s"):
            out[f"{prefix}{k}.q"], out[f"{prefix}{k}.s"] = v.q, v.s
        else:
            out[f"{prefix}{k}"] = v
    return out


def _assert_bf16_close(got, want, steps: float):
    """|got - want| <= steps bf16 spacings (2^-7 relative) of the larger
    magnitude, with the mean magnitude of ``want`` as the floor near 0."""
    scale = np.maximum(np.maximum(np.abs(got), np.abs(want)),
                       np.abs(want).mean())
    err = np.abs(got - want) / (scale * 2.0 ** -7)
    assert err.max() <= steps, f"max error {err.max():.2f} bf16 steps"


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.is_floating_point() \
            else x.numpy()
    return np.asarray(x)


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

def test_init_params_identical_leaf_for_leaf():
    mine = _leaves(convert.init_params(DIMS, seed=5))
    ref = _leaves(jconvert.init_params(DIMS, seed=5))
    assert mine.keys() == ref.keys()
    for k in ref:
        assert mine[k].dtype == np.float32, k
        np.testing.assert_array_equal(mine[k], np.asarray(ref[k]), err_msg=k)


def test_quantize_params_gives_equal_q_and_s():
    params = convert.init_params(DIMS, seed=2)
    mine = _leaves(quant.quantize_params(params))
    ref = _leaves(jquant.quantize_params(jconvert.init_params(DIMS, seed=2)))
    assert mine.keys() == ref.keys()
    assert "decoder/tok_emb_q.q" in mine
    for k in ref:
        np.testing.assert_array_equal(np.asarray(mine[k]), np.asarray(ref[k]),
                                      err_msg=k)
    assert quant.is_quantized(quant.quantize_params(params))
    assert not quant.is_quantized(params)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_params_from_numpy_round_trips(dtype):
    """cast_params semantics: float leaves cast, int8 q and fp32 s kept.
    The JAX package's own tree (jax arrays, its QTensor) converts alike."""
    params = quant.quantize_params(convert.init_params(DIMS, seed=1))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = _leaves(jconvert.cast_params(
        jquant.quantize_params(jconvert.init_params(DIMS, seed=1)), jdt))
    for source in (params, jquant.quantize_params(
            jconvert.init_params(DIMS, seed=1))):
        got = _leaves(convert.params_from_numpy(source, "cpu", dtype))
        assert got.keys() == ref.keys()
        for k, v in got.items():
            if k.endswith(".q"):
                assert v.dtype == torch.int8, k
            elif k.endswith(".s"):
                assert v.dtype == torch.float32, k
            else:
                assert v.dtype == dtype, k
            np.testing.assert_array_equal(
                _np(v), np.asarray(ref[k]).astype(_np(v).dtype), err_msg=k)


# ---------------------------------------------------------------------------
# Front end
# ---------------------------------------------------------------------------

def _speechy(seconds: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = int(seconds * 16000)
    t = np.arange(n) / 16000.0
    x = (0.3 * np.sin(2 * np.pi * (200 + 40 * np.sin(2 * np.pi * 1.3 * t)) * t)
         + 0.2 * np.sin(2 * np.pi * 850 * t) + 0.05 * rng.standard_normal(n))
    return (0.5 * x).astype(np.float32)


def test_golden_copy_matches_jax_golden():
    audio = _speechy(3.0, seed=4)
    np.testing.assert_array_equal(golden.log_mel_golden(audio),
                                  jgolden.log_mel_golden(audio))


@pytest.mark.parametrize("seconds", [45.3, 20.0])
def test_streamed_mel_matches_jax_session(seconds):
    """The slab path (three slabs at 45.3 s) and the one-shot path (20 s)
    of compute_mel, int16 transfer, against the JAX session's.  Tolerance
    3e-5, the JAX front end's own bound against the golden mel: the fp32
    DFT matmuls sum in another order on each side, and a quiet frequency
    bin, whose power comes out of cancelling terms, keeps few correct
    digits through log10."""
    sf = 2000
    jsess = JaxSession(jconvert.init_params(DIMS), DIMS,
                       JaxCfg(dtype="float32", mel_slab_frames=sf))
    tsess = WhisperSession(convert.init_params(DIMS), DIMS,
                           RuntimeCfg(dtype="float32", mel_slab_frames=sf),
                           device="cpu")
    audio = _speechy(seconds, seed=9)
    padded = golden.reflect_pad(audio)
    nv = golden.num_frames(len(audio))
    bucket = mel_frame_bucket(nv)
    want = np.asarray(jsess.compute_mel(padded, nv, bucket))
    got = tsess.compute_mel(padded, nv, bucket).numpy()
    assert got.shape == want.shape == (80, bucket)
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=0)
    assert np.all(got[:, nv:] == 0.0)


def test_one_shot_mel_matches_golden():
    """fp32 transfer; the ROADMAP bound for the front end is 2e-4."""
    audio = _speechy(7.3, seed=1)
    padded = torch.from_numpy(golden.reflect_pad(audio))
    nv = golden.num_frames(len(audio))
    got = log_mel_torch(padded, nv, n_mels=80, n_frames=nv).numpy()
    np.testing.assert_allclose(got, golden.log_mel_golden(audio), atol=2e-4,
                               rtol=0)


# ---------------------------------------------------------------------------
# The model at x0 (fp32) and at x5 (bf16, int8 weights, kernels B1-B4)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    params = convert.init_params(DIMS, seed=3)
    rng = np.random.default_rng(1)
    mel = rng.normal(0, 1, (2, DIMS.n_mels, 2 * DIMS.max_source_positions))
    return params, mel.astype(np.float32)


def test_x0_encoder_prefill_and_step_match_jax(setup):
    """fp32 with TF32 off against JAX at HIGHEST: 3e-4 (the ROADMAP bound
    for the fp32 model)."""
    params, mel = setup
    jp = jconvert.cast_params(params, jnp.float32)
    tp = convert.params_from_numpy(params, "cpu", torch.float32)
    enc_j = jw.encoder_apply(jp, DIMS, jnp.asarray(mel), precision=HIGHEST)
    enc_t = tw.encoder_apply(tp, DIMS, torch.from_numpy(mel))
    np.testing.assert_allclose(enc_t.numpy(), np.asarray(enc_j), atol=3e-4,
                               rtol=0)

    prompt = np.array([[5, 6, 7], [5, 6, 7]], np.int64)
    lj, cj = jw.decoder_prefill(jp, DIMS, jnp.asarray(prompt, jnp.int32),
                                enc_j, 12, precision=HIGHEST)
    lt, ct = tw.decoder_prefill(tp, DIMS, torch.from_numpy(prompt),
                                torch.from_numpy(np.array(enc_j)), 12)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=3e-4, rtol=0)
    tok = np.array([9, 11])
    sj, _ = jw.decoder_step(jp, DIMS, jnp.asarray(tok, jnp.int32),
                            jnp.int32(3), cj, precision=HIGHEST)
    st, ct = tw.decoder_step(tp, DIMS, torch.from_numpy(tok), 3, ct)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=3e-4, rtol=0)
    assert not ct.self_k[:, :, :, 4:].any()  # nothing written past pos


def test_x5_encoder_prefill_and_kernel_step_match_jax(setup):
    """bf16 with int8 weights through B1/B2 in the encoder and B3/B4 in the
    step, against the JAX x5 path (Pallas in interpret mode, head-packed
    caches).  Tolerances: the encoder output within 4 bf16 steps of each
    value, the mean magnitude as the floor near zero (bf16 rounding after
    every op, summed in another order on each side, through two layers);
    the logits within 2e-2, a few bf16 steps of the hidden state they
    project."""
    params, mel = setup
    qparams = quant.quantize_params(params)
    jp = jconvert.cast_params(jquant.quantize_params(
        jconvert.init_params(DIMS, seed=3)), jnp.bfloat16)
    tp = convert.params_from_numpy(qparams, "cpu", torch.bfloat16)
    enc_j = jw.encoder_apply(jp, DIMS, jnp.asarray(mel), fused_attention=True,
                             fused_mlp=True)
    encoder = tw.WhisperEncoder(tp["encoder"], DIMS, device="cpu",
                                fused_attention=True, fused_mlp=True)
    enc_t = encoder(torch.from_numpy(mel))
    ej = np.array(enc_j.astype(jnp.float32))
    _assert_bf16_close(enc_t.float().numpy(), ej, steps=4.0)

    # Decoder from the same (JAX) encoder states on both sides.
    enc_bf = torch.from_numpy(ej).to(torch.bfloat16)
    decoder = tw.WhisperDecoder(tp["decoder"], DIMS, device="cpu")
    dparams = {"decoder": decoder.tree()}
    prompt = np.array([[5, 6, 7], [5, 6, 7]], np.int64)
    lj, cj = jw.decoder_prefill(jp, DIMS, jnp.asarray(prompt, jnp.int32),
                                enc_j, 12, int8_cross_kv=True)
    lt, ct = tw.decoder_prefill(dparams, DIMS, torch.from_numpy(prompt),
                                enc_bf, 12, int8_cross_kv=True)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=2e-2, rtol=0)
    np.testing.assert_array_equal(ct.cross_k.numpy(), np.asarray(cj.cross_k))

    cj = jw.pack_cross_cache(cj, transpose_k=True)
    cj = cj._replace(self_k=pack_self_cache(cj.self_k),
                     self_v=pack_self_cache(cj.self_v))
    tok = np.array([9, 11])
    t_ = DIMS.max_source_positions
    sj, _ = jw.decoder_step(jp, DIMS, jnp.asarray(tok, jnp.int32),
                            jnp.int32(3), cj, cross_len=t_, int8_mxu=True)
    st, _ = decoder(torch.from_numpy(tok), 3, ct, kernel_step=True,
                    cross_len=t_)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=2e-2, rtol=0)


def test_runtime_cfg_matches_jax_fields_and_defaults():
    """A ladder rung or discovery config means the same to both packages."""
    mine = dataclasses.asdict(RuntimeCfg())
    ref = dataclasses.asdict(JaxCfg())
    assert mine == ref
