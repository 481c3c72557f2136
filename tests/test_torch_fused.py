"""The port's fused encoder block, W8A8 encoder and hybrid decode step
against the JAX package (CPU).

Same weights (``init_params(dims, seed)``) and same inputs, made from a seed
with numpy, through ``whisper_tpu`` (Pallas kernels in interpret mode, as
its own tests run them on the CPU) and through ``whisper_tpu_torch`` (the
kernels' plain versions, which a CPU tensor takes).

Tolerances: fp32 runs agree to a few 1e-4 (other summation orders through
two to six products per layer); bf16 runs within 4 bf16 spacings of each
encoder value, the bound ``test_torch_slice.py`` holds the x5 encoder to
(every op rounds to bf16, and the two packages sum in another order), and
logits within 2e-2, that file's LOGIT_TOL.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from whisper_tpu.models import convert as jconvert
from whisper_tpu.models import whisper as jw
from whisper_tpu.ops import decoder_kernels as jdk
from whisper_tpu.variants import quant as jquant
from whisper_tpu_torch.models import convert
from whisper_tpu_torch.models import whisper as tw
from whisper_tpu_torch.models.registry import WhisperDims
from whisper_tpu_torch.ops import attention, decoder_kernels, encoder_block
from whisper_tpu_torch.ops import encoder_mlp
from whisper_tpu_torch.variants import quant

torch.set_num_threads(2)

LOGIT_TOL = 2e-2


def _dims(d, heads, layers=2, t_enc=96):
    return WhisperDims(n_mels=80, d_model=d, encoder_layers=layers,
                       encoder_heads=heads, decoder_layers=layers,
                       decoder_heads=heads, vocab_size=256,
                       max_source_positions=t_enc, max_target_positions=32)


SMALL = _dims(128, 2)


def _params(dims, seed, dtype, int8=False):
    """The same weights for both packages, cast (and quantized) alike."""
    jp, tp = jconvert.init_params(dims, seed), convert.init_params(dims, seed)
    if int8:
        jp, tp = jquant.quantize_params(jp), quant.quantize_params(tp)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return (jconvert.cast_params(jp, jdt),
            convert.params_from_numpy(tp, "cpu", dtype))


def _mel(dims, batch, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(0, 1, (batch, dims.n_mels,
                             2 * dims.max_source_positions)).astype(np.float32)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _assert_close(got, want, dtype, steps=4.0, atol=3e-4):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, atol=atol, rtol=1e-4)
        return
    scale = np.maximum(np.maximum(np.abs(got), np.abs(want)),
                       np.abs(want).mean())
    err = np.abs(got - want) / (scale * 2.0 ** -7)
    assert err.max() <= steps, f"max error {err.max():.2f} bf16 steps"


# ---------------------------------------------------------------------------
# encoder_apply(fused_block=True)
# ---------------------------------------------------------------------------

FUSED_CASES = {
    # name: (dims, dtype, int8 weights, the composition JAX picks)
    "whole_bf16": (SMALL, torch.bfloat16, False, "whole"),
    "whole_bf16_int8_weights": (SMALL, torch.bfloat16, True, "whole"),
    "whole_fp32": (SMALL, torch.float32, False, "whole"),
    "chunked_fp32_d512": (_dims(512, 8, layers=1, t_enc=32), torch.float32,
                          False, "chunked"),
    "chunked_bf16_d1024": (_dims(1024, 16, layers=1, t_enc=32),
                           torch.bfloat16, True, "chunked"),
}


@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_encoder_fused_block_matches_jax(case):
    """B9a -> B1 -> B9b ("whole") or B9a -> B1 -> O-projection -> B2
    ("chunked"), picked where the JAX package picks it."""
    dims, dtype, int8, mode = FUSED_CASES[case]
    assert encoder_block.fused_block_mode(dims.d_model, dims.d_ffn,
                                          dtype) == mode
    jp, tp = _params(dims, 3, dtype, int8)
    mel = _mel(dims, 2, 4)
    want = jw.encoder_apply(jp, dims, jnp.asarray(mel), fused_block=True)
    for mod, name in ((encoder_block, "ln_qkv_launches"),
                      (encoder_block, "out_mlp_launches"),
                      (attention, "launches"), (encoder_mlp, "launches")):
        setattr(mod, name, 0)
    got = tw.encoder_apply(tp, dims, torch.from_numpy(mel), fused_block=True)
    assert got.dtype == dtype
    assert encoder_block.ln_qkv_launches == attention.launches == 0
    _assert_close(got, want, dtype)
    # the module fuses [q|k|v] once and gives the function's values
    enc = tw.WhisperEncoder(tp["encoder"], dims, device="cpu",
                            fused_block=True)
    assert "qkv_w" in enc.tree()["blocks"] and "q_w" not in enc.tree()["blocks"]
    assert torch.equal(enc(torch.from_numpy(mel)), got)
    # and it is not the unfused block (tanh GELU, other roundings)
    plain = tw.encoder_apply(tp, dims, torch.from_numpy(mel))
    assert not torch.equal(plain, got)


def test_encoder_fused_block_falls_back_where_jax_does():
    """d = 1056: past the "whole" budget and 3d no multiple of 128, so JAX
    has no QKV chunk plan and runs the unfused block; so does the port."""
    dims = _dims(1056, 16, layers=1, t_enc=16)
    dtype = torch.bfloat16
    assert encoder_block.fused_block_mode(dims.d_model, dims.d_ffn,
                                          dtype) is None
    jp, tp = _params(dims, 1, dtype)
    mel = _mel(dims, 1, 2)
    want = jw.encoder_apply(jp, dims, jnp.asarray(mel), fused_block=True)
    got = tw.encoder_apply(tp, dims, torch.from_numpy(mel), fused_block=True)
    assert torch.equal(got, tw.encoder_apply(tp, dims, torch.from_numpy(mel)))
    # 6 bf16 steps: the unfused bf16 chain rounds after every op, and at
    # this width each product sums eight times the terms of d = 128.
    _assert_close(got, want, dtype, steps=6.0)
    enc = tw.WhisperEncoder(tp["encoder"], dims, device="cpu",
                            fused_block=True)
    assert "q_w" in enc.tree()["blocks"]
    assert torch.equal(enc(torch.from_numpy(mel)), got)


def test_fused_block_supersedes_fused_mlp_and_ignores_int8_activations():
    dims, dtype = SMALL, torch.bfloat16
    _, tp = _params(dims, 3, dtype, int8=True)
    mel = torch.from_numpy(_mel(dims, 1, 4))
    base = tw.encoder_apply(tp, dims, mel, fused_block=True)
    both = tw.encoder_apply(tp, dims, mel, fused_block=True, fused_mlp=True,
                            fused_attention=True, int8_activations=True)
    assert torch.equal(base, both)
    enc = tw.WhisperEncoder(tp["encoder"], dims, device="cpu",
                            fused_block=True, int8_activations=True)
    assert not quant.is_quantized(enc.tree())
    assert torch.equal(enc(mel), base)


# ---------------------------------------------------------------------------
# x6: the W8A8 encoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fused", [False, True])
def test_encoder_int8_activations_matches_jax(fused, dtype):
    """Every block product W8A8; with fused attention and MLP (the rung's
    own flags) the MLP half stays on B2 and QKV/O stay W8A8.  fp32: the
    integer sums are exact; a last-place difference in an LN output can
    still move one quantized activation by one step (absmax/127 of its
    row), so 1e-3 holds where the dense fp32 encoders hold 3e-4.  bf16: 6
    bf16 steps, not 4, for the same reason on top of the bf16 chain's own
    spread."""
    dims = SMALL
    jp, tp = _params(dims, 6, dtype, int8=True)
    mel = _mel(dims, 2, 7)
    want = jw.encoder_apply(jp, dims, jnp.asarray(mel), int8_activations=True,
                            fused_attention=fused, fused_mlp=fused)
    got = tw.encoder_apply(tp, dims, torch.from_numpy(mel),
                           int8_activations=True, fused_attention=fused,
                           fused_mlp=fused)
    _assert_close(got, want, dtype, steps=6.0, atol=1e-3)
    off = tw.encoder_apply(tp, dims, torch.from_numpy(mel),
                           fused_attention=fused, fused_mlp=fused)
    assert not torch.equal(off, got)
    # the module keeps int8 what the W8A8 products read, and only that
    enc = tw.WhisperEncoder(tp["encoder"], dims, device="cpu",
                            fused_attention=fused, fused_mlp=fused,
                            int8_activations=True)
    blocks = enc.tree()["blocks"]
    kept = {k for k, v in blocks.items() if isinstance(v, quant.QTensor)}
    assert kept == {"q_w", "k_w", "v_w", "o_w"} | (
        set() if fused else {"fc1_w", "fc2_w"})
    assert torch.equal(enc(torch.from_numpy(mel)), got)


def test_int8_activations_without_int8_weights_is_the_dense_encoder():
    """As in JAX: W8A8 needs the int8 weight operand; dense weights run the
    plain products."""
    dims, dtype = SMALL, torch.bfloat16
    _, tp = _params(dims, 6, dtype)
    mel = torch.from_numpy(_mel(dims, 1, 7))
    assert torch.equal(tw.encoder_apply(tp, dims, mel, int8_activations=True),
                       tw.encoder_apply(tp, dims, mel))


# ---------------------------------------------------------------------------
# The hybrid decode step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("form", ["float32", "bfloat16_int8"])
def test_build_step_weights_leaf_for_leaf(form):
    dtype = torch.float32 if form == "float32" else torch.bfloat16
    jp, tp = _params(SMALL, 8, dtype, int8=form.endswith("int8"))
    want = jdk.build_step_weights(jp, SMALL)
    got = decoder_kernels.build_step_weights(tp, SMALL)
    assert got.keys() == want.keys()
    for k, v in got.items():
        assert v.dtype == dtype and tuple(v.shape) == want[k].shape, k
        np.testing.assert_array_equal(_np(v), _np(want[k]), err_msg=k)
    d = SMALL.d_model
    assert not got["qkv_b"][:, 0, d:2 * d].any()        # K has no bias


@pytest.mark.parametrize("form", ["float32", "bfloat16_int8"])
def test_decoder_step_hybrid_matches_jax_for_two_steps(form):
    """Prefill, then two consecutive hybrid steps outside any loop: logits
    and the self cache rows they write.  bfloat16_int8: int8 weights and
    the int8 cross cache (``_attend_int8``)."""
    dims = SMALL
    int8 = form.endswith("int8")
    dtype = torch.float32 if form == "float32" else torch.bfloat16
    jp, tp = _params(dims, 9, dtype, int8=int8)
    rng = np.random.default_rng(10)
    enc = rng.normal(0, 1, (3, dims.max_source_positions,
                            dims.d_model)).astype(np.float32)
    prompt = np.asarray([[3, 5, 7]] * 3)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jl, jc = jw.decoder_prefill(jp, dims, jnp.asarray(prompt, jnp.int32),
                                jnp.asarray(enc, jdt), 8, int8_cross_kv=int8)
    tl, tc = tw.decoder_prefill(tp, dims, torch.from_numpy(prompt),
                                torch.from_numpy(enc).to(dtype), 8,
                                int8_cross_kv=int8)
    jsw = jdk.build_step_weights(jp, dims)
    tsw = decoder_kernels.build_step_weights(tp, dims)
    tol = 5e-4 if dtype == torch.float32 else LOGIT_TOL
    tok = np.asarray(jl[:, -1].argmax(-1))
    decoder_kernels.launches = 0
    for pos in (3, 4):
        jl, jc = jdk.decoder_step_hybrid(jp, jsw, dims,
                                         jnp.asarray(tok, jnp.int32),
                                         jnp.int32(pos), jc, interpret=True)
        tl, tc = decoder_kernels.decoder_step_hybrid(
            tp, tsw, dims, torch.from_numpy(tok.copy()), pos, tc)
        assert tl.dtype == torch.float32 and tl.shape == (3, 256)
        np.testing.assert_allclose(_np(tl), _np(jl), atol=tol, rtol=0)
        _assert_close(tc.self_k[:, :, :, pos], jc.self_k[:, :, :, pos], dtype,
                      atol=5e-4)
        _assert_close(tc.self_v[:, :, :, pos], jc.self_v[:, :, :, pos], dtype,
                      atol=5e-4)
        tok = np.asarray(jl.argmax(-1))
    assert decoder_kernels.launches == 0     # CPU tensors: the plain version
    # the hybrid step is not the plain step: tanh GELU, one QKV product
    _, tc2 = tw.decoder_prefill(tp, dims, torch.from_numpy(prompt),
                                torch.from_numpy(enc).to(dtype), 8,
                                int8_cross_kv=int8)
    a, _ = tw.decoder_step(tp, dims, torch.from_numpy(prompt[:, 0]), 3, tc2)
    _, tc3 = tw.decoder_prefill(tp, dims, torch.from_numpy(prompt),
                                torch.from_numpy(enc).to(dtype), 8,
                                int8_cross_kv=int8)
    b, _ = decoder_kernels.decoder_step_hybrid(
        tp, tsw, dims, torch.from_numpy(prompt[:, 0]), 3, tc3)
    assert not torch.equal(a, b)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=0.1)
