"""The port's sessions at rungs x6 and x7 and with the fused encoder block and
the hybrid decode step, against the JAX package's sessions (CPU).

``transcribe_longform`` runs on 40 s of synthetic audio with
``mel_slab_frames`` lowered to 3000 (two slabs, two 30 s chunks in one
batch bucket of two) through both packages' sessions.  The model is the one
of ``test_torch_slice.py``: d_model 128, two heads of 64, two encoder and
two decoder layers, vocab 256, the encoder's full 1500 positions.  The JAX
side runs as its own tests run it on the CPU (Pallas in interpret mode).

Each configuration is judged as that file judges x5: JAX's own chain is
replayed step by step outside its ``while_loop`` to get its logits; the
port's first-step logits agree within LOGIT_TOL, and each chunk's token
chain equals JAX's or first diverges where JAX's top-2 margin is below
LOGIT_TOL (a tie-flip).
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from whisper_tpu.models import whisper as jw
from whisper_tpu.ops import decoder_kernels as jdk
from whisper_tpu.ops.self_attention import pack_self_cache, quantize_pack_self
from whisper_tpu.pipeline.longform import transcribe_longform as jax_longform
from whisper_tpu.runtime.session import RuntimeCfg as JaxCfg
from whisper_tpu.runtime.session import WhisperSession as JaxSession
from whisper_tpu.variants.ladder import apply_variant as jax_apply_variant
from whisper_tpu_torch.frontend import golden
from whisper_tpu_torch.models import convert
from whisper_tpu_torch.models import whisper as tw
from whisper_tpu_torch.models.registry import WhisperDims, get_dims
from whisper_tpu_torch.ops import decoder_kernels
from whisper_tpu_torch.pipeline.chunk import CHUNK_FRAMES, mel_frame_bucket
from whisper_tpu_torch.pipeline.longform import transcribe_longform
from whisper_tpu_torch.runtime import generate
from whisper_tpu_torch.runtime.session import RuntimeCfg, WhisperSession
from whisper_tpu_torch.variants.ladder import LADDER, apply_variant

torch.set_num_threads(2)

DIMS = WhisperDims(n_mels=80, d_model=128, encoder_layers=2, encoder_heads=2,
                   decoder_layers=2, decoder_heads=2, vocab_size=256,
                   max_source_positions=1500, max_target_positions=32)
SLAB = 3000
MAX_NEW = 5
PROMPT = [250, 252, 253, 254]
LOGIT_TOL = 2e-2   # test_torch_slice.py's: a few bf16 steps of the hidden state
BUCKET = 2
FRAME_STARTS = [0, 2500]

CONFIGS = {
    "x6": ("x6", {}),
    "x7": ("x7", {}),
    "x5_fused_block_hybrid_step": ("x5", dict(fused_encoder_block=True,
                                              fused_decoder_step=True)),
}


class RecordingTok:
    ids = {"<|startoftranscript|>": 250, "<|endoftext|>": 251,
           "<|en|>": 252, "<|transcribe|>": 253, "<|notimestamps|>": 254,
           "<|startofprev|>": 255}

    def __init__(self):
        self.rows = []

    def token_to_id(self, t):
        return self.ids.get(t)

    def decode(self, ids, skip_special_tokens=True, **_):
        self.rows.append([int(i) for i in ids])
        return " ".join(f"w{i}" for i in ids)


def _audio(seconds: float = 40.0, seed: int = 5) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = int(seconds * 16000)
    t = np.arange(n) / 16000.0
    x = (0.3 * np.sin(2 * np.pi * (180 + 60 * np.sin(2 * np.pi * 0.7 * t)) * t)
         + 0.15 * np.sin(2 * np.pi * 920 * t) + 0.04 * rng.standard_normal(n))
    return (0.5 * x).astype(np.float32)


@pytest.fixture(scope="module")
def params():
    return convert.init_params(DIMS, seed=7)


def _cfgs(rung, overrides):
    jcfg, _ = jax_apply_variant(JaxCfg(), rung)
    tcfg, _ = apply_variant(RuntimeCfg(), rung)
    over = dict(overrides, mel_slab_frames=SLAB)
    return (dataclasses.replace(jcfg, **over),
            dataclasses.replace(tcfg, **over))


def _sessions(rung, overrides, params):
    jcfg, tcfg = _cfgs(rung, overrides)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")      # x6's precedence warning
        return (JaxSession(params, DIMS, jcfg),
                WhisperSession(params, DIMS, tcfg, device="cpu"))


def _jax_replay(jsess, mel):
    """JAX's greedy chain for the bucket under ``jsess``'s configuration,
    step by step as ``greedy_generate`` runs it: (encoder states, per-step
    logits [MAX_NEW, B, V], tokens [B, MAX_NEW])."""
    cfg, p = jsess.cfg, jsess.params
    mel_pad = jnp.pad(mel, ((0, 0), (0, CHUNK_FRAMES)))
    chunks = jnp.stack([mel_pad[:, s:s + CHUNK_FRAMES] for s in FRAME_STARTS])
    enc = jw.encoder_apply(p, DIMS, chunks,
                           fused_attention=cfg.fused_attention,
                           int8_activations=jsess._enc_i8,
                           fused_mlp=cfg.fused_encoder_mlp,
                           fused_block=cfg.fused_encoder_block)
    prompt = jnp.asarray([PROMPT] * BUCKET, jnp.int32)
    logits, cache = jw.decoder_prefill(p, DIMS, prompt, enc,
                                       len(PROMPT) + MAX_NEW,
                                       int8_cross_kv=cfg.int8_kv_cache)
    sw = jsess._step_weights
    if sw is None:
        cache = jw.pack_cross_cache(cache, transpose_k=True)
        if jsess._int8_self:
            k8, v8, ks, vs = quantize_pack_self(cache.self_k, cache.self_v)
            cache = cache._replace(self_k=k8, self_v=v8, self_k_scale=ks,
                                   self_v_scale=vs)
        else:
            cache = cache._replace(self_k=pack_self_cache(cache.self_k),
                                   self_v=pack_self_cache(cache.self_v))
    steps = [np.asarray(logits[:, -1].astype(jnp.float32))]
    toks = [steps[0].argmax(-1)]
    for i in range(1, MAX_NEW):
        tok = jnp.asarray(toks[-1], jnp.int32)
        pos = jnp.int32(len(PROMPT) + i - 1)
        if sw is not None:
            lg, cache = jdk.decoder_step_hybrid(p, sw, DIMS, tok, pos, cache,
                                                interpret=True)
        else:
            lg, cache = jw.decoder_step(p, DIMS, tok, pos, cache,
                                        cross_len=DIMS.max_source_positions,
                                        int8_mxu=True)
        steps.append(np.asarray(lg.astype(jnp.float32)))
        toks.append(steps[-1].argmax(-1))
    return enc, np.stack(steps), np.stack(toks, axis=1)


def _strip(row, eot=251):
    out = []
    for t in row:
        if t == eot:
            break
        out.append(int(t))
    return out


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_session_agrees_with_jax(name, params):
    rung, overrides = CONFIGS[name]
    audio = _audio()
    jsess, tsess = _sessions(rung, overrides, params)
    jtok, ttok, tokens = RecordingTok(), RecordingTok(), []
    jtext, _ = jax_longform(jsess, audio, "en", "transcribe", MAX_NEW,
                            tokenizer=jtok)
    decoder_kernels.launches = 0
    ttext, _ = transcribe_longform(tsess, audio, "en", "transcribe", MAX_NEW,
                                   tokenizer=ttok, token_collector=tokens)
    tokens = tokens[0]
    assert tokens.shape == (BUCKET, MAX_NEW) and len(jtok.rows) == BUCKET
    assert decoder_kernels.launches == 0     # CPU: the plain versions

    padded = golden.reflect_pad(audio)
    nv = golden.num_frames(len(audio))
    mel_j = jsess.compute_mel(padded, nv, mel_frame_bucket(nv))
    enc_j, logits_j, toks_j = _jax_replay(jsess, mel_j)
    # The replay is JAX's own chain: it strips to what the session decoded.
    assert [_strip(r) for r in toks_j] == jtok.rows

    ej = np.array(enc_j.astype(jnp.float32))
    prompt = torch.tensor([PROMPT] * BUCKET)
    lt, _ = tw.decoder_prefill(tsess._decoder_params, DIMS, prompt,
                               torch.from_numpy(ej).to(torch.bfloat16),
                               len(PROMPT) + MAX_NEW, int8_cross_kv=True)
    np.testing.assert_allclose(lt[:, -1].numpy(), logits_j[0],
                               atol=LOGIT_TOL, rtol=0)
    for r in range(BUCKET):
        diff = np.nonzero(tokens[r] != toks_j[r])[0]
        if diff.size:
            i = diff[0]
            top2 = np.sort(logits_j[i, r])[-2:]
            assert top2[1] - top2[0] < LOGIT_TOL, (
                f"chunk {r} diverges at step {i} with margin "
                f"{top2[1] - top2[0]}")
    if (tokens == toks_j).all():
        assert ttok.rows == jtok.rows and ttext == jtext


def test_x7_chain_equals_x5_chain(params):
    """The int8 self cache's quantization noise is far below the argmax
    margins at this size: the port's x7 tokens equal its x5 tokens, as the
    JAX package pins for its own (``test_x7_greedy_chain_matches_x5``)."""
    audio = _audio()
    out = {}
    for rung in ("x5", "x7"):
        cfg = _cfgs(rung, {})[1]
        sess = WhisperSession(params, DIMS, cfg, device="cpu")
        assert sess._int8_self is (rung == "x7")
        tokens = []
        transcribe_longform(sess, audio, "en", "transcribe", 8,
                            tokenizer=RecordingTok(), token_collector=tokens)
        out[rung] = tokens[0]
    np.testing.assert_array_equal(out["x7"], out["x5"])


def test_session_flags_follow_jax(params):
    """The derived flags (and x6's precedence warning) are the JAX
    session's, for every rung and for dims without the kernel step."""
    nano = get_dims("test/whisper-nano")          # head_dim 32
    nano_params = convert.init_params(nano, seed=0)
    for rung in sorted(LADDER):
        for dims, prm in ((DIMS, params), (nano, nano_params)):
            jcfg, tcfg = _cfgs(rung, dict(fused_decoder_step=rung == "x2"))
            with warnings.catch_warnings(record=True) as jw_:
                warnings.simplefilter("always")
                js = JaxSession(prm, dims, jcfg)
            with warnings.catch_warnings(record=True) as tw_:
                warnings.simplefilter("always")
                ts = WhisperSession(prm, dims, tcfg, device="cpu")
            assert ts._enc_i8 == js._enc_i8, rung
            assert ts._int8_self == (js._int8_self and ts._kernel_step), rung
            assert (ts._step_weights is None) == (js._step_weights is None)
            mine = [str(w.message) for w in tw_
                    if "int8_encoder_act" in str(w.message)]
            theirs = [str(w.message) for w in jw_
                      if "int8_encoder_act" in str(w.message)]
            assert mine == theirs and len(mine) == (rung == "x6"), rung
    ts = WhisperSession(nano_params, nano, _cfgs("x7", {})[1], device="cpu")
    assert not ts._kernel_step and not ts._int8_self   # x7 runs as x5 there


def test_step_weights_with_pad_count_raises_as_in_jax(params):
    sess = WhisperSession(params, DIMS, _cfgs("x5", dict(
        fused_decoder_step=True))[1], device="cpu")
    enc = torch.zeros((1, 1500, 128), dtype=torch.bfloat16)
    mask = torch.zeros(256)
    args = (sess._decoder_params, DIMS, enc, torch.tensor(PROMPT), mask, mask)
    with pytest.raises(ValueError, match="pad_count"):
        generate.greedy_generate(*args, max_new_tokens=2, eot_id=251,
                                 step_weights=sess._step_weights,
                                 pad_count=torch.zeros(1, dtype=torch.int32))
    # without step_weights a conditioned prompt runs; with no pad slot it
    # decodes the tokens of the call without pad_count
    got = generate.greedy_generate(*args, max_new_tokens=2, eot_id=251,
                                   pad_count=torch.zeros(1, dtype=torch.int32))
    assert torch.equal(got, generate.greedy_generate(*args, max_new_tokens=2,
                                                     eot_id=251))


def test_hybrid_step_leaves_the_decode_kernels_out(params):
    """With step_weights the self cache stays bf16 in the prefill layout at
    every rung (x7 too): nothing is quantized or packed, as in JAX."""
    seen = {}
    real = decoder_kernels.decoder_step_hybrid

    def spy(p, sw, dims, token, pos, cache, **kw):
        seen["cache"] = cache
        return real(p, sw, dims, token, pos, cache, **kw)

    sess = WhisperSession(params, DIMS, _cfgs("x7", dict(
        fused_decoder_step=True))[1], device="cpu")
    assert sess._int8_self and sess._step_weights is not None
    generate.decoder_step_hybrid = spy
    try:
        mel = torch.zeros((80, 3000))
        out = sess.transcribe_from_mel(mel, [0], PROMPT, 3, 251)
    finally:
        generate.decoder_step_hybrid = real
    assert out.shape == (1, 3)
    cache = seen["cache"]
    assert cache.self_k.dtype == torch.bfloat16 and cache.self_k_scale is None
    assert cache.cross_k.dtype == torch.int8


def test_int8_self_cache_outside_the_kernel_step_raises(params):
    """As in JAX (``_decoder_blocks``): an int8 self cache must not reach
    the plain blocks, which would attend int8 bytes as values."""
    _, tsess = _sessions("x7", {}, params)
    p = tsess._decoder_params
    enc = torch.zeros((1, 1500, 128), dtype=torch.bfloat16)
    _, cache = tw.decoder_prefill(p, DIMS, torch.tensor([PROMPT]), enc, 8,
                                  int8_cross_kv=True)
    cache = tw.quantize_self_kv(cache)
    assert cache.self_k.dtype == torch.int8
    assert cache.self_k_scale.shape == (2, 1, 2, 8)
    with pytest.raises(ValueError, match="int8 self cache"):
        tw.decoder_step(p, DIMS, torch.tensor([3]), 4, cache)
    logits, cache = tw.decoder_step(p, DIMS, torch.tensor([3]), 4, cache,
                                    kernel_step=True, cross_len=1500)
    assert logits.shape == (1, 256) and torch.isfinite(logits).all()
