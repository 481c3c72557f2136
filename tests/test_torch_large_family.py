"""The large family (whisper-large-v3, large-v3-turbo, distil-large-v3:
128 mels, 20 heads of 64, vocab 51,866) on the port against the JAX
package, on the CPU.

- A toy of the family (``_dims(128, 256, 2, 4, 2, 4, 51866)``, the same
  registry entry in both packages; 128 mels, the full 51,866-id vocabulary
  and the encoder's 1500 positions), weights from the JAX package's
  ``init_params`` carried across by the port's converter (``save_params`` /
  ``load_params``): x0 fp32 greedy through ``transcribe_longform`` on a 40 s
  clip with the slab front end at 128 mels (``mel_slab_frames`` 3000) and
  51,866-wide suppress masks, token for token with JAX; at x5 the port's
  plain path within the JAX tests' tolerances module by module (the mel,
  the encoder states, the prefill logits).
- The decode kernels' plain versions at the family's 20 heads of 64 (B3,
  B4, B6; a narrow cache of 2 layers and 64 columns) against the JAX
  kernels, run as the JAX tests run them (Pallas in interpret mode).
- The memory gate at the family's dims: the port's ``decode_footprint``
  equals JAX's term by term at whisper-large-v3 and large-v3-turbo (and
  large-v3 with a distil-large-v3 draft), buckets 1 and 16.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from whisper_tpu.models import convert as jconvert
from whisper_tpu.models import registry as jregistry
from whisper_tpu.models import whisper as jw
from whisper_tpu.ops.cross_attention import (
    cross_attend_step_packed,
    pack_cross_kv,
    pack_cross_kv_t,
)
from whisper_tpu.ops.self_attention import (
    pack_self_cache,
    self_attend_step_packed,
)
from whisper_tpu.pipeline.longform import transcribe_longform as jax_longform
from whisper_tpu.runtime.genconfig import GenerationCfg as JaxGenCfg
from whisper_tpu.runtime.session import RuntimeCfg as JaxCfg
from whisper_tpu.runtime.session import WhisperSession as JaxSession
from whisper_tpu.utils import hbm as jhbm
from whisper_tpu.variants.ladder import apply_variant as jax_apply_variant
from test_torch_ops import _assert_bf16_close, _bf16_pair, _np, _unpack_self
from whisper_tpu_torch.frontend import golden
from whisper_tpu_torch.models import convert
from whisper_tpu_torch.models import registry
from whisper_tpu_torch.models import whisper as tw
from whisper_tpu_torch.ops import cross_attention as t_cross
from whisper_tpu_torch.ops import self_attention as t_self
from whisper_tpu_torch.pipeline.chunk import CHUNK_FRAMES, mel_frame_bucket
from whisper_tpu_torch.pipeline.longform import transcribe_longform
from whisper_tpu_torch.runtime.genconfig import GenerationCfg
from whisper_tpu_torch.runtime.session import RuntimeCfg, WhisperSession
from whisper_tpu_torch.utils import hbm
from whisper_tpu_torch.variants.ladder import apply_variant

torch.set_num_threads(2)

DIMS = registry._dims(128, 256, 2, 4, 2, 4, 51866)
SLAB = 3000             # the 40 s clip's 4,000 frames over two slabs
MAX_NEW = 8
# large-v3's special ids (its tokenizer: one language more than the
# multilingual models', so the task and timestamp ids sit one higher)
SPECIALS = {"<|startoftranscript|>": 50258, "<|endoftext|>": 50257,
            "<|en|>": 50259, "<|transcribe|>": 50360,
            "<|notimestamps|>": 50364, "<|startofprev|>": 50362}
PROMPT = [50258, 50259, 50360, 50364]
# ids suppressed at every step and at the first, across the vocabulary to
# its last id (a timestamp of large-v3's)
SUPPRESS = [1, 2, 220, 50257 + 100, 50363, 51865]
BEGIN_SUPPRESS = [220, 50257]
BF16_EPS = 2.0 ** -7
LOGIT_TOL = 2e-2        # test_torch_slice's: a few bf16 steps of the state
# The JAX tests hold an fp32 front end within 3e-5 of the float64 golden
# mel at 80 mels; at 128 mels the narrow low bands sum one or two DFT bins,
# and on this clip JAX's own slab front end lies 5.9e-5 from the golden mel
# of its int16 samples (the port's 3.8e-5), so the two are held to
# chip_smoke.py's card-against-CPU mel bound.
MEL_TOL = 1e-4


class RecordingTok:
    """large-v3's special ids; ``decode`` records the generated ids of every
    chunk (prompt and EOT stripped) it is given."""

    def __init__(self):
        self.rows = []

    def token_to_id(self, t):
        return SPECIALS.get(t)

    def decode(self, ids, skip_special_tokens=True, **_):
        self.rows.append([int(i) for i in ids])
        return " ".join(f"w{i}" for i in ids)


def _audio(seconds: float = 40.0, seed: int = 11) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = int(seconds * 16000)
    t = np.arange(n) / 16000.0
    x = (0.3 * np.sin(2 * np.pi * (180 + 60 * np.sin(2 * np.pi * 0.7 * t)) * t)
         + 0.15 * np.sin(2 * np.pi * 920 * t) + 0.04 * rng.standard_normal(n))
    return (0.5 * x).astype(np.float32)


@pytest.fixture(scope="module")
def params(tmp_path_factory):
    """JAX's ``init_params`` tree written by the port's ``save_params`` and
    read back by its ``load_params`` (numpy leaves for both packages)."""
    tree = jconvert.init_params(jregistry._dims(128, 256, 2, 4, 2, 4, 51866),
                                seed=3)
    d = str(tmp_path_factory.mktemp("large_toy"))
    convert.save_params(convert._unflatten(
        {k: np.asarray(v, np.float32)
         for k, v in convert._flatten(tree).items()}), DIMS, d)
    loaded, dims = convert.load_params(d)
    assert dims == DIMS
    return loaded


def _sessions(rung: str, params):
    jcfg, _ = jax_apply_variant(JaxCfg(), rung)
    tcfg, _ = apply_variant(RuntimeCfg(), rung)
    jcfg = dataclasses.replace(jcfg, mel_slab_frames=SLAB)
    tcfg = dataclasses.replace(tcfg, mel_slab_frames=SLAB)
    return (JaxSession(params, DIMS, jcfg),
            WhisperSession(params, DIMS, tcfg, device="cpu"))


def test_the_toy_is_the_family_in_both_registries():
    """The toy's entry and the family's dims are one in both packages: 128
    mels, 20 heads of 64 at d = 1,280, vocab 51,866."""
    assert DIMS.to_dict() == dataclasses.asdict(
        jregistry._dims(128, 256, 2, 4, 2, 4, 51866))
    for model_id in ("openai/whisper-large-v3",
                     "openai/whisper-large-v3-turbo",
                     "distil-whisper/distil-large-v3"):
        got = registry.get_dims(model_id)
        assert got.to_dict() == dataclasses.asdict(jregistry.get_dims(
            model_id))
        assert (got.n_mels, got.d_model, got.encoder_heads, got.head_dim,
                got.vocab_size) == (128, 1280, 20, 64, 51866)


def test_x0_longform_tokens_equal_jax(params):
    """fp32 (TF32 off, JAX at HIGHEST) through the long-form path: the
    128-mel slab front end over two slabs, the 128-channel stem, two chunks
    in a bucket of two, 51,866-wide suppress masks at every step and the
    first; each chunk's tokens and the stitched text equal JAX's."""
    audio = _audio()
    jsess, tsess = _sessions("x0", params)
    jtok, ttok = RecordingTok(), RecordingTok()
    jtext, _ = jax_longform(jsess, audio, "en", "transcribe", MAX_NEW,
                            tokenizer=jtok,
                            gen_cfg=JaxGenCfg(SUPPRESS, BEGIN_SUPPRESS))
    tokens = []
    ttext, _ = transcribe_longform(tsess, audio, "en", "transcribe", MAX_NEW,
                                   tokenizer=ttok,
                                   gen_cfg=GenerationCfg(SUPPRESS,
                                                         BEGIN_SUPPRESS),
                                   token_collector=tokens)
    assert tokens[0].shape == (2, MAX_NEW)
    assert not np.isin(tokens[0], SUPPRESS).any()
    assert not np.isin(tokens[0][:, 0], BEGIN_SUPPRESS).any()
    assert len(jrows := jtok.rows) == 2 and ttok.rows == jrows
    assert ttext == jtext


def _bf16_steps(got, want) -> float:
    scale = np.maximum(np.maximum(np.abs(got), np.abs(want)),
                       np.abs(want).mean())
    return float((np.abs(got - want) / (scale * BF16_EPS)).max())


def test_x5_modules_agree_with_jax(params):
    """Rung x5 (bf16, int8 weights and cross cache; B1 and B2 as plain
    versions here, JAX's Pallas kernels in interpret mode): the streamed
    128-mel front end within MEL_TOL of JAX's and of the float64 golden
    mel of the same int16 samples; the encoder states of the bucket no
    farther (within a bf16 step) from an fp32 evaluation of the same
    int8-weight encoder (the port's x5 session at float32) than JAX's are,
    and within 8 bf16 steps of JAX's (chip_smoke.py's encoder bound): at
    d = 256 each bf16 path lies 4.1-4.4 steps from that evaluation, so the
    4 of test_torch_model (d = 128) does not hold between them; the
    prefill's logits over 51,866 ids within LOGIT_TOL, test_torch_slice's."""
    audio = _audio()
    jsess, tsess = _sessions("x5", params)
    padded = golden.reflect_pad(audio)
    nv = golden.num_frames(len(audio))
    bucket = mel_frame_bucket(nv)
    mel_j = jsess.compute_mel(padded, nv, bucket)
    mel_t = tsess.compute_mel(padded, nv, bucket)
    assert mel_t.shape == (128, bucket)
    np.testing.assert_allclose(mel_t.numpy(), np.asarray(mel_j),
                               atol=MEL_TOL, rtol=0)
    pcm = np.round(np.clip(audio, -1.0, 1.0) * 32767.0)
    want = golden.log_mel_golden((pcm * np.float32(1 / 32767.0)).astype(
        np.float32), n_mels=128)
    np.testing.assert_allclose(mel_t[:, :nv].numpy(), want, atol=MEL_TOL,
                               rtol=0)

    starts = [0, 2500]
    mel = np.pad(np.asarray(mel_j), ((0, 0), (0, CHUNK_FRAMES)))
    chunks = np.stack([mel[:, s:s + CHUNK_FRAMES] for s in starts])
    enc_j = jw.encoder_apply(jsess.params, DIMS, jnp.asarray(chunks),
                             fused_attention=True, fused_mlp=True)
    enc_t = tsess.encoder(torch.from_numpy(chunks)).float().numpy()
    ej = np.array(enc_j.astype(jnp.float32))
    cfg = dataclasses.replace(tsess.cfg, dtype="float32")
    fp32 = WhisperSession(params, DIMS, cfg, device="cpu").encoder(
        torch.from_numpy(chunks)).numpy()
    assert enc_t.shape == (2, 1500, 256)
    assert _bf16_steps(enc_t, fp32) <= _bf16_steps(ej, fp32) + 1.0
    assert _bf16_steps(enc_t, ej) <= 8.0

    prompt = np.array([PROMPT] * 2, np.int32)
    lj, _ = jw.decoder_prefill(jsess.params, DIMS, jnp.asarray(prompt),
                               enc_j, 4 + MAX_NEW, int8_cross_kv=True)
    lt, _ = tw.decoder_prefill(tsess._decoder_params, DIMS,
                               torch.from_numpy(prompt).long(),
                               torch.from_numpy(ej).to(torch.bfloat16),
                               4 + MAX_NEW, int8_cross_kv=True)
    assert lt.shape == (2, 4, 51866)
    np.testing.assert_allclose(lt[:, -1].float().numpy(),
                               np.asarray(lj[:, -1].astype(jnp.float32)),
                               atol=LOGIT_TOL, rtol=0)


# ---------------------------------------------------------------------------
# the decode kernels' plain versions at 20 heads of 64
# ---------------------------------------------------------------------------

N_L, B, H, S, DH = 2, 2, 20, 64, 64


@pytest.mark.parametrize("kernel", ["B3", "B4", "B6"])
def test_decode_kernels_at_twenty_heads_match_jax(kernel):
    """B3 (the new row written at ``pos`` 40 with mixed ``pad_count``: the
    caches unpacked equal JAX's exactly), B4 (int8 x int8) and B6 (the int8
    cache dequantized) at 20 heads, layer 1 of 2, 64 columns all valid:
    within 2 bf16 steps of the JAX kernels, test_torch_ops's tolerance."""
    rng = np.random.default_rng({"B3": 20, "B4": 21, "B6": 22}[kernel])
    layer = 1
    qj, qt = _bf16_pair(rng.normal(0, 1, (B, H, DH)) * DH ** -0.5)
    if kernel == "B3":
        pos, pads = 40, np.array([0, 7], np.int32)
        (kcj, kct), (vcj, vct) = (_bf16_pair(rng.normal(0, 1, (
            N_L, B, H, S, DH))) for _ in range(2))
        (knj, knt), (vnj, vnt) = (_bf16_pair(rng.normal(0, 1, (B, H, DH)))
                                  for _ in range(2))
        want, k_out, v_out = self_attend_step_packed(
            qj, knj, vnj, pack_self_cache(kcj), pack_self_cache(vcj),
            jnp.int32(layer), jnp.int32(pos), jnp.asarray(pads),
            interpret=True)
        got = t_self.self_attend_step_plain(qt, knt, vnt, kct, vct, layer,
                                            pos, torch.from_numpy(pads))
        np.testing.assert_array_equal(_np(kct), _unpack_self(k_out, S))
        np.testing.assert_array_equal(_np(vct), _unpack_self(v_out, S))
    else:
        k8, v8 = (rng.integers(-127, 128, (N_L, B, H, S, DH), dtype=np.int8)
                  for _ in range(2))
        ks, vs = (rng.uniform(0.001, 0.02, (N_L, B, H)).astype(np.float32)
                  for _ in range(2))
        mxu = kernel == "B4"
        want = cross_attend_step_packed(
            qj, (pack_cross_kv_t if mxu else pack_cross_kv)(jnp.asarray(k8)),
            pack_cross_kv(jnp.asarray(v8)), jnp.asarray(ks), jnp.asarray(vs),
            jnp.int32(layer), s_valid=S, int8_mxu=mxu, interpret=True)
        plain = (t_cross.cross_attend_step_plain if mxu
                 else t_cross.cross_attend_step_dequant_plain)
        got = plain(qt, torch.from_numpy(k8), torch.from_numpy(v8),
                    torch.from_numpy(ks), torch.from_numpy(vs), layer,
                    s_valid=S)
    assert got.shape == (B, H, DH)
    _assert_bf16_close(got, want, steps=2.0)


# ---------------------------------------------------------------------------
# the memory gate at the family's dims
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bucket", [1, 16])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("model_id, draft", [
    ("openai/whisper-large-v3", None),
    ("openai/whisper-large-v3-turbo", None),
    ("openai/whisper-large-v3", "distil-whisper/distil-large-v3")])
def test_decode_footprint_equals_jax_term_by_term(model_id, draft, int8,
                                                  bucket):
    """The port's gate and JAX's at the family's dims: every term equal
    (one cache copy, as the port prices it, and JAX's two)."""
    dims = registry.get_dims(model_id)
    kw = dict(weight_bytes=2, kv_bytes=2, int8_cross=int8)
    if draft is not None:
        kw["draft_dims"] = registry.get_dims(draft)
    for copies in (1.0, 2.0):
        want = jhbm.decode_footprint(jregistry.get_dims(model_id), bucket,
                                     132, cache_copies=copies, **{
                                         k: (jregistry.get_dims(draft)
                                             if k == "draft_dims" else v)
                                         for k, v in kw.items()})
        got = hbm.decode_footprint(dims, bucket, 132, cache_copies=copies,
                                   **kw)
        assert got == want


# ---------------------------------------------------------------------------
# fault 3.2: the pools a bucket program keeps, against the card's
# ---------------------------------------------------------------------------

# A bucket program's memory pools on the card (NVIDIA H100 80GB HBM3, x5,
# GiB), measured by chip_smoke.py's [graph] and [large] lines and by
# ``python -m whisper_tpu_torch.profile_ladder --pools`` (PERF.md §6): two
# values where two runs differed.
CARD_POOLS = [("openai/whisper-base", 16, 0.447),
              ("openai/whisper-base", 4, 0.129),
              ("openai/whisper-large-v3-turbo", 16, 1.037),
              ("openai/whisper-large-v3-turbo", 16, 1.152),
              ("openai/whisper-large-v3-turbo", 4, 0.256),
              ("openai/whisper-large-v3-turbo", 4, 0.314),
              ("openai/whisper-large-v3", 16, 1.037),
              ("openai/whisper-large-v3", 16, 1.152)]


@pytest.mark.parametrize("model_id, rows, gib", CARD_POOLS)
def test_program_pool_bytes_is_within_1_5x_of_the_cards_pools(model_id,
                                                               rows, gib):
    """``program_pool_bytes`` (the gate's price of a program's pools before
    any key has been captured) within 1.5x of what the card's programs
    kept, either way; before the repair it priced 1.51-1.68x low."""
    est = hbm.program_pool_bytes(registry.get_dims(model_id), rows, 4,
                                 act_bytes=2) / 2 ** 30
    assert gib / 1.5 <= est <= 1.5 * gib, (est, gib)
