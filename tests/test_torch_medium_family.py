"""The medium family (whisper-small, whisper-medium and their English-only
forms, distil-medium.en, distil-small.en: 80 mels, 12 and 16 heads of 64 at
d = 768 and 1,024, vocab 51,865 or 51,864) on the port against the JAX
package, on the CPU.

- Both registries hold the family's entries alike, and the port picks the
  fused encoder block's composition where the JAX rule picks it
  (``encoder_block.fused_block_mode``: "whole" at d = 384 and 512,
  "chunked" at d = 768, 1,024 and 1,280).
- A toy of the family at d = 768 with 12 heads of 64, one encoder and one
  decoder layer, the English-only vocabulary of 51,864 ids and the
  encoder's 1500 positions (``_dims(80, 768, 1, 12, 1, 12, 51864)``),
  weights from the JAX package's ``init_params`` carried across by the
  port's converter (``save_params`` / ``load_params``): x0 fp32 greedy
  through ``transcribe_longform`` on a 40 s clip with an English-only
  tokenizer's special ids and 51,864-wide suppress masks, token for token
  with JAX; x0 speculative decoding with a draft of the same shape, equal
  to JAX's and to the port's greedy tokens.
- The x5 fused-block encoder at d = 768 (the "chunked" composition: B9a,
  B1, a plain O-projection, B2) against JAX's, whose Pallas kernels run in
  interpret mode.
- The decode kernels' plain versions at 12 and 16 heads (B3, B4, B6, B7)
  against the JAX kernels in interpret mode.
- The memory gate at the family's dims: the port's ``decode_footprint``
  equals JAX's term by term at whisper-small, whisper-medium and
  whisper-medium.en with a distil-medium.en draft, buckets 1 and 16.
- An English-only tokenizer without ``<|en|>`` raises in both packages.
- ``program_pool_bytes`` within 1.5x of the pools the card's programs kept
  at whisper-small, whisper-medium and whisper-medium.en's speculative
  program (``chip_smoke.py`` ``[medium]``).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from whisper_tpu.models import convert as jconvert
from whisper_tpu.models import registry as jregistry
from whisper_tpu.models import whisper as jw
from whisper_tpu.ops import encoder_block as jeb
from whisper_tpu.ops import encoder_mlp as jem
from whisper_tpu.ops.cross_attention import (
    cross_attend_multi_packed,
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
from whisper_tpu.runtime.speculative import (
    speculative_generate as jax_speculative,
)
from whisper_tpu.tokenizer import specials as jspecials
from whisper_tpu.utils import hbm as jhbm
from whisper_tpu.variants import quant as jquant
from whisper_tpu.variants.ladder import apply_variant as jax_apply_variant
from test_torch_large_family import _audio
from test_torch_ops import _assert_bf16_close, _bf16_pair, _np, _unpack_self
from whisper_tpu_torch.models import convert
from whisper_tpu_torch.models import registry
from whisper_tpu_torch.models import whisper as tw
from whisper_tpu_torch.ops import attention, encoder_block, encoder_mlp
from whisper_tpu_torch.ops import cross_attention as t_cross
from whisper_tpu_torch.ops import self_attention as t_self
from whisper_tpu_torch.pipeline.longform import transcribe_longform
from whisper_tpu_torch.runtime.genconfig import GenerationCfg
from whisper_tpu_torch.runtime.generate import (
    build_suppress_mask,
    greedy_generate,
)
from whisper_tpu_torch.runtime.session import RuntimeCfg, WhisperSession
from whisper_tpu_torch.runtime.speculative import speculative_generate
from whisper_tpu_torch.tokenizer import specials
from whisper_tpu_torch.utils import hbm
from whisper_tpu_torch.variants import quant
from whisper_tpu_torch.variants.ladder import apply_variant

torch.set_num_threads(2)

FAMILY = {  # model id: (d, heads, encoder layers, decoder layers, vocab)
    "openai/whisper-small": (768, 12, 12, 12, 51865),
    "openai/whisper-small.en": (768, 12, 12, 12, 51864),
    "openai/whisper-medium": (1024, 16, 24, 24, 51865),
    "openai/whisper-medium.en": (1024, 16, 24, 24, 51864),
    "distil-whisper/distil-medium.en": (1024, 16, 24, 2, 51864),
    "distil-whisper/distil-small.en": (768, 12, 12, 4, 51864),
}
# (n_mels, d, encoder layers, heads, decoder layers, heads, vocab)
TOY = (80, 768, 1, 12, 1, 12, 51864)
DIMS, JDIMS = registry._dims(*TOY), jregistry._dims(*TOY)
# an English-only tokenizer's special ids (one id below the multilingual
# ones: the .en vocabulary has no <|endoftext|> at 50257); timestamps from
# 50363 to the last id, 51863
SPECIALS = {"<|endoftext|>": 50256, "<|startoftranscript|>": 50257,
            "<|en|>": 50258, "<|translate|>": 50357, "<|transcribe|>": 50358,
            "<|startofprev|>": 50360, "<|notimestamps|>": 50362}
EOT = 50256
PROMPT = [50257, 50258, 50358, 50362]
# ids suppressed at every step and at the first, across the vocabulary to
# its last id (and one past it, which the masks drop in both packages)
SUPPRESS = [1, 2, 220, 50357, 51863, 51864]
BEGIN_SUPPRESS = [220, EOT]
MAX_NEW = 8
DRAFT_K = 4


class RecordingTok:
    """An English-only tokenizer's special ids; ``decode`` records the
    generated ids of every chunk (prompt and EOT stripped) it is given."""

    def __init__(self, ids=SPECIALS):
        self.ids, self.rows = ids, []

    def token_to_id(self, t):
        return self.ids.get(t)

    def decode(self, ids, skip_special_tokens=True, **_):
        self.rows.append([int(i) for i in ids])
        return " ".join(f"w{i}" for i in ids)


def _carried(tree, dims, directory):
    """``tree`` (JAX's ``init_params``) written by the port's
    ``save_params`` and read back by its ``load_params``."""
    convert.save_params(convert._unflatten(
        {k: np.asarray(v, np.float32)
         for k, v in convert._flatten(tree).items()}), dims, directory)
    loaded, got = convert.load_params(directory)
    assert got == dims
    return loaded


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """{"main", "draft"}: the toy's weights from JAX's ``init_params``
    (seeds 3 and 5), carried across by the port's converter."""
    return {name: _carried(jconvert.init_params(JDIMS, seed=seed), DIMS,
                           str(tmp_path_factory.mktemp(name)))
            for name, seed in (("main", 3), ("draft", 5))}


# ---------------------------------------------------------------------------
# the registries and the fused block's rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model_id", sorted(FAMILY))
def test_the_family_is_one_in_both_registries(model_id):
    """Each entry equal in both packages, at the family's widths: 80 mels,
    heads of 64, d_ffn = 4d, 1500 source positions."""
    got = registry.get_dims(model_id)
    assert got.to_dict() == dataclasses.asdict(jregistry.get_dims(model_id))
    d, heads, el, dl, vocab = FAMILY[model_id]
    assert (got.n_mels, got.d_model, got.encoder_heads, got.decoder_heads,
            got.head_dim, got.encoder_layers, got.decoder_layers,
            got.vocab_size, got.d_ffn, got.max_source_positions) == (
        80, d, heads, heads, 64, el, dl, vocab, 4 * d, 1500)


def _jax_rule(d, f, dtype):
    """The composition ``whisper_tpu.models.whisper.encoder_apply`` picks
    for ``fused_block`` (whisper.py:222-243), from the JAX package's own
    predicates."""
    if jeb.fits_vmem(d, f, dtype):
        return "whole"
    qkv_c = jeb.qkv_chunk_plan(d, dtype)
    mlp_ok = jem.fits_vmem(d, f, dtype) or jem.chunk_plan(d, f, dtype) \
        is not None
    return "chunked" if qkv_c is not None and mlp_ok else None


@pytest.mark.parametrize("d, mode", [(384, "whole"), (512, "whole"),
                                     (768, "chunked"), (1024, "chunked"),
                                     (1280, "chunked")])
def test_fused_block_mode_is_the_jax_rule(d, mode):
    """At each width the port's ``fused_block_mode`` is the JAX rule's pick
    (``mode`` in bf16, the rungs' dtype; in fp32, where the budget holds
    half the weights, whatever JAX picks), and its chunk plans are JAX's:
    at d = 768 the whole block's bf16 weights (2 (d^2 + 2 d f) 2 B = 21.2
    MB) exceed the 12 MiB budget, so whisper-small takes the "chunked"
    composition and never B9b."""
    f = 4 * d
    assert _jax_rule(d, f, jnp.bfloat16) == mode
    for tdt, jdt in ((torch.bfloat16, jnp.bfloat16),
                     (torch.float32, jnp.float32)):
        assert encoder_block.fused_block_mode(d, f, tdt) == _jax_rule(d, f,
                                                                      jdt)
        assert encoder_block.qkv_chunk_plan(d, tdt) == jeb.qkv_chunk_plan(
            d, jdt)
        assert encoder_block.mlp_fits_vmem(d, f, tdt) == jem.fits_vmem(
            d, f, jdt)
        assert encoder_block.mlp_chunk_plan(d, f, tdt) == jem.chunk_plan(
            d, f, jdt)


# ---------------------------------------------------------------------------
# the toy at d = 768, 12 heads, 51,864 ids
# ---------------------------------------------------------------------------

def _sessions(params, **over):
    """Sessions of both packages at x0 (fp32, the float32 wire; JAX at
    HIGHEST) with ``over`` of their configs."""
    jcfg, _ = jax_apply_variant(JaxCfg(), "x0")
    tcfg, _ = apply_variant(RuntimeCfg(), "x0")
    return (JaxSession(params, JDIMS, dataclasses.replace(jcfg, **over)),
            WhisperSession(params, DIMS, dataclasses.replace(tcfg, **over),
                           device="cpu"))


def test_x0_longform_tokens_equal_jax(weights):
    """fp32 (TF32 off, JAX at HIGHEST) through the long-form path at d =
    768 with 12 heads: the 40 s clip's two chunks in a bucket of two, an
    English-only tokenizer's prompt and EOT, 51,864-wide suppress masks at
    every step and the first; each chunk's tokens and the stitched text
    equal JAX's."""
    audio = _audio()
    jsess, tsess = _sessions(weights["main"], max_batch=2)
    jtok, ttok = RecordingTok(), RecordingTok()
    kw = dict(language="en", task="transcribe", max_new_tokens=MAX_NEW)
    jtext, _ = jax_longform(jsess, audio, tokenizer=jtok,
                            gen_cfg=JaxGenCfg(SUPPRESS, BEGIN_SUPPRESS), **kw)
    tokens = []
    ttext, _ = transcribe_longform(tsess, audio, tokenizer=ttok,
                                   gen_cfg=GenerationCfg(SUPPRESS,
                                                         BEGIN_SUPPRESS),
                                   token_collector=tokens, **kw)
    assert tokens[0].shape == (2, MAX_NEW)
    assert (tokens[0] < 51864).all()
    assert not np.isin(tokens[0], SUPPRESS).any()
    assert not np.isin(tokens[0][:, 0], BEGIN_SUPPRESS).any()
    assert len(jtok.rows) == 2 and ttok.rows == jtok.rows
    assert ttext == jtext


@pytest.mark.parametrize("share_encoder", [False, True])
def test_x0_speculative_equals_jax_and_greedy(weights, share_encoder):
    """Draft-and-verify at 51,864 ids, draft_k 4 (five queries a verify
    pass), over two rows of encoder states made from a seed, the draft on
    states of its own or on the main model's (``share_encoder``, as
    distil-medium.en on whisper-medium.en's), the English-only prompt and
    suppress masks: tokens, verify rounds and each row's committed tokens
    equal JAX's, and the tokens are the port's greedy ones (lossless)."""
    jp, tp = (jconvert.cast_params(weights["main"], jnp.float32),
              convert.params_from_numpy(weights["main"], "cpu",
                                        torch.float32))
    jd, td = (jconvert.cast_params(weights["draft"], jnp.float32),
              convert.params_from_numpy(weights["draft"], "cpu",
                                        torch.float32))
    rng = np.random.default_rng(23)
    enc = rng.normal(0, 1, (2, 1500, 768)).astype(np.float32)
    enc_d = enc if share_encoder else rng.normal(
        0, 1, (2, 1500, 768)).astype(np.float32)
    jenc, tenc = jnp.asarray(enc), torch.from_numpy(enc)
    jenc_d, tenc_d = jnp.asarray(enc_d), torch.from_numpy(enc_d)
    base = build_suppress_mask(51864, SUPPRESS)
    first = build_suppress_mask(51864, SUPPRESS + BEGIN_SUPPRESS)
    jt, jr, jn = jax_speculative(
        jp, JDIMS, jd, JDIMS, jenc, jenc_d, jnp.asarray(PROMPT, jnp.int32),
        jnp.asarray(base), jnp.asarray(first), max_new_tokens=MAX_NEW,
        eot_id=EOT, draft_k=DRAFT_K)
    tt, tr, tn = speculative_generate(
        tp, DIMS, td, DIMS, tenc, tenc_d, torch.tensor(PROMPT),
        torch.from_numpy(base), torch.from_numpy(first),
        max_new_tokens=MAX_NEW, eot_id=EOT, draft_k=DRAFT_K)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert int(tr) == int(jr)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    greedy = greedy_generate(tp, DIMS, tenc, torch.tensor(PROMPT),
                             torch.from_numpy(base), torch.from_numpy(first),
                             MAX_NEW, EOT)
    assert torch.equal(tt, greedy)
    assert not np.isin(tt.numpy(), SUPPRESS).any()


def _bf16_steps(got, want) -> float:
    got, want = _np(got), _np(want)
    scale = np.maximum(np.maximum(np.abs(got), np.abs(want)),
                       np.abs(want).mean())
    return float((np.abs(got - want) / (scale * 2.0 ** -7)).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_block_encoder_at_d768_is_jaxs_chunked_composition(dtype):
    """The encoder with int8 weights (x5's) and ``fused_block`` at d = 768
    and 12 heads, two layers, 64 positions (128 mel frames; the tiles'
    widths are the model's): the port runs the "chunked" composition (B9a,
    B1, a plain O-projection, B2; their plain versions here, no launch
    counted), and it is not the unfused block.  Against JAX's (Pallas in
    interpret mode): in fp32 within ``tests/test_torch_fused.py``'s fp32
    bound; in bf16 (x5) within the JAX tests' bound for the chunked
    composition (2e-2 of the largest value,
    ``tests/test_encoder_block.py::test_encoder_engages_chunked_block_at_medium_dims``)
    and no farther (within a bf16 step) than JAX's from the port's fp32
    evaluation of the same weights: at this width the two bf16 paths lie
    4-5 bf16 steps from each other and 3-4 from fp32."""
    tdt, jdt = {"float32": (torch.float32, jnp.float32),
                "bfloat16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    dims = registry.WhisperDims(n_mels=80, d_model=768, encoder_layers=2,
                                encoder_heads=12, decoder_layers=1,
                                decoder_heads=12, vocab_size=256,
                                max_source_positions=64,
                                max_target_positions=32)
    assert encoder_block.fused_block_mode(768, 3072, tdt) == "chunked"
    jp = jconvert.cast_params(jquant.quantize_params(
        jconvert.init_params(dims, 3)), jdt)
    tq = quant.quantize_params(convert.init_params(dims, 3))
    tp = convert.params_from_numpy(tq, "cpu", tdt)
    mel = torch.from_numpy(np.random.default_rng(4).normal(
        0, 1, (2, 80, 128)).astype(np.float32))
    want = jw.encoder_apply(jp, dims, jnp.asarray(mel.numpy()),
                            fused_block=True)
    for mod, name in ((encoder_block, "ln_qkv_launches"),
                      (encoder_block, "out_mlp_launches"),
                      (attention, "launches"), (encoder_mlp, "launches")):
        setattr(mod, name, 0)
    got = tw.encoder_apply(tp, dims, mel, fused_block=True)
    assert got.dtype == tdt and tuple(got.shape) == (2, 64, 768)
    assert encoder_block.ln_qkv_launches == attention.launches == 0
    assert encoder_block.out_mlp_launches == encoder_mlp.launches == 0
    assert not torch.equal(got, tw.encoder_apply(tp, dims, mel))
    if tdt == torch.float32:
        np.testing.assert_allclose(_np(got), _np(want), atol=3e-4,
                                   rtol=1e-4)
        return
    g, w = _np(got), _np(want)
    assert np.abs(g - w).max() / np.abs(w).max() < 2e-2
    fp32 = tw.encoder_apply(convert.params_from_numpy(tq, "cpu",
                                                      torch.float32),
                            dims, mel, fused_block=True)
    assert _bf16_steps(g, fp32) <= _bf16_steps(w, fp32) + 1.0


# ---------------------------------------------------------------------------
# the decode kernels' plain versions at 12 and 16 heads of 64
# ---------------------------------------------------------------------------

N_L, B, S, DH = 2, 2, 64, 64


@pytest.mark.parametrize("heads", [12, 16])
@pytest.mark.parametrize("kernel", ["B3", "B4", "B6", "B7"])
def test_decode_kernels_at_the_familys_heads_match_jax(kernel, heads):
    """B3 (the new row written at ``pos`` 40 with mixed ``pad_count``: the
    caches unpacked equal JAX's exactly), B4 (int8 x int8), B6 (the int8
    cache dequantized) and B7 (B4's verify pass, five queries, each bitwise
    the single-token plain version) at whisper-small's 12 and
    whisper-medium's 16 heads, layer 1 of 2, 64 columns all valid: within
    2 bf16 steps of the JAX kernels (interpret mode), test_torch_ops's
    tolerance."""
    rng = np.random.default_rng(100 * heads + ["B3", "B4", "B6",
                                               "B7"].index(kernel))
    layer, h = 1, heads
    if kernel == "B3":
        qj, qt = _bf16_pair(rng.normal(0, 1, (B, h, DH)) * DH ** -0.5)
        pos, pads = 40, np.array([0, 7], np.int32)
        (kcj, kct), (vcj, vct) = (_bf16_pair(rng.normal(0, 1, (
            N_L, B, h, S, DH))) for _ in range(2))
        (knj, knt), (vnj, vnt) = (_bf16_pair(rng.normal(0, 1, (B, h, DH)))
                                  for _ in range(2))
        want, k_out, v_out = self_attend_step_packed(
            qj, knj, vnj, pack_self_cache(kcj), pack_self_cache(vcj),
            jnp.int32(layer), jnp.int32(pos), jnp.asarray(pads),
            interpret=True)
        got = t_self.self_attend_step_plain(qt, knt, vnt, kct, vct, layer,
                                            pos, torch.from_numpy(pads))
        np.testing.assert_array_equal(_np(kct), _unpack_self(k_out, S))
        np.testing.assert_array_equal(_np(vct), _unpack_self(v_out, S))
        assert got.shape == (B, h, DH)
        _assert_bf16_close(got, want, steps=2.0)
        return
    k8, v8 = (rng.integers(-127, 128, (N_L, B, h, S, DH), dtype=np.int8)
              for _ in range(2))
    ks, vs = (rng.uniform(0.001, 0.02, (N_L, B, h)).astype(np.float32)
              for _ in range(2))
    mxu = kernel != "B6"
    packed = ((pack_cross_kv_t if mxu else pack_cross_kv)(jnp.asarray(k8)),
              pack_cross_kv(jnp.asarray(v8)), jnp.asarray(ks),
              jnp.asarray(vs), jnp.int32(layer))
    args = (torch.from_numpy(k8), torch.from_numpy(v8), torch.from_numpy(ks),
            torch.from_numpy(vs), layer)
    if kernel == "B7":
        qj, qt = _bf16_pair(rng.normal(0, 1, (B, DRAFT_K + 1, h, DH))
                            * DH ** -0.5)
        want = cross_attend_multi_packed(qj, *packed, s_valid=S,
                                         int8_mxu=True, interpret=True)
        got = t_cross.cross_attend_multi_plain(qt, *args, s_valid=S,
                                               int8_mxu=True)
        assert got.shape == (B, DRAFT_K + 1, h, DH)
        for i in range(DRAFT_K + 1):
            assert torch.equal(got[:, i], t_cross.cross_attend_step_plain(
                qt[:, i].contiguous(), *args, s_valid=S))
    else:
        qj, qt = _bf16_pair(rng.normal(0, 1, (B, h, DH)) * DH ** -0.5)
        want = cross_attend_step_packed(qj, *packed, s_valid=S,
                                        int8_mxu=mxu, interpret=True)
        plain = (t_cross.cross_attend_step_plain if mxu
                 else t_cross.cross_attend_step_dequant_plain)
        got = plain(qt, *args, s_valid=S)
        assert got.shape == (B, h, DH)
    _assert_bf16_close(got, want, steps=2.0)


# ---------------------------------------------------------------------------
# the memory gate at the family's dims
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bucket", [1, 16])
@pytest.mark.parametrize("model_id, draft", [
    ("openai/whisper-small", None),
    ("openai/whisper-medium", None),
    ("openai/whisper-medium.en", "distil-whisper/distil-medium.en")])
def test_decode_footprint_equals_jax_term_by_term(model_id, draft, bucket):
    """The port's gate and JAX's at the family's dims, x5's int8 cross
    cache and the bf16 one: every term equal (one cache copy, as the port
    prices it, and JAX's two)."""
    dims, jdims = registry.get_dims(model_id), jregistry.get_dims(model_id)
    for int8 in (False, True):
        kw = dict(weight_bytes=2, kv_bytes=2, int8_cross=int8)
        for copies in (1.0, 2.0):
            want = jhbm.decode_footprint(
                jdims, bucket, 132, cache_copies=copies, **kw,
                **({} if draft is None
                   else {"draft_dims": jregistry.get_dims(draft)}))
            got = hbm.decode_footprint(
                dims, bucket, 132, cache_copies=copies, **kw,
                **({} if draft is None
                   else {"draft_dims": registry.get_dims(draft)}))
            assert got == want


# ---------------------------------------------------------------------------
# the prompt's special ids
# ---------------------------------------------------------------------------

def test_an_english_only_tokenizer_without_en_raises_in_both_packages():
    """Both packages read the prompt's ids from a tokenizer where one is
    given (an English-only tokenizer's here) and raise alike for one that
    lacks ``<|en|>``; without one both take the multilingual fallback
    (ROADMAP §3, shared with the JAX package, not a fault)."""
    got = specials.special_tokens("en", "transcribe", RecordingTok())
    assert dataclasses.asdict(got) == dataclasses.asdict(
        jspecials.special_tokens("en", "transcribe", RecordingTok()))
    assert [got.sot, got.lang, got.task, got.no_timestamps] == PROMPT
    assert got.eot == EOT
    no_en = RecordingTok({k: v for k, v in SPECIALS.items()
                          if k != "<|en|>"})
    for module in (specials, jspecials):
        with pytest.raises(KeyError, match="<\\|en\\|>"):
            module.special_tokens("en", "transcribe", no_en)
    assert dataclasses.asdict(specials.special_tokens(
        "en", "transcribe", None)) == dataclasses.asdict(
        jspecials.special_tokens("en", "transcribe", None))


# ---------------------------------------------------------------------------
# the gate's price of a bucket program's pools, against the card's
# ---------------------------------------------------------------------------

# A bucket program's memory pools on the card (NVIDIA H100 80GB HBM3, 700 W,
# x5, bucket 16, GiB), measured by chip_smoke.py's [medium] (a), (b) and (d)
# lines (PERF.md §6): whisper-small's and whisper-medium's greedy programs,
# and whisper-medium.en's speculative program with a distil-medium.en draft
# on the shared encoder, which the gate prices as the greedy one
# (``speculative_footprint``: no draft encoder).
CARD_POOLS = [("openai/whisper-small", 0.648),
              ("openai/whisper-medium", 0.840),
              ("openai/whisper-medium.en", 0.873)]


@pytest.mark.parametrize("model_id, gib", CARD_POOLS)
def test_program_pool_bytes_is_within_1_5x_of_the_cards_pools(model_id,
                                                               gib):
    """``program_pool_bytes`` (the gate's price of a program's pools before
    any key is captured) within 1.5x of what the card's programs kept,
    either way, as ``tests/test_torch_large_family.py`` holds it at the
    large family."""
    est = hbm.program_pool_bytes(registry.get_dims(model_id), 16, 4,
                                 act_bytes=2) / 2 ** 30
    assert gib / 1.5 <= est <= 1.5 * gib, (est, gib)
