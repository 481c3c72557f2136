"""The port's speculative decoding against the JAX package (CPU): kernel
B7's plain version, per-row positions in the decoder step,
``speculative_generate``, the session and CLI paths, and ``utils.hbm``.

Same weights (``init_params(dims, seed)``) and same inputs, made from a seed
with numpy, through ``whisper_tpu`` (Pallas kernels in interpret mode, as
its own tests run them on the CPU) and through ``whisper_tpu_torch`` (the
kernels' plain versions, which a CPU tensor takes).  Token sequences, round
counts and committed counts must be EQUAL at fp32; tolerances of the
numeric comparisons are stated where they are used.
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from whisper_tpu.models import convert as jconvert
from whisper_tpu.models import whisper as jw
from whisper_tpu.ops.cross_attention import (
    cross_attend_multi_packed,
    pack_cross_kv,
    pack_cross_kv_t,
)
from whisper_tpu.pipeline.longform import transcribe_longform as jax_longform
from whisper_tpu.runtime.session import RuntimeCfg as JaxCfg
from whisper_tpu.runtime.session import WhisperSession as JaxSession
from whisper_tpu.runtime.speculative import (
    speculative_generate as jax_speculative,
)
from whisper_tpu.utils import hbm as jhbm
from whisper_tpu_torch.bench import cli
from whisper_tpu_torch.models import convert
from whisper_tpu_torch.models import whisper as tw
from whisper_tpu_torch.models.registry import WhisperDims, get_dims
from whisper_tpu_torch.ops import cross_attention as t_cross
from whisper_tpu_torch.pipeline.longform import transcribe_longform
from whisper_tpu_torch.runtime.generate import (
    build_suppress_mask,
    greedy_generate,
)
from whisper_tpu_torch.runtime.session import RuntimeCfg, WhisperSession
from whisper_tpu_torch.runtime.speculative import speculative_generate
from whisper_tpu_torch.utils import hbm
from whisper_tpu_torch.variants import quant
from whisper_tpu_torch.variants.ladder import apply_variant

torch.set_num_threads(2)

NANO = get_dims("test/whisper-nano")
# head_dim 64 and an even head count: the dims the cross-attention kernels
# (and the JAX package's packing gate) take.
HD64 = WhisperDims(n_mels=80, d_model=128, encoder_layers=2, encoder_heads=2,
                   decoder_layers=2, decoder_heads=2, vocab_size=256,
                   max_source_positions=96, max_target_positions=64)
# the same with the encoder's full 1,500 positions, for session runs
HD64_LONG = dataclasses.replace(HD64, max_source_positions=1500)
EOT = 2


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _pair(dims, seed, dtype=torch.float32):
    """The same weights for both packages."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    return (jconvert.cast_params(jconvert.init_params(dims, seed), jdt),
            convert.params_from_numpy(convert.init_params(dims, seed), "cpu",
                                      dtype))


def _bf16_steps(got, want) -> float:
    got, want = _np(got), _np(want)
    scale = np.maximum(np.maximum(np.abs(got), np.abs(want)),
                       np.abs(want).mean())
    return float((np.abs(got - want) / (scale * 2.0 ** -7)).max())


# ---------------------------------------------------------------------------
# B7: T queries against one layer's int8 cross cache
# ---------------------------------------------------------------------------

# T -> S of the cache: one query and nine (past one of the card's chunks
# of eight queries) against eleven 192-row segments
_B7_ROWS = {2: 200, 5: 200, 1: 2000, 9: 2000}


@pytest.mark.parametrize("t", [2, 5, 1, 9])
@pytest.mark.parametrize("int8_mxu", [False, True])
def test_b7_plain_matches_jax_and_each_query_is_the_single_token_one(
        int8_mxu, t):
    """Against ``cross_attend_multi_packed`` in interpret mode: 2 bf16 steps
    (the int8 path: exp and the sum of e may differ in the last fp32 bits,
    which moves one 7-bit probability by a step; the dequantizing path:
    XLA on the CPU keeps the bf16 p * v products in fp32, the port rounds
    each as the kernel is written).  And each query BITWISE equal to the
    port's single-token plain version (B4's or B6's) on that query."""
    rng = np.random.default_rng(10 * t + int8_mxu)
    n_l, b, h, s, dh, layer = 2, 2, 4, _B7_ROWS[t], 64, 1
    k8 = rng.integers(-127, 128, (n_l, b, h, s, dh), dtype=np.int8)
    v8 = rng.integers(-127, 128, (n_l, b, h, s, dh), dtype=np.int8)
    ks = rng.uniform(0.001, 0.02, (n_l, b, h)).astype(np.float32)
    vs = rng.uniform(0.001, 0.02, (n_l, b, h)).astype(np.float32)
    q = (rng.normal(0, 1, (b, t, h, dh)) * dh ** -0.5).astype(np.float32)
    qj = jnp.asarray(q, jnp.bfloat16)
    qt = torch.from_numpy(q).to(torch.bfloat16)
    pack_k = pack_cross_kv_t if int8_mxu else pack_cross_kv
    want = cross_attend_multi_packed(
        qj, pack_k(jnp.asarray(k8)), pack_cross_kv(jnp.asarray(v8)),
        jnp.asarray(ks), jnp.asarray(vs), jnp.int32(layer), s_valid=s - 8,
        int8_mxu=int8_mxu, interpret=True)
    args = (torch.from_numpy(k8), torch.from_numpy(v8), torch.from_numpy(ks),
            torch.from_numpy(vs), layer)
    t_cross.multi_launches = 0
    got = t_cross.cross_attend_multi(qt, *args, s_valid=s - 8,
                                     int8_mxu=int8_mxu)
    assert t_cross.multi_launches == 0      # a CPU tensor: the plain version
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (b, t, h, dh)
    assert _bf16_steps(got, want) <= 2.0
    one = t_cross.cross_attend_step if int8_mxu \
        else t_cross.cross_attend_step_dequant
    for i in range(t):
        assert torch.equal(got[:, i], one(qt[:, i].contiguous(), *args,
                                          s_valid=s - 8))


def test_b7_fp32_queries_are_bitwise_the_single_token_ones():
    """An fp32 q through the int8 x int8 path: every part is exact or a
    single rounding, so T = 9 queries equal nine single-token calls."""
    rng = np.random.default_rng(3)
    n_l, b, h, s, dh = 1, 1, 2, 96, 64
    k8 = torch.from_numpy(rng.integers(-127, 128, (n_l, b, h, s, dh),
                                       dtype=np.int8))
    v8 = torch.from_numpy(rng.integers(-127, 128, (n_l, b, h, s, dh),
                                       dtype=np.int8))
    ks = torch.full((n_l, b, h), 0.01)
    q = torch.from_numpy(rng.normal(0, 0.125, (b, 9, h, dh))
                         .astype(np.float32))
    got = t_cross.cross_attend_multi(q, k8, v8, ks, ks, 0, s_valid=s,
                                     int8_mxu=True)
    for i in range(9):
        assert torch.equal(got[:, i], t_cross.cross_attend_step(
            q[:, i].contiguous(), k8, v8, ks, ks, 0, s_valid=s))


# ---------------------------------------------------------------------------
# Per-row positions
# ---------------------------------------------------------------------------

def _prefill_pair(dims, seed, batch, max_len):
    jp, tp = _pair(dims, seed)
    rng = np.random.default_rng(seed + 1)
    enc = rng.normal(0, 1, (batch, dims.max_source_positions,
                            dims.d_model)).astype(np.float32)
    prompt = np.asarray([[3, 5, 7]] * batch)
    _, jc = jw.decoder_prefill(jp, dims, jnp.asarray(prompt, jnp.int32),
                               jnp.asarray(enc), max_len)
    _, tc = tw.decoder_prefill(tp, dims, torch.from_numpy(prompt),
                               torch.from_numpy(enc), max_len)
    return jp, tp, jc, tc


def test_decoder_step_with_per_row_positions_matches_jax():
    """fp32: logits to 3e-4 and the cache rows each row writes to 2e-5;
    every other row of the cache stays as the prefill left it."""
    jp, tp, jc, tc = _prefill_pair(HD64, 4, 3, 12)
    before = tc.self_k.clone()
    pos = np.asarray([3, 5, 8])
    tok = np.asarray([9, 11, 13])
    jl, jc = jw.decoder_step(jp, HD64, jnp.asarray(tok, jnp.int32),
                             jnp.asarray(pos, jnp.int32), jc)
    tl, tc2 = tw.decoder_step(tp, HD64, torch.from_numpy(tok),
                              torch.from_numpy(pos), tc)
    assert tc2.self_k is tc.self_k            # written in place
    np.testing.assert_allclose(_np(tl), _np(jl), atol=3e-4, rtol=0)
    for r, p in enumerate(pos):
        for got, want in ((tc.self_k, jc.self_k), (tc.self_v, jc.self_v)):
            np.testing.assert_allclose(_np(got[:, r, :, p]),
                                       _np(want[:, r, :, p]), atol=2e-5,
                                       rtol=0)
        keep = [s for s in range(12) if s != p]
        assert torch.equal(tc.self_k[:, r][:, :, keep],
                           before[:, r][:, :, keep])
        assert not torch.equal(tc.self_k[:, r, :, p], before[:, r, :, p])


def test_equal_per_row_positions_are_the_scalar_step_bitwise():
    _, tp, _, tc = _prefill_pair(HD64, 5, 3, 12)
    tc2 = tw.KVCache(*(None if t is None else t.clone() for t in tc))
    tok = torch.tensor([9, 11, 13])
    a, ca = tw.decoder_step(tp, HD64, tok, 4, tc)
    b, cb = tw.decoder_step(tp, HD64, tok, torch.tensor([4, 4, 4]), tc2)
    assert torch.equal(a, b)
    assert torch.equal(ca.self_k, cb.self_k)
    assert torch.equal(ca.self_v, cb.self_v)


def test_per_row_positions_refuse_the_kernel_step_and_the_int8_self_cache():
    """As in the JAX package: the kernel step and the int8 self cache take
    one position for all rows and one token a row."""
    _, tp, _, _ = _prefill_pair(HD64, 5, 2, 12)
    enc = torch.zeros((2, HD64.max_source_positions, HD64.d_model))
    _, cache = tw.decoder_prefill(tp, HD64, torch.tensor([[3, 5]] * 2), enc,
                                  12, int8_cross_kv=True)
    tok, pos = torch.tensor([9, 11]), torch.tensor([2, 3])
    with pytest.raises(ValueError, match="one position"):
        tw.decoder_step(tp, HD64, tok, pos, cache, kernel_step=True,
                        cross_len=96)
    with pytest.raises(ValueError, match="int8 self cache"):
        tw.decoder_step(tp, HD64, tok, pos, tw.quantize_self_kv(cache),
                        cross_len=96)
    _, plain = tw.decoder_prefill(tp, HD64, torch.tensor([[3, 5]] * 2), enc,
                                  12)
    with pytest.raises(ValueError, match="int8 cross cache"):
        tw.decoder_step(tp, HD64, tok, pos, plain, cross_len=96)


# ---------------------------------------------------------------------------
# speculative_generate
# ---------------------------------------------------------------------------

def _encode(dims, jp, tp, mel):
    return (jw.encoder_apply(jp, dims, jnp.asarray(mel)),
            tw.encoder_apply(tp, dims, torch.from_numpy(mel)))


def _both(dims, main, draft, mel, prompt, max_new, k, suppress=(), **kw):
    """(port result, JAX result) of speculative_generate on the same
    weights and encoder inputs; each side encodes with its own encoder."""
    (jp, tp), (jd, td) = main, draft
    jenc, tenc = _encode(dims, jp, tp, mel)
    jenc_d, tenc_d = (jenc, tenc) if draft is main \
        else _encode(dims, jd, td, mel)
    mask = build_suppress_mask(dims.vocab_size, list(suppress))
    want = jax_speculative(
        jp, dims, jd, dims, jenc, jenc_d, jnp.asarray(prompt, jnp.int32),
        jnp.asarray(mask), jnp.asarray(mask), max_new_tokens=max_new,
        eot_id=EOT, draft_k=k, **kw)
    got = speculative_generate(
        tp, dims, td, dims, tenc, tenc_d, torch.tensor(prompt),
        torch.from_numpy(mask), torch.from_numpy(mask),
        max_new_tokens=max_new, eot_id=EOT, draft_k=k, **kw)
    greedy = greedy_generate(
        tp, dims, tenc, torch.tensor(prompt), torch.from_numpy(mask),
        torch.from_numpy(mask), max_new, EOT,
        int8_cross_kv=kw.get("int8_cross_kv", False))
    return got, want, greedy


def _assert_equal_runs(got, want, greedy):
    toks, rounds, n = got
    jtoks, jrounds, jn = want
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    assert rounds == int(jrounds)
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    assert torch.equal(toks, greedy)          # lossless


@pytest.fixture(scope="module")
def nano():
    return _pair(NANO, 0), _pair(NANO, 99)


SPEC_CASES = {
    # name: (draft, batch, prompt, max_new, k, suppress)
    "adversarial_k1": ("adv", 1, [3, 5], 12, 1, ()),
    "adversarial_k3_batch4": ("adv", 4, [3, 5], 12, 3, ()),
    "adversarial_k4": ("adv", 2, [3, 5], 12, 4, ()),
    "perfect_k4": ("same", 2, [3, 5], 12, 4, ()),
    "perfect_k3_batch4": ("same", 4, [3], 10, 3, ()),
    "suppress_list": ("adv", 2, [3], 10, 3, (7, 8, 9, 102, 919)),
    "rows_finish_at_different_lengths": ("adv", 8, [3], 10, 3, ()),
}


@pytest.mark.parametrize("case", sorted(SPEC_CASES))
def test_speculative_generate_equals_jax_and_greedy(nano, case):
    """x0 fp32: tokens, n_rounds and n_committed equal to the JAX package's,
    and the tokens equal to the port's own greedy_generate."""
    which, batch, prompt, max_new, k, suppress = SPEC_CASES[case]
    main, adv = nano
    rng = np.random.default_rng(len(case))
    mel = rng.normal(0, 1, (batch, NANO.n_mels, 3000)).astype(np.float32)
    got, want, greedy = _both(NANO, main, main if which == "same" else adv,
                              mel, prompt, max_new, k, suppress)
    _assert_equal_runs(got, want, greedy)
    if which == "same":           # every proposal accepted
        assert got[1] <= -(-max_new // (k + 1)) + 1
    if suppress:
        assert not (set(got[0].flatten().tolist()) - {EOT}) & set(suppress)


def test_a_row_that_ends_early_is_frozen_while_the_rest_goes_on(nano):
    """All but EOT and five tokens suppressed, so rows reach EOT at
    different rounds: a frozen row commits nothing more and pads with EOT
    while the others go on, and the counts still equal the JAX package's."""
    main, adv = nano
    rng = np.random.default_rng(21)
    mel = rng.normal(0, 1, (6, NANO.n_mels, 3000)).astype(np.float32)
    keep = {EOT, 102, 139, 475, 919, 246}
    suppress = [i for i in range(NANO.vocab_size) if i not in keep]
    got, want, greedy = _both(NANO, main, adv, mel, [3], 14, 2, suppress)
    _assert_equal_runs(got, want, greedy)
    n = got[2].numpy()
    assert (n >= 1).all() and (n <= 14 + 2).all()


@pytest.mark.parametrize("case", ["int8_cross_kv", "packed_draft_dequant",
                                  "packed_draft_int8", "packed_main_dequant",
                                  "packed_main_int8",
                                  "packed_main_int8_perfect_draft"])
def test_speculative_generate_with_the_int8_cross_cache(case):
    """The int8 cross cache and the kernel routes (JAX: the packed caches,
    Pallas in interpret mode; the port: B4/B6/B7's plain versions) at fp32:
    tokens, rounds and committed counts equal to JAX's, tokens equal to the
    port's greedy_generate(int8_cross_kv=True)."""
    main, adv = _pair(HD64, 0), _pair(HD64, 99)
    rng = np.random.default_rng(5)
    mel = rng.normal(0, 1, (2, HD64.n_mels,
                            2 * HD64.max_source_positions)).astype(np.float32)
    kw = dict(int8_cross_kv=True)
    if case.startswith("packed"):
        kw.update(packed_draft=True, int8_mxu="int8" in case,
                  packed_main="main" in case)
    draft = main if case.endswith("perfect_draft") else adv
    t_cross.multi_launches = 0
    got, want, greedy = _both(HD64, main, draft, mel, [3, 5], 10, 3, **kw)
    _assert_equal_runs(got, want, greedy)
    assert t_cross.multi_launches == 0


@pytest.mark.parametrize("rung", ["x4", "x5"])
def test_speculative_is_lossless_against_the_ports_greedy_at_x4_and_x5(rung):
    """bf16, int8 weights, the int8 cross cache and the kernels' plain
    versions: the session's speculative tokens equal its greedy tokens, for
    an adversarial draft and for one with the main model's own weights."""
    cfg, _ = apply_variant(RuntimeCfg(max_batch=4), rung)
    params = convert.init_params(HD64_LONG, seed=0)
    sess = WhisperSession(params, HD64_LONG, cfg, device="cpu")
    assert sess._kernel_step
    rng = np.random.default_rng(3)
    mel = torch.from_numpy(rng.normal(0, 1, (80, 6000)).astype(np.float32))
    args = (mel, [0, 2500, 3000], [3, 5], 8, EOT)
    want = sess.transcribe_from_mel(*args)
    for draft in (convert.init_params(HD64_LONG, seed=99), params):
        sess.set_draft_model(draft, HD64_LONG)
        got = sess.transcribe_from_mel(*args, speculative=True, draft_k=3)
        np.testing.assert_array_equal(got, want)


def test_draft_k_below_one_raises(nano):
    main, adv = nano
    enc = torch.zeros((1, 1500, NANO.d_model))
    mask = torch.zeros(NANO.vocab_size)
    for bad in (0, -1):
        with pytest.raises(ValueError, match="draft_k"):
            speculative_generate(main[1], NANO, adv[1], NANO, enc, enc,
                                 torch.tensor([3]), mask, mask, 4, EOT,
                                 draft_k=bad)


# ---------------------------------------------------------------------------
# Session, long-form path and CLI
# ---------------------------------------------------------------------------

class Tok:
    """Special ids that fit the small vocabularies; ids as text."""

    ids = {"<|startoftranscript|>": 250, "<|endoftext|>": 251,
           "<|en|>": 252, "<|transcribe|>": 253, "<|notimestamps|>": 254,
           "<|startofprev|>": 255}

    def token_to_id(self, t):
        return self.ids.get(t)

    def decode(self, ids, skip_special_tokens=True, **_):
        return " ".join(f"w{i}" for i in ids)


def test_longform_text_with_a_draft_equals_greedy_and_jax():
    """x0 through ``transcribe_longform`` (65 s, three chunks in a bucket of
    four): the text with an adversarial draft, a perfect draft and a draft
    that shares the main encoder equals the greedy text and the JAX
    package's speculative text."""
    params = convert.init_params(NANO, seed=0)
    rng = np.random.default_rng(7)
    audio = rng.normal(0, 0.1, int(16000 * 65)).astype(np.float32)
    kw = dict(language="en", task="transcribe", max_new_tokens=6,
              tokenizer=Tok())
    sess = WhisperSession(params, NANO,
                          RuntimeCfg(dtype="float32", max_batch=4),
                          device="cpu")
    assert not sess.has_draft
    want, _ = transcribe_longform(sess, audio, **kw)
    assert want
    for draft, share in ((convert.init_params(NANO, seed=99), False),
                         (params, False),
                         (convert.init_params(NANO, seed=99), True)):
        sess.set_draft_model(draft, NANO, share_encoder=share)
        assert sess.has_draft
        got, timing = transcribe_longform(sess, audio, speculative=True,
                                          draft_k=3, **kw)
        assert got == want
        assert timing.model_only_s > 0
    jsess = JaxSession(params, NANO, JaxCfg(dtype="float32", max_batch=4))
    jsess.set_draft_model(jconvert.init_params(NANO, seed=99), NANO)
    jtext, _ = jax_longform(jsess, audio, speculative=True, draft_k=3, **kw)
    assert jtext == want


def test_session_refusals_are_the_jax_packages():
    sess = WhisperSession(convert.init_params(NANO, seed=0), NANO,
                          RuntimeCfg(dtype="float32", max_batch=2),
                          device="cpu")
    mel = torch.zeros((NANO.n_mels, 3000))
    with pytest.raises(RuntimeError, match="set_draft_model"):
        sess.transcribe_from_mel(mel, [0], [3], 4, EOT, speculative=True)
    narrow = dataclasses.replace(NANO, d_model=NANO.d_model // 2,
                                 encoder_heads=1, decoder_heads=1)
    with pytest.raises(ValueError, match="share_encoder"):
        sess.set_draft_model(convert.init_params(narrow, seed=1), narrow,
                             share_encoder=True)
    assert not sess.has_draft
    sess.set_draft_model(convert.init_params(narrow, seed=1), narrow)
    for kw in (dict(num_beams=2), dict(ts_cfg=object()),
               dict(temperature=0.5), dict(pad_count=1)):
        with pytest.raises(ValueError, match="plain greedy"):
            sess.transcribe_from_mel(mel, [0], [3], 4, EOT, speculative=True,
                                     **kw)
    with pytest.raises(ValueError, match="draft_k"):
        sess.transcribe_from_mel(mel, [0], [3], 4, EOT, speculative=True,
                                 draft_k=0)
    # a narrower draft (its own encoder) still gives the greedy tokens
    np.testing.assert_array_equal(
        sess.transcribe_from_mel(mel, [0], [3], 4, EOT, speculative=True),
        sess.transcribe_from_mel(mel, [0], [3], 4, EOT))


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A tokenizer.json with Whisper's specials at small ids (nano's
    vocabulary is 1,000); no params: the runs use --allow-random-init."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, trainers

    d = tmp_path_factory.mktemp("nano-sidecars")
    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(["some text to build a vocab"], trainers.BpeTrainer(
        vocab_size=400, initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    tok.add_special_tokens(["<|endoftext|>", "<|startoftranscript|>", "<|en|>",
                            "<|transcribe|>", "<|translate|>",
                            "<|notimestamps|>"])
    tok.save(str(d / "tokenizer.json"))
    return d


def _cli_args(tmp, audio_dir, model_dir, *extra):
    return ["--audio-dir", str(audio_dir), "--model-id", "test/whisper-nano",
            "--onnx-dir", str(model_dir), "--allow-random-init",
            "--max-new-tokens", "5", "--variant", "x0", "--warmup", "1",
            "--out-csv", str(tmp / "c.csv"), "--out-json", str(tmp / "j.json"),
            "--out-summary-json", str(tmp / "s.json"), *extra]


def test_cli_with_a_draft_writes_the_text_it_writes_without(tmp_path,
                                                            model_dir):
    import json
    import struct

    audio_dir = tmp_path / "audio"
    audio_dir.mkdir()
    rng = np.random.default_rng(0)
    for name, secs in (("a.wav", 3.0), ("b.wav", 40.0)):
        pcm = np.clip(rng.normal(0, 0.1, int(secs * 16000)) * 32768.0, -32768,
                      32767).astype("<i2").tobytes()
        hdr = struct.pack("<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + len(pcm),
                          b"WAVE", b"fmt ", 16, 1, 1, 16000, 32000, 2, 16,
                          b"data", len(pcm))
        (audio_dir / name).write_bytes(hdr + pcm)
    texts = {}
    for label, extra in (("greedy", ()),
                         ("draft", ("--draft-model-id", "test/whisper-nano",
                                    "--draft-k", "3")),
                         ("shared", ("--draft-model-id", "test/whisper-nano",
                                     "--draft-share-encoder"))):
        out = tmp_path / label
        out.mkdir()
        assert cli.main(_cli_args(out, audio_dir, model_dir, *extra),
                        device="cpu") == 0
        rows = json.load(open(out / "j.json"))
        texts[label] = [r["text"] for r in rows]
        assert len(rows) == 2
    assert texts["draft"] == texts["greedy"] == texts["shared"]
    assert any(texts["greedy"])


CLI_REFUSALS = {
    "beams": ["--num-beams", "2"],
    "timestamps": ["--timestamps"],
    "word_timestamps": ["--word-timestamps"],
    "temperatures": ["--temperatures", "0,0.2"],
    "sequential": ["--longform-mode", "sequential"],
}


@pytest.mark.parametrize("case", sorted(CLI_REFUSALS))
def test_cli_refuses_a_draft_beside_what_it_does_not_compose_with(case,
                                                                  tmp_path):
    """The draft's own refusal is the JAX CLI's message: beams, timestamps,
    word timestamps, temperatures and the sequential mode each run without a
    draft, so the draft's refusal is the one given."""
    argv = ["--audio-dir", str(tmp_path), "--model-id", "test/whisper-nano",
            "--allow-random-init", "--draft-model-id", "test/whisper-nano",
            *CLI_REFUSALS[case]]
    with pytest.raises(SystemExit, match="composes with plain greedy "
                                         "chunked/pipelined modes only"):
        cli.main(argv, device="cpu")


def test_cli_draft_k_zero_returns_2(tmp_path):
    assert cli.main(["--audio-dir", str(tmp_path), "--model-id",
                     "test/whisper-nano", "--allow-random-init",
                     "--draft-model-id", "test/whisper-nano", "--draft-k",
                     "0"], device="cpu") == 2


# ---------------------------------------------------------------------------
# utils.hbm
# ---------------------------------------------------------------------------

HBM_DIMS = [get_dims("openai/whisper-base"), get_dims("openai/whisper-tiny"),
            NANO]


@pytest.mark.parametrize("i", range(len(HBM_DIMS)))
def test_hbm_values_equal_the_jax_packages(i):
    from whisper_tpu.models.registry import get_dims as jget

    dims = HBM_DIMS[i]
    jdims = jget(["openai/whisper-base", "openai/whisper-tiny",
                  "test/whisper-nano"][i])
    draft, jdraft = get_dims("openai/whisper-tiny"), \
        jget("openai/whisper-tiny")
    assert hbm.param_count(dims) == jhbm.param_count(jdims)
    n = sum(int(np.asarray(v.q if isinstance(v, quant.QTensor) else v).size)
            for v in _leaves(convert.init_params(NANO, seed=0)))
    assert hbm.param_count(NANO) == n
    assert hbm.param_bytes(dims, 4) == jhbm.param_bytes(jdims, 4)
    for kw in (dict(), dict(kv_bytes=4), dict(int8_cross=True),
               dict(int8_cross=True, int8_self=True)):
        assert hbm.kv_cache_bytes(dims, 16, 132, **kw) \
            == jhbm.kv_cache_bytes(jdims, 16, 132, **kw)
    for kw in (dict(), dict(draft_dims=draft, cache_copies=2.0),
               dict(draft_dims=draft, shared_draft_params=True,
                    int8_cross=True, cache_copies=1.0),
               dict(enc_len=96, weight_bytes=4, kv_bytes=4)):
        jkw = dict(kw)
        if "draft_dims" in jkw:
            jkw["draft_dims"] = jdraft
        assert hbm.decode_footprint(dims, 16, 132, **kw) \
            == jhbm.decode_footprint(jdims, 16, 132, **jkw)
    fp = hbm.decode_footprint(dims, 16, 132)
    for budget in (1 << 20, 1 << 40, None, 0):
        if budget is None:
            continue
        assert hbm.check_fit(fp, budget) is None \
            or "GiB" in hbm.check_fit(fp, budget)
        assert (hbm.check_fit(fp, budget) is None) \
            == (jhbm.check_fit(fp, budget) is None)


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def test_hbm_shared_encoder_prices_no_draft_encoder():
    """With share_encoder the draft's encoder never runs: neither its
    weights nor a second set of encoder states is resident."""
    base, tiny = get_dims("openai/whisper-base"), \
        get_dims("openai/whisper-tiny")
    own = hbm.decode_footprint(base, 16, 132, draft_dims=tiny)
    shared = hbm.decode_footprint(base, 16, 132, draft_dims=tiny,
                                  shared_draft_encoder=True)
    assert shared["draft_enc_states"] == 0 < own["draft_enc_states"]
    assert 0 < shared["draft_params"] < own["draft_params"]
    assert shared["draft_kv_cache"] == own["draft_kv_cache"]
    assert shared["total"] == sum(v for k, v in shared.items()
                                  if k != "total")


def test_hbm_malformed_budget_falls_through_to_the_device(monkeypatch):
    """``WHISPER_TPU_HBM_GB=abc`` must not hide the card: the budget is then
    the device's figure (None where there is no card), not None by way of
    the malformed value."""
    monkeypatch.setenv(hbm.BUDGET_ENV, "2.5")
    assert hbm.device_hbm_budget() == int(2.5 * (1 << 30))
    monkeypatch.setenv(hbm.BUDGET_ENV, "abc")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (1 << 30, 80 << 30))
    assert hbm.device_hbm_budget() == 80 << 30
    assert hbm.device_hbm_budget("cpu") is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert hbm.device_hbm_budget() is None


def test_set_draft_model_warns_outside_any_except(monkeypatch):
    """A footprint over the budget warns (ResourceWarning), and with
    warnings as errors the warning reaches the caller: it is raised outside
    the estimate's try/except."""
    sess = WhisperSession(convert.init_params(NANO, seed=0), NANO,
                          RuntimeCfg(dtype="float32", max_batch=2),
                          device="cpu")
    draft = convert.init_params(NANO, seed=1)
    monkeypatch.setenv(hbm.BUDGET_ENV, "0.000001")
    with pytest.warns(ResourceWarning, match="speculative decode"):
        sess.set_draft_model(draft, NANO)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(ResourceWarning):
            sess.set_draft_model(draft, NANO)
    monkeypatch.setenv(hbm.BUDGET_ENV, "80")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        sess.set_draft_model(draft, NANO, share_encoder=True)
    assert sess.has_draft
