"""The port's audio upload wires against the JAX package's (CPU).

Every path that uploads audio carries the JAX package's seven
``audio_transfer`` modes: f32, int16, and the compact encodings dint16,
dint16p, ulaw8, pcm12 and pcm14 (host encoders: ``utils.pcmpack`` and
``audio.resample.ulaw_encode``; device decode:
``frontend.mel.decode_transfer``), and the CLI's ``auto``/``auto-pcm`` probe
(``utils.wireprobe``).  The same audio, made from a seed with numpy, goes
through both packages:

- the encoders' bytes are JAX's, byte for byte, for float32 and int16
  input, odd lengths and batched rows;
- the decodes are JAX's bitwise for int16, dint16, dint16p, pcm12 and
  pcm14; ulaw8's table is within 1 ulp of its formula evaluated in float64,
  and within JAX's own distance from that plus 1 ulp of JAX (XLA's float32
  expm1 on a CPU stands up to 3 ulp from float64);
- the one-shot (plain and B5's wrapper), streamed-slab, pipelined-slab and
  short-batch mels are within 3e-5 of JAX's (the port's mel tolerance,
  tests/test_torch_slice.py) on the same samples, and under dint16 and
  dint16p bitwise the port's own int16 mel.  For ulaw8 "the same samples"
  are the port's decode, given to JAX as float32: XLA's own ulaw8 decode
  moves with the program it sits in (inside one it contracts the
  multiply-subtract into an FMA and multiplies by 1/255; eagerly it does
  neither), a few ulp either way, and JAX's mel moves with it by more than
  3e-5 (5.5e-5 on the 20 s file below);
- x0 tokens equal JAX's under every wire through the CLI, the short batch
  (greedy and speculative; full, 1/8-trimmed and past-the-window rows),
  the streamed long-form path and the pipelined mode (test/whisper-nano);
- the probe picks what JAX's picks under the same rates, one case for each
  test of tests/test_wireprobe.py.
"""

import csv
import json
import struct

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisper_tpu.audio.resample import ulaw_encode as jax_ulaw_encode
from whisper_tpu.bench import cli as jax_cli
from whisper_tpu.frontend.mel import decode_transfer as jax_decode
from whisper_tpu.frontend.mel import log_mel_jax
from whisper_tpu.frontend.mel import log_spec_slab as jax_log_spec_slab
from whisper_tpu.pipeline.longform import transcribe_longform as jax_longform
from whisper_tpu.pipeline.pipelined import (
    transcribe_longform_pipelined as jax_pipelined,
)
from whisper_tpu.runtime.session import RuntimeCfg as JaxCfg
from whisper_tpu.runtime.session import WhisperSession as JaxSession
from whisper_tpu.utils import pcmpack as jax_pcmpack
from whisper_tpu.utils import wireprobe as jax_wireprobe
from whisper_tpu_torch.audio.resample import ulaw_encode
from whisper_tpu_torch.bench import cli
from whisper_tpu_torch.frontend import golden
from whisper_tpu_torch.frontend.mel import (
    decode_transfer,
    log_spec_slab,
    ulaw_table,
)
from whisper_tpu_torch.models import convert
from whisper_tpu_torch.models.registry import get_dims
from whisper_tpu_torch.ops import log_mel
from whisper_tpu_torch.pipeline.chunk import CHUNK_FRAMES
from whisper_tpu_torch.pipeline.longform import transcribe_longform
from whisper_tpu_torch.pipeline.pipelined import (
    transcribe_longform_pipelined,
)
from whisper_tpu_torch.runtime.generate import front_key
from whisper_tpu_torch.runtime.session import RuntimeCfg, WhisperSession
from whisper_tpu_torch.utils import pcmpack, wireprobe

torch.set_num_threads(2)

NANO = get_dims("test/whisper-nano")
ENCODINGS = ("dint16", "dint16p", "ulaw8", "pcm12", "pcm14")
WIRES = ("f32", "int16") + ENCODINGS
EXACT = ("int16", "dint16", "dint16p", "pcm12", "pcm14")  # bitwise decodes
MEL_TOL = 3e-5
PAD_LEN = CHUNK_FRAMES * 160 + 400     # the full 30 s window, reflect-padded
PROMPT = [3, 4, 5, 499]
EOT = 2


class FakeTok:
    """Special ids inside the nano vocabulary; ids decode as words, so
    equal texts are equal tokens."""

    _ids = {"<|startoftranscript|>": 3, "<|endoftext|>": 2, "<|en|>": 4,
            "<|transcribe|>": 5, "<|notimestamps|>": 499,
            "<|startofprev|>": 7}

    def token_to_id(self, t):
        return self._ids.get(t)

    def decode(self, ids, skip_special_tokens=True, **_):
        return "".join(f" w{int(i)}" for i in ids)


def _speechy(seconds: float, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = int(seconds * 16000)
    t = np.arange(n, dtype=np.float64) / 16000.0
    x = (0.3 * np.sin(2 * np.pi * (200 + 40 * np.sin(2 * np.pi * 1.3 * t)) * t)
         + 0.2 * np.sin(2 * np.pi * 850 * t)
         + 0.05 * rng.standard_normal(n))
    return (x * 0.5).astype(np.float32)


def _source(shape, kind: str, seed: int = 0) -> np.ndarray:
    """Audio past [-1, 1] at the edges (the clip counts), or int16 PCM."""
    rng = np.random.default_rng(seed)
    x = np.clip(rng.normal(0, 0.35, shape), -1.3, 1.3).astype(np.float32)
    if kind == "int16":
        return np.round(np.clip(x, -1, 1) * 32767).astype(np.int16)
    return x


def _tag(mode: str) -> str:
    return mode if mode in ("pcm12", "pcm14") else "auto"


def _encode_both(x: np.ndarray, mode: str):
    if mode == "ulaw8":
        return jax_ulaw_encode(x), ulaw_encode(x)
    return jax_pcmpack.encode_wire(x, mode), pcmpack.encode_wire(x, mode)


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in float32 steps, elementwise (same-sign values)."""
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def _cfgs(mode: str, **over):
    """x0 (fp32) configurations of both packages, max_batch 4."""
    kw = dict(dtype="float32", max_batch=4, audio_transfer=mode, **over)
    return JaxCfg(**kw), RuntimeCfg(**kw)


@pytest.fixture(scope="module")
def params():
    return convert.init_params(NANO, seed=0)


@pytest.fixture(scope="module")
def sessions(params):
    """{wire: (JAX session, port session)} at x0, slabs of 2,000 frames."""
    out = {}
    for mode in WIRES:
        jcfg, tcfg = _cfgs(mode, mel_slab_frames=2000)
        out[mode] = (JaxSession(params, NANO, jcfg),
                     WhisperSession(params, NANO, tcfg, device="cpu"))
    return out


# ---------------------------------------------------------------------------
# host encoders and device decodes
# ---------------------------------------------------------------------------

SHAPES = [(1,), (2,), (3,), (1001,), (3, 517), (2, 2, 34)]


@pytest.mark.parametrize("kind", ["float32", "int16"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("mode", EXACT + ("ulaw8",))
def test_encoder_bytes_equal_jax(mode, shape, kind):
    """The wire bytes and dtype are JAX's, pcm12's and pcm14's zero-padded
    pack groups included; a batch's rows encode independently."""
    x = _source(shape, kind)
    want, got = _encode_both(x, mode)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    if len(shape) > 1 and mode != "ulaw8":
        rows = np.stack([pcmpack.encode_wire(r, mode)
                         for r in x.reshape(-1, shape[-1])])
        assert rows.tobytes() == got.tobytes()


@pytest.mark.parametrize("kind", ["float32", "int16"])
@pytest.mark.parametrize("mode", ["pcm12", "pcm14"])
def test_quantized_reference_equals_jax_and_the_decode(mode, kind):
    x = _source((3, 1003), kind, seed=1)
    want = jax_pcmpack.quantized_reference(x, mode)
    got = pcmpack.quantized_reference(x, mode)
    assert got.tobytes() == want.tobytes()
    dec = decode_transfer(torch.from_numpy(pcmpack.pack_pcm(x, mode)),
                          mode).numpy()
    # equal values (the reference rounds a small negative to -0.0)
    assert np.array_equal(dec[..., :x.shape[-1]], got)
    assert not dec[..., x.shape[-1]:].any()        # the pack group's tail


def test_unknown_pack_modes_raise_as_in_jax():
    x = _source((8,), "float32")
    for mod in (pcmpack, jax_pcmpack):
        with pytest.raises(ValueError, match="unknown"):
            mod.encode_wire(x, "ulaw8")
        with pytest.raises(ValueError, match="unknown"):
            mod.pack_pcm(x, "pcm16")


@pytest.mark.parametrize("shape", SHAPES[2:], ids=str)
@pytest.mark.parametrize("mode", EXACT)
def test_decode_is_jax_bitwise(mode, shape):
    """int16, dint16, dint16p, pcm12 and pcm14: the float32 samples are
    JAX's bit for bit (the same float32 reciprocals, multiplied)."""
    enc = pcmpack.encode_wire(_source(shape, "float32", seed=2), mode)
    want = np.asarray(jax_decode(jnp.asarray(enc), _tag(mode)))
    got = decode_transfer(torch.from_numpy(enc), _tag(mode))
    assert got.dtype == torch.float32
    assert got.numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("mode", ["dint16", "dint16p"])
def test_delta_decodes_are_the_int16_decode_bitwise(mode):
    """The running sum mod 2^16 gives the int16 PCM back exactly, full
    scale and wrap-around steps included."""
    x = _source((4, 2001), "int16", seed=3)
    x[0, :4] = [32767, -32768, 32767, -32768]
    want = decode_transfer(torch.from_numpy(x))
    got = decode_transfer(torch.from_numpy(pcmpack.encode_wire(x, mode)))
    assert torch.equal(got, want)


def test_ulaw8_decode_is_within_its_bound_of_jax():
    """All 256 codes, and batched rows: the table within 1 ulp of JAX's
    formula evaluated in float64 (on JAX's own float32 y and |y| log1p(255)),
    and from JAX's decode no farther than JAX is from that, plus 1 ulp."""
    codes = np.arange(256, dtype=np.uint8)
    want = np.asarray(jax_decode(jnp.asarray(codes)))
    got = decode_transfer(torch.from_numpy(codes)).numpy()
    assert np.array_equal(got, ulaw_table())
    y = np.asarray(jnp.asarray(codes).astype(jnp.float32) * (1.0 / 127.5)
                   - 1.0)
    m = np.asarray(jnp.abs(jnp.asarray(y)) * jnp.log1p(255.0))
    exact = (np.sign(y) * (np.expm1(m.astype(np.float64)) / 255.0)).astype(
        np.float32)
    assert _ulps(got, exact).max() <= 1
    assert (_ulps(got, want) <= _ulps(want, exact) + 1).all()
    rows = ulaw_encode(_source((3, 777), "float32", seed=4))
    got_rows = decode_transfer(torch.from_numpy(rows)).numpy()
    assert np.array_equal(got_rows, ulaw_table()[rows])


@pytest.mark.parametrize("dtype", [torch.float64, torch.int32,
                                   torch.bfloat16])
def test_a_dtype_that_is_no_wire_raises(dtype):
    """No fallback: a tensor of no upload wire's dtype raises, never
    passes as float32."""
    with pytest.raises(ValueError, match="no upload wire"):
        decode_transfer(torch.zeros(8, dtype=dtype))


def test_an_unknown_audio_transfer_raises():
    with pytest.raises(ValueError, match="names no upload wire"):
        WhisperSession(convert.init_params(NANO, seed=0), NANO,
                       RuntimeCfg(dtype="float32", audio_transfer="pcm16"),
                       device="cpu")


@pytest.mark.parametrize("mode", WIRES)
def test_session_encodes_as_jax(sessions, mode):
    """The session's host encoding (1-D and [B, L] rows) and its decode
    tag are the JAX session's; audio already in the wire's dtype passes."""
    jsess, tsess = sessions[mode]
    for x in (_source((4001,), "float32", 5), _source((3, 999), "float32")):
        want = np.asarray(jsess._encode_transfer(x))
        got = tsess._encode_transfer(x)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
        assert tsess._encode_transfer(got) is got
    assert tsess._transfer_tag() == jsess._transfer_tag()


# ---------------------------------------------------------------------------
# mels: one-shot, streamed slabs, pipelined slabs, short rows
# ---------------------------------------------------------------------------

def _mel_close(got, want):
    got = got.numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=MEL_TOL, rtol=0)


def _jax_side(sessions, mode, audio):
    """The JAX session and the audio it is given for the port's mel under
    ``mode``: the same, or under ulaw8 the f32 session and the port's
    decoded samples (see the module's docstring)."""
    if mode != "ulaw8":
        return sessions[mode][0], audio
    return sessions["f32"][0], decode_transfer(
        torch.from_numpy(ulaw_encode(audio))).numpy()


@pytest.mark.parametrize("mode", WIRES)
def test_one_shot_and_streamed_mels_equal_jax(sessions, mode):
    """20 s one shot (the plain front end, and B5's wrapper, whose plain
    version a CPU tensor takes) and 45 s streamed in slabs of 2,000 frames:
    within 3e-5 of the JAX session's mel."""
    tsess = sessions[mode][1]
    for seconds in (20.0, 45.0):
        audio = _speechy(seconds, seed=3)
        padded = golden.reflect_pad(audio)
        nv = golden.num_frames(len(audio))
        bucket = nv + 37
        jsess, jpadded = _jax_side(sessions, mode, padded)
        want = jsess.compute_mel(jpadded, nv, bucket)
        _mel_close(tsess.compute_mel(padded, nv, bucket), want)
        if seconds < 30:
            wire = torch.from_numpy(tsess._encode_transfer(padded))
            _mel_close(log_mel.log_mel(wire, nv, NANO.n_mels, bucket,
                                       transfer=tsess._transfer_tag()), want)


@pytest.mark.parametrize("mode", WIRES)
def test_pipelined_slab_log_spec_equals_jax(sessions, mode):
    """A pipelined slab (``encode_host_slab`` past the file's end: its zero
    tail made in float32 before the encode) through ``log_spec_slab`` with
    the session's tag: the raw log-spec within 1.2e-4 of JAX's (the 3e-5 of
    the normalized mel, x4), its masked max within 3e-5."""
    tsess = sessions[mode][1]
    padded = golden.reflect_pad(_speechy(12.3, seed=6))
    cap, f0 = 900, 600
    need = (cap + 2) * golden.HOP
    nv = golden.num_frames(int(12.3 * 16000)) - f0
    enc = tsess.encode_host_slab(padded, f0 * golden.HOP, need)
    assert enc.tobytes() == np.asarray(sessions[mode][0].encode_host_slab(
        padded, f0 * golden.HOP, need)).tobytes()
    slab = sessions["f32"][1].encode_host_slab(padded, f0 * golden.HOP, need)
    jsess, slab = _jax_side(sessions, mode, slab)
    jenc = np.asarray(jsess._encode_transfer(slab))
    ls, vmax = log_spec_slab(torch.from_numpy(enc), nv, NANO.n_mels, cap,
                             transfer=tsess._transfer_tag())
    jls, jvmax = jax_log_spec_slab(jnp.asarray(jenc), jnp.int32(nv),
                                   n_mels=NANO.n_mels, n_frames=cap,
                                   transfer=jsess._transfer_tag())
    np.testing.assert_allclose(ls[:, :nv].numpy(), np.asarray(jls)[:, :nv],
                               atol=4 * MEL_TOL, rtol=0)
    assert abs(float(vmax) - float(jvmax)) <= MEL_TOL


@jax.jit
def _jax_short_mels(decoded, n_valid):
    """The JAX short program's mel of decoded rows [B, L <= window]: the
    zero tail to the window, then ``log_mel_jax`` a row."""
    full = PAD_LEN
    if decoded.shape[-1] > full:
        decoded = decoded[..., :full]
    decoded = jnp.pad(decoded, ((0, 0), (0, full - decoded.shape[-1])))
    return jax.vmap(lambda a, v: log_mel_jax(
        a, v, n_mels=NANO.n_mels, n_frames=CHUNK_FRAMES))(decoded, n_valid)


def _rows(clips, ship_len):
    """The engine's tick layout: reflect-padded rows in [B, ship_len]."""
    audio = np.zeros((len(clips), ship_len), dtype=np.float32)
    n_valid = np.zeros(len(clips), dtype=np.int32)
    for i, c in enumerate(clips):
        p = golden.reflect_pad(c)
        audio[i, :len(p)] = p
        n_valid[i] = golden.num_frames(len(c))
    return audio, n_valid


CLIPS = [_speechy(1.1, 0), _speechy(2.7, 1), _speechy(3.6, 2)]


def _row_forms():
    full, n_valid = _rows(CLIPS, PAD_LEN)
    over = np.concatenate(
        [full, np.random.default_rng(9).normal(0, 0.5, (3, 803))
         .astype(np.float32)], axis=1)
    return {"full": full, "trimmed": _rows(CLIPS, PAD_LEN // 8)[0],
            "over": over}, n_valid


@pytest.mark.parametrize("mode", WIRES)
def test_short_batch_mels_equal_jax(sessions, mode):
    """The short path's rows, full, trimmed to 1/8 (60,050 samples: pcm14
    packs them to 60,052) and shipped past the window: each row's mel
    within 3e-5 of JAX's short program's (its decode, its zero tail made
    after the decode, ``log_mel_jax``)."""
    tsess = sessions[mode][1]
    forms, n_valid = _row_forms()
    for audio in forms.values():
        got = tsess._short_mel(audio, n_valid)
        jsess, audio = _jax_side(sessions, mode, audio)
        jwire = jnp.asarray(jsess._encode_transfer(audio))
        want = _jax_short_mels(jax_decode(jwire, jsess._transfer_tag()),
                               jnp.asarray(n_valid))
        _mel_close(got, want)


@pytest.mark.parametrize("mode", ["dint16", "dint16p"])
def test_delta_wire_mels_are_the_int16_mels_bitwise(sessions, mode):
    """dint16 and dint16p decode to int16's samples, so every mel path
    gives int16's mel bit for bit."""
    tsess, isess = sessions[mode][1], sessions["int16"][1]
    audio = _speechy(45.0, seed=3)
    padded = golden.reflect_pad(audio)
    nv = golden.num_frames(len(audio))
    for n in (nv, 2000):         # streamed, then one shot
        got = tsess.compute_mel(padded[:n * 160 + 400], n, n)
        want = isess.compute_mel(padded[:n * 160 + 400], n, n)
        assert torch.equal(got, want)
    forms, n_valid = _row_forms()
    assert torch.equal(tsess._short_mel(forms["trimmed"], n_valid),
                       isess._short_mel(forms["trimmed"], n_valid))


# ---------------------------------------------------------------------------
# x0 tokens
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", WIRES)
def test_short_batch_tokens_equal_jax(params, sessions, mode):
    """x0: the short batch's tokens at full width, trimmed and past the
    window equal JAX's full-width tokens, greedy and speculative (a random
    draft: lossless greedy)."""
    jsess, tsess = sessions[mode]
    forms, n_valid = _row_forms()
    want = np.asarray(jsess.transcribe_short_batch(forms["full"], n_valid,
                                                   PROMPT, 5, EOT))
    for audio in forms.values():
        got = tsess.transcribe_short_batch(audio, n_valid, PROMPT, 5, EOT)
        np.testing.assert_array_equal(got, want)
    spec = WhisperSession(params, NANO, _cfgs(mode)[1], device="cpu")
    spec.set_draft_model(convert.init_params(NANO, seed=99), NANO)
    got = spec.transcribe_short_speculative(forms["trimmed"], n_valid,
                                            PROMPT, 5, EOT, draft_k=3)
    np.testing.assert_array_equal(np.asarray(got), want)


@pytest.mark.parametrize("mode", WIRES)
def test_streamed_longform_text_equals_jax(sessions, mode):
    """x0 on 65 s (three chunks; the streamed mel over slabs of 2,000
    frames): the text, token for token, is JAX's."""
    jsess, tsess = sessions[mode]
    audio = _speechy(65.0, seed=4)
    kw = dict(language="en", task="transcribe", max_new_tokens=5,
              tokenizer=FakeTok())
    want, _ = jax_longform(jsess, audio, **kw)
    got, _ = transcribe_longform(tsess, audio, **kw)
    assert got == want and got


@pytest.mark.parametrize("mode", WIRES)
def test_pipelined_text_equals_jax(sessions, mode):
    """x0, the pipelined mode on 65 s in slabs of two chunks: JAX's
    text."""
    jsess, tsess = sessions[mode]
    audio = _speechy(65.0, seed=8)
    kw = dict(max_new_tokens=5, tokenizer=FakeTok(), slab_chunks=2)
    want, _ = jax_pipelined(jsess, audio, "en", "transcribe", **kw)
    got, _ = transcribe_longform_pipelined(tsess, audio, "en", "transcribe",
                                           **kw)
    assert got == want and got


def test_short_keys_differ_between_ulaw8_and_pcm12_of_equal_bytes(params):
    """ulaw8 rows of 3N samples and pcm12 rows of 2N samples ship the same
    uint8 bytes: their programs' keys differ by the decode's tag."""
    keys = []
    for mode, n in (("ulaw8", 3 * 4000), ("pcm12", 2 * 4000)):
        tsess = WhisperSession(params, NANO, _cfgs(mode)[1], device="cpu")
        audio = np.zeros((2, n), np.float32)
        front = tsess._short_front(audio, np.array([5, 5]), False)
        assert front.inputs[0].dtype == torch.uint8
        assert tuple(front.inputs[0].shape) == (2, 12000)
        keys.append(front_key(front))
    assert keys[0] != keys[1]


# ---------------------------------------------------------------------------
# the CLI and the probe
# ---------------------------------------------------------------------------

def _write_wav(path, data, sr=16000):
    pcm = np.clip(data * 32768.0, -32768, 32767).astype("<i2").tobytes()
    with open(path, "wb") as f:
        f.write(struct.pack("<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + len(pcm),
                            b"WAVE", b"fmt ", 16, 1, 1, sr, sr * 2, 2, 16,
                            b"data", len(pcm)) + pcm)


@pytest.fixture(scope="module")
def wav_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("wire-audio")
    _write_wav(str(d / "a.wav"), _speechy(4.2, seed=11))
    return str(d)


def _cli_argv(audio_dir, out, mode):
    return ["--audio-dir", audio_dir, "--model-id", "test/whisper-nano",
            "--allow-random-init", "--max-new-tokens", "4", "--warmup", "0",
            "--variant", "x0", "--audio-transfer", mode,
            "--out-csv", str(out / "c.csv"), "--out-json", str(out / "j.json"),
            "--out-summary-json", str(out / "s.json")]


def _cli_rows(out):
    with open(out / "c.csv") as f:
        rows = list(csv.reader(f))[1:]
    return ([(r[0], r[1]) for r in rows],
            [r["text"] for r in json.load(open(out / "j.json"))],
            json.load(open(out / "s.json"))["config_used"])


@pytest.mark.parametrize("mode", WIRES)
def test_cli_under_each_wire_gives_jax_outputs(wav_dir, tmp_path, mode):
    """``--audio-transfer <wire>`` at x0: rc 0, and the JAX CLI's files,
    durations, texts and config."""
    assert cli.main(_cli_argv(wav_dir, tmp_path / "t", mode),
                    device="cpu") == 0
    assert jax_cli.main(_cli_argv(wav_dir, tmp_path / "j", mode)) == 0
    got, want = _cli_rows(tmp_path / "t"), _cli_rows(tmp_path / "j")
    assert got == want
    assert got[2]["audio_transfer"] == mode


@pytest.mark.parametrize("mode", ["auto", "auto-pcm"])
def test_cli_probe_prints_its_rates_and_runs_its_pick(wav_dir, tmp_path,
                                                      capsys, mode):
    """``auto`` and ``auto-pcm``: the probe's line on stderr, every
    candidate's rate and the pick, which the run's config carries; the
    text is the JAX CLI's under the port's pick."""
    assert cli.main(_cli_argv(wav_dir, tmp_path / "t", mode),
                    device="cpu") == 0
    line = [x for x in capsys.readouterr().err.splitlines()
            if x.startswith("[wire-probe] ")][-1]
    rates, pick = line[len("[wire-probe] "):].split(" -> ")
    names = [r.split("=")[0] for r in rates.split()]
    assert names == ["int16", "dint16", "dint16p"] + (
        ["pcm12"] if mode == "auto-pcm" else [])
    assert all(r.endswith("MB/s") for r in rates.split())
    assert pick in names
    got = _cli_rows(tmp_path / "t")
    assert got[2]["audio_transfer"] == pick
    assert jax_cli.main(_cli_argv(wav_dir, tmp_path / "j", pick)) == 0
    assert got[:2] == _cli_rows(tmp_path / "j")[:2]


def test_probe_rates_returns_all_candidates():
    """The port's probe on the CPU: a positive rate a candidate, as JAX's
    (tests/test_wireprobe.py)."""
    rates = wireprobe.probe_rates(wireprobe.synth_speechlike(2.0),
                                  reps_big=3, reps_small=1, device="cpu")
    assert set(rates) == {"int16", "dint16", "dint16p"}
    assert all(v > 0 for v in rates.values())
    assert np.array_equal(wireprobe.synth_speechlike(0.5),
                          jax_wireprobe.synth_speechlike(0.5))


# Each case of tests/test_wireprobe.py: (fake rates given the candidates,
# audio length, allow_pcm).
PROBE_CASES = {
    "prefers_first_within_margin": (
        lambda c: {"int16": 1.00, "dint16": 0.90, "dint16p": 0.88},
        16000, False),
    "switches_on_clear_win": (
        lambda c: {"int16": 1.0, "dint16": 0.6, "dint16p": 0.9},
        16000, False),
    "allow_pcm_accounts_bytes": (
        lambda c: {m: {"int16": 2.0, "dint16": 2.0, "dint16p": 2.0,
                       "pcm14": 1.75, "pcm12": 1.5}[m] for m in c},
        16000, True),
    "lossless_never_pcm": (lambda c: {m: 1.0 for m in c}, 160, False),
    "margin_vs_first": (
        lambda c: {"int16": 0.100, "dint16": 0.086, "dint16p": 0.080},
        160, False),
    "unmeasurable_never_wins": (
        lambda c: {m: (float("inf") if m != "int16" else 0.1) for m in c},
        160, True),
}


@pytest.mark.parametrize("case", sorted(PROBE_CASES))
def test_choice_equals_jax_under_the_same_rates(monkeypatch, case):
    """The same rates give both packages the same pick, the same MB/s and
    the same candidates raced."""
    rates, n, allow_pcm = PROBE_CASES[case]
    seen = {}

    def fake(mod):
        def probe(audio, candidates, *_, **__):
            seen.setdefault(mod.__name__, candidates)
            return rates(candidates)
        return probe

    for mod in (wireprobe, jax_wireprobe):
        monkeypatch.setattr(mod, "probe_rates", fake(mod))
    audio = np.zeros(n, np.float32)
    got = wireprobe.choose_audio_transfer(audio, allow_pcm=allow_pcm)
    want = jax_wireprobe.choose_audio_transfer(audio, allow_pcm=allow_pcm)
    assert got == want
    assert seen[wireprobe.__name__] == seen[jax_wireprobe.__name__]


def test_cli_audio_transfer_choices_are_the_jax_clis():
    """The port's --audio-transfer takes every choice of the JAX CLI's."""
    def choices(parser):
        return next(a.choices for a in parser._actions
                    if a.dest == "audio_transfer")

    assert choices(cli.build_parser()) == choices(jax_cli.build_parser())
    for mode in choices(cli.build_parser()):
        assert cli.build_parser().parse_args(
            ["--audio-transfer", mode]).audio_transfer == mode


def test_probe_payloads_match_session_encoder(params):
    """The probe times the payloads a session ships (the shared
    ``pcmpack.encode_wire``)."""
    audio = np.random.default_rng(0).normal(0, 0.2, 4096).astype(np.float32)
    for mode in EXACT:
        tsess = WhisperSession(params, NANO, _cfgs(mode)[1], device="cpu")
        assert (tsess._encode_transfer(audio).tobytes()
                == pcmpack.encode_wire(audio, mode).tobytes())
