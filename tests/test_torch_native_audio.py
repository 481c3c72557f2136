"""The port's native audio decoder (``whisper_tpu_torch.native``) against
the cases of tests/test_native_audio.py, and the port's audio facade
against the JAX package's.

The library builds at first use with g++ and libav's headers; every case
skips where either is missing.  FLAC files are written by
``audio.flac.write_flac``, a pure-Python encoder of verbatim subframes
(STREAMINFO, frame headers with their CRC-8, frames with their CRC-16), so
nothing is downloaded and the samples a file holds are known exactly.
"""

import json
import os
import shutil
import struct

import numpy as np
import pytest
import torch

from whisper_tpu_torch.audio.flac import write_flac

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def native():
    from whisper_tpu_torch.native import audio_native

    if shutil.which("g++") is None:
        pytest.skip("no g++ toolchain")
    if not audio_native.available():
        pytest.skip("native library not built: "
                    f"{audio_native.unavailable_reason()}")
    return audio_native


def _write_wav(path, data, sr=16000, channels=1):
    pcm = np.clip(data * 32768.0, -32768, 32767).astype("<i2").tobytes()
    hdr = struct.pack(
        "<4sI4s4sIHHIIHH4sI",
        b"RIFF", 36 + len(pcm), b"WAVE", b"fmt ", 16, 1, channels, sr,
        sr * channels * 2, channels * 2, 16, b"data", len(pcm),
    )
    with open(path, "wb") as f:
        f.write(hdr + pcm)


def _pcm16(seconds: float, sr: int, channels: int = 1, seed: int = 0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 0.2, (int(seconds * sr), channels))
    return np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int16)


class TestNativeDecoder:
    def test_matches_python_wav_reader(self, native, tmp_path):
        from whisper_tpu_torch.audio.wav import read_wav

        rng = np.random.default_rng(3)
        p = tmp_path / "m.wav"
        _write_wav(p, rng.normal(0, 0.3, 32000), sr=16000)
        mono_n, sr_n = native.decode_mono(str(p))
        mono_p, sr_p = read_wav(str(p))
        assert sr_n == sr_p == 16000
        np.testing.assert_array_equal(mono_n, mono_p)

    def test_stereo_downmix(self, native, tmp_path):
        from whisper_tpu_torch.audio.wav import read_wav

        rng = np.random.default_rng(4)
        p = tmp_path / "s.wav"
        _write_wav(p, rng.normal(0, 0.2, 2 * 8000), sr=22050, channels=2)
        mono_n, sr = native.decode_mono(str(p))
        mono_p, _ = read_wav(str(p))
        assert sr == 22050
        np.testing.assert_allclose(mono_n, mono_p, atol=1e-7)

    def test_missing_file_error(self, native):
        with pytest.raises(RuntimeError):
            native.decode_mono("/does/not/exist.wav")

    def test_malformed_file_corpus(self, native, tmp_path):
        """Every malformed file gives a clean RuntimeError or a well-formed
        result, never a crash (tests/test_native_audio.py's corpus)."""
        rng = np.random.default_rng(5)
        good = np.clip(rng.normal(0, 0.3, 4000) * 32768.0, -32768, 32767
                       ).astype("<i2").tobytes()
        hdr = struct.pack(
            "<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + len(good), b"WAVE",
            b"fmt ", 16, 1, 1, 16000, 32000, 2, 16, b"data", len(good))
        corpus = {
            "empty.wav": b"",
            "just_magic.wav": b"RIFF",
            "truncated_header.wav": hdr[:20],
            "header_no_data.wav": hdr,
            "truncated_data.wav": hdr + good[:7],
            "garbage.wav": rng.bytes(4096),
            "riff_garbage.wav": b"RIFF" + rng.bytes(4096),
            "huge_declared_size.wav": struct.pack(
                "<4sI4s4sIHHIIHH4sI", b"RIFF", 0xFFFFFFF0, b"WAVE", b"fmt ",
                16, 1, 1, 16000, 32000, 2, 16, b"data", 0xFFFFFF00,
            ) + good[:64],
            "zero_channels.wav": struct.pack(
                "<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + len(good), b"WAVE",
                b"fmt ", 16, 1, 0, 16000, 0, 0, 16, b"data", len(good),
            ) + good,
            "zero_rate.wav": struct.pack(
                "<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + len(good), b"WAVE",
                b"fmt ", 16, 1, 1, 0, 0, 2, 16, b"data", len(good),
            ) + good,
            "garbage.mp3": rng.bytes(2048),
            "garbage.flac": b"fLaC" + rng.bytes(2048),
        }
        for name, blob in corpus.items():
            p = tmp_path / name
            p.write_bytes(blob)
            try:
                mono, sr = native.decode_mono(str(p))
            except RuntimeError:
                continue
            assert sr >= 0 and mono.ndim == 1, name

    @pytest.mark.parametrize("channels,sr", [(1, 16000), (1, 44100),
                                             (2, 22050)])
    def test_flac_decodes_sample_exact(self, native, tmp_path, channels, sr):
        """A FLAC file decodes to the PCM it was written from: x / 32768,
        the channel mean for stereo (as the WAV of the same samples)."""
        pcm = _pcm16(1.3, sr, channels, seed=channels)
        p = tmp_path / "a.flac"
        write_flac(p, pcm, sr)
        mono, got_sr = native.decode_mono(str(p))
        assert got_sr == sr and mono.shape == (pcm.shape[0],)
        want = (pcm.astype(np.float32) / np.float32(32768.0))
        if channels == 1:
            np.testing.assert_array_equal(mono, want[:, 0])
        else:
            np.testing.assert_allclose(mono, want.mean(axis=1), atol=1e-7)
        w = tmp_path / "a.wav"
        _write_wav(w, pcm.reshape(-1) / 32768.0, sr=sr, channels=channels)
        np.testing.assert_array_equal(mono, native.decode_mono(str(w))[0])

    def test_io_facade_prefers_native(self, native, tmp_path, monkeypatch):
        from whisper_tpu_torch.audio import io as aio

        calls = []
        real = native.decode_mono
        monkeypatch.setattr(native, "decode_mono",
                            lambda p: calls.append(p) or real(p))
        p = tmp_path / "f.wav"
        _write_wav(p, np.zeros(16000), sr=16000)
        mono, sr, dur = aio.load_audio_16k_mono(str(p))
        assert calls == [str(p)]
        assert sr == 16000 and abs(dur - 1.0) < 1e-3


class TestNativeResampler:
    def test_native_resample_bit_equals_numpy(self, native):
        from whisper_tpu_torch.audio.resample import _resample_linear_numpy

        rng = np.random.default_rng(0)
        for sr_in, sr_out in [(44100, 16000), (48000, 16000), (22050, 16000),
                              (8000, 16000), (16000, 8000), (11025, 16000)]:
            x = rng.normal(0, 0.3, 44100).astype(np.float32)
            got = native.resample_linear(x, sr_in, sr_out)
            want = _resample_linear_numpy(x, sr_in, sr_out)
            assert got.shape == want.shape, (sr_in, sr_out)
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"{sr_in}->{sr_out}")

    def test_resample_linear_routes_native(self, native, monkeypatch):
        from whisper_tpu_torch.audio import resample

        calls = []
        real = native.resample_linear
        monkeypatch.setattr(native, "resample_linear",
                            lambda *a: calls.append(a[1:]) or real(*a))
        out = resample.resample_linear(np.ones(1000, np.float32), 44100,
                                       16000)
        assert calls == [(44100, 16000)]
        assert len(out) == int(np.floor(1000 * 16000 / 44100 + 0.5))


class TestFacadeAgainstJax:
    @pytest.fixture(scope="class")
    def jax_native(self, native, tmp_path_factory):
        """The JAX package's decoder compiled from its own source into a
        temporary dir with the same flags, and loaded through its
        ``WHISPER_TPU_AUDIO_LIB`` override, so that its facade decodes
        flac too (nothing under whisper_tpu/ is written)."""
        import subprocess

        import whisper_tpu.audio.io as jio
        from whisper_tpu.native import audio_native as jn

        src = os.path.join(REPO, "whisper_tpu", "native", "audio_decode.cc")
        lib = tmp_path_factory.mktemp("jax-native") / "libjax_audio.so"
        subprocess.run(["g++", *native.CXXFLAGS, "-shared", "-o", str(lib),
                        src, *native.LDLIBS], check=True, capture_output=True)
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("WHISPER_TPU_AUDIO_LIB", str(lib))
            mp.setattr(jn, "_load_attempted", False)
            mp.setattr(jn, "_lib", None)
            mp.setattr(jio, "_native_checked", False)
            mp.setattr(jio, "_native", None)
            assert jn.available()
            yield jn

    @pytest.mark.parametrize("name,sr,channels", [
        ("a.wav", 16000, 1), ("b.wav", 44100, 2), ("c.flac", 16000, 1),
        ("d.flac", 48000, 2)])
    def test_load_audio_equals_jax(self, native, jax_native, tmp_path, name,
                                   sr, channels):
        from whisper_tpu.audio.io import load_audio_16k_mono as jax_load
        from whisper_tpu_torch.audio.io import load_audio_16k_mono

        pcm = _pcm16(2.1, sr, channels, seed=sr)
        p = tmp_path / name
        if name.endswith(".flac"):
            write_flac(p, pcm, sr)
        else:
            _write_wav(p, pcm.reshape(-1) / 32768.0, sr=sr, channels=channels)
        got = load_audio_16k_mono(str(p))
        want = jax_load(str(p))
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]

    def test_without_the_library_only_wav_is_read(self, tmp_path,
                                                   monkeypatch):
        """A library that does not load: .wav through the WAV reader, any
        other extension raises quoting why."""
        from whisper_tpu_torch.audio import io as aio
        from whisper_tpu_torch.native import audio_native

        audio_native.reset()
        monkeypatch.setenv(audio_native.LIB_ENV, str(tmp_path / "none.so"))
        try:
            w = tmp_path / "a.wav"
            _write_wav(w, np.zeros(8000), sr=16000)
            assert aio.load_audio_16k_mono(str(w))[2] == 0.5
            f = tmp_path / "a.flac"
            write_flac(f, np.zeros(800, np.int16), 16000)
            with pytest.raises(RuntimeError, match="none.so"):
                aio.load_audio_16k_mono(str(f))
        finally:
            monkeypatch.delenv(audio_native.LIB_ENV)
            audio_native.reset()


def test_cli_gives_the_same_texts_for_flac_and_wav(native, tmp_path):
    """The port's CLI over a directory holding the same samples as .wav
    and as .flac (test/whisper-nano, random weights, the CPU): equal
    texts."""
    from whisper_tpu_torch.bench import cli

    audio = tmp_path / "audio"
    audio.mkdir()
    pcm = _pcm16(3.2, 16000, 1, seed=7)
    _write_wav(audio / "clip_wav.wav", pcm[:, 0] / 32768.0)
    write_flac(audio / "clip_flac.flac", pcm, 16000)
    out = tmp_path / "out"
    rc = cli.main(["--audio-dir", str(audio), "--model-id",
                   "test/whisper-nano", "--onnx-dir", str(tmp_path / "none"),
                   "--allow-random-init", "--variant", "x0",
                   "--max-new-tokens", "4",
                   "--out-csv", str(out / "c.csv"),
                   "--out-json", str(out / "j.json"),
                   "--out-summary-json", str(out / "s.json")], device="cpu")
    assert rc == 0
    rows = {r["file"]: r for r in json.load(open(out / "j.json"))}
    assert set(rows) == {"clip_wav.wav", "clip_flac.flac"}
    assert rows["clip_wav.wav"]["text"] == rows["clip_flac.flac"]["text"]
    assert rows["clip_wav.wav"]["duration_s"] == \
        rows["clip_flac.flac"]["duration_s"]
