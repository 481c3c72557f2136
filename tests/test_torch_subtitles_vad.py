"""The port's copies of the subtitle writers (``bench.subtitles``) and the
energy VAD (``audio.vad``) against the JAX package's (CPU): on the inputs
of tests/test_subtitles.py and tests/test_vad.py, and on inputs made from
a seed, the same cues, byte-equal SRT/WebVTT text and files, the same
speech spans, condensed signals and restored times.
"""

import numpy as np
import pytest

from whisper_tpu.audio import vad as jvad
from whisper_tpu.bench import subtitles as jsub
from whisper_tpu.pipeline.sequential import Segment as JaxSegment
from whisper_tpu_torch.audio import vad
from whisper_tpu_torch.bench import subtitles
from whisper_tpu_torch.pipeline.sequential import Segment

SR = vad.SR


def _w(word, start, end):
    return {"word": word, "start": start, "end": end}


def _random_words(seed, n=40):
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.exponential(0.4, n))
    return [_w(f" w{i}" * int(rng.integers(1, 4)), round(float(s), 2),
               round(float(s + rng.uniform(0.05, 0.6)), 2))
            for i, s in enumerate(t)]


WORD_CASES = {
    # JAX's inputs (tests/test_subtitles.py)
    "single_cue": ([_w(" hello", 0.0, 0.4), _w(" world", 0.5, 0.9)], {}),
    "gap_splits": ([_w(" a", 0.0, 0.2), _w(" b", 2.0, 2.2)],
                   dict(max_gap_s=1.0)),
    "max_chars": ([_w(f" w{i}", i * 0.1, i * 0.1 + 0.05) for i in range(30)],
                  dict(max_chars=12)),
    "max_duration": ([_w(" x", t, t + 0.4) for t in range(0, 20, 1)],
                     dict(max_dur_s=5.0, max_gap_s=2.0)),
    "empty_word": ([_w("  ", 0, 1)], {}),
    "none": ([], {}),
    "random_0": (_random_words(0), {}),
    "random_1": (_random_words(1), dict(max_chars=30, max_gap_s=0.3)),
    "long_times": ([_w(" late", 3661.075, 3662.5), _w(" neg", -0.5, 0.1)],
                   {}),
}


@pytest.mark.parametrize("case", sorted(WORD_CASES))
def test_cues_and_formats_from_words_equal_jax(case):
    words, kw = WORD_CASES[case]
    got = subtitles.cues_from_words(words, **kw)
    want = jsub.cues_from_words(words, **kw)
    assert [(c.start_s, c.end_s, c.text) for c in got] == \
        [(c.start_s, c.end_s, c.text) for c in want]
    assert subtitles.format_srt(got) == jsub.format_srt(want)
    assert subtitles.format_vtt(got) == jsub.format_vtt(want)


def test_cues_from_segments_equal_jax():
    rows = [(0.0, 2.0, " first"), (2.0, 2.5, "   "), (2.5, 4.0, " second"),
            (61.25, 3661.075, " later")]
    got = subtitles.cues_from_segments([Segment(s, e, [], t)
                                        for s, e, t in rows])
    want = jsub.cues_from_segments([JaxSegment(s, e, [], t)
                                    for s, e, t in rows])
    assert [(c.start_s, c.end_s, c.text) for c in got] == \
        [(c.start_s, c.end_s, c.text) for c in want]


@pytest.mark.parametrize("ext", ["srt", "vtt"])
def test_written_files_are_byte_equal(tmp_path, ext):
    words = _random_words(2)
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    subtitles.write_subtitles(str(tmp_path / "a" / f"x.{ext}"),
                              subtitles.cues_from_words(words))
    jsub.write_subtitles(str(tmp_path / "b" / f"x.{ext}"),
                         jsub.cues_from_words(words))
    assert (tmp_path / "a" / f"x.{ext}").read_bytes() == \
        (tmp_path / "b" / f"x.{ext}").read_bytes()


def test_unknown_extension_raises_as_in_jax(tmp_path):
    for mod in (subtitles, jsub):
        with pytest.raises(ValueError):
            mod.write_subtitles(str(tmp_path / "a.sub"), [])


def _tone(seconds, freq=440.0, amp=0.3):
    t = np.arange(int(seconds * SR)) / SR
    return (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def _silence(seconds, noise=1e-4):
    rng = np.random.default_rng(0)
    return (noise * rng.standard_normal(int(seconds * SR))).astype(np.float32)


def _bursts(seed):
    rng = np.random.default_rng(seed)
    parts = []
    for _ in range(6):
        parts.append(_silence(float(rng.uniform(0.05, 3.0))))
        parts.append(_tone(float(rng.uniform(0.05, 2.0)),
                           freq=float(rng.uniform(100, 2000)),
                           amp=float(rng.uniform(0.01, 0.5))))
    return np.concatenate(parts)


VAD_CASES = {
    # JAX's inputs (tests/test_vad.py)
    "two_bursts": (lambda: np.concatenate(
        [_silence(1.0), _tone(1.0), _silence(3.0), _tone(1.0),
         _silence(1.0)]), {}),
    "short_gap_bridged": (lambda: np.concatenate(
        [_silence(1.0), _tone(1.0), _silence(1.0), _tone(1.0),
         _silence(1.0)]), {}),
    "short_blip": (lambda: np.concatenate(
        [_silence(2.0), _tone(0.1), _silence(2.0), _tone(1.0),
         _silence(1.0)]), dict(min_silence_duration_ms=500)),
    "all_silence": (lambda: _silence(3.0), {}),
    "continuous": (lambda: _tone(4.0), {}),
    "quiet_noise": (lambda: _silence(4.0, noise=3e-5), {}),
    "empty": (lambda: np.zeros(0, np.float32), {}),
    "random_0": (lambda: _bursts(0), {}),
    "random_1": (lambda: _bursts(1), dict(threshold_db=6.0)),
    "random_2": (lambda: _bursts(2), dict(speech_pad_ms=100,
                                          min_speech_duration_ms=100)),
}


@pytest.mark.parametrize("case", sorted(VAD_CASES))
def test_vad_spans_chunks_and_times_equal_jax(case):
    make, kw = VAD_CASES[case]
    audio = make()
    spans = vad.detect_speech(audio, vad.VadOptions(**kw))
    assert spans == jvad.detect_speech(audio, jvad.VadOptions(**kw))
    got, smap = vad.collect_chunks(audio, spans)
    want, jmap = jvad.collect_chunks(audio, spans)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert smap.total_samples == jmap.total_samples
    for t in np.linspace(0.0, len(audio) / SR + 1.0, 37):
        assert smap.restore_time(float(t)) == jmap.restore_time(float(t))
