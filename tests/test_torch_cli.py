"""The port's benchmark CLI against the JAX package's (CPU).

Both CLIs run in process on ``test/whisper-nano`` (random weights from seed
0 through ``--allow-random-init``, a small byte-level BPE tokenizer.json
with Whisper's special tokens and a generation_config.json beside it) over
three WAV files: 3.2 s (one-shot mel), 80 s (8,000 frames: past the
7,680-frame one-shot limit, so the streamed mel) and 2.5 s at 44.1 kHz
stereo (downmix and resample).  The port is asked for the CPU
(``main(argv, device="cpu")``, or ``WHISPER_TPU_TORCH_DEVICE=cpu`` for a
subprocess), where it runs the kernels' plain versions; unasked and without
a card it exits.  The prefetch thread is on (``suggested_cfg``: intra_op =
min(cpu_count, 16) >= 2 here).
"""

import csv
import json
import os
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

from whisper_tpu.bench import cli as jax_cli
from whisper_tpu.runtime.session import (
    load_best_cfg_from_discovery as jax_load_best,
)
from whisper_tpu_torch.bench import cli
from whisper_tpu_torch.ops import cross_attention, log_mel
from whisper_tpu_torch.runtime.session import load_best_cfg_from_discovery

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_wav(path, data, sr=16000, ch=1):
    pcm = np.clip(data * 32768.0, -32768, 32767).astype("<i2").tobytes()
    hdr = struct.pack("<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + len(pcm), b"WAVE",
                      b"fmt ", 16, 1, ch, sr, sr * ch * 2, ch * 2, 16,
                      b"data", len(pcm))
    with open(path, "wb") as f:
        f.write(hdr + pcm)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """tokenizer.json (Whisper's specials at small ids) and
    generation_config.json; no params: the runs use --allow-random-init."""
    from tokenizers import (
        Tokenizer,
        decoders,
        models,
        pre_tokenizers,
        trainers,
    )

    d = tmp_path_factory.mktemp("nano-sidecars")
    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(
        vocab_size=400, initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    tok.train_from_iterator(["some text to build a vocab"], trainer)
    tok.add_special_tokens([
        "<|endoftext|>", "<|startoftranscript|>", "<|en|>",
        "<|transcribe|>", "<|translate|>", "<|notimestamps|>",
        "<|startofprev|>",
    ])
    tok.save(str(d / "tokenizer.json"))
    with open(d / "generation_config.json", "w") as f:
        json.dump({"suppress_tokens": [5, 6], "begin_suppress_tokens": [7]}, f)
    return str(d)


@pytest.fixture(scope="module")
def audio_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("audio")
    rng = np.random.default_rng(0)
    _write_wav(str(d / "a_short.wav"), rng.normal(0, 0.1, int(3.2 * 16000)))
    _write_wav(str(d / "b_long.wav"), rng.normal(0, 0.1, 80 * 16000))
    stereo = rng.normal(0, 0.1, (int(2.5 * 44100), 2)).reshape(-1)
    _write_wav(str(d / "c_stereo.wav"), stereo, sr=44100, ch=2)
    (d / "notes.txt").write_text("not audio")
    return str(d)


def _argv(audio_dir, model_dir, out, *extra):
    return ["--audio-dir", audio_dir, "--model-id", "test/whisper-nano",
            "--onnx-dir", model_dir, "--allow-random-init",
            "--max-new-tokens", "4", "--warmup", "1", "--write-txt",
            "--out-csv", str(out / "c.csv"), "--out-json", str(out / "j.json"),
            "--out-summary-json", str(out / "s.json"), *extra]


def _outputs(out):
    with open(out / "c.csv") as f:
        reader = csv.reader(f)
        header = next(reader)
        rows = list(reader)
    return (header, rows, json.load(open(out / "j.json")),
            json.load(open(out / "s.json")))


def _keys(tree, prefix=""):
    """Every key path of a nested dict."""
    out = set()
    for k, v in tree.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, f"{prefix}{k}/")
    return out


@pytest.fixture(scope="module")
def jax_x0(audio_dir, model_dir, tmp_path_factory):
    out = tmp_path_factory.mktemp("jax-x0")
    assert jax_cli.main(_argv(audio_dir, model_dir, out, "--variant",
                              "x0")) == 0
    return out


def test_x0_text_equals_jax(jax_x0, audio_dir, model_dir, tmp_path):
    """fp32 on both sides: the same files, durations and per-file text, in
    the CSV, the JSON rows and the transcripts."""
    rc = cli.main(_argv(audio_dir, model_dir, tmp_path, "--variant", "x0"),
                  device="cpu")
    assert rc == 0
    header, rows, jrows, summary = _outputs(tmp_path)
    jheader, jrows_csv, jjrows, jsummary = _outputs(jax_x0)
    assert header == jheader
    assert [r[0] for r in rows] == ["a_short.wav", "b_long.wav",
                                    "c_stereo.wav"]
    assert [(r[0], r[1], r[4]) for r in rows] == [
        (r[0], r[1], r[4]) for r in jrows_csv]
    assert [r["text"] for r in jrows] == [r["text"] for r in jjrows]
    assert any(r["text"] for r in jrows)
    for name in ("a_short", "b_long", "c_stereo"):
        assert ((tmp_path / f"{name}.transcript.txt").read_text()
                == (jax_x0 / f"{name}.transcript.txt").read_text())
    assert summary["config_used"] == jsummary["config_used"]
    assert summary["tokenizer_json"] == jsummary["tokenizer_json"]


@pytest.mark.parametrize("variant", ["x5", "int8"])
def test_schemas_equal_jax(jax_x0, audio_dir, model_dir, tmp_path, variant):
    """At x5 and int8 (x4): the CSV header, the JSON rows' keys and every
    key path of the summary are the JAX CLI's.  On the CPU the one-shot
    files take B5's plain version, which counts no launch; nano's head_dim
    32 keeps both packages on the plain decode step."""
    log_mel.launches = cross_attention.dequant_launches = 0
    rc = cli.main(_argv(audio_dir, model_dir, tmp_path, "--variant",
                        variant), device="cpu")
    assert rc == 0
    assert log_mel.launches == 0 and cross_attention.dequant_launches == 0
    header, rows, jrows, summary = _outputs(tmp_path)
    jheader, _, jjrows, jsummary = _outputs(jax_x0)
    assert header == jheader == ["file", "duration_s", "end_to_end_s", "rtf",
                                 "text"]
    assert len(rows) == 3
    assert [set(r) for r in jrows] == [set(r) for r in jjrows]
    assert _keys(summary) == _keys(jsummary) | {"notes/variant"}
    assert summary["config_used"]["fused_frontend"] is True
    assert summary["config_used"]["int8_mxu_attn"] is (variant == "x5")
    assert summary["n_files"] == 3


def test_onnx_dir_reads_jax_save_params(jax_x0, audio_dir, model_dir,
                                        tmp_path):
    """A model dir holding the JAX package's ``save_params`` output (seed 0:
    the weights --allow-random-init builds) gives the JAX CLI's x0 text
    through ``load_params``."""
    import shutil

    from whisper_tpu.models.convert import init_params, save_params
    from whisper_tpu.models.registry import get_dims

    mdir = tmp_path / "model"
    shutil.copytree(model_dir, mdir)
    dims = get_dims("test/whisper-nano")
    save_params(init_params(dims, seed=0), dims, str(mdir))
    argv = [a for a in _argv(audio_dir, str(mdir), tmp_path / "out",
                             "--variant", "x0", "--limit-files", "1")
            if a != "--allow-random-init"]
    assert cli.main(argv, device="cpu") == 0
    _, _, jrows, summary = _outputs(tmp_path / "out")
    assert [r["text"] for r in jrows] == [
        r["text"] for r in _outputs(jax_x0)[2][:1]]
    assert summary["onnx_dir"] == str(mdir)


def test_profile_dir_writes_a_trace(audio_dir, model_dir, tmp_path):
    """--profile-dir writes a torch.profiler Chrome trace of the measured
    loop (the JAX CLI writes a jax.profiler trace)."""
    prof = tmp_path / "prof"
    rc = cli.main(_argv(audio_dir, model_dir, tmp_path, "--variant", "x5",
                        "--limit-files", "1", "--profile-dir", str(prof)),
                  device="cpu")
    assert rc == 0
    trace = json.load(open(prof / "trace.json"))
    assert trace["traceEvents"]


NOT_PORTED = {
    "data_parallel": ["--data-parallel", "2"],
    "tensor_parallel": ["--tensor-parallel", "2"],
    "dcn": ["--dcn-coordinator", "localhost:1234"],
}


# The mesh flags are ported (``parallel.mesh``, tests/test_torch_parallel.py
# runs them in gloo worlds); in a world of one process they exit naming
# what is missing: torchrun's processes, or --dcn-*'s world size and rank.
PORTED_NOW = {"data_parallel": "torchrun --nproc-per-node 2",
              "tensor_parallel": "torchrun --nproc-per-node 2",
              "dcn": "WORLD_SIZE is not set"}


@pytest.mark.parametrize("case", sorted(NOT_PORTED))
def test_not_ported_flags_exit_naming_roadmap(case, tmp_path):
    with pytest.raises(SystemExit, match=PORTED_NOW.get(case, "ROADMAP")):
        cli.main(["--audio-dir", str(tmp_path), *NOT_PORTED[case]],
                 device="cpu")


@pytest.mark.parametrize("wire", ["ulaw8", "auto"])
def test_audio_transfer_runs_and_gives_jax_outputs_at_x0(
        audio_dir, model_dir, tmp_path, tmp_path_factory, capsys, wire):
    """--audio-transfer ulaw8 (a lossy wire) and auto (the probe, timed
    here on the CPU) at x0 over the three files (one shot, streamed,
    resampled): rc 0 and the JAX CLI's files, durations and texts with the
    same flag.  Under auto both CLIs pick a lossless wire, whose samples are
    int16's bit for bit, so the texts agree whichever each probe picks; the
    port prints its probe's line."""
    rc = cli.main(_argv(audio_dir, model_dir, tmp_path, "--variant", "x0",
                        "--audio-transfer", wire), device="cpu")
    assert rc == 0
    probe = [x for x in capsys.readouterr().err.splitlines()
             if x.startswith("[wire-probe] ")]
    assert len(probe) == (wire == "auto")
    header, rows, jrows, summary = _outputs(tmp_path)
    jout = tmp_path_factory.mktemp(f"jax-wire-{wire}")
    assert jax_cli.main(_argv(audio_dir, model_dir, jout, "--variant", "x0",
                              "--audio-transfer", wire)) == 0
    jheader, jcsv, jjrows, jsummary = _outputs(jout)
    assert header == jheader and _keys(summary) == _keys(jsummary)
    assert [r[:2] for r in rows] == [r[:2] for r in jcsv]
    assert [r["text"] for r in jrows] == [r["text"] for r in jjrows]
    assert any(r["text"] for r in jrows)
    picked = summary["config_used"]["audio_transfer"]
    assert picked == wire if wire != "auto" else picked in (
        "int16", "dint16", "dint16p")


PIPELINED = {
    # the cases the port refused before the pipelined mode was ported
    "pipelined": ["--longform-mode", "pipelined"],
    "slab_chunks": ["--longform-mode", "pipelined", "--slab-chunks", "2"],
    "draft": ["--draft-model-id", "test/whisper-nano", "--longform-mode",
              "pipelined"],
    "words_language_auto": ["--longform-mode", "pipelined",
                            "--word-timestamps", "--language", "auto"],
    "prompt_timestamps_beams": ["--longform-mode", "pipelined",
                                "--initial-prompt", "build a vocab",
                                "--timestamps", "--num-beams", "2"],
}


@pytest.mark.parametrize("case", sorted(PIPELINED))
def test_pipelined_mode_gives_jax_outputs_at_x0(audio_dir, model_dir,
                                                tmp_path, tmp_path_factory,
                                                case):
    """``--longform-mode pipelined`` (with ``--slab-chunks``, a draft, word
    timings with ``--language auto``, an initial prompt with the grammar
    and beams) runs on the CPU at x0: rc 0 and the JAX CLI's outputs with
    the same flags: the CSV's files, durations and text, ``words`` (times
    within 0.01 s), the summary's keys and the transcripts, byte for
    byte."""
    argv = ["--variant", "x0", *PIPELINED[case]]
    assert cli.main(_argv(audio_dir, model_dir, tmp_path, *argv),
                    device="cpu") == 0
    jout = tmp_path_factory.mktemp(f"jax-{case}")
    assert jax_cli.main(_argv(audio_dir, model_dir, jout, *argv)) == 0
    header, rows, jrows, summary = _outputs(tmp_path)
    jheader, jcsv, jjrows, jsummary = _outputs(jout)
    assert header == jheader and _keys(summary) == _keys(jsummary)
    assert [(r[0], r[1], r[4]) for r in rows] == [(r[0], r[1], r[4])
                                                  for r in jcsv]
    assert any(r[4] for r in rows)
    for got, want in zip(jrows, jjrows):
        assert set(got) == set(want)
        if "words" in want:
            assert [w["word"] for w in got["words"]] == \
                [w["word"] for w in want["words"]]
            for a, b in zip(got["words"], want["words"]):
                assert abs(a["start"] - b["start"]) <= 0.01
                assert abs(a["end"] - b["end"]) <= 0.01
    for p in jout.glob("*.txt"):
        assert (tmp_path / p.name).read_bytes() == p.read_bytes()


def test_without_weights_the_cli_names_the_ports_converter(tmp_path):
    """A model dir without params.safetensors and no --allow-random-init:
    the message names the port's converter (the card's machine has no jax
    to run the JAX package's)."""
    with pytest.raises(SystemExit) as exc:
        cli.main(["--audio-dir", str(tmp_path), "--onnx-dir",
                  str(tmp_path / "none"), "--out-csv",
                  str(tmp_path / "o" / "c.csv")], device="cpu")
    msg = str(exc.value)
    assert "python -m whisper_tpu_torch.models.convert_cli" in msg
    assert "whisper_tpu.models" not in msg


DECODING_FLAGS = {
    "timestamps": ["--timestamps"],
    "language_auto": ["--language", "auto"],
    "temperatures": ["--temperatures", "0,0.2,0.4"],
    "beams": ["--num-beams", "2", "--length-penalty", "0.8"],
}


@pytest.mark.parametrize("case", sorted(DECODING_FLAGS))
def test_decoding_flags_run_and_give_jax_text_at_x0(jax_x0, audio_dir,
                                                    model_dir, tmp_path,
                                                    tmp_path_factory, case):
    """Each decoding flag the JAX CLI takes runs on the CPU at x0: rc 0,
    the JAX CLI's CSV header and summary keys, and the JAX CLI's text for
    every file with the same flag (the fallback ladder at T = 0 for files
    that pass its gates; sampled rungs may differ, so there the files and
    durations only)."""
    rc = cli.main(_argv(audio_dir, model_dir, tmp_path, "--variant", "x0",
                        *DECODING_FLAGS[case]), device="cpu")
    assert rc == 0
    header, rows, jrows, summary = _outputs(tmp_path)
    jout = tmp_path_factory.mktemp(f"jax-{case}")
    assert jax_cli.main(_argv(audio_dir, model_dir, jout, "--variant", "x0",
                              *DECODING_FLAGS[case])) == 0
    jheader, jcsv, jjrows, jsummary = _outputs(jout)
    assert header == jheader and _keys(summary) == _keys(jsummary)
    assert summary["timestamps"] == jsummary["timestamps"]
    assert [r[:2] for r in rows] == [r[:2] for r in jcsv]
    if case != "temperatures":
        assert [r["text"] for r in jrows] == [r["text"] for r in jjrows]
    if case == "timestamps":
        assert all("<|" in r["text"] for r in jrows if r["text"])


REFUSED = {
    # the JAX CLI's refusals of combinations (cli.py:220-228, 329-336)
    "temperatures_beams": ["--temperatures", "0,0.2", "--num-beams", "2"],
    "temperatures_timestamps": ["--temperatures", "0,0.2", "--timestamps"],
    "temperatures_prompt": ["--temperatures", "0", "--initial-prompt", "x"],
    "temperatures_words": ["--temperatures", "0", "--word-timestamps"],
    "temperatures_srt": ["--temperatures", "0", "--write-srt"],
    "draft_beams": ["--draft-model-id", "test/whisper-nano", "--num-beams",
                    "2"],
    "draft_timestamps": ["--draft-model-id", "test/whisper-nano",
                         "--timestamps"],
    "draft_temperatures": ["--draft-model-id", "test/whisper-nano",
                           "--temperatures", "0,0.2"],
    "draft_pipelined_beams": ["--draft-model-id", "test/whisper-nano",
                              "--longform-mode", "pipelined", "--num-beams",
                              "2"],
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refused_combinations_exit_as_in_jax(case, audio_dir, model_dir,
                                             tmp_path):
    argv = _argv(audio_dir, model_dir, tmp_path, *REFUSED[case])
    with pytest.raises(SystemExit) as want:
        jax_cli.main(argv)
    with pytest.raises(SystemExit) as got:
        cli.main(argv, device="cpu")
    assert str(got.value) == str(want.value)
    assert "compose" in str(got.value)


@pytest.mark.parametrize("variant", ["x6", "x7"])
def test_x6_and_x7_run_with_the_jax_schemas(jax_x0, audio_dir, model_dir,
                                            tmp_path, variant):
    """The two upper rungs of the users' ladder: rc 0, the reference's CSV
    header, three rows, the JAX CLI's summary keys and the rung's flags in
    ``config_used`` as the JAX ladder sets them."""
    from whisper_tpu.runtime.session import RuntimeCfg as JaxCfg
    from whisper_tpu.variants.ladder import apply_variant as jax_apply

    with pytest.warns(UserWarning) if variant == "x6" else _no_warning():
        rc = cli.main(_argv(audio_dir, model_dir, tmp_path, "--variant",
                            variant), device="cpu")
    assert rc == 0
    header, rows, jrows, summary = _outputs(tmp_path)
    assert header == ["file", "duration_s", "end_to_end_s", "rtf", "text"]
    assert len(rows) == 3 and summary["n_files"] == 3
    assert _keys(summary) == _keys(_outputs(jax_x0)[3]) | {"notes/variant"}
    want = jax_apply(JaxCfg(), variant)[0].to_dict()
    got = summary["config_used"]
    for flag in ("int8_encoder_act", "int8_self_kv", "int8_mxu_attn",
                 "int8_weights", "packed_cross_kv", "fused_encoder_mlp"):
        assert got[flag] is want[flag], flag
    assert got["int8_encoder_act"] is (variant == "x6")
    assert got["int8_self_kv"] is (variant == "x7")


def _no_warning():
    import contextlib

    return contextlib.nullcontext()


def test_discovery_json_with_the_four_flags_runs(audio_dir, model_dir,
                                                 tmp_path):
    """A discovery JSON may carry every flag of RuntimeCfg: the fused
    encoder block and the hybrid decode step run, and are echoed."""
    best = tmp_path / "best.json"
    best.write_text(json.dumps({"best": {
        "int8_weights": True, "int8_kv_cache": True, "packed_cross_kv": True,
        "int8_mxu_attn": True, "int8_self_kv": True,
        "int8_encoder_act": True, "fused_encoder_block": True,
        "fused_decoder_step": True}}))
    rc = cli.main(_argv(audio_dir, model_dir, tmp_path / "out",
                        "--discovery-best-json", str(best), "--limit-files",
                        "1"), device="cpu")
    assert rc == 0
    _, rows, _, summary = _outputs(tmp_path / "out")
    assert len(rows) == 1
    for flag in ("fused_encoder_block", "fused_decoder_step", "int8_self_kv",
                 "int8_encoder_act"):
        assert summary["config_used"][flag] is True, flag


def test_without_a_card_the_cli_exits_unless_asked_for_the_cpu(
        tmp_path, monkeypatch):
    """No device argument, no WHISPER_TPU_TORCH_DEVICE, no card: a clear
    error naming the missing card and how to ask for the CPU, and nothing
    runs.  Asking for a card that is not there exits too."""
    monkeypatch.delenv(cli.DEVICE_ENV, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--audio-dir", str(tmp_path), "--out-csv",
            str(tmp_path / "o" / "c.csv")]
    with pytest.raises(SystemExit) as exc:
        cli.main(argv)
    msg = str(exc.value)
    assert exc.value.code not in (0, None)
    assert "no CUDA card" in msg and cli.DEVICE_ENV in msg
    assert not (tmp_path / "o").exists()
    with pytest.raises(SystemExit, match="no CUDA card"):
        cli.main(argv, device="cuda")
    monkeypatch.setenv(cli.DEVICE_ENV, "cuda")
    with pytest.raises(SystemExit, match="no CUDA card"):
        cli.main(argv)
    # asked for the CPU through the environment, it gets as far as the files
    monkeypatch.setenv(cli.DEVICE_ENV, "cpu")
    with pytest.raises(SystemExit, match="model dir does not exist"):
        cli.main(argv)


def test_module_run_without_a_card_exits_nonzero(tmp_path):
    """``python -m whisper_tpu_torch.bench`` with the variable unset, on a
    machine without a card: a non-zero exit code and the message on stderr.
    (Skipped where a card is present: there the run is the card's.)"""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    env = {k: v for k, v in os.environ.items()
           if k not in ("WHISPER_TPU_PLATFORM", "PYTHONPATH", cli.DEVICE_ENV)}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-m", "whisper_tpu_torch.bench", "--audio-dir",
         str(tmp_path)], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0
    assert "no CUDA card" in proc.stderr and "DONE" not in proc.stdout


def test_parser_has_every_jax_flag():
    """The same option strings, defaults, choices and flag kinds."""
    def spec(parser):
        return {a.option_strings[0]: (a.dest, a.default, a.choices,
                                      type(a).__name__, a.type)
                for a in parser._actions if a.option_strings
                and a.dest != "help"}

    assert spec(cli.build_parser()) == spec(jax_cli.build_parser())


def test_discovery_config_coerced_like_jax(tmp_path):
    """Lenient coercion (strings, numbers, junk) gives the JAX package's
    RuntimeCfg field for field."""
    p = tmp_path / "best.json"
    p.write_text(json.dumps({"best": {
        "dtype": "float32", "max_batch": "8", "fused_frontend": "yes",
        "int8_weights": 1, "int8_kv_cache": "true", "packed_cross_kv": 1.0,
        "mel_slab_frames": "junk", "intra_op": 3.7, "audio_transfer": 5,
        "streamed_mel": "off", "allow_spinning": 0}}))
    mine = load_best_cfg_from_discovery(str(p))
    assert mine.to_dict() == jax_load_best(str(p)).to_dict()
    assert mine.max_batch == 8 and mine.fused_frontend
    assert not mine.streamed_mel


def test_module_run_loads_no_jax(audio_dir, model_dir, tmp_path):
    """``python -m whisper_tpu_torch.bench`` at x5 in a fresh process: rc 0,
    and no module of jax, jaxlib or whisper_tpu among its imports."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("WHISPER_TPU_PLATFORM", "PYTHONPATH")}
    env["PYTHONPATH"] = REPO
    env[cli.DEVICE_ENV] = "cpu"
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "whisper_tpu_torch.bench",
         *_argv(audio_dir, model_dir, tmp_path, "--variant", "x5",
                "--limit-files", "1")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "End-to-end p95(s):" in proc.stdout
    imported = {line.split("|")[-1].strip()
                for line in proc.stderr.splitlines()
                if line.startswith("import time:")}
    assert "whisper_tpu_torch.bench.cli" in imported
    bad = sorted(m for m in imported
                 if m.split(".")[0] in ("jax", "jaxlib", "whisper_tpu"))
    assert not bad, bad


# ---------------------------------------------------------------------------
# The sequential mode, conditioned prompts, word timings, subtitles and VAD
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sparse_audio_dir(tmp_path_factory):
    """JAX's VAD files (tests/test_vad.py): two tone bursts in near-silence
    (7 s) and a file of near-silence alone."""
    d = tmp_path_factory.mktemp("vad-audio")
    t = np.arange(16000 * 3) / 16000

    def quiet(s):
        return 1e-4 * np.random.default_rng(0).standard_normal(int(s * 16000))

    def tone(s):
        return 0.3 * np.sin(2 * np.pi * 440 * t[:int(s * 16000)])

    _write_wav(str(d / "sparse.wav"), np.concatenate(
        [quiet(1.0), tone(1.5), quiet(3.0), tone(1.0), quiet(0.5)]))
    _write_wav(str(d / "quiet.wav"), quiet(2.0))
    return str(d)


TIMING_FLAGS = {
    "sequential": (["--longform-mode", "sequential"], False),
    "sequential_conditioned": (["--longform-mode", "sequential",
                                "--condition-on-prev-text"], False),
    "sequential_subtitles": (["--longform-mode", "sequential", "--write-srt",
                              "--write-vtt"], False),
    "sequential_prompt_words": (["--longform-mode", "sequential",
                                 "--condition-on-prev-text",
                                 "--initial-prompt", "some vocab text",
                                 "--word-timestamps"], False),
    "initial_prompt": (["--initial-prompt", "build a vocab"], False),
    "word_timestamps": (["--word-timestamps"], False),
    "words_subtitles": (["--word-timestamps", "--write-srt", "--write-vtt"],
                        False),
    "vad_words_subtitles": (["--vad-filter", "--word-timestamps",
                             "--write-srt"], True),
    "vad_threshold": (["--vad-filter", "--vad-threshold-db", "6"], True),
}


@pytest.mark.parametrize("case", sorted(TIMING_FLAGS))
def test_timing_and_prompt_flags_give_jax_outputs_at_x0(
        audio_dir, sparse_audio_dir, model_dir, tmp_path, tmp_path_factory,
        case):
    """Each flag the port refused before this slice runs on the CPU at x0:
    rc 0 and the JAX CLI's outputs with the same flags, byte for byte: the
    CSV's files, durations and text, the per-file JSON (``words`` with
    ``--word-timestamps``, times within 0.01 s), the summary's keys, the
    transcripts and the .srt/.vtt files."""
    flags, sparse = TIMING_FLAGS[case]
    audio = sparse_audio_dir if sparse else audio_dir
    argv = ["--variant", "x0", "--max-new-tokens", "6", *flags]
    assert cli.main(_argv(audio, model_dir, tmp_path, *argv),
                    device="cpu") == 0
    jout = tmp_path_factory.mktemp(f"jax-{case}")
    assert jax_cli.main(_argv(audio, model_dir, jout, *argv)) == 0
    header, rows, jrows, summary = _outputs(tmp_path)
    jheader, jcsv, jjrows, jsummary = _outputs(jout)
    assert header == jheader and _keys(summary) == _keys(jsummary)
    assert [(r[0], r[1], r[4]) for r in rows] == [(r[0], r[1], r[4])
                                                  for r in jcsv]
    assert [set(r) for r in jrows] == [set(r) for r in jjrows]
    for got, want in zip(jrows, jjrows):
        if "words" in want:
            assert [w["word"] for w in got["words"]] == \
                [w["word"] for w in want["words"]]
            for a, b in zip(got["words"], want["words"]):
                assert abs(a["start"] - b["start"]) <= 0.01
                assert abs(a["end"] - b["end"]) <= 0.01
    if "--word-timestamps" in flags:
        assert any(r["words"] for r in jrows)
    outputs = sorted(p.name for p in jout.iterdir()
                     if p.suffix in (".txt", ".srt", ".vtt"))
    assert outputs == sorted(p.name for p in tmp_path.iterdir()
                             if p.suffix in (".txt", ".srt", ".vtt"))
    for name in outputs:
        assert (tmp_path / name).read_bytes() == (jout / name).read_bytes()
    if "--write-srt" in flags:
        assert any(name.endswith(".srt") for name in outputs)


TIMING_REFUSED = {
    # the JAX CLI's refusals (cli.py:216-237, 316-336)
    "vad_sequential": ["--vad-filter", "--longform-mode", "sequential"],
    "vad_pipelined": ["--vad-filter", "--longform-mode", "pipelined"],
    "srt_without_timing": ["--write-srt"],
    "vtt_without_timing": ["--write-vtt"],
    "draft_sequential": ["--draft-model-id", "test/whisper-nano",
                         "--longform-mode", "sequential"],
    "draft_word_timestamps": ["--draft-model-id", "test/whisper-nano",
                              "--word-timestamps"],
    "initial_prompt_without_tokenizer": ["--initial-prompt", "x"],
}


@pytest.mark.parametrize("case", sorted(TIMING_REFUSED))
def test_timing_and_prompt_refusals_exit_as_in_jax(case, audio_dir,
                                                   model_dir, tmp_path):
    model = (str(tmp_path / "no-tokenizer")
             if case == "initial_prompt_without_tokenizer" else model_dir)
    argv = _argv(audio_dir, model, tmp_path, *TIMING_REFUSED[case])
    with pytest.raises(SystemExit) as want:
        jax_cli.main(argv)
    with pytest.raises(SystemExit) as got:
        cli.main(argv, device="cpu")
    assert str(got.value) == str(want.value) and "ROADMAP" not in str(
        got.value)
