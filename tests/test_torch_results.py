"""The port's results tools (``whisper_tpu_torch.results``: copies of the
JAX package's ``wer``, ``compare``, ``summarize``, ``accumulate``,
``timelog`` and ``timed_run``) on the cases of tests/test_results.py and
tests/test_wer.py: every output equal to the JAX module's on the same
input (values, files byte for byte, printed reports), and the port's run
script beside the JAX one.  Host-only; no device, no tolerance but the
approximate ones the JAX tests state.
"""

import csv
import json
import os
import subprocess
import sys

import pytest

from whisper_tpu.results import accumulate as jacc
from whisper_tpu.results import compare as jcmp
from whisper_tpu.results import summarize as jsum
from whisper_tpu.results import timelog as jtl
from whisper_tpu.results import wer as jwer
from whisper_tpu_torch.results import (
    accumulate,
    compare,
    summarize,
    timed_run,
    timelog,
    wer,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TIME_LOG = """\
\tCommand being timed: "whisper_bench"
\tElapsed (wall clock) time (h:mm:ss or m:ss): 1:23.45
\tMaximum resident set size (kbytes): 2240512
"""


@pytest.mark.parametrize("raw", ["1:23.45", "2:01:05", "42.5", "", "x:y"])
def test_parse_elapsed_equals_jax(raw):
    assert timelog.parse_elapsed(raw) == jtl.parse_elapsed(raw)


def test_parse_time_log_equals_jax(tmp_path):
    p = tmp_path / "t.time.txt"
    p.write_text(TIME_LOG)
    got = timelog.parse_time_log(str(p))
    assert got == jtl.parse_time_log(str(p))
    assert got[0] == pytest.approx(83.45) and got[1] == 2240512
    assert timelog.parse_time_log("/nope") == (None, None)


SUMMARIES = [
    {"latency_end_to_end_s": {"p95": 1.5}},
    {"latency_end_to_end_s": {"median": 2.0}},
    {},
    {"config_used": {"compute_type": "float32"}},
    {"config_used": {"dtype": "bfloat16"}},
    {"config_used": {"dtype": "bfloat16", "int8_weights": True}},
    {"config_used": {"num_beams": 4}},
    {"config_used": {"beam_size": "2"}},
]


@pytest.mark.parametrize("i", range(len(SUMMARIES)))
def test_summary_extraction_equals_jax(i):
    s = SUMMARIES[i]
    assert summarize.extract_time_s(s) == jsum.extract_time_s(s)
    assert summarize.extract_precision(s, "fp32") == \
        jsum.extract_precision(s, "fp32")
    assert summarize.extract_beam_size(s) == jsum.extract_beam_size(s)


@pytest.mark.parametrize("secs", [None, 5.4, 83.45, 3700])
def test_format_duration_equals_jax(secs):
    assert summarize.format_duration(secs) == jsum.format_duration(secs)


def test_default_suts_keep_the_reference_rows_and_name_the_port_runs():
    """The reference's six rows as they are; four rows of the port, each
    the output directory of run_benchmark_whisper_tpu_torch.sh."""
    assert summarize.DEFAULT_SUTS[:6] == jsum.DEFAULT_SUTS[:6]
    port = summarize.DEFAULT_SUTS[6:]
    assert len(port) == 4
    assert [d for _, _, d in port] == [
        f"whisper_tpu_torch_{v}" for v in ("x2", "int8", "x5", "x0")]


def _results_dir(tmp_path, subdir):
    rd = tmp_path / "res"
    ld = rd / "logs"
    ld.mkdir(parents=True)
    sut = rd / subdir
    sut.mkdir()
    (sut / "inference_summary.json").write_text(json.dumps({
        "config_used": {"dtype": "bfloat16", "int8_weights": False},
        "latency_end_to_end_s": {"p95": 0.61},
    }))
    (ld / f"{subdir}.time.txt").write_text(TIME_LOG)
    fw = rd / "faster_whisper_fp32"
    fw.mkdir()
    (fw / "skipped.json").write_text(json.dumps(
        {"status": "skipped", "reason": "dependency absent"}))
    return rd, ld


def test_build_rows_and_tables_equal_jax(tmp_path):
    """tests/test_results.py's summary case on the port's x2 directory:
    a row for every SUT with the status rows of the absent ones, the run's
    row, and summary_table.md/.csv byte for byte the JAX module's for the
    same rows."""
    rd, ld = _results_dir(tmp_path, "whisper_tpu_torch_x2")
    rows = summarize.build_rows(str(rd), str(ld))
    assert len(rows) == len(summarize.DEFAULT_SUTS)
    by = {r["implementation"]: r for r in rows}
    assert by["faster-whisper (fp32)"]["time"] == "skipped (dependency absent)"
    assert by["onnxruntime rust (no HF pipeline)"]["time"] == "not run"
    ours = summarize.build_rows(str(rd), str(ld), include_missing=False)
    want = jsum.build_rows(str(rd), str(ld), suts=summarize.DEFAULT_SUTS,
                           include_missing=False)
    assert ours == want and len(ours) == 1
    assert ours[0]["implementation"] == "whisper-tpu-torch (bf16)"
    assert ours[0]["time_s"] == 0.61 and ours[0]["ram_mb"] == 2188
    assert rows[:6] == jsum.build_rows(str(rd), str(ld))[:6]
    summarize.write_summary_table(ours, str(tmp_path / "a.md"),
                                  str(tmp_path / "a.csv"))
    jsum.write_summary_table(ours, str(tmp_path / "b.md"),
                             str(tmp_path / "b.csv"))
    for ext in ("md", "csv"):
        assert (tmp_path / f"a.{ext}").read_bytes() == \
            (tmp_path / f"b.{ext}").read_bytes()


def test_summarize_main_writes_the_tables(tmp_path, capsys):
    rd, ld = _results_dir(tmp_path, "whisper_tpu_torch_x5")
    assert summarize.main(["--results-dir", str(rd)]) == 0
    got = list(csv.DictReader(open(rd / "summary_table.csv")))
    assert len(got) == len(summarize.DEFAULT_SUTS)
    timed = [r for r in got if r["time_s"]]
    assert [r["implementation"] for r in timed] == [
        "whisper-tpu-torch (int8 x int8)"]
    assert "Wrote summary table" in capsys.readouterr().out


MERGES = [
    ("# Results\n", "sut:4c:4g", "## sut - 4c/4g", "### Run T1\n\ntable1\n"),
    ("", "a:1c:1g", "## a", "### Run T\n\nt\n"),
]


@pytest.mark.parametrize("i", range(len(MERGES)))
def test_merge_section_equals_jax(i):
    args = MERGES[i]
    got = accumulate.merge_section(*args)
    assert got == jacc.merge_section(*args)
    # merging again into the block it made
    again = ("### Run T2\n\ntable2\n",)
    assert accumulate.merge_section(got, *args[1:3], *again) == \
        jacc.merge_section(got, *args[1:3], *again)


def test_update_results_md_and_csv_equal_jax(tmp_path):
    table = tmp_path / "summary_table.md"
    table.write_text("| Implementation |\n| --- |\n| whisper-tpu-torch |")
    scsv = tmp_path / "summary_table.csv"
    with open(scsv, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=[
            "implementation", "precision", "beam_size", "time_s", "ram_mb"])
        w.writeheader()
        w.writerow({"implementation": "whisper-tpu-torch (bf16)",
                    "precision": "bf16", "beam_size": 1, "time_s": 0.61,
                    "ram_mb": 2100})
    out = {}
    for name, mod in (("port", accumulate), ("jax", jacc)):
        md, rcsv = tmp_path / f"{name}.md", tmp_path / f"{name}.csv"
        ts = mod.update_results_md(str(md), str(table), "h100", 8, 96,
                                   timestamp="2026-10-17T00:00:00")
        mod.append_results_csv(str(rcsv), str(scsv), ts, "h100", 8, 96)
        mod.append_results_csv(str(rcsv), str(scsv), ts, "h100", 8, 96)
        out[name] = (md.read_bytes(), rcsv.read_bytes())
    assert out["port"] == out["jax"]
    assert b"## h100 - 8 cores / 96GB RAM" in out["port"][0]
    rows = list(csv.DictReader(open(tmp_path / "port.csv")))
    assert len(rows) == 2 and list(rows[0]) == accumulate.RESULTS_CSV_FIELDS


def _rows(texts, times):
    return [{"file": f"f{i}.wav", "duration_s": 10.0, "end_to_end_s": t,
             "rtf": t / 10.0, "text": x}
            for i, (x, t) in enumerate(zip(texts, times))]


@pytest.mark.parametrize("hyp", [["hello", "different"], ["hello ", "world"]])
def test_parity_report_equals_jax(tmp_path, capsys, hyp):
    ref, run = tmp_path / "ref.json", tmp_path / "run.json"
    ref.write_text(json.dumps(_rows(["hello", "world"], [1.0, 2.0])))
    run.write_text(json.dumps(_rows(hyp, [0.1, 0.2])))
    assert compare.compare_per_file(str(ref), str(run)) == \
        jcmp.compare_per_file(str(ref), str(run))
    rc = compare.print_parity(str(ref), str(run))
    got = capsys.readouterr().out
    assert rc == jcmp.print_parity(str(ref), str(run))
    assert got == capsys.readouterr().out
    assert rc == (1 if hyp[1] == "different" else 0)


def test_stats_lines_equal_jax(tmp_path, capsys):
    d = tmp_path / "run"
    d.mkdir()
    (d / "s.json").write_text(json.dumps({"latency_end_to_end_s": {
        "min": 1, "median": 2, "p90": 3, "p95": 4, "max": 5, "mean": 2.5}}))
    paths = [str(d / "s.json"), str(tmp_path / "missing" / "s.json")]
    compare.print_summary_stats(paths)
    got = capsys.readouterr().out
    jcmp.print_summary_stats(paths)
    assert got == capsys.readouterr().out and "median=2.000" in got


WER_CASES = [("the cat sat", "The cat sat."), ("the cat sat", "the dog sat"),
             ("a b c", "a c"), ("a c", "a b c"), ("", "anything"), ("", ""),
             ("abc", "ABC"), ("Hello,   World!", "hello world")]


@pytest.mark.parametrize("ref,hyp", WER_CASES)
def test_wer_cer_equal_jax(ref, hyp):
    assert wer.wer(ref, hyp) == jwer.wer(ref, hyp)
    assert wer.cer(ref, hyp) == jwer.cer(ref, hyp)
    assert wer.normalize_text(ref) == jwer.normalize_text(ref)
    assert wer.edit_distance(ref, hyp) == jwer.edit_distance(ref, hyp)


def test_wer_compare_files_equals_jax(tmp_path):
    ref = [{"file": "a.wav", "text": "the quick brown fox"},
           {"file": "b.wav", "text": "hello world"}]
    hyp = [{"file": "a.wav", "text": "the quick brown fox"},
           {"file": "b.wav", "text": "hello there world"}]
    rp, hp = tmp_path / "r.json", tmp_path / "h.json"
    rp.write_text(json.dumps(ref))
    hp.write_text(json.dumps(hyp))
    got = wer.compare_files(str(rp), str(hp))
    assert got == jwer.compare_files(str(rp), str(hp))
    assert got["wer"] == pytest.approx(1 / 6)


def test_timed_run_writes_what_timelog_reads(tmp_path):
    log = tmp_path / "t.time.txt"
    rc = timed_run.main([str(log), "--", sys.executable, "-c", "pass"])
    assert rc == 0
    elapsed, rss = timelog.parse_time_log(str(log))
    assert elapsed is not None and elapsed >= 0 and rss > 0
    assert jtl.parse_time_log(str(log)) == (elapsed, rss)


def _bench_args(path):
    """The benchmark command's flags in a run script, the module and the
    output directory's name left out."""
    text = open(path).read()
    cmd = text[text.rindex("python -m"):]
    lines = [ln.strip().rstrip("\\").strip() for ln in cmd.splitlines()]
    return [ln.replace("whisper_tpu_torch", "whisper_tpu") for ln in lines
            if ln]


def test_run_script_takes_the_jax_scripts_flags():
    ours = os.path.join(REPO, "run_benchmark_whisper_tpu_torch.sh")
    assert os.access(ours, os.X_OK)
    assert _bench_args(ours) == _bench_args(
        os.path.join(REPO, "run_benchmark_whisper_tpu.sh"))
    text = open(ours).read()
    assert "python -m whisper_tpu_torch.bench" in text
    assert "OUT=results/benchmarks/whisper_tpu_torch_${VARIANT}" in text


def test_run_script_without_a_card_exits_nonzero(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "WHISPER_TPU_TORCH_DEVICE")}
    env.update(PYTHONPATH=REPO, AUDIO_DIR=str(tmp_path),
               VARIANT="x0")
    proc = subprocess.run(["bash", os.path.join(REPO,
                                                "run_benchmark_whisper_tpu_torch.sh")],
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0 and "no CUDA card" in proc.stderr
    assert not os.path.exists(os.path.join(
        REPO, "results", "benchmarks", "whisper_tpu_torch_x0"))
