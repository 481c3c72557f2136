"""The port's config autotuner (``bench.discover``) against the JAX
package's (CPU).

The sweep runs ``test/whisper-nano``'s dims with Whisper's full vocabulary
(51,865 ids: the tokenizer-less special ids, 50,258 and up, must be rows of
the embedding; JAX clamps an index past the table, torch raises), random
weights from seed 0 written as a model dir by the port, two variants, one
timed run each, on 8 s of the tool's synthetic audio.  Its JSON must load
in both packages' ``load_best_cfg_from_discovery`` to the same config, pass
the port's ``_check_supported`` and drive the port's CLI.
"""

import dataclasses
import json
import os
import struct

import numpy as np
import pytest
import torch

from whisper_tpu.bench import discover as jax_discover
from whisper_tpu.runtime.session import (
    load_best_cfg_from_discovery as jax_load_best,
)
from whisper_tpu_torch.bench import cli, discover
from whisper_tpu_torch.models import convert
from whisper_tpu_torch.models.registry import get_dims
from whisper_tpu_torch.runtime.session import (
    _check_supported,
    load_best_cfg_from_discovery,
)

torch.set_num_threads(2)

DIMS = dataclasses.replace(get_dims("test/whisper-nano"), vocab_size=51865)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("nano-full-vocab"))
    convert.save_params(convert.init_params(DIMS, seed=0), DIMS, d)
    return d


@pytest.fixture(scope="module")
def best_json(model_dir, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("discover") / "best.json")
    rc = discover.main(["--model-dir", model_dir, "--synthetic-s", "8",
                        "--variants", "x0,x5", "--runs", "1",
                        "--max-new-tokens", "3", "--out", out], device="cpu")
    assert rc == 0
    return out


def test_synthetic_audio_equals_jax():
    np.testing.assert_array_equal(discover._synthetic_audio(2.5),
                                  jax_discover._synthetic_audio(2.5))


def test_discovery_json_has_the_jax_schema(best_json):
    """``best``, ``metric``, ``value``, ``sweep``: the best entry is the
    fastest of the sweep, and its flags are its variant's."""
    out = json.load(open(best_json))
    assert sorted(out) == ["best", "metric", "sweep", "value"]
    assert out["metric"] == "end_to_end_s"
    assert [r["variant"] for r in out["sweep"]] != [] and \
        sorted(r["variant"] for r in out["sweep"]) == ["x0", "x5"]
    times = [r["e2e_s"] for r in out["sweep"]]
    assert times == sorted(times) and out["value"] == times[0] > 0
    winner = out["sweep"][0]["variant"]
    assert out["best"]["int8_mxu_attn"] is (winner == "x5")
    assert out["best"]["dtype"] == ("float32" if winner == "x0"
                                    else "bfloat16")
    assert out["best"]["intra_op"] >= 1      # from suggested_cfg


def test_discovery_json_loads_in_both_packages(best_json):
    """Both packages' readers give the same config field for field, and
    the port takes it."""
    mine = load_best_cfg_from_discovery(best_json)
    assert mine.to_dict() == jax_load_best(best_json).to_dict()
    assert mine.to_dict() == json.load(open(best_json))["best"]
    _check_supported(mine)


def test_discovery_json_drives_the_cli(best_json, model_dir, tmp_path):
    """The port's CLI with ``--discovery-best-json``: rc 0 and the winner's
    config in ``config_used``."""
    sr = 16000
    pcm = (np.clip(discover._synthetic_audio(3.0), -1, 1) * 32767).astype(
        "<i2").tobytes()
    os.makedirs(tmp_path / "audio")
    with open(tmp_path / "audio" / "a.wav", "wb") as f:
        f.write(struct.pack("<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + len(pcm),
                            b"WAVE", b"fmt ", 16, 1, 1, sr, sr * 2, 2, 16,
                            b"data", len(pcm)) + pcm)
    out = tmp_path / "out"
    rc = cli.main(["--audio-dir", str(tmp_path / "audio"), "--onnx-dir",
                   model_dir, "--max-new-tokens", "3",
                   "--discovery-best-json", best_json,
                   "--out-csv", str(out / "c.csv"),
                   "--out-json", str(out / "j.json"),
                   "--out-summary-json", str(out / "s.json")], device="cpu")
    assert rc == 0
    used = json.load(open(out / "s.json"))["config_used"]
    best = json.load(open(best_json))["best"]
    assert {k: used[k] for k in best} == best


def test_sweep_sorts_fastest_first(model_dir):
    """``sweep`` itself: one entry per (variant, max_batch), sorted by e2e,
    each cfg its variant's at its batch cap."""
    params, dims = convert.load_params(model_dir)
    audio = discover._synthetic_audio(4.0)
    res = discover.sweep(params, dims, audio, ["x2"], [1, 2], 2, 1,
                         verbose=lambda *_: None, device="cpu")
    assert sorted(r["max_batch"] for r in res) == [1, 2]
    assert [r["e2e_s"] for r in res] == sorted(r["e2e_s"] for r in res)
    assert all(r["cfg"]["max_batch"] == r["max_batch"] for r in res)


def test_without_a_card_discover_exits_unless_asked_for_the_cpu(
        tmp_path, monkeypatch):
    monkeypatch.delenv(cli.DEVICE_ENV, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA card"):
        discover.main(["--out", str(tmp_path / "b.json")])
    assert not (tmp_path / "b.json").exists()
