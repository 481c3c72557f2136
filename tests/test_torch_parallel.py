"""The port's multi-device layer (``whisper_tpu_torch.parallel``) against
the JAX package's on the CPU.

Without processes: ``shard_params``' local shapes are the shard shapes of
JAX's ``param_shardings`` on the virtual 8-device mesh, QTensor leaves
included, and ``init_distributed`` maps the CLI's sentinels as JAX does.

With processes: gloo worlds of 2 (data parallel 2; tensor parallel 2)
and of 4 (dp 2 x tp 2), each rank a subprocess (tests/torch_parallel_worker
.py) on a free localhost port, one thread, 120 s collective timeouts and a
subprocess timeout.  Each world runs several checks once; they are held to
what tests/test_sharding.py asserts of JAX in the same configurations:
tokens equal to the one-process port and, at x0 fp32, to JAX; a small
file bucketing to the data axis; a lone request replicated; the kernel
(packed) step under dp and dp x tp, and off where head pairs do not divide
tp; int8 weights under TP; and the CLI in every rank writing one CSV.
"""

import csv
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_parallel_worker as W
from whisper_tpu_torch.models import convert
from whisper_tpu_torch.parallel import mesh as pm
from whisper_tpu_torch.runtime.session import WhisperSession

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_parallel_worker.py")
WORLD_TIMEOUT_S = 400


# ---------------------------------------------------------------------------
# Without processes
# ---------------------------------------------------------------------------

def _leaves(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _leaves(v, path)
        elif hasattr(v, "q") and hasattr(v, "s"):
            yield path + ".q", v.q
            yield path + ".s", v.s
        else:
            yield path, v


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dims_name,tp", [("nano", 1), ("nano", 2),
                                          ("packed", 2), ("packed", 4)])
def test_shard_params_local_shapes_equal_jax_shard_shapes(dims_name, tp,
                                                          int8):
    """Every leaf's local shape on every model rank is the shard shape of
    JAX's NamedSharding for it (the shape-aware rule: an int8 scale
    [L, 1, out] under a row-parallel rule stays whole), and the slices of
    the model ranks put back together are the whole leaf."""
    from whisper_tpu.parallel.mesh import make_mesh, param_shardings
    from whisper_tpu_torch.variants.quant import quantize_params

    dims = W.NANO if dims_name == "nano" else W.PACKED
    params = convert.init_params(dims, seed=1)
    if int8:
        params = quantize_params(params)
    jmesh = make_mesh(8, model_parallel=tp)
    want = dict(_leaves(param_shardings(params, jmesh)))
    full = dict(_leaves(params))
    shards = [dict(_leaves(pm.shard_params(
        params, pm.Mesh(data=8 // tp, model=tp, model_index=mi))))
        for mi in range(tp)]
    for path, sharding in want.items():
        assert tuple(shards[0][path].shape) == sharding.shard_shape(
            full[path].shape), path
    for path, leaf in full.items():
        parts = [np.asarray(s[path]) for s in shards]
        if all(p.shape == leaf.shape for p in parts):
            for p in parts:
                np.testing.assert_array_equal(p, leaf)
            continue
        axis = next(d for d in range(leaf.ndim)
                    if parts[0].shape[d] != leaf.shape[d])
        np.testing.assert_array_equal(np.concatenate(parts, axis), leaf)


def test_shard_params_keeps_the_named_leaves_whole():
    params = convert.init_params(W.NANO, seed=0)
    local = pm.shard_params(params, pm.Mesh(model=2),
                            whole=("encoder/blocks/fc1_w",))
    assert local["encoder"]["blocks"]["fc1_w"].shape == \
        params["encoder"]["blocks"]["fc1_w"].shape
    assert local["decoder"]["blocks"]["fc1_w"].shape[-1] == \
        params["decoder"]["blocks"]["fc1_w"].shape[-1] // 2


def test_make_mesh_raises_as_jax_and_without_a_group():
    with pytest.raises(ValueError, match="must divide"):
        pm.make_mesh(6, model_parallel=4)
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 4"):
        pm.make_mesh(4, model_parallel=2)


def test_init_distributed_maps_the_cli_sentinels(monkeypatch):
    """0 / -1 (not given) take WORLD_SIZE / RANK from the environment, as
    JAX's sentinels map to None and auto-detect; given values win; an
    empty coordinator is torchrun's env:// rendezvous."""
    import torch.distributed as dist

    seen = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: seen.append((backend, kw)))
    monkeypatch.setenv("WORLD_SIZE", "3")
    monkeypatch.setenv("RANK", "2")
    pm.init_distributed("h:1234", 0, -1, backend="gloo", timeout_s=7)
    pm.init_distributed("", 4, 1, backend="gloo")
    assert seen[0][1]["init_method"] == "tcp://h:1234"
    assert (seen[0][1]["world_size"], seen[0][1]["rank"]) == (3, 2)
    assert seen[0][1]["timeout"].total_seconds() == 7
    assert seen[1][1]["init_method"] == "env://"
    assert (seen[1][1]["world_size"], seen[1][1]["rank"]) == (4, 1)
    monkeypatch.delenv("WORLD_SIZE")
    with pytest.raises(RuntimeError, match="WORLD_SIZE is not set"):
        pm.init_distributed("h:1234", 0, 0, backend="gloo")


def test_cli_data_parallel_in_a_world_of_one_exits_naming_torchrun(
        tmp_path):
    env = dict(os.environ, WHISPER_TPU_TORCH_DEVICE="cpu")
    env.pop("WORLD_SIZE", None)
    proc = subprocess.run(
        [sys.executable, "-m", "whisper_tpu_torch.bench", "--audio-dir",
         str(tmp_path), "--data-parallel", "2"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert ("torchrun --nproc-per-node 2 -m whisper_tpu_torch.bench"
            in proc.stderr)


# ---------------------------------------------------------------------------
# gloo worlds
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_world(scenario: str, out_dir: str, sentinels: bool = False):
    """Every rank of the scenario's world, each a subprocess; [results of
    rank r].  A world whose rendezvous port was taken between the probe and
    the bind (another test's) is started once more on another port."""
    for attempt in range(2):
        logs, results = _try_world(scenario, out_dir, sentinels)
        if results is not None or attempt or not any(
                "Address already in use" in log for log in logs):
            break
    for r, log in enumerate(logs):
        path = os.path.join(out_dir, f"rank{r}.json")
        assert os.path.isfile(path), f"rank {r}: no result\n{log[-3000:]}"
        res = json.load(open(path))
        assert "error" not in res, f"rank {r}:\n{res['error']}"
    assert results is not None, "\n".join(log[-2000:] for log in logs)
    return results


def _try_world(scenario: str, out_dir: str, sentinels: bool):
    """(each rank's output, [results of rank r] or None if a rank
    failed)."""
    dp, tp = W.SHAPES[scenario]
    n = dp * tp
    for r in range(n):
        if os.path.exists(os.path.join(out_dir, f"rank{r}.json")):
            os.remove(os.path.join(out_dir, f"rank{r}.json"))
    port = _free_port()
    env = dict(os.environ, WORKER_SENTINELS="1" if sentinels else "0",
               OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    env.pop("RANK", None)
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(n), str(r), str(port), scenario,
         out_dir], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(n)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORLD_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    if any(p.returncode != 0 for p in procs):
        return logs, None
    return logs, [json.load(open(os.path.join(out_dir, f"rank{r}.json")))
                  for r in range(n)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    cache = {}

    def get(scenario):
        if scenario not in cache:
            out = str(tmp_path_factory.mktemp(scenario))
            cache[scenario] = (_run_world(scenario, out,
                                          sentinels=scenario == "tp2"), out)
        return cache[scenario]
    return get


@pytest.fixture(scope="module")
def one_process():
    """The one-process port's results of each check (dp = tp = 1)."""
    cache = {}

    def get(name):
        if name not in cache:
            fn = dict(sum(W.SCENARIOS.values(), []))[name]
            cache[name] = fn(1, 1)
        return cache[name]
    return get


@pytest.fixture(scope="module")
def jax_x0():
    """JAX x0 fp32 on one device: nano's 4 chunks, the 20 s file, the lone
    request (tests/test_sharding.py's references)."""
    from whisper_tpu.models.registry import get_dims
    from whisper_tpu.pipeline.longform import transcribe_longform
    from whisper_tpu.runtime.session import RuntimeCfg as JaxCfg
    from whisper_tpu.runtime.session import WhisperSession as JaxSession

    dims = get_dims("test/whisper-nano")
    chunks = JaxSession(convert.init_params(W.NANO, seed=4), dims,
                        JaxCfg(dtype="float32", max_batch=4)
                        ).transcribe_chunks(W.nano_mel(), [3], 4, 2)
    single = JaxSession(convert.init_params(W.NANO, seed=0), dims,
                        JaxCfg(dtype="float32", max_batch=4,
                               mel_slab_frames=1000))
    text, _ = transcribe_longform(single, W.speech(20.0), language="en",
                                  task="transcribe", max_new_tokens=4)
    audio, nv = W.short_request()
    short = single.transcribe_short_batch(audio, nv, [1, 2, 3], 4, 5)
    return {"chunks_x0": chunks.tolist(), "small_file": text,
            "serving_single": short.tolist()}


CASES = [(sc, name) for sc, checks in W.SCENARIOS.items()
         for name, _ in checks]


@pytest.mark.parametrize("scenario,name", CASES)
def test_mesh_session_equals_the_one_process_port(worlds, one_process,
                                                  jax_x0, scenario, name):
    """Each check of each world: every rank holds the same result, equal
    to the one-process port's (and at x0 fp32 to JAX's)."""
    results, _ = worlds(scenario)
    got = results[0][name]
    for r, res in enumerate(results[1:], 1):
        assert res[name] == got, f"rank {r} differs from rank 0"
    dp, tp = W.SHAPES[scenario]
    if name == "packed_off":
        # the one-process reference takes the same (plain) cross path
        sess = WhisperSession(convert.init_params(W.PAIRS, seed=1), W.PAIRS,
                              W.packed_cfg(packed_cross_kv=False),
                              device="cpu")
        want = {"tokens": sess.transcribe_chunks(
            W.packed_mel(W.PAIRS, 2, 6), [3, 5], 4, 2).tolist(),
            "packed": False}
        one = WhisperSession(convert.init_params(W.PAIRS, seed=1), W.PAIRS,
                             W.packed_cfg(), device="cpu")
        assert one._packed            # on with one process, off at tp 2
    elif name == "packed_x5" and scenario != "dp2":
        # tp > 1 runs 4 chunks of another seed (test_sharding.py:292)
        sess = WhisperSession(convert.init_params(W.PACKED, seed=9), W.PACKED,
                              W.packed_cfg(), device="cpu")
        want = {"tokens": sess.transcribe_chunks(
            W.packed_mel(W.PACKED, 4, 4), [3, 5], 4, 2).tolist(),
            "packed": True, "int8_self": False}
    else:
        want = one_process(name)
    if name in ("w8a8", "fused"):
        # bitwise: the rank's columns and heads are the same products, the
        # gathers and the int32 sums exact
        np.testing.assert_array_equal(np.asarray(got["enc"]),
                                      np.asarray(want["enc"]))
        got, want = dict(got, enc=None), dict(want, enc=None)
    if name == "options":
        np.testing.assert_allclose(got.pop("sum_lp"), want["sum_lp"],
                                   rtol=1e-5)
        np.testing.assert_allclose(got.pop("align"), want["align"],
                                   rtol=1e-5)
        want = {k: v for k, v in want.items() if k not in ("sum_lp",
                                                           "align")}
    if name == "chunks_x0":
        assert got["tokens"] == jax_x0["chunks_x0"]
        assert got["fc1_local"][-1] == want["fc1_local"][-1] // tp
        got, want = got["tokens"], want["tokens"]
    if name == "small_file":
        assert got["bucket_1"] == dp and got["text"] == jax_x0["small_file"]
        got, want = got["text"], want["text"]
    if name == "serving_single":
        assert got["warned"] and got["tokens"] == jax_x0["serving_single"]
        got = dict(got, warned=False)
    if name == "int8_weights":
        assert got["enc_o_w"][1] == want["enc_o_w"][1] // tp
        got, want = got["tokens"], want["tokens"]
    assert got == want


@pytest.mark.parametrize("scenario", ["dp2", "dp2tp2"])
def test_cli_in_every_rank_writes_one_csv_with_the_one_process_texts(
        worlds, tmp_path, scenario):
    """The CLI run by every rank of the world: rank 0 alone writes its
    outputs, and its texts are the one-process CLI's over the same files."""
    from whisper_tpu_torch.bench import cli

    results, out_dir = worlds(scenario)
    assert [r["cli"] for r in results] == [{"rc": 0, "wrote": r == 0}
                                           for r in range(len(results))]
    out = str(tmp_path / "one")
    assert cli.main(W.cli_argv(os.path.join(out_dir, "audio"), out,
                               str(tmp_path / "none")), device="cpu") == 0

    def texts(d):
        with open(os.path.join(d, "c.csv")) as f:
            return [(r["file"], r["text"]) for r in csv.DictReader(f)]
    got = texts(os.path.join(out_dir, "cli_out_rank0"))
    assert [f for f, _ in got] == ["a.wav", "b.wav"]
    assert got == texts(out)
