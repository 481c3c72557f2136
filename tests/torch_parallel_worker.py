"""One rank of a gloo world for tests/test_torch_parallel.py (not a test
module itself): ``python tests/torch_parallel_worker.py WORLD RANK PORT
SCENARIO OUT_DIR``.

The rank joins a process group of WORLD processes over
``tcp://127.0.0.1:PORT`` (``parallel.mesh.init_distributed``, 120 s
timeouts), runs every check of SCENARIO on the CPU with one thread, and
writes what it got to OUT_DIR/rank<RANK>.json; the test compares those
with the one-process port and the JAX package.  Inputs are made here from
fixed seeds, as the test makes them.
"""

import json
import os
import sys
import time
import traceback
import warnings

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from whisper_tpu_torch.models import convert  # noqa: E402
from whisper_tpu_torch.models.registry import WhisperDims, get_dims  # noqa: E402
from whisper_tpu_torch.parallel import mesh as pm  # noqa: E402
from whisper_tpu_torch.runtime.session import (  # noqa: E402
    RuntimeCfg,
    WhisperSession,
)

NANO = get_dims("test/whisper-nano")
# head_dim 64, 4 heads: the packed (kernel) step stays on at tp 2
PACKED = WhisperDims(n_mels=80, d_model=256, encoder_layers=2,
                     encoder_heads=4, decoder_layers=2, decoder_heads=4,
                     vocab_size=256, max_source_positions=1500,
                     max_target_positions=32)
# 2 heads of 64: (2 // 2) % 2 != 0, so tp 2 turns the packed step off
PAIRS = WhisperDims(n_mels=80, d_model=128, encoder_layers=2,
                    encoder_heads=2, decoder_layers=2, decoder_heads=2,
                    vocab_size=256, max_source_positions=1500,
                    max_target_positions=32)


def nano_mel(n=4, seed=0):
    rng = np.random.default_rng(seed)
    mel = np.zeros((n, NANO.n_mels, 3000), dtype=np.float32)
    mel[:, :, :128] = rng.normal(0, 1, (n, NANO.n_mels, 128))
    return mel


def packed_mel(dims, n, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(0, 1, (n, dims.n_mels, 3000)).astype(np.float32)


def packed_cfg(**kw):
    return RuntimeCfg(**dict(dict(
        dtype="float32", max_batch=8, int8_kv_cache=True,
        packed_cross_kv=True, int8_mxu_attn=True, streamed_mel=False), **kw))


def speech(seconds, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(0, 0.1, int(seconds * 16000)).astype(np.float32)


def short_request():
    rng = np.random.default_rng(1)
    audio = np.zeros((1, 2 * 16000 + 400), dtype=np.float32)
    audio[0, :32000] = rng.normal(0, 0.1, 32000)
    return audio, np.array([200], dtype=np.int32)


def toks(x):
    return np.asarray(x).tolist()


def session(params, dims, cfg):
    return WhisperSession(params, dims, cfg, device="cpu")


# ---------------------------------------------------------------------------
# Checks; each returns a JSON-able value
# ---------------------------------------------------------------------------

def chunks_x0(dp, tp):
    """test_sharding.py:72-177: nano at x0 fp32, 4 chunks."""
    sess = session(convert.init_params(NANO, seed=4), NANO,
                   RuntimeCfg(dtype="float32", max_batch=4,
                              data_parallel=dp, tensor_parallel=tp))
    return {"tokens": toks(sess.transcribe_chunks(nano_mel(), [3], 4, 2)),
            "fc1_local": list(sess.decoder.tree()["blocks"]["fc1_w"].shape)}


def small_file_bucket(dp, tp):
    """test_sharding.py:180: one 20 s chunk buckets to the data axis, over
    the streamed multi-slab mel."""
    from whisper_tpu_torch.pipeline.longform import transcribe_longform

    sess = session(convert.init_params(NANO, seed=0), NANO,
                   RuntimeCfg(dtype="float32", max_batch=4,
                              mel_slab_frames=1000, data_parallel=dp,
                              tensor_parallel=tp))
    text, _ = transcribe_longform(sess, speech(20.0), language="en",
                                  task="transcribe", max_new_tokens=4)
    return {"bucket_1": sess._batch_bucket(1), "text": text}


def serving_single(dp, tp):
    """test_sharding.py:215: a lone request on a DP session runs
    replicated (bucket 1 does not divide the data axis), with a warning."""
    sess = session(convert.init_params(NANO, seed=0), NANO,
                   RuntimeCfg(dtype="float32", max_batch=4,
                              data_parallel=dp, tensor_parallel=tp))
    audio, nv = short_request()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t = sess.transcribe_short_batch(audio, nv, [1, 2, 3], 4, 5)
    return {"tokens": toks(t),
            "warned": any("replicated" in str(w.message) for w in caught)}


def packed_x5(dp, tp, int8_self=False):
    """test_sharding.py:269, 292, 330: the kernel step (B3/B8 and B4 through
    their sharded wrappers) under dp and dp x tp."""
    n = 4
    sess = session(convert.init_params(PACKED, seed=9), PACKED,
                   packed_cfg(int8_self_kv=int8_self, data_parallel=dp,
                              tensor_parallel=tp))
    t = sess.transcribe_chunks(packed_mel(PACKED, n, 3 if tp == 1 else 4),
                               [3, 5], 4, 2)
    return {"tokens": toks(t), "packed": sess._packed,
            "int8_self": sess._int8_self}


def packed_off(dp, tp):
    """test_sharding.py:315: head pairs that do not divide tp turn the
    packed step off, as in JAX; the tokens are the one-process port's."""
    sess = session(convert.init_params(PAIRS, seed=1), PAIRS,
                   packed_cfg(data_parallel=dp, tensor_parallel=tp))
    t = sess.transcribe_chunks(packed_mel(PAIRS, 2, 6), [3, 5], 4, 2)
    return {"tokens": toks(t), "packed": sess._packed}


def int8_weights(dp, tp):
    """test_sharding.py:427: int8 weights under TP; a row-parallel QTensor
    keeps its rows, its [L, 1, out] scale stays whole."""
    sess = session(convert.init_params(NANO, seed=0), NANO,
                   RuntimeCfg(dtype="float32", int8_weights=True,
                              max_batch=2, data_parallel=dp,
                              tensor_parallel=tp))
    rng = np.random.default_rng(0)
    mel = rng.normal(0, 0.5, (2, NANO.n_mels, 3000)).astype(np.float32)
    enc_q = sess.encoder.tree()["blocks"]
    return {"tokens": toks(sess.transcribe_chunks(mel, [3], 4, 2)),
            "enc_o_w": list(enc_q["o_w"].shape)}


def w8a8_encoder(dp, tp):
    """x6's W8A8 encoder: the row-parallel O product takes the row absmax
    over "model" and sums int32 accumulators, so the encoder states equal
    the one-process port's."""
    cfg = RuntimeCfg(dtype="float32", int8_weights=True,
                     int8_encoder_act=True, max_batch=2, data_parallel=dp,
                     tensor_parallel=tp)
    sess = session(convert.init_params(NANO, seed=2), NANO, cfg)
    enc = sess.encoder(torch.from_numpy(nano_mel(2, seed=5)))
    return {"enc": enc[:, ::50].tolist()}


def fused(dp, tp):
    """The fused encoder block (B9a and B1 on the rank's heads, B9b whole on
    the gathered context) and the hybrid step (B10c whole) under TP."""
    cfg = RuntimeCfg(dtype="float32", max_batch=2, fused_attention=True,
                     fused_encoder_block=True, fused_decoder_step=True,
                     data_parallel=dp, tensor_parallel=tp)
    sess = session(convert.init_params(PACKED, seed=3), PACKED, cfg)
    mel = packed_mel(PACKED, 2, 8)
    enc = sess.encoder(torch.from_numpy(mel))
    return {"tokens": toks(sess.transcribe_chunks(mel, [3, 5], 4, 2)),
            "enc": enc[:, ::50].tolist()}


def options(dp, tp):
    """Beams, scores, sampling with a seed, the alignment heads and the
    detected language through a mesh session (nano at x0)."""
    from whisper_tpu_torch.runtime.langdetect import detect_language

    sess = session(convert.init_params(NANO, seed=4), NANO,
                   RuntimeCfg(dtype="float32", max_batch=4,
                              data_parallel=dp, tensor_parallel=tp))
    mel = torch.from_numpy(nano_mel().transpose(1, 0, 2).reshape(
        NANO.n_mels, -1).copy())
    starts = [0, 3000, 6000, 9000]
    beams = sess.transcribe_from_mel(mel, starts, [3], 4, 2, num_beams=2)
    t, lp, nt = sess.transcribe_from_mel(mel, starts, [3], 4, 2,
                                         temperature=0.7, seed=3,
                                         with_scores=True)
    w = sess.alignment_weights(nano_mel()[0], [3], [7, 9])
    lang = detect_language(sess, mel[:, :3000], 3, {4: "en", 5: "de"})
    return {"beams": toks(beams), "sampled": toks(t),
            "sum_lp": np.asarray(lp).tolist(), "n_tok": toks(nt),
            "align": np.asarray(w).sum(axis=(1, 2, 3)).tolist(),
            "align_shape": list(w.shape), "lang": list(lang[:2])}


def speculative(dp, tp):
    """Speculative decoding with a whole draft on every rank."""
    params = convert.init_params(NANO, seed=4)
    sess = session(params, NANO, RuntimeCfg(dtype="float32", max_batch=4,
                                            data_parallel=dp,
                                            tensor_parallel=tp))
    sess.set_draft_model(convert.init_params(NANO, seed=8), NANO)
    mel = torch.from_numpy(nano_mel().transpose(1, 0, 2).reshape(
        NANO.n_mels, -1).copy())
    t = sess.transcribe_from_mel(mel, [0, 3000, 6000, 9000], [3], 6, 2,
                                 speculative=True, draft_k=2)
    return {"tokens": toks(t)}


def cli_argv(audio, out, model_dir, dp=1, tp=1):
    return ["--audio-dir", audio, "--model-id", "test/whisper-nano",
            "--onnx-dir", model_dir, "--allow-random-init", "--variant",
            "x0", "--max-new-tokens", "4", "--max-batch", "4",
            "--data-parallel", str(dp), "--tensor-parallel", str(tp),
            "--out-csv", os.path.join(out, "c.csv"),
            "--out-json", os.path.join(out, "j.json"),
            "--out-summary-json", os.path.join(out, "s.json")]


def cli_run(dp, tp, out_dir, rank):
    """The CLI in every rank (x0, nano, random weights): rank 0 alone
    writes the CSV."""
    from whisper_tpu_torch.bench import cli

    audio = os.path.join(out_dir, "audio")
    if rank == 0:
        write_audio_dir(audio)
    torch.distributed.barrier()
    out = os.path.join(out_dir, f"cli_out_rank{rank}")
    rc = cli.main(cli_argv(audio, out, os.path.join(out_dir, "none"), dp,
                           tp), device="cpu")
    return {"rc": rc, "wrote": os.path.isfile(os.path.join(out, "c.csv"))}


def write_audio_dir(path):
    """Two WAV files: 3.2 s, and 62 s (three chunks)."""
    import struct

    os.makedirs(path, exist_ok=True)
    for name, sec in (("a.wav", 3.2), ("b.wav", 62.0)):
        pcm = np.clip(speech(sec, seed=int(sec)) * 32768.0, -32768, 32767
                      ).astype("<i2").tobytes()
        hdr = struct.pack("<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + len(pcm),
                          b"WAVE", b"fmt ", 16, 1, 1, 16000, 32000, 2, 16,
                          b"data", len(pcm))
        with open(os.path.join(path, name), "wb") as f:
            f.write(hdr + pcm)


SCENARIOS = {
    # world of 2: data parallel
    "dp2": [("chunks_x0", chunks_x0), ("small_file", small_file_bucket),
            ("serving_single", serving_single), ("packed_x5", packed_x5),
            ("packed_x7", lambda dp, tp: packed_x5(dp, tp, int8_self=True)),
            ("options", options), ("speculative", speculative)],
    # world of 2: tensor parallel
    "tp2": [("chunks_x0", chunks_x0), ("packed_x5", packed_x5),
            ("packed_off", packed_off), ("int8_weights", int8_weights),
            ("w8a8", w8a8_encoder), ("fused", fused), ("options", options),
            ("speculative", speculative)],
    # world of 4: dp 2 x tp 2
    "dp2tp2": [("chunks_x0", chunks_x0), ("packed_x5", packed_x5),
               ("small_file", small_file_bucket)],
}
SHAPES = {"dp2": (2, 1), "tp2": (1, 2), "dp2tp2": (2, 2)}
CLI_SCENARIOS = ("dp2", "dp2tp2")


def main():
    world, rank, port, scenario, out_dir = sys.argv[1:6]
    rank = int(rank)
    torch.set_num_threads(1)
    if os.environ.get("WORKER_SENTINELS") == "1":
        # the CLI's sentinels: the world size and the rank from the
        # environment, as torchrun sets them
        os.environ.update(WORLD_SIZE=world, RANK=str(rank))
        pm.init_distributed(f"127.0.0.1:{port}", 0, -1, backend="gloo",
                            timeout_s=120)
    else:
        pm.init_distributed(f"127.0.0.1:{port}", int(world), rank,
                            backend="gloo", timeout_s=120)
    dp, tp = SHAPES[scenario]
    results, times = {}, {}
    try:
        for name, fn in SCENARIOS[scenario]:
            t0 = time.perf_counter()
            results[name] = fn(dp, tp)
            times[name] = time.perf_counter() - t0
        if scenario in CLI_SCENARIOS:
            results["cli"] = cli_run(dp, tp, out_dir, rank)
    except Exception:  # reported to the test, which fails on it
        results["error"] = traceback.format_exc()
    results["seconds"] = times
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(results, f)
    torch.distributed.destroy_process_group()
    return 1 if "error" in results else 0


if __name__ == "__main__":
    sys.exit(main())
