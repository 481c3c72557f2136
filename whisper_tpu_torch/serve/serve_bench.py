"""Serving-path benchmark: N concurrent short streams through the
continuous-batching engine (port of ``scripts/serve_bench.py``;
BASELINE.json config 5).

Measures the aggregate real-time factor (total audio seconds / wall
seconds) and per-request latency percentiles for a burst of N streams of
S seconds each, submitted from worker threads like independent clients.
Weights are random (``init_params(seed=0)``), the streams synthetic tones
with noise from seed 0, as in the JAX script; ``chip_smoke.py`` calls
``run_bench``.

Usage: python -m whisper_tpu_torch.serve.serve_bench [--streams 64]
       [--seconds 30] [--variant x5] [--model-id openai/whisper-base]
       [--reps 3]

It runs on the first CUDA card and exits non-zero without one
(``WHISPER_TPU_TORCH_DEVICE=cpu`` runs the plain versions on the CPU).
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import time
from typing import List

import numpy as np

SAMPLE_RATE = 16_000


def make_streams(n: int, seconds: float) -> List[np.ndarray]:
    """n float32 clips of `seconds`: a tone of 150 + 10 i Hz plus noise."""
    rng = np.random.default_rng(0)
    n_samp = int(seconds * SAMPLE_RATE)
    t = np.arange(n_samp) / float(SAMPLE_RATE)
    return [(0.1 * np.sin(2 * np.pi * (150 + 10 * i) * t)
             + 0.03 * rng.standard_normal(n_samp)).astype(np.float32)
            for i in range(n)]


def percentile(sorted_lat: List[float], q: float) -> float:
    """The JAX script's nearest-rank percentile of a sorted list."""
    return sorted_lat[min(len(sorted_lat) - 1, int(q * len(sorted_lat)))]


def run_bench(engine, streams: List[np.ndarray], reps: int = 3,
              timeout: float = 600.0) -> List[dict]:
    """Submit every stream at once from its own thread, `reps` times; per
    rep the wall seconds, the aggregate x real time, each request's p50,
    p95 and largest latency in seconds, and the engine's ticks so far.  A
    request that fails raises here."""
    total_audio = sum(len(a) for a in streams) / float(SAMPLE_RATE)

    def one(audio):
        t = time.perf_counter()
        engine.transcribe(audio, timeout=timeout)
        return time.perf_counter() - t

    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        with cf.ThreadPoolExecutor(len(streams)) as ex:
            lat = sorted(ex.map(one, streams))
        wall = time.perf_counter() - t0
        out.append({"wall_s": wall, "x_real_time": total_audio / wall,
                    "p50_s": percentile(lat, 0.5),
                    "p95_s": percentile(lat, 0.95), "max_s": lat[-1],
                    "ticks": engine.stats["batches"]})
    return out


def main(argv=None, *, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--streams", type=int, default=64)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--variant", default="x5")
    ap.add_argument("--model-id", default="openai/whisper-base")
    ap.add_argument("--max-new-tokens", type=int, default=128)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--draft-model-id", default="",
                    help="attach a random-init draft of this registry id: "
                         "the engine's ticks then take the speculative leg")
    ap.add_argument("--draft-share-encoder", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from whisper_tpu_torch.models.convert import init_params
    from whisper_tpu_torch.models.registry import get_dims
    from whisper_tpu_torch.runtime.session import RuntimeCfg, WhisperSession
    from whisper_tpu_torch.serve.engine import EngineConfig, StreamingEngine
    from whisper_tpu_torch.utils.device import resolve_device
    from whisper_tpu_torch.variants.ladder import apply_variant

    device = resolve_device(device)
    dims = get_dims(args.model_id)
    cfg, _ = apply_variant(RuntimeCfg(), args.variant)
    session = WhisperSession(init_params(dims, seed=0), dims, cfg,
                             device=device)
    if args.draft_model_id:
        d_dims = get_dims(args.draft_model_id)
        session.set_draft_model(init_params(d_dims, seed=1), d_dims,
                                share_encoder=args.draft_share_encoder)
    eng = StreamingEngine(session, cfg=EngineConfig(
        max_new_tokens=args.max_new_tokens, batch_window_ms=20))
    try:
        streams = make_streams(args.streams, args.seconds)
        where = (f"CUDA card {torch.cuda.get_device_name(device)}"
                 if device.type == "cuda" else "the CPU")
        print(f"warmup on {where} (every short bucket)...", flush=True)
        t0 = time.perf_counter()
        eng.warmup()
        print(f"warmup done in {time.perf_counter() - t0:.1f}s", flush=True)
        for rep, r in enumerate(run_bench(eng, streams, args.reps)):
            print(f"rep{rep}: wall {r['wall_s']:.2f}s -> "
                  f"{r['x_real_time']:.0f}x aggregate | latency p50 "
                  f"{r['p50_s']:.2f}s p95 {r['p95_s']:.2f}s max "
                  f"{r['max_s']:.2f}s | ticks {r['ticks']}", flush=True)
    finally:
        eng.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
