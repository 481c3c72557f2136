"""Config autotuner (port of ``whisper_tpu.bench.discover``): produces the
``--discovery-best-json`` artifact.

The reference consumes a tuned "best" config from a discovery JSON
(``{"best": {...}}``, ref src/main.rs:124-167) but ships no tuner.  This
tool sweeps the variant ladder (and optionally batch caps) against a real
or synthetic workload through ``pipeline.longform.transcribe_longform``,
measures end-to-end seconds per run after a warm-up, and writes the winning
``RuntimeCfg`` in the discovery schema (``best``, ``metric``, ``value``,
``sweep``), ready for ``python -m whisper_tpu_torch.bench
--discovery-best-json best.json`` (and readable by the JAX package's CLI:
the same keys).  Every cfg starts from ``suggested_cfg()``, so the written
config keeps its ``intra_op`` (the CLI's prefetch thread).

It runs on the first CUDA card, or on the CPU when asked (``main(argv,
device="cpu")`` or ``WHISPER_TPU_TORCH_DEVICE=cpu``); without a card and
unasked it exits non-zero.  What the pick is worth on the card: each run is
a host-bound decode loop (PERF.md §5), and e2e spreads widely from call to
call (PERF.md §7), so the fastest of a few runs per config separates
variants only where they differ by more than that spread.

Run: python -m whisper_tpu_torch.bench.discover [--audio FILE |
         --synthetic-s 60] [--model-id ID | --model-dir DIR]
         [--variants x2,x4,x5,x7] [--max-batches 8,16] [--out best.json]
         [--runs 3]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import List

import numpy as np


def _synthetic_audio(seconds: float) -> np.ndarray:
    rng = np.random.default_rng(0)
    t = np.arange(int(seconds * 16000)) / 16000.0
    x = 0.3 * np.sin(2 * np.pi * 220 * t) + 0.04 * rng.standard_normal(len(t))
    return x.astype(np.float32)


def sweep(params, dims, audio, variants: List[str], max_batches: List[int],
          max_new_tokens: int, runs: int, verbose=print, *,
          device=None) -> List[dict]:
    """Each (variant, max_batch): a session on ``device`` (resolved as the
    CLI does), a warm-up run, then the fastest of ``runs`` timed runs;
    the results sorted fastest first."""
    from whisper_tpu_torch.pipeline.longform import transcribe_longform
    from whisper_tpu_torch.runtime.session import (
        WhisperSession,
        suggested_cfg,
    )
    from whisper_tpu_torch.utils.device import resolve_device
    from whisper_tpu_torch.variants.ladder import apply_variant

    device = resolve_device(device)
    results = []
    for variant in variants:
        for mb in max_batches:
            base = dataclasses.replace(suggested_cfg(), max_batch=mb)
            cfg, _ = apply_variant(base, variant)
            session = WhisperSession(params, dims, cfg, device=device)
            transcribe_longform(session, audio, "en", "transcribe",
                                max_new_tokens)  # warm-up: kernels, caches
            times = []
            for _ in range(runs):
                t0 = time.perf_counter()
                transcribe_longform(session, audio, "en", "transcribe",
                                    max_new_tokens)
                times.append(time.perf_counter() - t0)
            best = min(times)
            verbose(f"  variant={variant} max_batch={mb}: {best:.3f}s")
            results.append({
                "variant": variant, "max_batch": mb,
                "e2e_s": best, "cfg": dataclasses.asdict(cfg),
            })
            del session
    return sorted(results, key=lambda r: r["e2e_s"])


def main(argv=None, *, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--audio", default="", help="wav file to tune against")
    ap.add_argument("--synthetic-s", type=float, default=60.0,
                    help="synthetic audio length when --audio is not given")
    ap.add_argument("--model-id", default="openai/whisper-base")
    ap.add_argument("--model-dir", default="")
    ap.add_argument("--variants", default="x2,x4,x5,x7")
    ap.add_argument("--max-batches", default="16")
    ap.add_argument("--max-new-tokens", type=int, default=128)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--out", default="discovery_best.json")
    args = ap.parse_args(argv)

    from whisper_tpu_torch.models import convert
    from whisper_tpu_torch.models.registry import get_dims
    from whisper_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    if args.model_dir:
        params, dims = convert.load_params(args.model_dir)
    else:
        dims = get_dims(args.model_id)
        params = convert.init_params(dims, seed=0)

    if args.audio:
        from whisper_tpu_torch.audio.io import load_audio_16k_mono

        audio, _, _ = load_audio_16k_mono(args.audio)
    else:
        audio = _synthetic_audio(args.synthetic_s)

    variants = [v for v in args.variants.split(",") if v]
    max_batches = [int(b) for b in args.max_batches.split(",") if b]
    print(f"Sweeping {len(variants) * len(max_batches)} configs "
          f"({len(audio)/16000:.0f}s audio, {args.runs} runs each)...")
    results = sweep(params, dims, audio, variants, max_batches,
                    args.max_new_tokens, args.runs, device=device)

    best = results[0]
    out = {
        "best": best["cfg"],
        "metric": "end_to_end_s",
        "value": best["e2e_s"],
        "sweep": [
            {k: r[k] for k in ("variant", "max_batch", "e2e_s")}
            for r in results
        ],
    }
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print(f"Best: variant={best['variant']} max_batch={best['max_batch']} "
          f"({best['e2e_s']:.3f}s) -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
