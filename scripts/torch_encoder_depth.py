"""How far the port's bf16 encoder lies from an fp32 evaluation of the
same weights, by depth, on the CPU:

    python scripts/torch_encoder_depth.py [--model-id openai/whisper-large-v3-turbo]
        [--layers 6,32] [--seed 0]

For each layer count, the model's encoder cut to that many layers (its
widths as the registry gives them; random weights from ``--seed``) runs one
30 s chunk of a seeded mel at rung x5 (bf16, int8 weights, the kernels'
plain versions) and at x5 with dtype float32 (the same int8 weights, fp32
arithmetic); prints the largest difference in bf16 steps (2^-7 relative
of the larger magnitude, the mean magnitude as the floor near zero: the
measure of ``chip_smoke.py``'s card-against-CPU check) and its 99.99th
percentile.  ``chip_smoke.py`` scales its encoder bound by the ratio of
these distances between depths.  Imports only the port; at whisper-large
width it needs ~8 GB of host memory and ~30 s of an 8-core CPU a depth.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def bf16_steps(got: np.ndarray, want: np.ndarray) -> tuple:
    """(largest, 99.99th percentile) of |got - want| in bf16 steps."""
    scale = np.maximum(np.maximum(np.abs(got), np.abs(want)),
                       np.abs(want).mean())
    err = np.abs(got - want) / (scale * 2.0 ** -7)
    return float(err.max()), float(np.percentile(err, 99.99))


def main(argv=None) -> None:
    import torch

    from whisper_tpu_torch.models.convert import init_params
    from whisper_tpu_torch.models.registry import get_dims
    from whisper_tpu_torch.pipeline.chunk import CHUNK_FRAMES
    from whisper_tpu_torch.runtime.session import RuntimeCfg, WhisperSession
    from whisper_tpu_torch.variants.ladder import apply_variant

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model-id", default="openai/whisper-large-v3-turbo")
    ap.add_argument("--layers", default="6,32")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    cfg, _ = apply_variant(RuntimeCfg(), "x5")
    full = get_dims(args.model_id)
    for n_layers in (int(x) for x in args.layers.split(",")):
        # the decoder cut to one layer and a small vocabulary: only the
        # encoder runs
        dims = dataclasses.replace(full, encoder_layers=n_layers,
                                   decoder_layers=1, vocab_size=1000)
        params = init_params(dims, seed=args.seed)
        mel = np.random.default_rng(1).normal(
            0, 0.5, (1, dims.n_mels, CHUNK_FRAMES)).astype(np.float32)
        out = {}
        for dtype in ("bfloat16", "float32"):
            session = WhisperSession(params, dims, dataclasses.replace(
                cfg, dtype=dtype), device="cpu")
            t0 = time.perf_counter()
            out[dtype] = session.encoder(torch.from_numpy(mel)).float().numpy()
            out[dtype + " s"] = time.perf_counter() - t0
            del session
        worst, p9999 = bf16_steps(out["bfloat16"], out["float32"])
        print(f"{args.model_id} encoder at {n_layers} layers (d = "
              f"{dims.d_model}, {dims.encoder_heads} heads, {dims.n_mels} "
              f"mels): bf16 against fp32 {worst:.2f} bf16 steps at most, "
              f"{p9999:.2f} at the 99.99th percentile; the bf16 encoder "
              f"{out['bfloat16 s']:.1f} s on the CPU", flush=True)


if __name__ == "__main__":
    main()
