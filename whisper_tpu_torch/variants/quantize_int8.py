"""Offline int8 model-dir quantizer (port of
``whisper_tpu.variants.quantize_int8``, the mirror of the reference's
quantize_onnx_int8.py).

Reads a model dir, quantizes the matmul weights to per-channel int8
(``variants.quant.quantize_params``, numpy, the JAX package's arithmetic)
and writes ``<model_dir>-int8/`` (or ``--out-dir``) with the params, their
config and ``optimization_metadata.json``, copying the tokenizer.json and
generation_config.json sidecars.  Host-only numpy: it touches no device
and needs neither jax nor the ``safetensors`` package.  The int8 dir is
what ``--variant int8`` (x4) loads.

Run: python -m whisper_tpu_torch.variants.quantize_int8 --model-dir DIR
         [--out-dir DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys


def quantize_model_dir(model_dir: str, out_dir: str | None = None) -> str:
    """Write the int8 copy of ``model_dir``; returns its path."""
    from whisper_tpu_torch.models import convert
    from whisper_tpu_torch.variants.ladder import (
        LADDER,
        write_variant_metadata,
    )
    from whisper_tpu_torch.variants.quant import quantize_params

    out_dir = out_dir or model_dir.rstrip("/") + "-int8"
    params, dims = convert.load_params(model_dir)
    qparams = quantize_params(params)

    with open(os.path.join(model_dir, convert.CONFIG_FILE)) as f:
        src_cfg = json.load(f)
    convert.save_params(
        qparams, dims, out_dir,
        extra_config={
            "int8_weights": True,
            "model_id": src_cfg.get("model_id"),
            "source": model_dir,
        },
    )
    write_variant_metadata(out_dir, LADDER["int8"],
                           src_cfg.get("model_id") or model_dir)
    for sidecar in ("tokenizer.json", "generation_config.json"):
        src = os.path.join(model_dir, sidecar)
        if os.path.isfile(src):
            shutil.copy(src, os.path.join(out_dir, sidecar))
    return out_dir


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model-dir", required=True)
    p.add_argument("--out-dir", default="")
    args = p.parse_args(argv)
    out = quantize_model_dir(args.model_dir, args.out_dir or None)
    print(f"Quantized model written to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
