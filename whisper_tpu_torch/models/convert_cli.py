"""Checkpoint converter CLI (port of ``whisper_tpu.models.convert_cli``,
the replacement for the reference's ONNX export step): converts a local HF
Whisper checkpoint dir into a model dir that both packages load.

Host-only numpy: it touches no device and needs neither jax nor the
``safetensors`` package (``models.convert.read_safetensors`` and
``write_safetensors``), so it runs on the card's machine as it is.

Run: python -m whisper_tpu_torch.models.convert_cli --hf-dir HF_CHECKPOINT \
         --out-dir MODEL_DIR [--model-id openai/whisper-base] [--int8]
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--hf-dir", required=True,
                   help="HF checkpoint dir (config.json + *.safetensors)")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--model-id", default="")
    p.add_argument("--int8", action="store_true",
                   help="also write an <out-dir>-int8 quantized copy")
    args = p.parse_args(argv)

    from whisper_tpu_torch.models.convert import convert_hf_model_dir

    convert_hf_model_dir(args.hf_dir, args.out_dir,
                         model_id=args.model_id or None)
    print(f"Converted {args.hf_dir} -> {args.out_dir}")
    if args.int8:
        from whisper_tpu_torch.variants.quantize_int8 import (
            quantize_model_dir,
        )

        out = quantize_model_dir(args.out_dir)
        print(f"Quantized copy -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
