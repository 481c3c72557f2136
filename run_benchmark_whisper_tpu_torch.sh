#!/usr/bin/env bash
# One-shot bench of the PyTorch port on its CUDA card: the flags of
# run_benchmark_whisper_tpu.sh through python -m whisper_tpu_torch.bench
# (x5 by default: kernels B5, B1, B2, then B3 and B4 in the decode step).
# AUDIO_DIR / ONNX_DIR / VARIANT / MODEL_ID / ALLOW_RANDOM_INIT env
# override; output under results/benchmarks/whisper_tpu_torch_${VARIANT},
# the directories results.summarize's rows name.  Without a card it exits
# non-zero unless WHISPER_TPU_TORCH_DEVICE=cpu asks for the CPU.
set -euo pipefail
cd "$(dirname "$0")"

AUDIO_DIR=${AUDIO_DIR:-audio}
ONNX_DIR=${ONNX_DIR:-models/whisper-base}
VARIANT=${VARIANT:-x5}
OUT=results/benchmarks/whisper_tpu_torch_${VARIANT}

python -m whisper_tpu_torch.bench \
    --audio-dir "$AUDIO_DIR" \
    --onnx-dir "$ONNX_DIR" \
    --model-id "${MODEL_ID:-openai/whisper-base}" \
    ${ALLOW_RANDOM_INIT:+--allow-random-init} \
    --language en \
    --task transcribe \
    --max-new-tokens 128 \
    --variant "$VARIANT" \
    --warmup 1 \
    --write-txt \
    --out-csv "$OUT/inference_per_file.csv" \
    --out-json "$OUT/inference_per_file.json" \
    --out-summary-json "$OUT/inference_summary.json"
