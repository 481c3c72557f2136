"""Optimization-variant ladder (port of ``whisper_tpu.variants.ladder``).

The same rungs and flags as the JAX package, read by the port as:

  x0   fp32, no TF32                       - strict token parity
  x1   fp32 storage ('high' runs as full fp32, see RuntimeCfg)
  x2   bf16
  x3   bf16 + kernels B1 (encoder attention), B2 (encoder MLP) and B5
       (the one-shot front end, files of at most mel_slab_frames frames;
       longer files take the streamed slab mel, as in JAX)
  x4   x3 + int8 weights + int8 cross-KV: the decode step runs kernels B3
       and B6 (the int8 cross cache dequantized in the kernel)
  x5   x4 + int8 x int8 decode attention: kernels B3 and B4
  x6   x5 + W8A8 encoder: QKV/O of every encoder block as an exact
       int8 x int8 product with per-row activation scales (the MLP half
       stays on B2)
  x7   x5 + int8 self cache with per-row scales: the decode step runs
       kernels B8 and B4

Off the ladder, through ``RuntimeCfg`` or a discovery JSON:
``fused_encoder_block`` (kernels B9a, B1, B9b; B2 at d >= 1024) and
``fused_decoder_step`` (the hybrid step with kernel B10c).

``int8`` is an alias of x4, as in the JAX package.
``write_variant_metadata`` writes a model dir's
``optimization_metadata.json`` with the JAX package's keys.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import asdict, dataclass
from typing import Dict

from whisper_tpu_torch.runtime.session import RuntimeCfg


@dataclass(frozen=True)
class VariantSpec:
    name: str
    description: str
    dtype: str
    matmul_precision: str
    fused_frontend: bool = False
    fused_attention: bool = False
    int8_weights: bool = False
    int8_kv_cache: bool = False
    packed_cross_kv: bool = False
    int8_mxu_attn: bool = False
    int8_self_kv: bool = False
    int8_encoder_act: bool = False
    fused_encoder_mlp: bool = False
    fused_encoder_block: bool = False
    fused_decoder_step: bool = False
    audio_transfer: str = "int16"


_FUSED = dict(fused_frontend=True, fused_attention=True,
              fused_encoder_mlp=True)
_INT8 = dict(_FUSED, int8_weights=True, int8_kv_cache=True,
             packed_cross_kv=True)

LADDER: Dict[str, VariantSpec] = {
    "x0": VariantSpec("x0", "fp32 strict parity", "float32", "highest",
                      audio_transfer="float32"),
    "x1": VariantSpec("x1", "fp32 storage, HIGH matmul precision",
                      "float32", "high", audio_transfer="float32"),
    "x2": VariantSpec("x2", "bf16 serving precision", "bfloat16", "default"),
    "x3": VariantSpec("x3", "bf16 + fused front end, encoder attention "
                      "and MLP kernels (B5, B1, B2)", "bfloat16", "default",
                      **_FUSED),
    "x4": VariantSpec("x4", "x3 + int8 weights + int8 cross-KV, "
                      "dequantized in the decode kernel (B3, B6)",
                      "bfloat16", "default", **_INT8),
    "x5": VariantSpec("x5", "x4 + int8 x int8 decode attention (B3, B4)",
                      "bfloat16", "default", int8_mxu_attn=True, **_INT8),
    "x6": VariantSpec("x6", "x5 + W8A8 encoder QKV/O (exact int8 x int8 "
                      "products)", "bfloat16",
                      "default", int8_mxu_attn=True, int8_encoder_act=True,
                      **_INT8),
    "x7": VariantSpec("x7", "x5 + int8 self cache with per-row scales "
                      "(B8, B4)", "bfloat16",
                      "default", int8_mxu_attn=True, int8_self_kv=True,
                      **_INT8),
}
LADDER["int8"] = LADDER["x4"]


def apply_variant(cfg: RuntimeCfg, name: str) -> tuple[RuntimeCfg, VariantSpec]:
    """Return a copy of `cfg` with the variant's flags applied."""
    try:
        spec = LADDER[name]
    except KeyError:
        raise KeyError(f"Unknown variant {name!r}; known: {sorted(LADDER)}")
    flags = {f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)
             if f.name not in ("name", "description")}
    return dataclasses.replace(cfg, **flags), spec


def write_variant_metadata(model_dir: str, spec: VariantSpec,
                           base_model_id: str) -> None:
    """``optimization_metadata.json`` beside a model dir's weights (the
    reference's optimization_metadata.json convention): the JAX package's
    keys, with ``"framework"`` naming this package."""
    meta = {
        "variant": spec.name,
        "description": spec.description,
        **asdict(spec),
        "base_model_id": base_model_id,
        "framework": "whisper_tpu_torch",
    }
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "optimization_metadata.json"), "w") as f:
        json.dump(meta, f, indent=2)
