"""Optimization-variant ladder (port of ``whisper_tpu.variants.ladder``).

The same rungs and flags as the JAX package, read by the port as:

  x0   fp32, no TF32                       - strict token parity
  x1   fp32 storage ('high' runs as full fp32, see RuntimeCfg)
  x2   bf16
  x3   bf16 + kernels B1 (encoder attention) and B2 (encoder MLP); the
       fused front end (B5) is not ported, so only the streamed long-form
       mel runs (a one-shot file raises)
  x4   x3 + int8 weights + int8 cross-KV with the in-kernel dequantizing
       decode step (B6): raises until B6 is ported
  x5   x4 + int8 x int8 decode attention: kernels B3 and B4 (the slice)
  x6   x5 + W8A8 encoder: raises (not ported)
  x7   x5 + int8 self cache (B8): raises (not ported)

``int8`` is an alias of x4, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
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
    "x3": VariantSpec("x3", "bf16 + fused encoder attention and MLP "
                      "kernels (B1, B2)", "bfloat16", "default", **_FUSED),
    "x4": VariantSpec("x4", "x3 + int8 weights + int8 cross-KV (B6)",
                      "bfloat16", "default", **_INT8),
    "x5": VariantSpec("x5", "x4 + int8 x int8 decode attention (B3, B4)",
                      "bfloat16", "default", int8_mxu_attn=True, **_INT8),
    "x6": VariantSpec("x6", "x5 + W8A8 encoder QKV/O", "bfloat16",
                      "default", int8_mxu_attn=True, int8_encoder_act=True,
                      **_INT8),
    "x7": VariantSpec("x7", "x5 + int8 self cache (B8)", "bfloat16",
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
