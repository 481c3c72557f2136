"""Int8 weight quantization (port of ``whisper_tpu.variants.quant``).

Scope as in the JAX package: only the block matmul weights (attention
q/k/v/o, cross-attention, MLP fc1/fc2) and the tied-embedding OUTPUT
projection (``tok_emb_q``, [d, V] with per-vocab-column scales) are
quantized; convolutions, the embedding lookup and LayerNorms stay float.
Storage is per-output-channel symmetric int8 with a float32 scale.  The
functions work on the numpy parameter tree of ``models.convert``
(``init_params``), so the port and the JAX package quantize the same
arrays with the same arithmetic (``np.rint``: round half to even).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import numpy as np


class QTensor(NamedTuple):
    """Per-output-channel symmetric int8 weight: w ~ q * s.

    q: int8, same shape as the weight [..., in, out]
    s: float32 scale [..., 1, out] (broadcasts over the in axis)
    """

    q: Any
    s: Any


QUANTIZABLE = {
    "q_w", "k_w", "v_w", "o_w",
    "xq_w", "xk_w", "xv_w", "xo_w",
    "fc1_w", "fc2_w",
}


def quantize_tensor(w) -> QTensor:
    """Symmetric per-output-channel (last axis) int8 quantization."""
    w = np.asarray(w, dtype=np.float32)
    absmax = np.max(np.abs(w), axis=-2, keepdims=True)  # [..., 1, out]
    scale = np.maximum(absmax, 1e-12) / 127.0
    q = np.clip(np.rint(w / scale), -127, 127).astype(np.int8)
    return QTensor(q=q, s=scale.astype(np.float32))


def quantize_params(params: Dict) -> Dict:
    """Quantize every eligible block weight and add the decoder's
    ``tok_emb_q`` (the bf16/fp32 ``tok_emb`` stays for the lookup)."""

    def walk(node, in_blocks=False):
        if isinstance(node, dict):
            return {
                k: (quantize_tensor(v)
                    if in_blocks and k in QUANTIZABLE
                    and not isinstance(v, QTensor)
                    else walk(v, in_blocks or k == "blocks"))
                for k, v in node.items()
            }
        return node

    out = walk(params)
    dec = out.get("decoder")
    if isinstance(dec, dict) and "tok_emb" in dec and "tok_emb_q" not in dec:
        dec["tok_emb_q"] = quantize_tensor(np.asarray(dec["tok_emb"]).T)
    return out


def is_quantized(params: Dict) -> bool:
    if isinstance(params, QTensor):
        return True
    if isinstance(params, dict):
        return any(is_quantized(v) for v in params.values())
    return False
