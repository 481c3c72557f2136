"""Int8 weight quantization (port of ``whisper_tpu.variants.quant``).

Scope as in the JAX package: only the block matmul weights (attention
q/k/v/o, cross-attention, MLP fc1/fc2) and the tied-embedding OUTPUT
projection (``tok_emb_q``, [d, V] with per-vocab-column scales) are
quantized; convolutions, the embedding lookup and LayerNorms stay float.
Storage is per-output-channel symmetric int8 with a float32 scale.  The
functions work on the numpy parameter tree of ``models.convert``
(``init_params``), so the port and the JAX package quantize the same
arrays with the same arithmetic (``np.rint``: round half to even).

``int8_matmul`` is the W8A8 product of rung x6 (torch tensors): an
int8 x int8 matrix product accumulated exactly in int32.
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


def int8_matmul(xq, wq):
    """xq [..., K] int8 @ wq [K, N] int8 -> [..., N] int32, every sum exact
    (the JAX package's ``dot_general`` with ``preferred_element_type=int32``;
    a plain library product, outside any kernel, as there).

    On a CUDA tensor this is ``torch._int_mm`` (int8 tensor cores, int32
    accumulators), which wants more than 16 rows and K and N multiples of
    8: short inputs are padded with zero rows.  On a CPU tensor it is a
    float64 product, which holds every partial sum exactly (127^2 * K is
    far below 2^53) and runs through BLAS, cast to int32.  An fp32 product
    would be exact only while 127^2 * K < 2^24, that is K <= 1,040."""
    import torch

    lead, k = xq.shape[:-1], xq.shape[-1]
    x2 = xq.reshape(-1, k)
    if xq.device.type == "cpu":
        acc = torch.matmul(x2.double(), wq.double()).to(torch.int32)
    else:
        if k % 8 or wq.shape[1] % 8:
            raise ValueError(f"int8_matmul on the card needs K={k} and "
                             f"N={wq.shape[1]} to be multiples of 8")
        m = x2.shape[0]
        if m <= 16:
            x2 = torch.nn.functional.pad(x2, (0, 0, 0, 17 - m))
        acc = torch._int_mm(x2.contiguous(), wq)[:m]
    return acc.reshape(*lead, wq.shape[1])
