"""Parameter initialization and conversion (port of
``whisper_tpu.models.convert``).

``init_params`` builds the stacked-layer parameter tree in numpy from
``default_rng(seed)``, leaf for leaf identical to the JAX package's, so
that both packages start from the same weights.  ``load_params`` reads a
model dir written by the JAX package's ``save_params`` (``params.safetensors``
with stacked [L, ...] leaves and ``QTensor`` q8/scale pairs, plus
``config.json``) with numpy alone: the card's machine has no
``safetensors`` package.  ``params_from_numpy``
turns such a tree (numpy arrays, or the JAX package's tree with its
arrays read back as numpy; ``QTensor`` pairs included) into the port's
torch tree with ``cast_params`` semantics: float leaves cast to the
compute dtype, int8 ``q`` and fp32 ``s`` kept.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Tuple

import numpy as np
import torch

from whisper_tpu_torch.models.registry import WhisperDims
from whisper_tpu_torch.models.whisper import sinusoid_position_embedding
from whisper_tpu_torch.variants.quant import QTensor


def init_params(dims: WhisperDims, seed: int = 0) -> Dict:
    """Random-init float32 numpy params with the exact tree structure of a
    converted checkpoint (small scale keeps fp32 greedy well-behaved)."""
    rng = np.random.default_rng(seed)
    d, f = dims.d_model, dims.d_ffn

    def w(*shape, scale=0.02):
        return rng.normal(0.0, scale, size=shape).astype(np.float32)

    def zeros(*shape):
        return np.zeros(shape, dtype=np.float32)

    def ones(*shape):
        return np.ones(shape, dtype=np.float32)

    def attn(le, prefix=""):
        return {
            f"{prefix}q_w": w(le, d, d), f"{prefix}q_b": zeros(le, d),
            f"{prefix}k_w": w(le, d, d),
            f"{prefix}v_w": w(le, d, d), f"{prefix}v_b": zeros(le, d),
            f"{prefix}o_w": w(le, d, d), f"{prefix}o_b": zeros(le, d),
        }

    le, ld = dims.encoder_layers, dims.decoder_layers
    enc_blocks = {
        "attn_ln_s": ones(le, d), "attn_ln_b": zeros(le, d),
        **attn(le),
        "mlp_ln_s": ones(le, d), "mlp_ln_b": zeros(le, d),
        "fc1_w": w(le, d, f), "fc1_b": zeros(le, f),
        "fc2_w": w(le, f, d), "fc2_b": zeros(le, d),
    }
    dec_blocks = {
        "ln_s": ones(ld, d), "ln_b": zeros(ld, d),
        **attn(ld),
        "x_ln_s": ones(ld, d), "x_ln_b": zeros(ld, d),
        "xq_w": w(ld, d, d), "xq_b": zeros(ld, d),
        "xk_w": w(ld, d, d),
        "xv_w": w(ld, d, d), "xv_b": zeros(ld, d),
        "xo_w": w(ld, d, d), "xo_b": zeros(ld, d),
        "mlp_ln_s": ones(ld, d), "mlp_ln_b": zeros(ld, d),
        "fc1_w": w(ld, d, f), "fc1_b": zeros(ld, f),
        "fc2_w": w(ld, f, d), "fc2_b": zeros(ld, d),
    }
    return {
        "encoder": {
            "conv1_w": w(3, dims.n_mels, d), "conv1_b": zeros(d),
            "conv2_w": w(3, d, d), "conv2_b": zeros(d),
            "pos_embed": sinusoid_position_embedding(
                dims.max_source_positions, d),
            "blocks": enc_blocks,
            "ln_f_s": ones(d), "ln_f_b": zeros(d),
        },
        "decoder": {
            "tok_emb": w(dims.vocab_size, d),
            "pos_embed": w(dims.max_target_positions, d),
            "blocks": dec_blocks,
            "ln_f_s": ones(d), "ln_f_b": zeros(d),
        },
    }


PARAMS_FILE = "params.safetensors"
CONFIG_FILE = "config.json"

# safetensors dtype tags -> numpy dtypes (BF16 is widened to float32 below)
_ST_DTYPES = {"F64": "<f8", "F32": "<f4", "F16": "<f2", "I64": "<i8",
              "I32": "<i4", "I16": "<i2", "I8": "i1", "U8": "u1",
              "BOOL": "?"}


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """{name: array} of a safetensors file, read with numpy: an 8-byte
    little-endian header length, a JSON header of dtype, shape and data
    offsets, then the raw little-endian bytes.  BF16 tensors come back as
    float32 (exact)."""
    raw = np.memmap(path, dtype=np.uint8, mode="r")
    (n,) = struct.unpack("<Q", bytes(raw[:8]))
    header = json.loads(bytes(raw[8:8 + n]))
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        start, end = info["data_offsets"]
        buf = raw[base + start: base + end]
        if info["dtype"] == "BF16":
            arr = (buf.view("<u2").astype(np.uint32) << 16).view(np.float32)
        else:
            arr = buf.view(_ST_DTYPES[info["dtype"]]).copy()
        out[name] = arr.reshape(info["shape"])
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict:
    """'/'-joined keys -> nested dict; ``<key>.q8``/``<key>.scale`` pairs ->
    ``QTensor`` (the JAX package's ``_flatten`` inverted)."""
    out: Dict = {}
    pending_q: Dict[str, Dict[str, np.ndarray]] = {}
    for key, v in flat.items():
        if key.endswith(".q8") or key.endswith(".scale"):
            base, _, kind = key.rpartition(".")
            pending_q.setdefault(base, {})[kind] = v
            continue
        parts = key.split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    for base, parts_q in pending_q.items():
        parts = base.split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = QTensor(q=parts_q["q8"], s=parts_q["scale"])
    return out


def load_params(model_dir: str) -> Tuple[Dict, WhisperDims]:
    """(numpy parameter tree, dims) of a model dir in the JAX package's
    ``save_params`` format."""
    flat = read_safetensors(os.path.join(model_dir, PARAMS_FILE))
    with open(os.path.join(model_dir, CONFIG_FILE)) as f:
        cfg = json.load(f)
    return _unflatten(flat), WhisperDims(**cfg["whisper_tpu_dims"])


def params_from_numpy(tree, device, dtype: torch.dtype) -> Dict:
    """numpy (or array-like) tree -> torch tree on ``device``: float leaves
    cast to ``dtype``; any pair with ``q``/``s`` fields (this package's or
    the JAX package's ``QTensor``) becomes a ``QTensor`` of int8 ``q`` and
    fp32 ``s``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype)
                for k, v in tree.items()}
    if hasattr(tree, "q") and hasattr(tree, "s"):
        return QTensor(
            q=torch.from_numpy(np.array(tree.q, dtype=np.int8)).to(device),
            s=torch.from_numpy(np.array(tree.s, dtype=np.float32)).to(device))
    arr = np.array(tree, dtype=np.float32)  # a writable copy
    return torch.from_numpy(arr).to(device=device, dtype=dtype)
