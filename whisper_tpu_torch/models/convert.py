"""Parameter initialization and conversion (port of
``whisper_tpu.models.convert``).

``init_params`` builds the stacked-layer parameter tree in numpy from
``default_rng(seed)``, leaf for leaf identical to the JAX package's, so
that both packages start from the same weights.  ``params_from_numpy``
turns such a tree (numpy arrays, or the JAX package's tree with its
arrays read back as numpy; ``QTensor`` pairs included) into the port's
torch tree with ``cast_params`` semantics: float leaves cast to the
compute dtype, int8 ``q`` and fp32 ``s`` kept.
"""

from __future__ import annotations

from typing import Dict

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
