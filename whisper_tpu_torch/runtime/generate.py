"""Greedy generation with a static-shape KV cache (port of
``whisper_tpu.runtime.generate``).

Semantics are the JAX package's (and the reference's, src/main.rs:753-829):

- the prefill over the full prompt gives the first token, with
  suppression = base + begin_suppress;
- each later step uses the base suppression only;
- generation stops at EOT or after ``max_new_tokens``; rows that finish
  early keep emitting EOT, and the loop exits once every row is done;
- suppression is an additive ``-inf`` mask before argmax; ``torch.argmax``
  picks the first index on ties, like ``jnp.argmax``.

The JAX ``lax.while_loop`` becomes a Python loop.  The early exit reads
``done`` on the host once per step; a CUDA graph of the step is later work.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from whisper_tpu_torch.models import whisper
from whisper_tpu_torch.models.registry import WhisperDims


def build_suppress_mask(vocab_size: int, ids: Sequence[int] | None) -> np.ndarray:
    """Additive float32 mask [V]: 0 everywhere, -inf at suppressed ids."""
    mask = np.zeros(vocab_size, dtype=np.float32)
    if ids:
        idx = np.asarray([i for i in ids if 0 <= i < vocab_size], dtype=np.int64)
        mask[idx] = -np.inf
    return mask


def greedy_generate(params, dims: WhisperDims, enc_states: torch.Tensor,
                    prompt: torch.Tensor, suppress_mask: torch.Tensor,
                    first_suppress_mask: torch.Tensor, max_new_tokens: int,
                    eot_id: int, *, int8_cross_kv: bool = False,
                    kernel_step: bool = False) -> torch.Tensor:
    """Generated tokens [B, max_new_tokens] (prompt excluded), rows that
    finished early padded with EOT.  prompt: [P] ids shared by every row;
    masks: [V] fp32 additive.  kernel_step (x5) runs the decode step
    through kernels B3/B4 against the int8 cross cache."""
    if kernel_step and not int8_cross_kv:
        raise ValueError("kernel_step needs the int8 cross cache")
    b = enc_states.shape[0]
    p = prompt.shape[0]
    dev = enc_states.device
    tokens = prompt.to(device=dev, dtype=torch.long)[None, :].expand(b, p)
    logits, cache = whisper.decoder_prefill(
        params, dims, tokens, enc_states, p + max_new_tokens,
        int8_cross_kv=int8_cross_kv)
    first = torch.argmax(logits[:, -1, :].float() + first_suppress_mask, -1)

    buf = torch.full((b, max_new_tokens), eot_id, dtype=torch.long,
                     device=dev)
    buf[:, 0] = first
    done = first == eot_id
    last = first
    cross_len = enc_states.shape[1]
    for i in range(1, max_new_tokens):
        if bool(done.all()):
            break
        # `last` was generated as token index p+i-1 of the full sequence.
        step_logits, cache = whisper.decoder_step(
            params, dims, last, p + i - 1, cache, kernel_step=kernel_step,
            cross_len=cross_len)
        nxt = torch.argmax(step_logits.float() + suppress_mask, dim=-1)
        nxt = torch.where(done, eot_id, nxt)
        buf[:, i] = nxt
        done = done | (nxt == eot_id)
        last = nxt
    return buf


def strip_generated(row: np.ndarray, eot_id: int) -> list[int]:
    """Cut a generated row at the first EOT (exclusive), like the
    reference's strip of the trailing EOT (src/main.rs:926-943)."""
    out = []
    for t in row.tolist():
        if t == eot_id:
            break
        out.append(int(t))
    return out
