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

Options, with the JAX semantics: ``ts_cfg`` applies the timestamp grammar
(``runtime.timestamps``) after the suppression mask at every step;
``temperature > 0`` samples ``argmax(logits / T + Gumbel)``, the
distribution ``jax.random.categorical`` draws from, with the draws from an
explicit ``torch.Generator`` on the logits' device; ``return_logprobs``
also returns each row's summed log-probability (``log_softmax`` of the
masked logits, before the division by T) and its token count.

The JAX ``lax.while_loop`` becomes a Python loop.  The early exit reads
``done`` on the host once per step, and nothing else does: the grammar, the
draws and the sums stay on the device, so a CUDA graph can later capture
the whole step.

Under a mesh (``parallel.mesh``) every rank runs this loop on its own rows
(``mesh=`` reaches the model's collectives): the model ranks of one data
rank hold the same rows, and their logits follow the same all-reduce, so
their ``done`` reads agree and they take the same number of steps, as the
collectives need; a data rank stops when its own rows end.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from whisper_tpu_torch.models import whisper
from whisper_tpu_torch.models.registry import WhisperDims
from whisper_tpu_torch.ops.decoder_kernels import decoder_step_hybrid


def build_suppress_mask(vocab_size: int, ids: Sequence[int] | None) -> np.ndarray:
    """Additive float32 mask [V]: 0 everywhere, -inf at suppressed ids."""
    mask = np.zeros(vocab_size, dtype=np.float32)
    if ids:
        idx = np.asarray([i for i in ids if 0 <= i < vocab_size], dtype=np.int64)
        mask[idx] = -np.inf
    return mask


def pick(logits: torch.Tensor, temperature: float, generator,
         want_lp: bool, rows=None):
    """(token [B], its log-probability [B] or None) from masked fp32 logits
    [B, V].  T > 0: argmax(logits / T - log E), E ~ Exp(1) (a Gumbel-max
    draw); E is floored at the smallest normal float, so a suppressed id
    (-inf) can never be drawn.  The log-probability is that of the masked
    distribution at T = 1, as the JAX ``pick`` takes it.

    rows (lo, hi, n): the logits are rows [lo, hi) of a batch of n (a data
    rank's share): the draws are made for all n rows, as the one-process
    decode makes them, and rows [lo, hi) taken."""
    if temperature > 0:
        if rows is None:
            e = torch.empty_like(logits).exponential_(generator=generator)
        else:
            lo, hi, n = rows
            e = logits.new_empty((n,) + tuple(logits.shape[1:])).exponential_(
                generator=generator)[lo:hi]
        tok = torch.argmax(
            logits / temperature
            - torch.log(e.clamp_min_(torch.finfo(torch.float32).tiny)), -1)
    else:
        tok = torch.argmax(logits, dim=-1)
    if not want_lp:
        return tok, None
    lp = torch.log_softmax(logits, dim=-1).gather(-1, tok[:, None])[:, 0]
    return tok, lp


def greedy_generate(params, dims: WhisperDims, enc_states: torch.Tensor,
                    prompt: torch.Tensor, suppress_mask: torch.Tensor,
                    first_suppress_mask: torch.Tensor, max_new_tokens: int,
                    eot_id: int, *, ts_cfg=None, int8_cross_kv: bool = False,
                    kernel_step: bool = False,
                    int8_mxu: bool = True, int8_self: bool = False,
                    step_weights=None, temperature: float = 0.0,
                    generator: torch.Generator | None = None,
                    return_logprobs: bool = False, pad_count=None,
                    mesh=None, draw_rows=None):
    """Generated tokens [B, max_new_tokens] (prompt excluded), rows that
    finished early padded with EOT; with return_logprobs also (sum_lp [B]
    fp32, n_tok [B] int64): the log-probability summed over each row's
    tokens up to and including its first EOT, and their count.  prompt: [P]
    ids shared by every row; masks: [V] fp32 additive.  kernel_step runs the
    decode step through kernel B3 and, against the int8 cross cache, B4
    (int8_mxu, x5) or B6 (x4); with int8_self and int8_mxu (x7) the self
    cache is quantized after the prefill and the step runs B8, then B4.

    step_weights (``ops.decoder_kernels.build_step_weights``,
    cfg.fused_decoder_step) takes the hybrid step instead
    (``decoder_step_hybrid``: one QKV product, plain attention against the
    prefill-layout cache, kernel B10c for the MLP); the kernel step and the
    int8 self cache are then not used, at any rung, as in the JAX
    package.

    ts_cfg (``runtime.timestamps.TimestampCfg``) enforces the timestamp
    grammar.  temperature > 0 samples with ``generator``, a
    ``torch.Generator`` on enc_states' device.

    pad_count ([B] int32 on enc_states' device): the first pad_count[r]
    prompt slots of row r are left padding (previous-text conditioning at
    one static prompt length): masked in the prefill, and passed to every
    step (B3/B8 on the kernel step), so each row decodes as its unpadded
    shorter prompt would.

    mesh: this rank's share of a (data, model) mesh: enc_states are its
    rows, the weights its shard (``parallel.mesh.shard_params``); the
    tokens returned are its rows.  draw_rows (lo, hi, n): those rows'
    place in the batch, so that sampled draws equal the one-process
    decode's (``pick``)."""
    from whisper_tpu_torch.runtime import timestamps as ts

    if step_weights is not None and pad_count is not None:
        # decoder_step_hybrid has no pad mask: it would attend the left
        # padding and offset positions on conditioned prompts.
        raise ValueError("step_weights (fused_decoder_step) does not "
                         "support pad_count-conditioned prompts")
    if temperature > 0 and generator is None:
        raise ValueError("temperature > 0 requires a generator")
    kernel_step = kernel_step and step_weights is None
    if kernel_step and not int8_cross_kv:
        raise ValueError("kernel_step needs the int8 cross cache")
    b = enc_states.shape[0]
    p = prompt.shape[0]
    dev = enc_states.device
    tokens = prompt.to(device=dev, dtype=torch.long)[None, :].expand(b, p)
    prompt_mask = None
    if pad_count is not None:
        prompt_mask = (torch.arange(p, device=dev)[None, :]
                       >= pad_count[:, None])                  # [B, P]
    logits, cache = whisper.decoder_prefill(
        params, dims, tokens, enc_states, p + max_new_tokens,
        int8_cross_kv=int8_cross_kv, prompt_mask=prompt_mask, mesh=mesh)
    if kernel_step and int8_self and int8_mxu:
        cache = whisper.quantize_self_kv(cache)
    first_logits = logits[:, -1, :].float() + first_suppress_mask
    ts_state = None
    if ts_cfg is not None:
        ts_state = ts.init_state(b, eot_id, dev)
        first_logits = ts.apply_rules(first_logits, ts_state, 0, ts_cfg)
    first, sum_lp = pick(first_logits, temperature, generator,
                         return_logprobs, draw_rows)
    if ts_cfg is not None:
        ts_state = ts.update_state(ts_state, first, ts_cfg)

    buf = torch.full((b, max_new_tokens), eot_id, dtype=torch.long,
                     device=dev)
    buf[:, 0] = first
    done = first == eot_id
    n_tok = (torch.ones(b, dtype=torch.long, device=dev)
             if return_logprobs else None)
    last = first
    cross_len = enc_states.shape[1]
    for i in range(1, max_new_tokens):
        # The loop's one host read.  Under a mesh it is the same on every
        # model rank (the logits follow an all-reduce); a data rank ends
        # with its own rows, whose later tokens would all be EOT.
        if bool(done.all()):
            break
        # `last` was generated as token index p+i-1 of the full sequence.
        if step_weights is not None:
            step_logits, cache = decoder_step_hybrid(
                params, step_weights, dims, last, p + i - 1, cache,
                mesh=mesh)
        else:
            step_logits, cache = whisper.decoder_step(
                params, dims, last, p + i - 1, cache,
                kernel_step=kernel_step,
                cross_len=cross_len if kernel_step else None,
                int8_mxu=int8_mxu, pad_count=pad_count, mesh=mesh)
        step_logits = step_logits.float() + suppress_mask
        if ts_cfg is not None:
            step_logits = ts.apply_rules(step_logits, ts_state, i, ts_cfg)
        nxt, lp = pick(step_logits, temperature, generator, return_logprobs,
                       draw_rows)
        nxt = torch.where(done, eot_id, nxt)
        if return_logprobs:
            # rows done before this step add nothing
            sum_lp = sum_lp + torch.where(done, 0.0, lp)
            n_tok = n_tok + (~done).long()
        if ts_cfg is not None:
            ts_state = ts.update_state(ts_state, nxt, ts_cfg)
        buf[:, i] = nxt
        done = done | (nxt == eot_id)
        last = nxt
    if return_logprobs:
        return buf, sum_lp, n_tok
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
