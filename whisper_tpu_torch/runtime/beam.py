"""Beam search with a static-shape KV cache (port of
``whisper_tpu.runtime.beam``).

Semantics (standard seq2seq beam search, the JAX package's):
- one prefill per batch row, then ``top_k`` of the first log-softmax gives
  the K beams; the cache is tiled per beam (``repeat_interleave`` along the
  batch axis, the counterpart of ``jnp.repeat(x, k, axis=1)``);
- each step: log-softmax over the suppressed (and, with ``ts_cfg``,
  grammar-masked) logits; finished beams can only extend with EOT at zero
  cost, so their score freezes; top-K over the K*V candidates of a batch
  row; the self cache and the grammar state follow their parent beams (the
  cross cache is the same for every beam of a row and stays);
- the loop exits when every beam of every row is finished or at
  max_new_tokens; the final choice maximizes score / length**length_penalty
  with length = generated tokens incl. EOT.

The step is the one a speculative draft takes (``whisper.decoder_step``
with ``cross_len``): plain self-attention, and against the int8 cross
cache of the packing gate the cross-attention kernels, B4 (x5, x7) or B6
(x4), at B*K rows.  ``num_beams=1`` reduces to greedy decoding taking the
same step.
"""

from __future__ import annotations

import torch

from whisper_tpu_torch.models import whisper
from whisper_tpu_torch.models.registry import WhisperDims
from whisper_tpu_torch.runtime.speculative import _kernel_cross

NEG_INF = -1e30  # a finished beam's non-EOT candidates, as in the JAX file


def top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of each row of x, in the
    order of ``jax.lax.top_k``: the larger value first, the lower index on
    a tie (``torch.topk`` does not promise that order, a stable sort
    does)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def beam_generate(params, dims: WhisperDims, enc_states: torch.Tensor,
                  prompt: torch.Tensor, suppress_mask: torch.Tensor,
                  first_suppress_mask: torch.Tensor, max_new_tokens: int,
                  eot_id: int, num_beams: int, length_penalty: float = 1.0,
                  *, ts_cfg=None, int8_cross_kv: bool = False,
                  packed_cross: bool = False, int8_mxu: bool = False,
                  pad_count=None, mesh=None):
    """Returns (tokens [B, max_new_tokens] of the best beam, scores [B]).

    enc_states: [B, T_enc, d]; prompt: [P] ids shared by every row; masks:
    [V] fp32 additive.  packed_cross (with int8_cross_kv, head_dim 64 and
    an even head count) runs cross-attention through B4 (int8_mxu) or B6.
    With ts_cfg each beam carries its own timestamp-grammar state.
    pad_count ([B] int32): left pad slots of each row's prompt, masked in
    the prefill and repeated per beam for every step.  mesh: this rank's
    share of a (data, model) mesh (its rows and heads, ``greedy_generate``);
    the loop's ``done`` read agrees across its model ranks."""
    from whisper_tpu_torch.runtime import timestamps as ts

    b = enc_states.shape[0]
    k = num_beams
    p = prompt.shape[0]
    v = dims.vocab_size
    dev = enc_states.device

    tokens_p = prompt.to(device=dev, dtype=torch.long)[None, :].expand(b, p)
    prompt_mask = pad_bk = None
    if pad_count is not None:
        prompt_mask = (torch.arange(p, device=dev)[None, :]
                       >= pad_count[:, None])                  # [B, P]
        pad_bk = pad_count.repeat_interleave(k)                # [B*K]
    logits, cache = whisper.decoder_prefill(
        params, dims, tokens_p, enc_states, p + max_new_tokens,
        int8_cross_kv=int8_cross_kv, prompt_mask=prompt_mask, mesh=mesh)
    first_logits = logits[:, -1, :].float() + first_suppress_mask
    if ts_cfg is not None:
        first_logits = ts.apply_rules(first_logits,
                                      ts.init_state(b, eot_id, dev), 0,
                                      ts_cfg)
    scores, first = top_k(torch.log_softmax(first_logits, dim=-1), k)

    cross_len = (enc_states.shape[1]
                 if _kernel_cross(packed_cross, int8_cross_kv, dims, mesh)
                 else None)
    # [L, B, ...] -> [L, B*K, ...], beam j of row r at r*K + j; the scales
    # [L, B, H, 1, 1] tile alike
    cache = whisper.KVCache(*(None if x is None
                              else x.repeat_interleave(k, dim=1)
                              for x in cache))

    buf = torch.full((b, k, max_new_tokens), eot_id, dtype=torch.long,
                     device=dev)
    buf[:, :, 0] = first
    done = first == eot_id
    lengths = torch.ones((b, k), dtype=torch.long, device=dev)
    eot_only = torch.full((v,), NEG_INF, dtype=torch.float32, device=dev)
    eot_only[eot_id] = 0.0
    ts_state = None
    if ts_cfg is not None:
        ts_state = ts.update_state(ts.init_state(b * k, eot_id, dev),
                                   first.reshape(b * k), ts_cfg)
    row0 = torch.arange(b, device=dev)[:, None] * k
    last = first
    for i in range(1, max_new_tokens):
        if bool(done.all()):
            break
        step_logits, cache = whisper.decoder_step(
            params, dims, last.reshape(b * k), p + i - 1, cache,
            cross_len=cross_len, int8_mxu=int8_mxu, pad_count=pad_bk,
            mesh=mesh)
        step_logits = step_logits.float() + suppress_mask
        if ts_cfg is not None:
            step_logits = ts.apply_rules(step_logits, ts_state, i, ts_cfg)
        logp = torch.log_softmax(step_logits, dim=-1).reshape(b, k, v)
        logp = torch.where(done[:, :, None], eot_only, logp)

        total = scores[:, :, None] + logp                      # [B, K, V]
        scores, idx = top_k(total.reshape(b, k * v), k)        # [B, K]
        parent = idx // v
        tok = idx % v

        buf = buf.gather(1, parent[:, :, None].expand(-1, -1, max_new_tokens))
        buf[:, :, i] = tok
        prev_done = done.gather(1, parent)
        lengths = lengths.gather(1, parent)
        lengths = torch.where(prev_done, lengths, lengths + 1)
        done = prev_done | (tok == eot_id)
        # Only the self cache follows the parent beams: the cross K/V (and
        # its scales) are the same for every beam of a row.
        rows = (parent + row0).reshape(-1)
        cache = cache._replace(self_k=cache.self_k.index_select(1, rows),
                               self_v=cache.self_v.index_select(1, rows))
        if ts_cfg is not None:
            parents = ts.TimestampState(*(x.index_select(0, rows)
                                          for x in ts_state))
            ts_state = ts.update_state(parents, tok.reshape(b * k), ts_cfg)
        last = tok

    norm = scores / lengths.float() ** length_penalty
    best = torch.argmax(norm, dim=1)                           # [B]
    rows = torch.arange(b, device=dev)
    return buf[rows, best], norm[rows, best]
