"""Speculative greedy decoding: a draft model proposes, the main model
verifies in one pass (port of ``whisper_tpu.runtime.speculative``).

A small draft decoder proposes ``draft_k`` tokens with cheap steps; the
main model scores all of them, and the position after the last, in ONE
masked ``draft_k + 1``-token pass, and commits the longest prefix it agrees
with plus its own token at the first disagreement (or the bonus token when
it agrees with everything).  The output is **lossless**: for any draft the
committed sequence is the main model's greedy sequence under the verify
pass's arithmetic.

Cache bookkeeping rests on the static-shape caches: rejected draft
positions leave stale K/V rows in both caches, but every attention mask is
bounded by position (``k_idx <= pos``), so stale rows past the accepted
position are never attended and are overwritten when real tokens reach
them.

Rows accept different draft lengths, so every decoder pass runs at
**per-row positions**: a ``[B]`` tensor flows into ``decoder_step`` and
``_decoder_blocks``, whose cache writes become indexed writes.  Rows that
finish early are frozen: their commits are masked out and they pad with EOT
while the rest of the batch goes on.

The JAX package's ``lax.while_loop`` and ``fori_loop`` are Python loops
here.  A round reads the device once (``done.all()``); the accept and
commit arithmetic stays on the device.  With the int8 cross cache and
head_dim 64 the draft's steps run cross-attention through kernel B4 or B6
and the verify pass through B7 (``ops.cross_attention``); self-attention is
plain in both, since B3 takes one position for all rows.
"""

from __future__ import annotations

import torch

from whisper_tpu_torch.models import whisper
from whisper_tpu_torch.models.registry import WhisperDims


def _verify_pass(params, dims: WhisperDims, tokens, pos, cache,
                 cross_len=None, int8_mxu: bool = False, mesh=None):
    """Multi-token decoder pass: tokens [B, K] at per-row positions
    [pos_r, pos_r+K); logits [B, K, V] and the cache, written in place.
    With cross_len set, cross-attention runs the multi-query kernel B7: one
    K/V stream per layer for all K tokens, each query bitwise what the
    single-token kernel gives."""
    dec = params["decoder"]
    dtype = dec["tok_emb"].dtype
    k = tokens.shape[1]
    dev = tokens.device
    pos_idx = pos[:, None] + torch.arange(k, device=dev)[None, :]   # [B, K]
    x = dec["tok_emb"][tokens] + dec["pos_embed"][pos_idx].to(dtype)
    max_len = cache.self_k.shape[3]
    k_idx = torch.arange(max_len, device=dev)[None, None, :]        # [1,1,S]
    mask = (k_idx <= pos_idx[:, :, None])[:, None]                # [B,1,K,S]
    x, cache = whisper._decoder_blocks(params, dims, x, cache, pos, mask,
                                       cross_len=cross_len, int8_mxu=int8_mxu,
                                       mesh=mesh)
    return whisper._logits(params, x), cache


def _kernel_cross(packed: bool, int8_cross_kv: bool, dims: WhisperDims,
                  mesh=None) -> bool:
    """The JAX package's packing gate: the cross-attention kernels serve an
    int8 cross cache with head_dim 64 and an even head count, and under a
    mesh only where the head pairs divide the model axis (``(heads // 2)
    % tp == 0``, JAX session.py:287-289), so both packages take the same
    path."""
    tp = 1 if mesh is None else mesh.model
    return bool(packed and int8_cross_kv and dims.head_dim == 64
                and dims.decoder_heads % 2 == 0
                and (dims.decoder_heads // 2) % tp == 0)


def speculative_generate(params, dims: WhisperDims, draft_params,
                         draft_dims: WhisperDims, enc_states: torch.Tensor,
                         draft_enc_states: torch.Tensor, prompt: torch.Tensor,
                         suppress_mask: torch.Tensor,
                         first_suppress_mask: torch.Tensor,
                         max_new_tokens: int, eot_id: int, draft_k: int = 4,
                         *, int8_cross_kv: bool = False,
                         packed_draft: bool = False,
                         packed_main: bool = False, int8_mxu: bool = False,
                         mesh=None):
    """Returns (tokens [B, max_new_tokens], n_rounds, n_committed [B]).

    enc_states / draft_enc_states: each model's encoder states [B, T, d];
    prompt: [P] ids shared by every row; masks: [V] fp32 additive.
    n_rounds counts verify passes: with a good draft n_committed / n_rounds
    approaches draft_k + 1 tokens per pass of the main model, with a useless
    one about 1.

    int8_cross_kv quantizes BOTH models' cross caches as the greedy path
    does (both prefills run plain, through the same int8 values).
    packed_draft / packed_main (names kept from the JAX package, where the
    kernels needed a head-packed cache) route the draft's single-token
    steps through kernel B4 or B6 and the main model's verify pass through
    B7; int8_mxu picks the int8 x int8 numerics (x5) over the dequantizing
    ones (x4).  Drafts only propose, so the draft's kernel rounding cannot
    change the output.

    mesh: the main model is this rank's shard (its rows and heads); the
    draft is whole on every rank and runs without collectives.  The model
    ranks of a data rank propose alike (the same rows, the same
    deterministic draft) and read the same logits after the all-reduce, so
    their rounds agree."""
    if draft_k < 1:
        # Nothing would be drafted or committed, and the loop would not end.
        raise ValueError(f"draft_k must be >= 1, got {draft_k}")
    b = enc_states.shape[0]
    p = prompt.shape[0]
    dev = enc_states.device
    # + draft_k + 1 slack: the last verify round may overrun before masking
    # (a round commits up to draft_k + 1 tokens, the bonus token included).
    max_len = p + max_new_tokens + draft_k + 1
    tokens_p = prompt.to(device=dev, dtype=torch.long)[None, :].expand(b, p)

    logits, cache = whisper.decoder_prefill(
        params, dims, tokens_p, enc_states, max_len,
        int8_cross_kv=int8_cross_kv, mesh=mesh)
    first = torch.argmax(logits[:, -1, :].float() + first_suppress_mask, -1)
    m_cross_len = (enc_states.shape[1]
                   if _kernel_cross(packed_main, int8_cross_kv, dims, mesh)
                   else None)

    _, d_cache = whisper.decoder_prefill(
        draft_params, draft_dims, tokens_p, draft_enc_states, max_len,
        int8_cross_kv=int8_cross_kv)
    d_cross_len = (draft_enc_states.shape[1]
                   if _kernel_cross(packed_draft, int8_cross_kv, draft_dims)
                   else None)

    width = max_new_tokens + draft_k + 1
    buf = torch.full((b, width), eot_id, dtype=torch.long, device=dev)
    buf[:, 0] = first
    ar_k1 = torch.arange(draft_k + 1, device=dev)[None, :]        # [1, K+1]
    ar_w = torch.arange(width, device=dev)[None, :]
    zero_col = torch.zeros((b, 1), dtype=torch.long, device=dev)

    n_gen = torch.ones((b,), dtype=torch.long, device=dev)
    last = first
    done = first == eot_id
    rounds = 0
    while not bool(done.all()):            # the round's one host sync
        # [B] position of each row's `last`.  A row frozen by length may
        # have overrun max_new_tokens by up to draft_k; its steps are still
        # computed and discarded, and must write inside the cache (the JAX
        # package's dynamic slices clamp them there).
        pos = p + torch.clamp_max(n_gen, max_new_tokens - 1) - 1

        # --- the draft proposes draft_k tokens per row ---
        d_last = last
        drafts = []
        for i in range(draft_k):
            lg, d_cache = whisper.decoder_step(
                draft_params, draft_dims, d_last, pos + i, d_cache,
                cross_len=d_cross_len, int8_mxu=int8_mxu)
            d_last = torch.argmax(lg.float() + suppress_mask, dim=-1)
            drafts.append(d_last)
        drafts = torch.stack(drafts, dim=1)                       # [B, K]

        # --- the main model checks [last, d1..dK] in one K+1-token pass
        # (it scores the position after the last draft too, so full
        # acceptance commits the true bonus token) ---
        verify_in = torch.cat([last[:, None], drafts], dim=1)     # [B, K+1]
        v_logits, cache = _verify_pass(
            params, dims, verify_in, pos, cache, cross_len=m_cross_len,
            int8_mxu=int8_mxu, mesh=mesh)
        targets = torch.argmax(v_logits.float() + suppress_mask, dim=-1)

        # Longest accepted prefix per row: drafts[r, i] == targets[r, i].
        matches = torch.cat([(drafts == targets[:, :draft_k]).long(),
                             zero_col], dim=1)                    # [B, K+1]
        n_accept = torch.cumprod(matches, dim=1).sum(dim=1)       # in [0, K]
        # Commit drafts[:n_accept], then the main model's token at the
        # mismatch (the bonus token when everything matched).
        drafts_p = torch.cat([drafts, zero_col], dim=1)
        commit = torch.where(
            ar_k1 < n_accept[:, None], drafts_p,
            torch.where(ar_k1 == n_accept[:, None], targets, eot_id))
        n_commit = torch.where(done, 0, n_accept + 1)   # frozen rows: none

        # Row r writes commit[r] at buf[r, n_gen_r : n_gen_r + K + 1]: the
        # slack columns take the overrun, and a frozen row keeps its own
        # (its start is clamped into the buffer, as a dynamic slice's is).
        cols = torch.clamp_max(n_gen, width - draft_k - 1)[:, None] + ar_k1
        buf.scatter_(1, cols, torch.where(done[:, None],
                                          buf.gather(1, cols), commit))

        committed_eot = ((ar_k1 < n_commit[:, None])
                         & (commit == eot_id)).any(dim=1)
        last_new = commit.gather(
            1, torch.clamp_min(n_commit - 1, 0)[:, None])[:, 0]
        last = torch.where(done, last, last_new)
        n_gen = n_gen + n_commit
        done = done | committed_eot | (n_gen >= max_new_tokens)
        rounds += 1

    # Positions never committed (the overrun slack included) become EOT.
    buf = torch.where(ar_w < n_gen[:, None], buf, eot_id)[:, :max_new_tokens]
    return buf, rounds, n_gen
