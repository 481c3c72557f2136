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

The JAX package's ``lax.while_loop`` over rounds becomes a round function
over ``SpecState``, updated in place as the greedy loop's step
(``runtime.generate``); its ``fori_loop`` over the draft steps is unrolled
in the round.  On a card each call is one launch of a CUDA graph per key
(``SpecKey``, in a ``DecodeGraphs`` that holds the main and the draft
weights) whose round is the body of the greedy loop's while node
(``runtime.generate``): the card runs rounds while fewer than
max_new_tokens have run, which bounds the loop since every undone row
commits a token a round, and some row is undone; nothing is read, and the
rounds run are the rounds counted; a mesh rank's rounds too, wherever
its collectives can be captured (``generate.graphed``), with a key of its
own rows (``row0``).  ``eager=True``, the CPU and a mesh whose model axis
runs over gloo call the round function as it is and read ``done`` once a
round, an eager mesh on a card once a block of ``EXIT_BLOCK`` rounds (one
block behind).  A round adds one to the device
round counter only when some row was undone at its start, so ``n_rounds``
is the JAX ``while_loop``'s trip count however far a block overruns; a
round past all-done commits nothing (every row is frozen) and writes its
cache rows inside the cache (the clamp below).  With the int8 cross cache
and head_dim 64 the draft's steps run cross-attention through kernel B4 or
B6 and the verify pass through B7 (``ops.cross_attention``);
self-attention is plain in both, since B3 takes one position for all rows.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from whisper_tpu_torch.models import whisper
from whisper_tpu_torch.models.registry import WhisperDims
from whisper_tpu_torch.runtime.generate import (
    DecodeGraphs,
    Front,
    InPlaceState,
    exit_period,
    front_key,
    run_loop,
    states_front,
)

# Rounds the eager loop runs under an eager mesh on a card between two
# reads of ``done`` (``generate.exit_period``): a round takes 5-7 ms at
# whisper-base (16 rows, draft_k 4), so a read every two rounds costs the
# card nothing, and a block overruns all-done by at most three rounds.
EXIT_BLOCK = 2


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


@dataclasses.dataclass
class SpecState(InPlaceState):
    """The speculative loop's carried state, on the device, updated in place
    by one round (``_round_fn``)."""

    n_gen: torch.Tensor           # [B] int64, tokens committed (the first)
    last: torch.Tensor            # [B] int64, each row's last token
    done: torch.Tensor            # [B] bool
    buf: torch.Tensor             # [B, max_new_tokens + draft_k + 1] int64
    rounds: torch.Tensor          # [1] int64, rounds with a row undone
    suppress: torch.Tensor        # [V] fp32 additive mask
    cache: whisper.KVCache        # the main model's
    d_cache: whisper.KVCache      # the draft's

    def tensors(self) -> list:
        out = [self.n_gen, self.last, self.done, self.buf, self.rounds,
               self.suppress, *self.cache, *self.d_cache]
        return [t for t in out if t is not None]

    def trips(self) -> torch.Tensor:
        return self.rounds

    def outputs(self):
        """(buf, rounds, n_gen)."""
        return self.buf.clone(), self.rounds.clone(), self.n_gen.clone()


class SpecKey(NamedTuple):
    """What a captured speculative round is specialised to."""

    rows: int
    prompt_len: int
    max_new_tokens: int
    draft_k: int
    cross_len: int
    draft_cross_len: int
    kernel_main: bool      # the verify pass through B7
    kernel_draft: bool     # the draft's steps through B4/B6
    int8_mxu: bool
    int8_cross_kv: bool
    eot_id: int
    row0: int = 0          # a data rank's first row of the batch
    front: tuple = ()
    kind: str = "speculative"


def _round_fn(st: SpecState, params, dims: WhisperDims, draft_params,
              draft_dims: WhisperDims, *, prompt_len: int,
              max_new_tokens: int, draft_k: int, eot_id: int, m_cross_len,
              d_cross_len, int8_mxu: bool, mesh):
    """One draft-and-verify round over ``st``, in place, reading nothing on
    the host."""
    b, width = st.buf.shape

    def round_() -> None:
        dev = st.buf.device
        ar_k1 = torch.arange(draft_k + 1, device=dev)[None, :]    # [1, K+1]
        zero_col = torch.zeros((b, 1), dtype=torch.long, device=dev)
        done = st.done        # the rows frozen for this round (set last)
        st.rounds.add_((~done.all()).long())
        # [B] position of each row's `last`.  A row frozen by length may
        # have overrun max_new_tokens by up to draft_k, and a round past
        # all-done runs on frozen rows; their steps are still computed and
        # discarded, and must write inside the cache (the JAX package's
        # dynamic slices clamp them there).
        pos = prompt_len + torch.clamp_max(st.n_gen, max_new_tokens - 1) - 1

        # --- the draft proposes draft_k tokens per row ---
        d_last = st.last
        drafts = []
        for i in range(draft_k):
            lg, _ = whisper.decoder_step(
                draft_params, draft_dims, d_last, pos + i, st.d_cache,
                cross_len=d_cross_len, int8_mxu=int8_mxu)
            d_last = torch.argmax(lg.float() + st.suppress, dim=-1)
            drafts.append(d_last)
        drafts = torch.stack(drafts, dim=1)                       # [B, K]

        # --- the main model checks [last, d1..dK] in one K+1-token pass
        # (it scores the position after the last draft too, so full
        # acceptance commits the true bonus token) ---
        verify_in = torch.cat([st.last[:, None], drafts], dim=1)  # [B, K+1]
        v_logits, _ = _verify_pass(
            params, dims, verify_in, pos, st.cache, cross_len=m_cross_len,
            int8_mxu=int8_mxu, mesh=mesh)
        targets = torch.argmax(v_logits.float() + st.suppress, dim=-1)

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
        cols = torch.clamp_max(st.n_gen, width - draft_k - 1)[:, None] + ar_k1
        st.buf.scatter_(1, cols, torch.where(done[:, None],
                                             st.buf.gather(1, cols), commit))

        committed_eot = ((ar_k1 < n_commit[:, None])
                         & (commit == eot_id)).any(dim=1)
        last_new = commit.gather(
            1, torch.clamp_min(n_commit - 1, 0)[:, None])[:, 0]
        st.last.copy_(torch.where(done, st.last, last_new))
        st.n_gen.add_(n_commit)
        st.done.logical_or_(committed_eot | (st.n_gen >= max_new_tokens))

    return round_


def speculative_generate(params, dims: WhisperDims, draft_params,
                         draft_dims: WhisperDims, enc_states,
                         draft_enc_states: Optional[torch.Tensor],
                         prompt: torch.Tensor,
                         suppress_mask: torch.Tensor,
                         first_suppress_mask: torch.Tensor,
                         max_new_tokens: int, eot_id: int, draft_k: int = 4,
                         *, int8_cross_kv: bool = False,
                         packed_draft: bool = False,
                         packed_main: bool = False, int8_mxu: bool = False,
                         mesh=None, row0: int = 0, eager: bool = False,
                         graphs: Optional[DecodeGraphs] = None):
    """Returns (tokens [B, max_new_tokens], n_rounds, n_committed [B]).

    enc_states / draft_enc_states: each model's encoder states [B, T, d];
    or enc_states a ``generate.Front`` that computes both (the session's
    bucket programs: the main encoder, and the draft's unless it shares
    it) and draft_enc_states None.  prompt: [P] ids shared by every row;
    masks: [V] fp32 additive.
    n_rounds (a one-element int64 tensor on the device: read it after the
    results) counts verify passes that had a row undone: with a good draft
    n_committed / n_rounds approaches draft_k + 1 tokens per pass of the
    main model, with a useless one about 1.

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
    their rounds agree.  row0: the place of its first row in the batch
    (the key's).

    On a card the call runs as one launch of a CUDA graph kept in
    ``graphs`` (a ``DecodeGraphs`` of these main and draft weights; None:
    captured for this call alone), unless ``eager`` or a mesh whose
    collectives cannot be captured (``generate.graphed``): the front, both
    prefills and the first token, then the rounds under its while node;
    nothing is read, and the call returns before the loop ends.  The eager
    loop reads ``done`` once a round (an eager mesh on a card once
    ``EXIT_BLOCK`` rounds)."""
    if draft_k < 1:
        # Nothing would be drafted or committed, and the loop would not end.
        raise ValueError(f"draft_k must be >= 1, got {draft_k}")
    front = (enc_states if isinstance(enc_states, Front)
             else states_front(enc_states, draft_enc_states))
    b, t_enc, dev = front.rows, front.length, front.device
    p = prompt.shape[0]
    # + draft_k + 1 slack: the last verify round may overrun before masking
    # (a round commits up to draft_k + 1 tokens, the bonus token included).
    max_len = p + max_new_tokens + draft_k + 1
    width = max_new_tokens + draft_k + 1
    m_cross_len = (t_enc
                   if _kernel_cross(packed_main, int8_cross_kv, dims, mesh)
                   else None)
    d_cross_len = (front.draft_length
                   if _kernel_cross(packed_draft, int8_cross_kv, draft_dims)
                   else None)
    inputs = front.inputs + (prompt.long(), suppress_mask,
                             first_suppress_mask)
    nf = len(front.inputs)

    def prepare(xs, out: Optional[SpecState] = None) -> SpecState:
        """The front, both prefills and the first token: the state before
        round 0, written into ``out`` where given (both caches in place)."""
        enc, enc_d = front.encode(*xs[:nf])
        prompt_t, suppress, first_mask = xs[nf:]
        tokens_p = prompt_t[None, :].expand(b, p)
        logits, cache = whisper.decoder_prefill(
            params, dims, tokens_p, enc, max_len,
            int8_cross_kv=int8_cross_kv, mesh=mesh,
            cache=None if out is None else out.cache)
        first = torch.argmax(logits[:, -1, :].float() + first_mask, -1)
        _, d_cache = whisper.decoder_prefill(
            draft_params, draft_dims, tokens_p, enc_d, max_len,
            int8_cross_kv=int8_cross_kv,
            cache=None if out is None else out.d_cache)
        buf = torch.full((b, width), eot_id, dtype=torch.long, device=dev)
        buf[:, 0] = first
        st = SpecState(
            n_gen=torch.ones((b,), dtype=torch.long, device=dev), last=first,
            done=first == eot_id, buf=buf,
            rounds=torch.zeros(1, dtype=torch.long, device=dev),
            suppress=suppress, cache=cache, d_cache=d_cache)
        return st if out is None else out.copy_(st)

    def make_round(st: SpecState):
        return _round_fn(st, params, dims, draft_params, draft_dims,
                         prompt_len=p, max_new_tokens=max_new_tokens,
                         draft_k=draft_k, eot_id=eot_id,
                         m_cross_len=m_cross_len, d_cross_len=d_cross_len,
                         int8_mxu=int8_mxu, mesh=mesh)

    key = SpecKey(b, p, max_new_tokens, draft_k, t_enc, front.draft_length,
                  m_cross_len is not None, d_cross_len is not None, int8_mxu,
                  int8_cross_kv, eot_id, row0=row0, front=front_key(front))
    # Every undone row commits a token a round, so max_new_tokens rounds
    # bound the loop; it stops where every row is done.
    buf, rounds, n_gen = run_loop(
        inputs, prepare, make_round, 0, max_new_tokens,
        exit_period(True, dev, mesh, EXIT_BLOCK, eager=eager), graphs=graphs,
        key=key, device=dev, params=params, draft_params=draft_params,
        encoders=front.weights, mesh=mesh, eager=eager)
    # Positions never committed (the overrun slack included) become EOT.
    ar_w = torch.arange(width, device=dev)[None, :]
    buf = torch.where(ar_w < n_gen[:, None], buf, eot_id)[:, :max_new_tokens]
    return buf, rounds, n_gen
