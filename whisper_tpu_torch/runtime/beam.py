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

The JAX ``lax.while_loop`` becomes a step function over ``BeamState``,
updated in place as the greedy loop's (``runtime.generate``): every gather
of the parents (the token buffer, the lengths, ``done``, the self cache,
the grammar state) is copied back into the state's own tensors, the token
column is written at the device ``step``, and the cache slot ``pos`` is a
device tensor.  On a card each call is one launch of a CUDA graph per key
(``BeamKey``, in the caller's ``DecodeGraphs``) whose step is the body of
the greedy loop's while node: the card runs it while the JAX condition
holds (``i < max_new_tokens`` and not every beam of every row done) and
nothing is read, so the step counter is the ``while_loop``'s trip
count; a mesh rank's loop too, wherever its collectives can be captured
(``generate.graphed``), with a key of its own rows (``row0``).
``eager=True``, the CPU and a mesh whose model axis runs over gloo call
the step function as it is and read ``done`` as the greedy loop's eager
form does (``early_exit=False``: no read, every step runs).
Steps past the point where every beam is done change nothing the loop
returns: each beam's one candidate is its own EOT at zero cost, the scores
are already in ``top_k``'s order, so the parents are the identity, the
lengths stay and the column written is EOT, as it was.
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
from whisper_tpu_torch.runtime.speculative import _kernel_cross

NEG_INF = -1e30  # a finished beam's non-EOT candidates, as in the JAX file


def top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of each row of x, in the
    order of ``jax.lax.top_k``: the larger value first, the lower index on
    a tie (``torch.topk`` does not promise that order, a stable sort
    does)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@dataclasses.dataclass
class BeamState(InPlaceState):
    """The beam loop's carried state, on the device, updated in place by
    one step (``_step_fn``)."""

    last: torch.Tensor            # [B*K] int64, the tokens the step feeds
    pos: torch.Tensor             # [1] int32, their cache slot
    step: torch.Tensor            # [1] int64, the column the step writes
    done: torch.Tensor            # [B, K] bool
    lengths: torch.Tensor         # [B, K] int64, generated incl. EOT
    scores: torch.Tensor          # [B, K] fp32, summed log-probabilities
    buf: torch.Tensor             # [B, K, max_new_tokens] int64
    suppress: torch.Tensor        # [V] fp32 additive mask of every step
    eot_only: torch.Tensor        # [V] fp32: a finished beam's candidates
    row0: torch.Tensor            # [B, 1] int64: row r's first beam, r*K
    cache: whisper.KVCache        # tiled per beam: [L, B*K, ...]
    ts: Optional[object] = None   # timestamps.TimestampState, [B*K] rows
    pad_count: Optional[torch.Tensor] = None  # [B*K] int32

    def tensors(self) -> list:
        out = [self.last, self.pos, self.step, self.done, self.lengths,
               self.scores, self.buf, self.suppress, self.eot_only,
               self.row0, *self.cache, *(self.ts or ()), self.pad_count]
        return [t for t in out if t is not None]

    def trips(self) -> torch.Tensor:
        return self.step

    def outputs(self):
        """(buf, scores, lengths) of every beam."""
        return self.buf.clone(), self.scores.clone(), self.lengths.clone()


class BeamKey(NamedTuple):
    """What a captured beam step is specialised to."""

    rows: int              # B*K
    beams: int
    prompt_len: int
    max_new_tokens: int
    cross_len: int
    kernel_cross: bool     # B4/B6 against the int8 cross cache
    int8_mxu: bool
    int8_cross_kv: bool
    ts_cfg: object
    pads: bool
    eot_id: int
    row0: int = 0          # a data rank's first row of the batch
    front: tuple = ()
    kind: str = "beam"


def _step_fn(st: BeamState, params, dims: WhisperDims, *, eot_id: int,
             cross_len, int8_mxu: bool, ts_cfg, mesh):
    """One beam step over ``st``, in place, reading nothing on the host."""
    from whisper_tpu_torch.runtime import timestamps as ts

    b, k, n = st.buf.shape
    v = st.eot_only.shape[0]

    def step() -> None:
        logits, _ = whisper.decoder_step(
            params, dims, st.last, st.pos, st.cache, cross_len=cross_len,
            int8_mxu=int8_mxu, pad_count=st.pad_count, mesh=mesh)
        logits = logits.float() + st.suppress
        if ts_cfg is not None:
            logits = ts.apply_rules(logits, st.ts, st.step, ts_cfg)
        logp = torch.log_softmax(logits, dim=-1).reshape(b, k, v)
        logp = torch.where(st.done[:, :, None], st.eot_only, logp)

        total = st.scores[:, :, None] + logp                   # [B, K, V]
        scores, idx = top_k(total.reshape(b, k * v), k)        # [B, K]
        parent = idx // v
        tok = idx % v

        st.buf.copy_(st.buf.gather(1, parent[:, :, None].expand(-1, -1, n)))
        st.buf.index_copy_(2, st.step, tok[:, :, None])
        prev_done = st.done.gather(1, parent)
        lengths = st.lengths.gather(1, parent)
        st.lengths.copy_(torch.where(prev_done, lengths, lengths + 1))
        st.done.copy_(prev_done | (tok == eot_id))
        st.scores.copy_(scores)
        # Only the self cache follows the parent beams: the cross K/V (and
        # its scales) are the same for every beam of a row.
        rows = (parent + st.row0).reshape(-1)
        st.cache.self_k.copy_(st.cache.self_k.index_select(1, rows))
        st.cache.self_v.copy_(st.cache.self_v.index_select(1, rows))
        if ts_cfg is not None:
            ts.gather_state_(st.ts, rows)
            ts.update_state_(st.ts, tok.reshape(b * k), ts_cfg)
        st.last.copy_(tok.reshape(b * k))
        st.pos.add_(1)
        st.step.add_(1)

    return step


def beam_generate(params, dims: WhisperDims, enc_states,
                  prompt: torch.Tensor, suppress_mask: torch.Tensor,
                  first_suppress_mask: torch.Tensor, max_new_tokens: int,
                  eot_id: int, num_beams: int, length_penalty: float = 1.0,
                  *, ts_cfg=None, int8_cross_kv: bool = False,
                  packed_cross: bool = False, int8_mxu: bool = False,
                  pad_count=None, mesh=None, row0: int = 0,
                  early_exit: bool = True, eager: bool = False,
                  graphs: Optional[DecodeGraphs] = None):
    """Returns (tokens [B, max_new_tokens] of the best beam, scores [B]).

    enc_states: [B, T_enc, d], or a ``generate.Front`` that computes them
    (the session's bucket programs); prompt: [P] ids shared by every row;
    masks: [V] fp32 additive.  packed_cross (with int8_cross_kv, head_dim
    64 and an even head count) runs cross-attention through B4 (int8_mxu)
    or B6.  With ts_cfg each beam carries its own timestamp-grammar state.
    pad_count ([B] int32): left pad slots of each row's prompt, masked in
    the prefill and repeated per beam for every step.  mesh: this rank's
    share of a (data, model) mesh (its rows and heads, ``greedy_generate``);
    its model ranks' ``done`` agrees, so they take the same steps; row0:
    the place of its first row in the batch (the key's).

    On a card the call runs as one launch of a CUDA graph kept in
    ``graphs`` (a ``DecodeGraphs`` of these weights; None: captured for
    this call alone), unless ``eager`` or a mesh whose collectives cannot
    be captured (``generate.graphed``): the front, the prefill, the first
    top-K and the cache tiled per beam, then the steps under its while
    node; nothing is read, the card stops the loop, and the call returns
    before the decode ends.  The eager loop reads ``done`` once a step (an
    eager mesh on a card once ``generate.EXIT_BLOCK`` steps), or never with
    early_exit False (every step runs)."""
    from whisper_tpu_torch.runtime import timestamps as ts

    front = (enc_states if isinstance(enc_states, Front)
             else states_front(enc_states))
    b, t_enc, dev = front.rows, front.length, front.device
    k = num_beams
    p = prompt.shape[0]
    v = dims.vocab_size
    cross_len = (t_enc if _kernel_cross(packed_cross, int8_cross_kv, dims,
                                        mesh) else None)
    inputs = front.inputs + (prompt.long(), suppress_mask,
                             first_suppress_mask)
    if pad_count is not None:
        inputs += (pad_count,)
    nf = len(front.inputs)

    def prepare(xs, out: Optional[BeamState] = None) -> BeamState:
        """The front, the prefill (of B rows, in a buffer of its own) and
        the first top-K, the cache tiled per beam: the state before step 1,
        written into ``out`` where given (the tiles straight into its
        cache)."""
        enc = front.encode(*xs[:nf])
        prompt_t, suppress, first_mask, *rest = xs[nf:]
        tokens_p = prompt_t[None, :].expand(b, p)
        prompt_mask = pad_bk = None
        if pad_count is not None:
            pads = rest[0]
            prompt_mask = (torch.arange(p, device=dev)[None, :]
                           >= pads[:, None])                   # [B, P]
            pad_bk = pads.to(torch.int32).repeat_interleave(k)   # [B*K]
        logits, cache = whisper.decoder_prefill(
            params, dims, tokens_p, enc, p + max_new_tokens,
            int8_cross_kv=int8_cross_kv, prompt_mask=prompt_mask, mesh=mesh)
        first_logits = logits[:, -1, :].float() + first_mask
        if ts_cfg is not None:
            first_logits = ts.apply_rules(first_logits,
                                          ts.init_state(b, eot_id, dev), 0,
                                          ts_cfg)
        scores, first = top_k(torch.log_softmax(first_logits, dim=-1), k)
        # [L, B, ...] -> [L, B*K, ...], beam j of row r at r*K + j; the
        # scales [L, B, H, 1, 1] tile alike
        if out is None:
            cache = whisper.KVCache(*(None if x is None
                                      else x.repeat_interleave(k, dim=1)
                                      for x in cache))
        else:
            for x, tiles in zip(cache, out.cache):
                if x is not None:
                    tiles.view(x.shape[0], b, k, *x.shape[2:]).copy_(
                        x[:, :, None].expand(-1, -1, k,
                                             *(-1,) * (x.ndim - 2)))
            cache = out.cache
        buf = torch.full((b, k, max_new_tokens), eot_id, dtype=torch.long,
                         device=dev)
        buf[:, :, 0] = first
        eot_only = torch.full((v,), NEG_INF, dtype=torch.float32, device=dev)
        eot_only[eot_id:eot_id + 1].fill_(0.0)     # no copy from the host
        ts_state = None
        if ts_cfg is not None:
            ts_state = ts.update_state(ts.init_state(b * k, eot_id, dev),
                                       first.reshape(b * k), ts_cfg)
        st = BeamState(
            last=first.reshape(b * k),
            pos=torch.full((1,), p, dtype=torch.int32, device=dev),
            step=torch.ones(1, dtype=torch.long, device=dev),
            done=first == eot_id,
            lengths=torch.ones((b, k), dtype=torch.long, device=dev),
            scores=scores, buf=buf, suppress=suppress,
            eot_only=eot_only,
            row0=torch.arange(b, device=dev)[:, None] * k, cache=cache,
            ts=ts_state, pad_count=pad_bk)
        return st if out is None else out.copy_(st)

    def make_step(st: BeamState):
        return _step_fn(st, params, dims, eot_id=eot_id, cross_len=cross_len,
                        int8_mxu=int8_mxu, ts_cfg=ts_cfg, mesh=mesh)

    key = BeamKey(b * k, k, p, max_new_tokens, t_enc,
                  cross_len is not None, int8_mxu, int8_cross_kv, ts_cfg,
                  pad_count is not None, eot_id, row0=row0,
                  front=front_key(front))
    buf, scores, lengths = run_loop(
        inputs, prepare, make_step, 1, max_new_tokens,
        exit_period(early_exit, dev, mesh, eager=eager), graphs=graphs,
        key=key,
        device=dev, params=params, encoders=front.weights, mesh=mesh,
        eager=eager)

    norm = scores / lengths.float() ** length_penalty
    best = torch.argmax(norm, dim=1)                           # [B]
    rows = torch.arange(b, device=dev)
    return buf[rows, best], norm[rows, best]
