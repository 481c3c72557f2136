"""Whisper timestamp grammar over a batch of logits (port of
``whisper_tpu.runtime.timestamps``).

The behaviour of HF's ``WhisperTimeStampLogitsProcessor`` (OpenAI's
``ApplyTimestampRules``) as tensor operations on [B, V] fp32 logits and a
small carried state, so the decode loop applies it with no host read:

1. ``<|notimestamps|>`` is always suppressed.
2. Timestamps come in pairs (except directly after a segment start): if the
   last token was a timestamp and the one before was not, the next token
   must close the pair (timestamp or EOT, no text); if the last two were
   timestamps, the next must be text (no timestamp).
3. Timestamps are non-decreasing: candidates below the furthest timestamp
   seen are banned (equality allowed only when closing a pair).
4. The first generated token must be a timestamp, capped at
   ``max_initial_timestamp_index`` (default 50 = 1.0 s); EOT is banned
   there too, as HF bans every id below ``timestamp_begin``.
5. If the total probability mass on timestamps exceeds the most likely
   token below ``timestamp_begin`` (EOT included), everything below
   ``timestamp_begin`` is banned for this step.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

NEG_INF = float("-inf")


class TimestampCfg(NamedTuple):
    timestamp_begin: int          # id of <|0.00|>
    eot_id: int
    no_timestamps_id: int
    max_initial_timestamp_index: int = 50  # 1.0 s


class TimestampState(NamedTuple):
    """Per-row carried state of the grammar, int64 [B] each."""

    last: torch.Tensor      # previous token (EOT if none yet)
    penult: torch.Tensor    # the token before that
    max_ts: torch.Tensor    # largest timestamp id generated (0 = none)


def init_state(batch: int, eot_id: int, device=None) -> TimestampState:
    z = torch.full((batch,), eot_id, dtype=torch.long, device=device)
    return TimestampState(last=z, penult=z.clone(),
                          max_ts=torch.zeros_like(z))


def apply_rules(logits: torch.Tensor, state: TimestampState, step,
                cfg: TimestampCfg) -> torch.Tensor:
    """The grammar's -inf mask applied to fp32 logits [B, V]; ``step`` is
    0 for the first generated token: a host int, or the loop's counter as
    a one-element integer tensor on the logits' device, which is never
    read on the host (a captured step runs every step)."""
    v = logits.shape[-1]
    col = torch.arange(v, device=logits.device)[None, :]
    tsb = cfg.timestamp_begin
    is_ts_col = col >= tsb
    is_text_col = col < cfg.eot_id

    ban = col == cfg.no_timestamps_id

    last_was = (state.last >= tsb)[:, None]
    pen_was = ((state.penult >= tsb) | (step < 2))[:, None]

    # Pair grammar (rule 2).
    ban = ban | (last_was & pen_was & is_ts_col)
    ban = ban | (last_was & ~pen_was & is_text_col)

    # Monotonic timestamps (rule 3): ban ts < bound, where the bound allows
    # equality only when closing a pair.
    closing = (last_was & ~pen_was)[:, 0]
    bound = torch.where(closing, state.max_ts, state.max_ts + 1)
    has_ts = (state.max_ts > 0)[:, None]
    ban = ban | (has_ts & is_ts_col & (col < bound[:, None]))

    # First token: a bounded timestamp (rule 4), EOT banned with the rest.
    first = (col < tsb) | (col > tsb + cfg.max_initial_timestamp_index)
    if isinstance(step, torch.Tensor):
        ban = ban | ((step == 0)[:, None] & first)
    elif step == 0:
        ban = ban | first
    logits = logits.masked_fill(ban, NEG_INF)

    # Probability-mass rule (5), HF's `logprobs[k, :timestamp_begin].max()`.
    logprobs = torch.log_softmax(logits, dim=-1)
    ts_mass = torch.logsumexp(logprobs.masked_fill(~is_ts_col, NEG_INF),
                              dim=-1)
    max_text = logprobs.masked_fill(is_ts_col, NEG_INF).amax(dim=-1)
    force_ts = (ts_mass > max_text)[:, None]
    return logits.masked_fill(force_ts & ~is_ts_col, NEG_INF)


def update_state(state: TimestampState, token: torch.Tensor,
                 cfg: TimestampCfg) -> TimestampState:
    """Advance the carried state after ``token`` [B] is chosen."""
    token = token.to(torch.long)
    new_max = torch.where(token >= cfg.timestamp_begin,
                          torch.maximum(state.max_ts, token), state.max_ts)
    return TimestampState(last=token, penult=state.last, max_ts=new_max)


def update_state_(state: TimestampState, token: torch.Tensor,
                  cfg: TimestampCfg) -> None:
    """``update_state`` in place, into the state's own tensors (the graphed
    loop's static state)."""
    new = update_state(state, token, cfg)
    state.penult.copy_(new.penult)
    state.max_ts.copy_(new.max_ts)
    state.last.copy_(new.last)


def gather_state_(state: TimestampState, rows: torch.Tensor) -> None:
    """Each row of the state takes row ``rows[r]``'s values, in place (a
    beam follows its parent in the graphed beam loop)."""
    for t in state:
        t.copy_(t.index_select(0, rows))


def render_timestamp(token_id: int, timestamp_begin: int) -> str:
    """<|x.xx|> text for a timestamp token (0.02 s per step)."""
    return f"<|{(token_id - timestamp_begin) * 0.02:.2f}|>"
