"""Variant-quality diagnosis: teacher-forced logit deltas and argmax
margins (port of ``whisper_tpu.variants.diagnose``, the judge of the
port's rungs: every divergence at x2+ must be a tie-flip).

- ``teacher_forced_logits``: the fp32 logits a session assigns to every
  position of a given token sequence, through its own encoder, weights and
  int8 cross K/V in one prefill: the variant's numeric field along a fixed
  trajectory.
- ``divergence_report``: compares a variant's field with a reference's
  along the reference's own greedy chains and, at each realized decode
  divergence, reports the reference's argmax margin between its token and
  the variant's, the max |delta logit| over the (non-suppressed) vocab at
  that step, and the chain-wide max |delta logit|.

Tie-flip criterion: if the variant picked b where the reference picked a,
then lg_v[b] >= lg_v[a] implies lg_0[a] - lg_0[b] <= 2 * max|delta logit|
at the step; or the variant's teacher-forced field still prefers a by at
most ``KERNEL_EPS``, the gap the decode-step kernels' other order of
accumulation can close.  Anything past both bounds is drift.  The
constant and the rule are the JAX module's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

NEG = float("-inf")

# Decode-step kernels (packed int8 cross-attention, fused self-attention)
# accumulate in a different order than the prefill path used for
# teacher-forcing; a variant-field gap smaller than this can legitimately
# flip at decode time.  Scale: bf16 rounding on O(10) logits is ~0.04-0.1;
# observed step-vs-prefill deltas are below 0.15 (tests/test_parity_margins
# calibration run, 2026-08-17).
KERNEL_EPS = 0.25


def teacher_forced_logits(session, mel_chunk, tokens: Sequence[int]
                          ) -> np.ndarray:
    """fp32 logits [len(tokens), V] the session's variant assigns along
    ``tokens`` (prompt + generated), teacher-forced in ONE prefill pass.

    Runs the session's own encoder (``session.encoder``: its fused kernels,
    W8A8 at x6, the fused block) and its int8 cross K/V, so the field
    carries the variant's numeric path up to the decode-step kernels.
    Position i's row predicts token i+1.  mel_chunk: [n_mels, 3000], numpy
    or a tensor."""
    from whisper_tpu_torch.models import whisper

    dev = session.device
    enc = session.encoder(torch.as_tensor(mel_chunk).to(dev)[None])
    toks = session._token_tensor(tokens)[None]   # clamped, as in JAX
    logits, _ = whisper.decoder_prefill(
        session._decoder_params, session.dims, toks, enc,
        max_len=len(tokens) + 1, int8_cross_kv=session.cfg.int8_kv_cache,
        mesh=getattr(session, "mesh", None))
    return logits[0].float().cpu().numpy()


@dataclass
class StepDiag:
    round_idx: int
    step: int            # index into the round's generated chain
    x0_token: int
    var_token: int
    x0_margin: float     # lg0[x0_token] - lg0[var_token] (>= 0)
    var_margin: float    # lgv[x0_token] - lgv[var_token] (teacher-forced;
                         # <= 0 when the variant's own field already flips,
                         # small-positive when only its decode-step kernel
                         # numerics flip it)
    max_dlogit_step: float
    tie_flip: bool       # see KERNEL_EPS in divergence_report


@dataclass
class VariantDiag:
    name: str
    max_dlogit_chain: float   # over all steps/rounds, non-suppressed vocab
    p99_dlogit_chain: float
    median_x0_margin: float   # x0 top1-vs-top2 margin across all steps
    divergences: List[StepDiag]

    @property
    def all_tie_flips(self) -> bool:
        return all(d.tie_flip for d in self.divergences)


def _suppress(lg: np.ndarray, sup: set) -> np.ndarray:
    if not sup:
        return lg
    lg = lg.copy()
    lg[:, list(sup)] = NEG
    return lg


def divergence_report(
    name: str,
    sess_x0,
    sess_var,
    mel_x0: np.ndarray,
    mel_var: np.ndarray,
    prompt: Sequence[int],
    x0_rounds: List[List[int]],
    var_rounds: List[List[int]],
    eot_id: Optional[int] = None,
) -> VariantDiag:
    """Diagnose a variant's divergences from x0 along x0's greedy chains.

    mel_x0 / mel_var: each session's OWN [n_mels, 3000] chunk (the mel
    path is part of the variant's numerics).  x0_rounds / var_rounds: the
    actually-decoded chains per suppression round (scripts/parity_matrix.py
    semantics: round r suppresses all earlier rounds' tokens).
    """
    p = len(prompt)
    divs: List[StepDiag] = []
    d_max = 0.0
    d_all: List[float] = []
    margins: List[float] = []
    sup: set = set()
    for r, (c0, cv) in enumerate(zip(x0_rounds, var_rounds)):
        seq = list(prompt) + list(c0)
        lg0 = _suppress(teacher_forced_logits(sess_x0, mel_x0, seq), sup)
        lgv = _suppress(teacher_forced_logits(sess_var, mel_var, seq), sup)
        # positions p-1 .. p-1+len(c0)-1 predict chain tokens 0..len-1
        for i, tok0 in enumerate(c0):
            row0 = lg0[p - 1 + i]
            rowv = lgv[p - 1 + i]
            ok = np.isfinite(row0)
            d_step = float(np.max(np.abs(rowv[ok] - row0[ok])))
            d_all.append(d_step)
            d_max = max(d_max, d_step)
            srt = np.sort(row0[ok])
            margins.append(float(srt[-1] - srt[-2]))
            early_eot = i >= len(cv) and eot_id is not None
            if (i < len(cv) and cv[i] != tok0) or early_eot:
                tokv = int(eot_id) if early_eot else cv[i]
                margin = float(row0[tok0] - row0[tokv])
                vmargin = float(rowv[tok0] - rowv[tokv])
                # Tie-flip if (a) the variant's teacher-forced field itself
                # prefers tokv — then margin <= 2Δ holds by the triangle
                # inequality — or (b) the field still narrowly prefers tok0
                # (vmargin <= KERNEL_EPS) and the decode-STEP kernels
                # (packed int8 cross-attn vs the prefill path used for
                # teacher-forcing) tipped a near-tie with their different
                # accumulation order.  Anything past both bounds is drift.
                divs.append(StepDiag(
                    round_idx=r, step=i, x0_token=int(tok0),
                    var_token=int(tokv), x0_margin=margin,
                    var_margin=vmargin, max_dlogit_step=d_step,
                    tie_flip=(margin <= 2.0 * d_step + 1e-6
                              or vmargin <= KERNEL_EPS),
                ))
                break  # past the first divergence the trajectories differ
            if i >= len(cv):
                break
        else:
            # No divergence inside c0 — but a variant that keeps decoding
            # PAST x0's stop is drifting too: position p-1+len(c0) is
            # where x0 predicted EOT (the last teacher-forced row), and
            # the variant emitted cv[len(c0)] there instead.
            if (eot_id is not None and len(cv) > len(c0)
                    and (not divs or divs[-1].round_idx != r)):
                row0 = lg0[p - 1 + len(c0)]
                rowv = lgv[p - 1 + len(c0)]
                ok = np.isfinite(row0)
                d_step = float(np.max(np.abs(rowv[ok] - row0[ok])))
                tokv = int(cv[len(c0)])
                margin = float(row0[eot_id] - row0[tokv])
                vmargin = float(rowv[eot_id] - rowv[tokv])
                divs.append(StepDiag(
                    round_idx=r, step=len(c0), x0_token=int(eot_id),
                    var_token=tokv, x0_margin=margin,
                    var_margin=vmargin, max_dlogit_step=d_step,
                    tie_flip=(margin <= 2.0 * d_step + 1e-6
                              or vmargin <= KERNEL_EPS),
                ))
        sup.update(c0)
    return VariantDiag(
        name=name,
        max_dlogit_chain=d_max,
        p99_dlogit_chain=float(np.percentile(d_all, 99)) if d_all else 0.0,
        median_x0_margin=float(np.median(margins)) if margins else 0.0,
        divergences=divs,
    )
