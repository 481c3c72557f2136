"""Language detection: the softmax over the language tokens after
<|startoftranscript|> (port of ``whisper_tpu.runtime.langdetect``).

The encoder runs on the first 30 s window, then the decoder prefill of just
``[sot]``; the probability the model gives each language token at the next
position decides (openai-whisper's and faster-whisper's
``detect_language``).  Language-token ids come from the tokenizer (every
added token of the form ``<|xx|>`` that is not a task or control token), or
from the standard multilingual layout ``sot+1 .. sot+99`` without one.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from whisper_tpu_torch.models import whisper

_NON_LANG = {"startoftranscript", "endoftext", "translate", "transcribe",
             "notimestamps", "nospeech", "nocaptions", "startoflm",
             "startofprev"}
_LANG_RE = re.compile(r"^<\|([a-z]{2,3})\|>$")


def language_token_ids(tokenizer, sot: int, vocab_size: int) -> Dict[int, str]:
    """{token_id: language_code} for all language tokens."""
    if tokenizer is not None:
        out = {}
        for tid in range(vocab_size):
            tok = tokenizer._tokens[tid] if tid < len(tokenizer._tokens) else None
            if not tok:
                continue
            m = _LANG_RE.match(tok)
            if m and m.group(1) not in _NON_LANG:
                out[tid] = m.group(1)
        if out:
            return out
    # Standard multilingual layout: 99 languages right after <|sot|>.
    return {sot + 1 + i: f"lang_{i}" for i in range(99)
            if sot + 1 + i < vocab_size}


def _plain_encoder_tree(session) -> Dict:
    """The session's encoder weights as the unfused encoder reads them:
    a fused-block session holds [q_w | k_w | v_w] as one ``qkv_w`` (built
    from the dequantized weights, ``whisper.fused_qkv``), so its slices are
    the weights themselves.  int8 leaves kept for W8A8 (x6) stay QTensors:
    ``_dense`` dequantizes them when it is not asked for W8A8."""
    tree = session.encoder.tree()
    blocks = tree["blocks"]
    if "qkv_w" in blocks:
        blocks = dict(blocks)
        w, bias = blocks.pop("qkv_w"), blocks.pop("qkv_b")
        d = w.shape[-1] // 3
        blocks.update(q_w=w[..., :d], k_w=w[..., d:2 * d], v_w=w[..., 2 * d:],
                      q_b=bias[..., :d], v_b=bias[..., 2 * d:])
        tree = dict(tree, blocks=blocks)
    return tree


def detect_language(session, mel_chunk: torch.Tensor, sot: int,
                    lang_ids: Dict[int, str]
                    ) -> Optional[Tuple[str, int, float]]:
    """(language_code, lang_token_id, probability) for a first-window mel
    [n_mels, <= 3000] on the session's device, or None when the vocabulary
    has no language tokens.  The encoder takes the JAX call's flags:
    ``fused_attention`` only (B1 at x3+), no fused MLP, no fused block and
    no W8A8."""
    if not lang_ids:
        return None
    dims = session.dims
    enc = whisper.encoder_apply(
        {"encoder": _plain_encoder_tree(session)}, dims,
        mel_chunk.to(session.device)[None],
        fused_attention=session.cfg.fused_attention,
        mesh=getattr(session, "mesh", None))
    tokens = torch.full((1, 1), sot, dtype=torch.long, device=session.device)
    logits, _ = whisper.decoder_prefill(session._decoder_params, dims, tokens,
                                        enc, max_len=2,
                                        mesh=getattr(session, "mesh", None))
    probs = torch.softmax(logits[0, -1, :].float(), dim=-1).cpu().numpy()
    ids = np.asarray(sorted(lang_ids), dtype=np.int64)
    lang_probs = probs[ids]
    best = int(ids[int(lang_probs.argmax())])
    # renormalize over the language tokens, like openai-whisper
    p = float(lang_probs.max() / max(lang_probs.sum(), 1e-12))
    return lang_ids[best], best, p
