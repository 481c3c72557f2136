"""Decode-only byte-level BPE detokenizer (port of
``whisper_tpu.tokenizer.bpe``).

The reference uses the HF `tokenizers` crate purely for `decode(ids,
skip_special_tokens=true)` (ref src/main.rs:637-648).  This module
implements that decode direction directly from a HF ``tokenizer.json``
file: id -> token string -> byte-level unmap -> UTF-8, with no third-party
dependency.  ``encode_text`` (text -> ids, for ``--initial-prompt``) needs
the ``tokenizers`` package, imported when it is called.
"""

from __future__ import annotations

import functools
import json
from typing import Dict, List, Optional, Sequence


@functools.lru_cache(maxsize=1)
def _byte_decoder() -> Dict[str, int]:
    """Inverse of GPT-2's bytes_to_unicode map (public algorithm): printable
    unicode char (as used inside BPE token strings) -> original byte."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {chr(c): b for b, c in zip(bs, cs)}


class WhisperDetokenizer:
    """Loads a HF tokenizer.json and decodes token ids to text.

    Mirrors `Tokenizer::decode(ids, skip_special_tokens=true)` for byte-level
    BPE vocabularies (the only direction the pipeline needs, ref
    src/main.rs:637-648).
    """

    def __init__(self, vocab: Dict[str, int], added_tokens: List[dict]):
        size = max(
            max(vocab.values(), default=-1),
            max((t["id"] for t in added_tokens), default=-1),
        ) + 1
        self._tokens: List[Optional[str]] = [None] * size
        self._is_added = [False] * size
        self._is_special = [False] * size
        for tok, idx in vocab.items():
            self._tokens[idx] = tok
        for t in added_tokens:
            self._tokens[t["id"]] = t["content"]
            self._is_added[t["id"]] = True
            self._is_special[t["id"]] = bool(t.get("special", False))
        self._token_to_id = {t: i for i, t in enumerate(self._tokens) if t is not None}
        self._byte_dec = _byte_decoder()

    @classmethod
    def from_file(cls, path: str) -> "WhisperDetokenizer":
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        vocab = data.get("model", {}).get("vocab", {})
        added = data.get("added_tokens", []) or []
        return cls(vocab, added)

    def token_to_id(self, token: str) -> Optional[int]:
        """Lookup used for special-token resolution (ref src/main.rs:530-541)."""
        return self._token_to_id.get(token)

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True,
               timestamp_begin: Optional[int] = None) -> str:
        """Decode ids to text.  With `timestamp_begin`, ids at or above it
        render as ``<|x.xx|>`` markers (0.02 s per step) — Whisper timestamp
        tokens often live beyond the BPE vocab, like HF's
        decode_with_timestamps handles them."""
        parts: List[str] = []
        byte_buf = bytearray()

        def flush():
            if byte_buf:
                parts.append(byte_buf.decode("utf-8", errors="replace"))
                byte_buf.clear()

        for i in ids:
            if timestamp_begin is not None and i >= timestamp_begin:
                flush()
                parts.append(f"<|{(i - timestamp_begin) * 0.02:.2f}|>")
                continue
            if i < 0 or i >= len(self._tokens):
                continue
            tok = self._tokens[i]
            if tok is None:
                continue
            if self._is_added[i]:
                if self._is_special[i] and skip_special_tokens:
                    continue
                flush()
                parts.append(tok)
                continue
            for ch in tok:
                b = self._byte_dec.get(ch)
                if b is None:
                    # Not a byte-level char (shouldn't happen for Whisper
                    # vocabs); emit as-is.
                    flush()
                    parts.append(ch)
                else:
                    byte_buf.append(b)
        flush()
        return "".join(parts)


def encode_text(tokenizer_json: str, text: str) -> List[int]:
    """Encode free text to token ids for prompt conditioning
    (``--initial-prompt``, ``<|startofprev|>`` prefixes).  Encoding needs
    byte-level BPE merges and the GPT-2 pre-tokenizer, so this delegates to
    the ``tokenizers`` package, imported here (decoding stays
    dependency-free); a leading space is prepended as openai-whisper does
    for its initial prompt."""
    try:
        from tokenizers import Tokenizer
    except ImportError as e:
        raise RuntimeError(
            "--initial-prompt needs the `tokenizers` package to encode "
            "text (decoding stays dependency-free)"
        ) from e
    tok = Tokenizer.from_file(tokenizer_json)
    return list(tok.encode(" " + text.strip(), add_special_tokens=False).ids)
