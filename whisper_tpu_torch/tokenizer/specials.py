"""Special-token ids for the decoder prompt (ref src/main.rs:528-569) and
tokenizer-file discovery (ref src/main.rs:574-635).

A copy of ``SpecialTokens``, ``special_tokens`` and ``resolve_tokenizer``
from ``whisper_tpu.tokenizer.specials``: this package imports nothing of
``whisper_tpu``, so that no import of it can reach jax.  The tokenizer is
duck-typed: any object with ``token_to_id(str) -> int | None`` (for
example ``tokenizer.bpe.WhisperDetokenizer``) will do.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Tuple

from whisper_tpu_torch.tokenizer.bpe import WhisperDetokenizer


@dataclass(frozen=True)
class SpecialTokens:
    sot: int
    eot: int
    lang: int
    task: int
    no_timestamps: int
    # <|startofprev|>: previous-text conditioning prefix (sequential mode).
    sot_prev: int = 50361


def special_tokens(language: str, task: str, tokenizer) -> SpecialTokens:
    if tokenizer is not None:
        def get_id(t: str) -> int:
            i = tokenizer.token_to_id(t)
            if i is None:
                raise KeyError(f"Tokenizer missing token: {t}")
            return i

        sot_prev = tokenizer.token_to_id("<|startofprev|>")
        return SpecialTokens(
            sot=get_id("<|startoftranscript|>"),
            eot=get_id("<|endoftext|>"),
            lang=get_id(f"<|{language}|>"),
            task=get_id(f"<|{task}|>"),
            no_timestamps=get_id("<|notimestamps|>"),
            sot_prev=sot_prev if sot_prev is not None else 50361,
        )

    # Hardcoded multilingual fallback (ref src/main.rs:543-568).
    lang = {"en": 50259, "hi": 50276}.get(language, 50259)
    task_tok = {"transcribe": 50359, "translate": 50358}.get(task, 50359)
    return SpecialTokens(
        sot=50258, eot=50257, lang=lang, task=task_tok, no_timestamps=50363
    )


def resolve_tokenizer(
    tokenizer_json: str = "",
    model_dir: str = "",
    model_id: str = "",
) -> Optional[Tuple[WhisperDetokenizer, Path]]:
    """Find and load tokenizer.json with the reference's priority chain
    (ref src/main.rs:574-635). Returns (tokenizer, path) or None."""
    if tokenizer_json.strip():
        p = Path(tokenizer_json.strip())
        if not p.is_file():
            raise FileNotFoundError(f"tokenizer_json not found: {p}")
        return WhisperDetokenizer.from_file(str(p)), p

    # Empty strings are skipped: Path("")/"tokenizer.json" is the RELATIVE
    # path ./tokenizer.json, and a stray file in the CWD must not outrank
    # the documented chain (flag > model_dir > model_id > hub snapshot).
    for root in (model_dir, model_id):
        if not root.strip():
            continue
        cand = Path(root) / "tokenizer.json"
        if cand.is_file():
            return WhisperDetokenizer.from_file(str(cand)), cand

    # HF hub cache: newest snapshot containing tokenizer.json.
    if "/" in model_id:
        org, _, name = model_id.partition("/")
        if org and name:
            base = Path(os.environ.get("HF_HOME") or
                        Path(os.environ.get("HOME", ".")) / ".cache/huggingface")
            snaps = base / "hub" / f"models--{org}--{name}" / "snapshots"
            if snaps.is_dir():
                best: Optional[Tuple[float, Path]] = None
                for entry in snaps.iterdir():
                    p = entry / "tokenizer.json"
                    if p.is_file():
                        m = entry.stat().st_mtime
                        if best is None or m > best[0]:
                            best = (m, p)
                if best is not None:
                    return WhisperDetokenizer.from_file(str(best[1])), best[1]
    return None
