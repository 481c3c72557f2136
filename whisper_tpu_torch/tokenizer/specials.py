"""Special-token ids for the decoder prompt (ref src/main.rs:528-569).

A copy of ``SpecialTokens`` and ``special_tokens`` from
``whisper_tpu.tokenizer.specials``: this package imports nothing of
``whisper_tpu``, so that no import of it can reach jax.  The tokenizer is
duck-typed: any object with ``token_to_id(str) -> int | None`` (for
example ``whisper_tpu.tokenizer.WhisperDetokenizer``) will do.
"""

from __future__ import annotations

from dataclasses import dataclass


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
