"""Timing breakdown matching the reference's `Timing` struct (src/main.rs:1010-1016).

``load_s`` is measured by the caller (src/main.rs:1167-1170) and added to
``end_to_end_s`` when reporting (src/main.rs:1190); the fields here cover the
inside of a single long-form transcription call.

A copy of ``whisper_tpu.utils.timing``: this package imports nothing of
``whisper_tpu``, so that no import of it can reach jax.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Timing:
    preprocess_s: float = 0.0   # log-mel front end
    model_only_s: float = 0.0   # encoder forward + greedy token loop
    decode_s: float = 0.0       # detokenize + stitch
    end_to_end_s: float = 0.0   # whole transcription call
