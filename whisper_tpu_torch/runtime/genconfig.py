"""Suppression lists of a model's generation_config.json (ref
src/main.rs:102-106, 650-657); empty lists when the model has none, exactly
like the reference.

A copy of ``GenerationCfg`` from ``whisper_tpu.runtime.genconfig``, whose
package ``__init__`` imports jax.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List


@dataclass
class GenerationCfg:
    suppress_tokens: List[int] = field(default_factory=list)
    begin_suppress_tokens: List[int] = field(default_factory=list)
