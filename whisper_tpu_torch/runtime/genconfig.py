"""Suppression lists of a model's generation_config.json (ref
src/main.rs:102-106, 650-657); empty lists when the model has none, exactly
like the reference.

A copy of ``GenerationCfg`` and ``load_generation_cfg`` from
``whisper_tpu.runtime.genconfig``, whose package ``__init__`` imports jax.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import List


@dataclass
class GenerationCfg:
    suppress_tokens: List[int] = field(default_factory=list)
    begin_suppress_tokens: List[int] = field(default_factory=list)


def load_generation_cfg(path: str) -> GenerationCfg:
    if not os.path.isfile(path):
        return GenerationCfg()
    with open(path) as f:
        data = json.load(f)
    return GenerationCfg(
        suppress_tokens=list(data.get("suppress_tokens") or []),
        begin_suppress_tokens=list(data.get("begin_suppress_tokens") or []),
    )
