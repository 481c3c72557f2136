"""Latency statistics matching the reference's stat contract.

The reference computes a linear-interpolated percentile
(src/main.rs:1021-1031) and a stat block of min/median/p90/p95/max/mean
(src/main.rs:1033-1048) where the median is the *upper* median ``v[len/2]``
(not interpolated).  The summary-JSON schema depends on these exact keys and
semantics, so they are reproduced here.

Note the reference repo contains a second, different percentile
implementation (benchmark_with_hf_pipeline.py:21-30); per SURVEY.md §7 we
standardize on the linear-interpolated one everywhere.

A copy of ``whisper_tpu.utils.stats``: this package imports nothing of
``whisper_tpu``.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence


def percentile(xs: Sequence[float], p: float) -> float:
    """Linear-interpolated percentile (ref src/main.rs:1021-1031)."""
    if not xs:
        return math.nan
    v = sorted(xs)
    k = (len(v) - 1) * (p / 100.0)
    f = math.floor(k)
    c = math.ceil(k)
    if f == c:
        return v[int(k)]
    return v[f] + (v[c] - v[f]) * (k - f)


def stat_block(xs: Sequence[float]) -> Dict[str, float]:
    """min/median/p90/p95/max/mean block (ref src/main.rs:1033-1048).

    median is the upper median ``v[len/2]`` to match the reference exactly.
    """
    v = sorted(xs)
    if not v:
        nan = math.nan
        return {"min": nan, "median": nan, "p90": nan, "p95": nan, "max": nan, "mean": nan}
    return {
        "min": v[0],
        "median": v[len(v) // 2],
        "p90": percentile(xs, 90.0),
        "p95": percentile(xs, 95.0),
        "max": v[-1],
        "mean": sum(v) / len(v),
    }
