"""/usr/bin/time -v log parsing (elapsed wall clock + MaxRSS).

Same extraction contract as the reference's resource accounting
(compare_container_benchmarks.py:9-47): elapsed accepts h:mm:ss.ss, mm:ss.ss
or plain seconds; MaxRSS is reported in KB.

A copy of ``whisper_tpu.results.timelog`` (this package imports nothing of
``whisper_tpu``).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple


def parse_elapsed(raw: str) -> Optional[float]:
    raw = raw.strip()
    if not raw:
        return None
    try:
        fields = [float(p) for p in raw.split(":")]
    except ValueError:
        return None
    secs = 0.0
    for f in fields:
        secs = secs * 60.0 + f
    return secs


def parse_time_log(path: str) -> Tuple[Optional[float], Optional[int]]:
    """Returns (elapsed_seconds, max_rss_kb); (None, None) when absent."""
    if not os.path.isfile(path):
        return None, None
    elapsed, rss = None, None
    with open(path, encoding="utf-8", errors="ignore") as f:
        for line in f:
            if "Elapsed (wall clock) time" in line:
                # GNU time's label itself contains colons:
                # "Elapsed (wall clock) time (h:mm:ss or m:ss): 1:23.45"
                # (the reference splits on the first ':' and silently loses
                # the value, compare_container_benchmarks.py:38-40 — fixed
                # here by cutting after the label's closing paren).
                if ")" in line:
                    value = line.rpartition(")")[2].lstrip(": ")
                else:
                    value = line.split(":", 1)[1]
                elapsed = parse_elapsed(value)
            elif "Maximum resident set size" in line:
                try:
                    rss = int(line.split(":", 1)[1].strip())
                except ValueError:
                    pass
    return elapsed, rss
