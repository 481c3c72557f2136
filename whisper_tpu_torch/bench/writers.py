"""Benchmark output writers — byte-compatible with the reference schemas.

Per-file CSV `file,duration_s,end_to_end_s,rtf,text` with {:.3}/{:.4}/{:.6}
formatting (ref src/main.rs:1216-1229), per-file JSON rows (ref :1232,
:1053-1060 incl. the same rounding), and the summary JSON with stat blocks,
breakdown, config echo and notes (ref :1235-1259).

A copy of ``whisper_tpu.bench.writers`` (the same rounding, column order
and key sets): this package imports nothing of ``whisper_tpu``.
"""

from __future__ import annotations

import csv
import json
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from whisper_tpu_torch.utils.stats import stat_block


@dataclass
class RowOut:
    """Per-file result row (ref src/main.rs:1053-1060) with the reference's
    rounding applied at construction (ref :1192-1199)."""

    file: str
    duration_s: float
    end_to_end_s: float
    rtf: float
    text: str
    # Word-level timestamps ({word,start,end} dicts) — present in the JSON
    # rows only behind --word-timestamps; the reference schema is unchanged
    # when the flag is off.
    words: Optional[List[Dict]] = None

    @classmethod
    def make(cls, file: str, duration_s: float, end_to_end_s: float,
             rtf: float, text: str, words: Optional[List[Dict]] = None
             ) -> "RowOut":
        return cls(
            file=file,
            duration_s=round(duration_s * 1000.0) / 1000.0,
            end_to_end_s=round(end_to_end_s * 10_000.0) / 10_000.0,
            rtf=round(rtf * 1_000_000.0) / 1_000_000.0,
            text=text,
            words=words,
        )

    def to_dict(self) -> Dict:
        d = {
            "file": self.file,
            "duration_s": self.duration_s,
            "end_to_end_s": self.end_to_end_s,
            "rtf": self.rtf,
            "text": self.text,
        }
        if self.words is not None:
            d["words"] = self.words
        return d


def write_per_file_csv(rows: Sequence[RowOut], path: str) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["file", "duration_s", "end_to_end_s", "rtf", "text"])
        for r in rows:
            w.writerow([
                r.file,
                f"{r.duration_s:.3f}",
                f"{r.end_to_end_s:.4f}",
                f"{r.rtf:.6f}",
                r.text,
            ])


def write_per_file_json(rows: Sequence[RowOut], path: str) -> None:
    with open(path, "w") as f:
        json.dump([r.to_dict() for r in rows], f, indent=2)


def write_summary_json(summary: Dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(summary, f, indent=2)


def build_summary(
    *,
    config_used: Dict,
    rows: Sequence[RowOut],
    end2end: List[float],
    load: List[float],
    preprocess: List[float],
    model_only: List[float],
    decode: List[float],
    rtf_end2end: List[float],
    model_id: str,
    onnx_dir: str,
    language: str,
    task: str,
    max_new_tokens: int,
    tokenizer_json: str,
    timestamps: bool,
    notes: Dict,
) -> Dict:
    """Summary dict with the reference's exact key set (ref src/main.rs:1235-1259)."""
    return {
        "config_used": config_used,
        "n_files": len(rows),
        "latency_end_to_end_s": stat_block(end2end),
        "breakdown_s": {
            "load_s": stat_block(load),
            "preprocess_s": stat_block(preprocess),
            "model_only_s": stat_block(model_only),
            "decode_s": stat_block(decode),
        },
        "rtf_end_to_end": stat_block(rtf_end2end),
        "model_id": model_id,
        "onnx_dir": onnx_dir,
        "language": language,
        "task": task,
        "max_new_tokens": max_new_tokens,
        "tokenizer_json": tokenizer_json,
        "timestamps": timestamps,
        "notes": notes,
    }
