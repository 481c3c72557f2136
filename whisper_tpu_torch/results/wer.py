"""Word/character error rate computation and per-file accuracy reports.

The reference lists WER/CER columns as unimplemented future work
(PLAN.md:6-7); this module implements them for this framework:
Levenshtein distance over words (WER) or characters (CER), with the usual
normalization (lowercase, punctuation stripped, whitespace collapsed).

Run: python -m whisper_tpu_torch.results.wer REF.json HYP.json
  (per-file JSON rows as written by the bench CLI; REF provides ground
   truth via its `text` fields — e.g. a run of a trusted SUT — and HYP is
   the run under evaluation)

A copy of ``whisper_tpu.results.wer`` (this package imports nothing of
``whisper_tpu``).
"""

from __future__ import annotations

import argparse
import json
import re
import string
import sys
from typing import Dict, List, Sequence


def normalize_text(text: str) -> str:
    text = text.lower()
    text = text.translate(str.maketrans("", "", string.punctuation))
    return re.sub(r"\s+", " ", text).strip()


def edit_distance(a: Sequence, b: Sequence) -> int:
    """Levenshtein distance, O(len(a)*len(b)) with O(min) memory."""
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, x in enumerate(a, 1):
        cur = [i]
        for j, y in enumerate(b, 1):
            cur.append(min(
                prev[j] + 1,          # deletion
                cur[j - 1] + 1,       # insertion
                prev[j - 1] + (x != y),  # substitution
            ))
        prev = cur
    return prev[-1]


def wer(ref: str, hyp: str) -> float:
    r = normalize_text(ref).split()
    h = normalize_text(hyp).split()
    if not r:
        return 0.0 if not h else 1.0
    return edit_distance(r, h) / len(r)


def cer(ref: str, hyp: str) -> float:
    r = normalize_text(ref).replace(" ", "")
    h = normalize_text(hyp).replace(" ", "")
    if not r:
        return 0.0 if not h else 1.0
    return edit_distance(r, h) / len(r)


def compare_files(ref_json: str, hyp_json: str) -> Dict:
    with open(ref_json, encoding="utf-8") as f:
        refs = {r["file"]: r["text"] for r in json.load(f)}
    with open(hyp_json, encoding="utf-8") as f:
        hyps = {r["file"]: r["text"] for r in json.load(f)}
    common = sorted(set(refs) & set(hyps))
    rows: List[Dict] = []
    total_w_err = total_w = total_c_err = total_c = 0
    for fn in common:
        r_words = normalize_text(refs[fn]).split()
        h_words = normalize_text(hyps[fn]).split()
        r_chars = normalize_text(refs[fn]).replace(" ", "")
        h_chars = normalize_text(hyps[fn]).replace(" ", "")
        we = edit_distance(r_words, h_words)
        ce = edit_distance(r_chars, h_chars)
        rows.append({
            "file": fn,
            "wer": we / len(r_words) if r_words else (0.0 if not h_words else 1.0),
            "cer": ce / len(r_chars) if r_chars else (0.0 if not h_chars else 1.0),
        })
        total_w_err += we
        total_w += len(r_words)
        total_c_err += ce
        total_c += len(r_chars)
    return {
        "n_files": len(common),
        "rows": rows,
        "wer": total_w_err / total_w if total_w else 0.0,
        "cer": total_c_err / total_c if total_c else 0.0,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("ref_json")
    ap.add_argument("hyp_json")
    args = ap.parse_args(argv)
    r = compare_files(args.ref_json, args.hyp_json)
    for row in r["rows"]:
        print(f"  {row['file']}: WER={row['wer']:.4f} CER={row['cer']:.4f}")
    print(f"overall ({r['n_files']} files): WER={r['wer']:.4f} CER={r['cer']:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
