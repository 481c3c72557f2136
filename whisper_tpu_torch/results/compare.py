"""Cross-SUT comparison + parity checking.

Two reference tools re-imagined for this framework:

- ``stats`` (analog of compare_end_to_end_latencies.py:31-60): print the
  ``latency_end_to_end_s`` stat line of each given inference_summary.json.
- ``parity`` (analog of compare_latencies.py:48-89, upgraded per SURVEY.md
  §2.2 P9 into a transcript-parity checker): given two per-file JSONs
  (reference SUT vs TPU SUT), print side-by-side latency stats, per-file
  latency/rtf deltas, and per-file transcript equality — the operational
  check behind the "token-for-token vs fp32 reference" contract.

Run:
  python -m whisper_tpu_torch.results.compare stats S1.json S2.json ...
  python -m whisper_tpu_torch.results.compare parity REF.json TPU.json

A copy of ``whisper_tpu.results.compare`` (this package imports nothing of
``whisper_tpu``): its keys and report keep the "tpu" names of the run under
test.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List

from whisper_tpu_torch.utils.stats import stat_block


def _fmt_stats(block: Dict[str, float]) -> str:
    return (
        f"min={block['min']:.3f} median={block['median']:.3f} "
        f"p90={block['p90']:.3f} p95={block['p95']:.3f} "
        f"max={block['max']:.3f} mean={block['mean']:.3f}"
    )


def print_summary_stats(paths: List[str]) -> None:
    for path in paths:
        label = os.path.basename(os.path.dirname(path)) or path
        if not os.path.isfile(path):
            print(f"{label}: (missing: {path})")
            continue
        with open(path, encoding="utf-8") as f:
            summary = json.load(f)
        block = summary.get("latency_end_to_end_s") or {}
        if not block:
            print(f"{label}: (no latency_end_to_end_s)")
            continue
        print(f"{label}: {_fmt_stats(block)}")


def compare_per_file(ref_json: str, tpu_json: str) -> Dict:
    """Returns {n_files, n_text_match, mismatches, e2e stats, deltas}."""
    with open(ref_json, encoding="utf-8") as f:
        ref_rows = {r["file"]: r for r in json.load(f)}
    with open(tpu_json, encoding="utf-8") as f:
        tpu_rows = {r["file"]: r for r in json.load(f)}

    common = sorted(set(ref_rows) & set(tpu_rows))
    deltas = []
    mismatches = []
    for fn in common:
        a, b = ref_rows[fn], tpu_rows[fn]
        deltas.append({
            "file": fn,
            "d_end_to_end_s": b["end_to_end_s"] - a["end_to_end_s"],
            "d_rtf": b["rtf"] - a["rtf"],
            "text_match": a["text"].strip() == b["text"].strip(),
        })
        if not deltas[-1]["text_match"]:
            mismatches.append(fn)
    return {
        "n_files": len(common),
        "only_in_ref": sorted(set(ref_rows) - set(tpu_rows)),
        "only_in_tpu": sorted(set(tpu_rows) - set(ref_rows)),
        "n_text_match": len(common) - len(mismatches),
        "mismatched_files": mismatches,
        "ref_e2e": stat_block([ref_rows[f]["end_to_end_s"] for f in common]),
        "tpu_e2e": stat_block([tpu_rows[f]["end_to_end_s"] for f in common]),
        "deltas": deltas,
    }


def print_parity(ref_json: str, tpu_json: str) -> int:
    """Prints the parity report; returns exit code (1 on text mismatch)."""
    r = compare_per_file(ref_json, tpu_json)
    print(f"files compared: {r['n_files']}")
    if r["only_in_ref"] or r["only_in_tpu"]:
        print(f"  only in ref: {r['only_in_ref']}")
        print(f"  only in tpu: {r['only_in_tpu']}")
    print(f"ref  e2e: {_fmt_stats(r['ref_e2e'])}")
    print(f"tpu  e2e: {_fmt_stats(r['tpu_e2e'])}")
    print("per-file deltas (tpu - ref):")
    for d in r["deltas"]:
        mark = "OK " if d["text_match"] else "DIFF"
        print(f"  [{mark}] {d['file']}: d_e2e={d['d_end_to_end_s']:+.4f}s "
              f"d_rtf={d['d_rtf']:+.6f}")
    print(f"transcript parity: {r['n_text_match']}/{r['n_files']}")
    if r["mismatched_files"]:
        print(f"MISMATCHED: {r['mismatched_files']}")
        return 1
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_stats = sub.add_parser("stats", help="print e2e stat lines")
    p_stats.add_argument("summaries", nargs="+")
    p_par = sub.add_parser("parity", help="per-file latency + transcript parity")
    p_par.add_argument("ref_json")
    p_par.add_argument("tpu_json")
    args = ap.parse_args(argv)

    if args.cmd == "stats":
        print_summary_stats(args.summaries)
        return 0
    return print_parity(args.ref_json, args.tpu_json)


if __name__ == "__main__":
    sys.exit(main())
