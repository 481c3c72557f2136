"""Append-only results history — RESULTS.md marker sections + RESULTS.csv
rows, schema-identical to the reference's update_results_md.py:

- RESULTS.md gains/extends a ``<!-- RESULTS:{sut}:{cores}c:{mem}g START/END -->``
  block containing ``### Run <timestamp>`` entries with the summary table;
- RESULTS.csv appends one row per summary-table row with
  ``timestamp,sut_name,core_count,memory_gb,implementation,precision,
  beam_size,time_s,ram_mb``.

Run: python -m whisper_tpu_torch.results.accumulate --summary-table T --core-count N
     --memory-gb G [--sut-name S] [--summary-csv C]

A copy of ``whisper_tpu.results.accumulate`` (this package imports nothing
of ``whisper_tpu``).
"""

from __future__ import annotations

import argparse
import csv
import os
import sys
from datetime import datetime

RESULTS_CSV_FIELDS = [
    "timestamp", "sut_name", "core_count", "memory_gb",
    "implementation", "precision", "beam_size", "time_s", "ram_mb",
]


def merge_section(contents: str, marker_key: str, header: str,
                  entry: str) -> str:
    """Insert `entry` into the marker-delimited block for `marker_key`,
    creating block/header as needed (same merge rules as
    update_results_md.py:33-47)."""
    start = f"<!-- RESULTS:{marker_key} START -->"
    end = f"<!-- RESULTS:{marker_key} END -->"
    if start in contents and end in contents:
        pre, rest = contents.split(start, 1)
        body, post = rest.split(end, 1)
        body = body.strip()
        if header not in body:
            body = f"{header}\n\n{entry}\n{body}".strip()
        else:
            body = f"{body}\n\n{entry}".strip()
        return f"{pre}{start}\n{body}\n{end}{post}"
    block = f"{start}\n{header}\n\n{entry}\n{end}"
    return contents.rstrip() + "\n\n" + block + "\n"


def update_results_md(results_md: str, summary_table: str, sut_name: str,
                      core_count: int, memory_gb: int,
                      timestamp: str | None = None) -> str:
    timestamp = timestamp or datetime.now().isoformat(timespec="seconds")
    with open(summary_table, encoding="utf-8") as f:
        table_text = f.read().strip()

    contents = ""
    if os.path.isfile(results_md):
        with open(results_md, encoding="utf-8") as f:
            contents = f.read()
    if not contents.strip():
        contents = "# Results\n\n"

    marker_key = f"{sut_name}:{core_count}c:{memory_gb}g"
    header = f"## {sut_name} - {core_count} cores / {memory_gb}GB RAM"
    entry = f"### Run {timestamp}\n\n{table_text}\n"
    updated = merge_section(contents, marker_key, header, entry)
    with open(results_md, "w", encoding="utf-8") as f:
        f.write(updated)
    return timestamp


def append_results_csv(results_csv: str, summary_csv: str, timestamp: str,
                       sut_name: str, core_count: int, memory_gb: int) -> None:
    if not os.path.isfile(summary_csv):
        print(f"Missing summary CSV: {summary_csv}")
        return
    with open(summary_csv, newline="", encoding="utf-8") as f:
        rows = list(csv.DictReader(f))

    d = os.path.dirname(results_csv)
    if d:
        os.makedirs(d, exist_ok=True)
    write_header = not os.path.isfile(results_csv)
    with open(results_csv, "a", newline="", encoding="utf-8") as f:
        w = csv.DictWriter(f, fieldnames=RESULTS_CSV_FIELDS)
        if write_header:
            w.writeheader()
        for row in rows:
            w.writerow({
                "timestamp": timestamp,
                "sut_name": sut_name,
                "core_count": core_count,
                "memory_gb": memory_gb,
                **{k: row.get(k, "") for k in (
                    "implementation", "precision", "beam_size",
                    "time_s", "ram_mb",
                )},
            })


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--results-md", default="RESULTS.md")
    ap.add_argument("--summary-table", required=True)
    ap.add_argument("--summary-csv", default="")
    ap.add_argument("--sut-name", default="default")
    ap.add_argument("--core-count", type=int, required=True)
    ap.add_argument("--memory-gb", type=int, required=True)
    ap.add_argument("--results-csv", default="RESULTS.csv")
    args = ap.parse_args(argv)

    if not os.path.isfile(args.summary_table):
        raise SystemExit(f"Missing summary table: {args.summary_table}")
    ts = update_results_md(args.results_md, args.summary_table, args.sut_name,
                           args.core_count, args.memory_gb)
    print(f"Updated {args.results_md}")
    if args.summary_csv:
        append_results_csv(args.results_csv, args.summary_csv, ts,
                           args.sut_name, args.core_count, args.memory_gb)
    return 0


if __name__ == "__main__":
    sys.exit(main())
