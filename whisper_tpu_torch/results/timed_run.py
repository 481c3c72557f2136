"""GNU-time-compatible command runner.

The reference wraps every SUT in ``/usr/bin/time -v`` and parses the log
for wall clock + MaxRSS (scripts/run_container_benchmarks_inner.sh:65-69,
compare_container_benchmarks.py:32-47).  A host does not always ship GNU
time, so this wrapper runs a command and writes a log with the exact two
lines the parser needs, measured via ``resource.getrusage``.

Run: python -m whisper_tpu_torch.results.timed_run LOGFILE -- CMD [ARGS...]

A copy of ``whisper_tpu.results.timed_run`` (this package imports nothing
of ``whisper_tpu``).
"""

from __future__ import annotations

import resource
import subprocess
import sys
import time


def run_timed(log_path: str, cmd: list[str]) -> int:
    t0 = time.perf_counter()
    proc = subprocess.run(cmd)
    elapsed = time.perf_counter() - t0
    # ru_maxrss of children is reported in KB on Linux.
    rss_kb = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss

    m, s = divmod(elapsed, 60.0)
    h, m = divmod(int(m), 60)
    stamp = (f"{h}:{int(m):02d}:{s:05.2f}" if h else f"{int(m)}:{s:05.2f}")
    with open(log_path, "w") as f:
        f.write(f'\tCommand being timed: "{" ".join(cmd)}"\n')
        f.write(f"\tElapsed (wall clock) time (h:mm:ss or m:ss): {stamp}\n")
        f.write(f"\tMaximum resident set size (kbytes): {rss_kb}\n")
        f.write(f"\tExit status: {proc.returncode}\n")
    return proc.returncode


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 3 or argv[1] != "--":
        print(__doc__)
        return 2
    return run_timed(argv[0], argv[2:])


if __name__ == "__main__":
    sys.exit(main())
