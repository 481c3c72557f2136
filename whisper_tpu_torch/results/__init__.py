"""results of whisper_tpu_torch: the reference's reporting tools over the
CLI's outputs (copies of ``whisper_tpu.results``; ``xplane.py`` is not
ported, ``torch.profiler`` takes its place): ``summarize``,
``accumulate``, ``compare``, ``wer``, ``timelog``, ``timed_run``."""

from whisper_tpu_torch.results.summarize import build_rows, write_summary_table
from whisper_tpu_torch.results.timelog import parse_time_log

__all__ = ["parse_time_log", "build_rows", "write_summary_table"]
