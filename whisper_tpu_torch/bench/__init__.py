"""bench of whisper_tpu_torch: the reference-compatible benchmark CLI
(``python -m whisper_tpu_torch.bench``) and its output writers."""

from whisper_tpu_torch.bench.writers import (
    build_summary,
    write_per_file_csv,
    write_per_file_json,
)

__all__ = ["write_per_file_csv", "write_per_file_json", "build_summary"]
