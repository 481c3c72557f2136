"""frontend of whisper_tpu_torch (see the package docstring)."""
