"""The device a program of the port runs on, shared by the benchmark CLI
(``bench/cli.py``) and the servers (``serve/server.py``,
``serve/http_server.py``).

``device`` if the caller gives one, else the environment variable
``WHISPER_TPU_TORCH_DEVICE``, else the first CUDA card.  Without a card and
without a request for the CPU the program exits non-zero: nothing of the
port carries on on the CPU by itself.
"""

from __future__ import annotations

import os

DEVICE_ENV = "WHISPER_TPU_TORCH_DEVICE"


def resolve_device(device=None):
    """The device of the run (a ``torch.device``); raises SystemExit when a
    CUDA card is wanted and none is present."""
    import torch

    asked = device if device is not None else os.environ.get(DEVICE_ENV, "")
    if asked:
        dev = torch.device(asked)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise SystemExit(f"error: device {asked!r} was asked for and no "
                             "CUDA card is present")
        return dev
    if not torch.cuda.is_available():
        raise SystemExit(
            "error: no CUDA card is present (torch.cuda.is_available() is "
            f"false); to run on the CPU ask for it: {DEVICE_ENV}=cpu in the "
            "environment, or main(argv, device='cpu')")
    return torch.device("cuda")
