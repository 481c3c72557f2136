"""Shared helpers for the kernel modules (port of ``whisper_tpu.ops.common``).

The tanh-GELU constant is parity-sensitive: the fused encoder MLP (B2) and
its plain version must use this one definition.
"""

from __future__ import annotations

import contextlib
import threading

import torch

# Held by every wrapper while it adds one to its launch counter: the serving
# engine's lanes launch from several threads, and `+=` on a module global is
# a read and a write that two threads can interleave.
COUNT_LOCK = threading.Lock()
# The launches a thread records while it captures a CUDA graph (None when
# it captures nothing): a capture launches nothing, each launch of the graph
# does.
_TALLY = threading.local()


def count_launch(module, **counts) -> None:
    """Add ``counts`` to the launch counters of the wrapper's ``module``
    (``launches=1``, ...), under ``COUNT_LOCK``.  While this thread
    captures a CUDA graph (``tally_launches``) they are tallied instead."""
    tally = getattr(_TALLY, "counts", None)
    with COUNT_LOCK:
        for name, n in counts.items():
            if tally is not None:
                tally[(module, name)] = tally.get((module, name), 0) + int(n)
            else:
                setattr(module, name, getattr(module, name) + int(n))


@contextlib.contextmanager
def tally_launches():
    """Within the block, this thread's wrappers tally their launches into
    the dict yielded, {(module, counter): n}, and leave the counters as
    they are: a CUDA graph's capture.  A decode loop's graph holds its
    step as the body of a while node that runs it until every row is done,
    so a launch adds the tally once a body that ran: ``defer_launches``
    notes the device count of bodies run, and ``settle_launches`` adds
    tally x count where the caller copies the results to the host (so an
    ``_async`` form reads nothing).  A block within another tallies into
    its own dict, and the outer block's takes the launches before and
    after it (a while node's body within its graph's program)."""
    outer = getattr(_TALLY, "counts", None)
    _TALLY.counts = {}
    try:
        yield _TALLY.counts
    finally:
        _TALLY.counts = outer


def add_launches(tally: dict, times: int = 1) -> None:
    """Add ``times`` x a tally of ``tally_launches`` to the counters, under
    the lock."""
    with COUNT_LOCK:
        for (module, name), n in tally.items():
            setattr(module, name, getattr(module, name) + n * times)


# (tally, the count of bodies run copied to the host, an event after the
# copy), in the order the runs were queued
_PENDING: list = []


def defer_launches(tally: dict, runs: torch.Tensor) -> None:
    """Note that ``runs`` (a one-element integer tensor on the card,
    computed by work queued on the current stream) bodies of a graph whose
    capture tallied ``tally`` ran.  Nothing waits: the count is copied to
    pinned host memory behind that work and an event recorded after the
    copy.  The runs whose copy has landed are added at once, so the list
    holds only runs still on the card."""
    if not tally:
        return
    host = runs.reshape(1).to("cpu", non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    with COUNT_LOCK:
        _PENDING.append((tally, host, event))
    settle_launches()


def settle_launches(wait: bool = False) -> None:
    """Add the launches of every deferred run whose count has reached the
    host (``defer_launches``); with ``wait``, wait for all of them first.
    Called after a copy of results to the host, which waited for its own
    runs: a later run still on the card stays deferred, so the caller
    never waits for another caller's work.  Reads only host memory."""
    with COUNT_LOCK:
        ready = [p for p in _PENDING if wait or p[2].query()]
        for p in ready:
            _PENDING.remove(p)
    for tally, host, event in ready:
        event.synchronize()
        add_launches(tally, int(host[0]))


SQRT_2_OVER_PI = 0.7978845608028654


def round_up(x: int, m: int) -> int:
    """Smallest multiple of ``m`` that is >= ``x``."""
    return ((x + m - 1) // m) * m


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximation GELU, the form the JAX package's fused kernels use
    (the unfused encoder and decoder blocks use exact erf GELU)."""
    return 0.5 * x * (
        1.0 + torch.tanh(SQRT_2_OVER_PI * (x + 0.044715 * x * x * x))
    )


def div127(x: torch.Tensor) -> torch.Tensor:
    """x / 127 as a true fp32 division, the int8 scale of a row or a head.
    On a CUDA tensor PyTorch turns a division by a Python number into a
    product with its reciprocal, which differs in the last place from the
    division the kernels and the CPU do; a tensor divisor is divided by."""
    return x / torch.full_like(x, 127.0)


def disable_tf32() -> None:
    """Run fp32 matmuls and convolutions in full fp32 on the card.

    cuDNN convolutions default to TF32, which would run the x0 encoder
    conv stem at ~3 decimal digits and break fp32 parity with the JAX
    package; the front end's DFT matmuls need full fp32 at every rung."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def check_operand(name: str, t: torch.Tensor, dtype: torch.dtype,
                  shape: tuple, device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` whose data lies on a 16-byte boundary, what a kernel of this
    package reads in vectors."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer not 16-byte aligned")


def route(t: torch.Tensor) -> str:
    """'plain' for a CPU tensor, 'kernel' for a CUDA tensor; anything else
    raises.  A CUDA tensor never takes the plain version."""
    if t.device.type == "cpu":
        return "plain"
    if t.device.type == "cuda":
        return "kernel"
    raise ValueError(f"no kernel for device {t.device}")
