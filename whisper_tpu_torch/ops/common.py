"""Shared helpers for the kernel modules (port of ``whisper_tpu.ops.common``).

The tanh-GELU constant is parity-sensitive: the fused encoder MLP (B2) and
its plain version must use this one definition.
"""

from __future__ import annotations

import threading

import torch

# Held by every wrapper while it adds one to its launch counter: the serving
# engine's lanes launch from several threads, and `+=` on a module global is
# a read and a write that two threads can interleave.
COUNT_LOCK = threading.Lock()

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
