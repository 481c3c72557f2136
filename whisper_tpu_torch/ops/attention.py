"""B1: fused encoder self-attention (port of ``whisper_tpu.ops.attention``).

``fused_attention`` replaces the JAX package's Pallas ``fused_attention``
(``_attn_kernel``): unmasked multi-head attention over q/k/v
[B, H, T, 64] bf16 with q pre-scaled by 64^-0.5, fp32 scores and softmax,
probabilities cast to the q dtype, P.V accumulated in fp32 and written in
the q dtype.

On a CUDA tensor it launches the hand-written Hopper kernel
``csrc/attention.cu`` (TMA loads, ``wgmma`` for both products, the scores
and probabilities kept in registers; the source note there says what
bounds it and how the design answers); on a CPU tensor it takes ``fused_attention_plain``,
the same function in plain PyTorch.  Any other device raises.
"""

from __future__ import annotations

import torch

from whisper_tpu_torch.ops import kernels
from whisper_tpu_torch.ops.common import COUNT_LOCK, check_operand, route

launches = 0  # kernel launches since the last reset (plain calls excluded)


def fused_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """Reference version: the JAX kernel's math in plain PyTorch."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.matmul(probs.float(), v.float()).to(q.dtype)


def fused_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Full (unmasked) attention: q, k, v [B, H, T, Dh] -> [B, H, T, Dh].

    q must already be scaled by Dh^-0.5.  The kernel takes bf16, Dh = 64."""
    if route(q) == "plain":
        return fused_attention_plain(q, k, v)
    global launches
    b, h, t, dh = q.shape
    if dh != 64:
        raise ValueError(f"fused_attention kernel needs head_dim 64, got {dh}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        check_operand(name, x, torch.bfloat16, (b, h, t, dh), q.device)
    out = torch.empty_like(q)
    lib = kernels.library()
    kernels.check(lib.wt_fused_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h, t,
        kernels.stream_ptr(q.device)), "fused_attention")
    with COUNT_LOCK:
        launches += 1
    return out
