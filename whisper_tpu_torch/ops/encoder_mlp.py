"""B2: fused encoder MLP (port of ``whisper_tpu.ops.encoder_mlp``).

``fused_encoder_mlp`` replaces the JAX package's Pallas
``fused_encoder_mlp`` (``_mlp_kernel``) and, by design, its FFN-chunked
variant (``_fused_mlp_chunked``): x + FC2(GELU_tanh(FC1(LN(x)))) with LN
statistics in fp32 (eps 1e-5), fp32 accumulation, tanh GELU, bf16 out.
The weights arrive dense; int8 weights are dequantized by the caller.

On a CUDA tensor it launches the hand-written Hopper kernels of
``csrc/encoder_mlp.cu``: the LayerNorm, then the two products as tiled
``wgmma`` kernels fed by TMA (``csrc/gemm_sm90.cuh``) with bias + GELU and
bias + residual on the accumulators, one C call and no torch operation.
They take every width of ``KERNEL_WIDTHS``, so there is no VMEM-style
budget (no ``fits_vmem``/``chunk_plan``).  LN(x) [N, d] and the FFN's
hidden activations [N, f] pass through device memory as scratch of the
call: 123 MB at whisper-base bucket 16.  On a CPU tensor it takes
``fused_encoder_mlp_plain``.  Any other device raises.
"""

from __future__ import annotations

import torch

from whisper_tpu_torch.ops import kernels
from whisper_tpu_torch.ops.common import (
    COUNT_LOCK,
    check_operand,
    gelu_tanh,
    route,
)

LN_EPS = 1e-5
KERNEL_WIDTHS = (128, 384, 512, 768, 1024, 1280)  # d_model instantiations
F_CHUNK = 64  # a TMA box of the products: f must be a multiple

launches = 0  # kernel launches since the last reset (plain calls excluded)


def fused_encoder_mlp_plain(x, ln_s, ln_b, w1, b1, w2, b2) -> torch.Tensor:
    """Reference version: the JAX kernel's math in plain PyTorch."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = torch.square(x32 - mean).mean(dim=-1, keepdim=True)
    r = (x32 - mean) * torch.rsqrt(var + LN_EPS)
    r = (r * ln_s.float() + ln_b.float()).to(x.dtype)
    h = torch.matmul(r.float(), w1.float()) + b1.float()
    h = gelu_tanh(h).to(x.dtype)
    y = torch.matmul(h.float(), w2.float()) + b2.float()
    return (x32 + y).to(x.dtype)


def fused_encoder_mlp(x: torch.Tensor, ln_s: torch.Tensor, ln_b: torch.Tensor,
                      w1: torch.Tensor, b1: torch.Tensor,
                      w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """x [B, T, d] -> x + FC2(GELU_tanh(FC1(LN(x)))); w1 [d, f], w2 [f, d]."""
    if route(x) == "plain":
        return fused_encoder_mlp_plain(x, ln_s, ln_b, w1, b1, w2, b2)
    global launches
    b, t, d = x.shape
    f = w1.shape[1]
    if d not in KERNEL_WIDTHS or f % F_CHUNK:
        raise ValueError(f"fused_encoder_mlp kernel: d={d} not in "
                         f"{KERNEL_WIDTHS} or f={f} not a multiple of "
                         f"{F_CHUNK}")
    bf = torch.bfloat16
    check_operand("x", x, bf, (b, t, d), x.device)
    for name, a, shape in (("ln_s", ln_s, (d,)), ("ln_b", ln_b, (d,)),
                           ("w1", w1, (d, f)), ("b1", b1, (f,)),
                           ("w2", w2, (f, d)), ("b2", b2, (d,))):
        check_operand(name, a, bf, shape, x.device)
    out = torch.empty_like(x)
    # scratch of this call (the CLI's prefetch thread may be inside another)
    r = torch.empty_like(x)
    h = torch.empty((b * t, f), dtype=bf, device=x.device)
    lib = kernels.library()
    kernels.check(lib.wt_fused_encoder_mlp(
        x.data_ptr(), ln_s.data_ptr(), ln_b.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), r.data_ptr(),
        h.data_ptr(), out.data_ptr(), b * t, d, f,
        kernels.stream_ptr(x.device)), "fused_encoder_mlp")
    with COUNT_LOCK:
        launches += 1
    return out
