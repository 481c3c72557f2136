"""B4: one-token decoder cross-attention with int8 x int8 dots (port of
``whisper_tpu.ops.cross_attention``, x5 path).

``cross_attend_step`` replaces the JAX package's Pallas
``cross_attend_step_packed(int8_mxu=True)`` (``_kernel_int8_mxu``).  As
there, q is quantized per head in the wrapper (absmax/127, round half to
even, clip +-127) and the per-column scales for the layer are combined
outside the kernel:

  scores = (q8 . K8 as int32) * (q_scale * k_scale[layer])
  e = exp(scores - max) over columns < s_valid
  p8 = round_half_even(127 * e)
  ctx = (p8 . V8 as int32) * (v_scale[layer] / (127 * sum e))

The port keeps the int8 cross cache in the prefill layout
[L, B, H, S, 64] for both K and V (the head-pair packing and transposed K
existed for Mosaic).  On a CUDA tensor it launches the hand-written
Hopper kernel ``csrc/cross_attention.cu``; on a CPU tensor it takes
``cross_attend_step_plain``.  Any other device raises.
"""

from __future__ import annotations

import torch

from whisper_tpu_torch.ops import kernels
from whisper_tpu_torch.ops.common import check_operand, route

launches = 0  # kernel launches since the last reset (plain calls excluded)


def quantize_q(q: torch.Tensor):
    """Per-head symmetric int8 quantization of q [B, H, Dh] (the JAX
    wrapper's): returns (q8 int8, q_scale [B, H] fp32)."""
    q32 = q.float()
    absmax = q32.abs().amax(dim=-1, keepdim=True)
    qscale = torch.clamp_min(absmax, 1e-12) / 127.0
    q8 = torch.clamp(torch.round(q32 / qscale), -127, 127).to(torch.int8)
    return q8, qscale[..., 0]


def quantize_probs(e: torch.Tensor) -> torch.Tensor:
    """7-bit probabilities: round(127 * e), half to even like jnp.round.
    e = exp(s - max) lies in [0, 1], so the result fits int8."""
    return torch.round(e * 127.0).to(torch.int8)


def cross_attend_step_plain(q, k8, v8, k_scale, v_scale, layer: int, *,
                            s_valid: int) -> torch.Tensor:
    """Reference version, with the wrapper's arguments.  Both integer dots
    run in float64, which holds every partial sum exactly (P.V reaches
    127*127*1500 ~ 2.4e7, past fp32's 2^24); the int32 -> fp32 conversions
    then round exactly where the JAX kernel's do."""
    q8, qscale = quantize_q(q)
    qk_scale = qscale * k_scale[layer].float()                    # [B, H]
    k8, v8 = k8[layer], v8[layer]                                 # [B,H,S,Dh]
    s_max = k8.shape[2]
    dots = torch.matmul(k8.double(), q8.double()[..., None])[..., 0]
    scores = dots.float() * qk_scale[..., None]                   # [B, H, S]
    cols = torch.arange(s_max, device=q8.device)
    scores = torch.where(cols < s_valid, scores,
                         torch.finfo(torch.float32).min)
    e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    denom = e.sum(dim=-1, keepdim=True)                           # [B, H, 1]
    p8 = quantize_probs(e)
    ctx = torch.matmul(p8.double()[..., None, :], v8.double())[..., 0, :]
    scale = v_scale[layer].float()[..., None] / (127.0 * denom)
    return (ctx.float() * scale).to(q.dtype)


def cross_attend_step(q: torch.Tensor, k8: torch.Tensor, v8: torch.Tensor,
                      k_scale: torch.Tensor, v_scale: torch.Tensor,
                      layer: int, *, s_valid: int) -> torch.Tensor:
    """Single-token cross-attention against the int8 cache of one layer.

    q: [B, H, 64] (pre-scaled by 64^-0.5); k8, v8: [L, B, H, S, 64] int8;
    k_scale, v_scale: [L, B, H] fp32 per-head scales.  Returns ctx
    [B, H, 64] in q's dtype."""
    if route(q) == "plain":
        return cross_attend_step_plain(q, k8, v8, k_scale, v_scale, layer,
                                       s_valid=s_valid)
    global launches
    b, h, dh = q.shape
    n_layers, s_max = k8.shape[0], k8.shape[3]
    if dh != 64 or q.dtype != torch.bfloat16:
        raise ValueError("cross_attend_step kernel needs bf16 q with "
                         f"head_dim 64, got {q.dtype} / {dh}")
    if not (0 <= layer < n_layers and 0 < s_valid <= s_max):
        raise ValueError(f"layer {layer} / s_valid {s_valid} outside the "
                         f"cache [{n_layers}, {s_max}]")
    q8, qscale = quantize_q(q)
    qks = (qscale * k_scale[layer].float()).contiguous()
    vds = v_scale[layer].float().contiguous()
    check_operand("q8", q8, torch.int8, (b, h, dh), q.device)
    for name, x in (("qk_scale", qks), ("v_scale", vds)):
        check_operand(name, x, torch.float32, (b, h), q.device)
    for name, x in (("k8", k8), ("v8", v8)):
        check_operand(name, x, torch.int8, (n_layers, b, h, s_max, dh),
                      q.device)
    out = torch.empty_like(q)
    lib = kernels.library()
    kernels.check(lib.wt_cross_attend_step(
        q8.data_ptr(), qks.data_ptr(), vds.data_ptr(), k8.data_ptr(),
        v8.data_ptr(), out.data_ptr(), b, h, s_max, int(layer), int(s_valid),
        kernels.stream_ptr(q.device)), "cross_attend_step")
    launches += 1
    return out
