"""B4, B6 and B7: decoder cross-attention against the int8 cross cache
(port of ``whisper_tpu.ops.cross_attention``): one token a call on the x5
and x4 decode paths, T tokens a call in the speculative verify pass.

``cross_attend_step`` replaces the JAX package's Pallas
``cross_attend_step_packed(int8_mxu=True)`` (``_kernel_int8_mxu``).  As
there, q is quantized per head (absmax/127, round half to even, clip
+-127) and the scales of q and of the layer's K are combined; in the port
the kernel does both itself, so the wrapper launches it and nothing else
(``quantize_q`` is the plain version's):

  scores = (q8 . K8 as int32) * (q_scale * k_scale[layer])
  e = exp(scores - max) over columns < s_valid
  p8 = round_half_even(127 * e)
  ctx = (p8 . V8 as int32) * (v_scale[layer] / (127 * sum e))

The port keeps the int8 cross cache in the prefill layout
[L, B, H, S, 64] for both K and V (the head-pair packing and transposed K
existed for Mosaic).  On a CUDA tensor it launches the hand-written
Hopper kernel ``csrc/cross_attention.cu`` (a cluster of blocks per head,
each a segment of the rows); on a CPU tensor it takes
``cross_attend_step_plain``.  Any other device raises.

``cross_attend_step_dequant`` (B6, rung x4) replaces
``cross_attend_step_packed(int8_mxu=False)`` (``_kernel``): the int8 K/V
are dequantized in the kernel, with fp32 scores times k_scale, an fp32
softmax normalized before the cast to bf16, each bf16 p * bf16(V8)
product rounded to bf16 and summed in fp32, then times v_scale.  On a
CUDA tensor it launches ``csrc/cross_attention_dequant.cu``; on a CPU
tensor it takes ``cross_attend_step_dequant_plain``.

``cross_attend_multi`` (B7) replaces ``cross_attend_multi_packed``
(``_kernel_multi_int8_mxu`` and ``_kernel_multi``): T queries per row
against one layer's K/V, read once for all of them.  Each query's output
is bit for bit what the single-token function gives for it (B4 with
``int8_mxu``, else B6), on the card and in the plain version alike: that is
what keeps speculative decoding equal to greedy decoding.  On a CUDA tensor
it launches ``csrc/cross_attention_multi.cu``; on a CPU tensor it takes
``cross_attend_multi_plain``.
"""

from __future__ import annotations

import sys

import torch

from whisper_tpu_torch.ops import kernels
from whisper_tpu_torch.ops.common import (
    check_operand,
    count_launch,
    div127,
    route,
)

launches = 0  # B4 kernel launches since the last reset (plain excluded)
dequant_launches = 0  # B6 kernel launches since the last reset
multi_launches = 0  # B7 launches (either kernel) since the last reset


def quantize_q(q: torch.Tensor):
    """Per-head symmetric int8 quantization of q [..., H, Dh] (the JAX
    wrapper's): returns (q8 int8, q_scale [..., H] fp32).  Both divisions
    are true fp32 divisions, as in the kernels (``cross_quantize_q``)."""
    q32 = q.float()
    absmax = q32.abs().amax(dim=-1, keepdim=True)
    qscale = div127(torch.clamp_min(absmax, 1e-12))
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
    b, h, dh = q.shape
    n_layers, s_max = k8.shape[0], k8.shape[3]
    if dh != 64 or q.dtype != torch.bfloat16:
        raise ValueError("cross_attend_step kernel needs bf16 q with "
                         f"head_dim 64, got {q.dtype} / {dh}")
    if not (0 <= layer < n_layers and 0 < s_valid <= s_max):
        raise ValueError(f"layer {layer} / s_valid {s_valid} outside the "
                         f"cache [{n_layers}, {s_max}]")
    check_operand("q", q, torch.bfloat16, (b, h, dh), q.device)
    # the kernel takes the whole scale tensors and reads one scale a block,
    # so a layer's slice need not lie on a 16-byte boundary (6 heads at
    # bucket 1)
    for name, x in (("k_scale", k_scale), ("v_scale", v_scale)):
        check_operand(name, x, torch.float32, (n_layers, b, h), q.device)
    for name, x in (("k8", k8), ("v8", v8)):
        check_operand(name, x, torch.int8, (n_layers, b, h, s_max, dh),
                      q.device)
    # this launch is the wrapper's only device operation: the kernel
    # quantizes q and combines the scales itself
    out = torch.empty_like(q)
    lib = kernels.library()
    kernels.check(lib.wt_cross_attend_step(
        q.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(), k8.data_ptr(),
        v8.data_ptr(), out.data_ptr(), b, h, s_max, int(layer), int(s_valid),
        kernels.stream_ptr(q.device)), "cross_attend_step")
    count_launch(sys.modules[__name__], launches=1)
    return out


def cross_attend_step_dequant_plain(q, k8, v8, k_scale, v_scale, layer: int,
                                    *, s_valid: int) -> torch.Tensor:
    """Reference version of B6, with the wrapper's arguments: the JAX
    ``_kernel``'s math in plain PyTorch.  The P.V products are taken in
    bf16 (in fp32 for an fp32 q, as there), each rounded, then summed in
    fp32."""
    k, v = k8[layer].float(), v8[layer]                           # [B,H,S,Dh]
    s_max = k.shape[2]
    scores = torch.matmul(k, q.float()[..., None])[..., 0]
    scores = scores * k_scale[layer].float()[..., None]           # [B, H, S]
    cols = torch.arange(s_max, device=q.device)
    scores = torch.where(cols < s_valid, scores,
                         torch.finfo(torch.float32).min)
    e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    probs = e / e.sum(dim=-1, keepdim=True)
    pv = torch.bfloat16 if q.dtype == torch.bfloat16 else torch.float32
    prod = probs.to(pv)[..., None] * v.to(pv)                     # rounded
    ctx = prod.float().sum(dim=-2)
    return (ctx * v_scale[layer].float()[..., None]).to(q.dtype)


def cross_attend_step_dequant(q: torch.Tensor, k8: torch.Tensor,
                              v8: torch.Tensor, k_scale: torch.Tensor,
                              v_scale: torch.Tensor, layer: int, *,
                              s_valid: int) -> torch.Tensor:
    """Single-token cross-attention against the int8 cache of one layer,
    dequantized in the kernel (rung x4).  Arguments as
    :func:`cross_attend_step`; the kernel reads q as it is (bf16)."""
    if route(q) == "plain":
        return cross_attend_step_dequant_plain(q, k8, v8, k_scale, v_scale,
                                               layer, s_valid=s_valid)
    b, h, dh = q.shape
    n_layers, s_max = k8.shape[0], k8.shape[3]
    if dh != 64 or q.dtype != torch.bfloat16:
        raise ValueError("cross_attend_step_dequant kernel needs bf16 q with "
                         f"head_dim 64, got {q.dtype} / {dh}")
    if not (0 <= layer < n_layers and 0 < s_valid <= s_max):
        raise ValueError(f"layer {layer} / s_valid {s_valid} outside the "
                         f"cache [{n_layers}, {s_max}]")
    check_operand("q", q, torch.bfloat16, (b, h, dh), q.device)
    for name, x in (("k_scale", k_scale), ("v_scale", v_scale)):
        check_operand(name, x, torch.float32, (n_layers, b, h), q.device)
    for name, x in (("k8", k8), ("v8", v8)):
        check_operand(name, x, torch.int8, (n_layers, b, h, s_max, dh),
                      q.device)
    out = torch.empty_like(q)
    lib = kernels.library()
    kernels.check(lib.wt_cross_attend_step_dequant(
        q.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(), k8.data_ptr(),
        v8.data_ptr(), out.data_ptr(), b, h, s_max, int(layer), int(s_valid),
        kernels.stream_ptr(q.device)), "cross_attend_step_dequant")
    count_launch(sys.modules[__name__], dequant_launches=1)
    return out


def cross_attend_multi_plain(q, k8, v8, k_scale, v_scale, layer: int, *,
                             s_valid: int,
                             int8_mxu: bool = False) -> torch.Tensor:
    """Reference version of B7, with the wrapper's arguments: the
    single-token plain version (B4's with int8_mxu, else B6's) applied to
    each of the T queries, so each query is bitwise what that function
    gives."""
    one = cross_attend_step_plain if int8_mxu \
        else cross_attend_step_dequant_plain
    return torch.stack([one(q[:, t], k8, v8, k_scale, v_scale, layer,
                            s_valid=s_valid) for t in range(q.shape[1])],
                       dim=1)


def cross_attend_multi(q: torch.Tensor, k8: torch.Tensor, v8: torch.Tensor,
                       k_scale: torch.Tensor, v_scale: torch.Tensor,
                       layer: int, *, s_valid: int,
                       int8_mxu: bool = False) -> torch.Tensor:
    """T-query cross-attention against the int8 cache of one layer (the
    speculative verify pass, T = draft_k + 1).

    q: [B, T, H, 64] (pre-scaled by 64^-0.5); k8, v8: [L, B, H, S, 64]
    int8; k_scale, v_scale: [L, B, H] fp32.  int8_mxu: both dots int8 x
    int8 with q quantized per (b, t, h) in the kernel (the x5 numerics),
    else the cache is dequantized in the kernel (x4).  Returns ctx [B, T, H, 64] in
    q's dtype.  T is any positive number."""
    if route(q) == "plain":
        return cross_attend_multi_plain(q, k8, v8, k_scale, v_scale, layer,
                                        s_valid=s_valid, int8_mxu=int8_mxu)
    b, t, h, dh = q.shape
    n_layers, s_max = k8.shape[0], k8.shape[3]
    if dh != 64 or q.dtype != torch.bfloat16:
        raise ValueError("cross_attend_multi kernel needs bf16 q with "
                         f"head_dim 64, got {q.dtype} / {dh}")
    if not (0 <= layer < n_layers and 0 < s_valid <= s_max and t >= 1):
        raise ValueError(f"layer {layer} / s_valid {s_valid} / T {t} outside "
                         f"the cache [{n_layers}, {s_max}]")
    check_operand("q", q, torch.bfloat16, (b, t, h, dh), q.device)
    for name, x in (("k_scale", k_scale), ("v_scale", v_scale)):
        check_operand(name, x, torch.float32, (n_layers, b, h), q.device)
    for name, x in (("k8", k8), ("v8", v8)):
        check_operand(name, x, torch.int8, (n_layers, b, h, s_max, dh),
                      q.device)
    out = torch.empty_like(q)
    lib = kernels.library()
    dims = (b, t, h, s_max, int(layer), int(s_valid),
            kernels.stream_ptr(q.device))
    # the int8 kernel quantizes each query per (b, t, h) itself
    entry = lib.wt_cross_attend_multi if int8_mxu \
        else lib.wt_cross_attend_multi_dequant
    kernels.check(entry(
        q.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(), k8.data_ptr(),
        v8.data_ptr(), out.data_ptr(), *dims),
        "cross_attend_multi" if int8_mxu else "cross_attend_multi_dequant")
    count_launch(sys.modules[__name__], multi_launches=1)
    return out


# ---------------------------------------------------------------------------
# Per-shard wrappers of a (data, model) mesh (``parallel.mesh``)
# ---------------------------------------------------------------------------

def cross_attend_step_sharded(q, k8, v8, k_scale, v_scale, layer: int, *,
                              s_valid: int, int8_mxu: bool = True, mesh,
                              heads: int) -> torch.Tensor:
    """B4 (int8_mxu) or B6 on this rank's shard: the counterpart of the
    JAX ``cross_attend_step_packed_sharded`` (``shard_map`` with the batch
    over "data" and head groups over "model").  The rank already holds its
    rows and heads [model_index * heads/tp, (model_index + 1) * heads/tp)
    of q and of the cross cache, so this checks the head count and runs the
    kernel (the plain version on a CPU tensor) on them; no collective."""
    from whisper_tpu_torch.parallel.mesh import check_heads

    check_heads(heads, q.shape[1], mesh, "cross_attend_step_sharded")
    step = cross_attend_step if int8_mxu else cross_attend_step_dequant
    return step(q, k8, v8, k_scale, v_scale, layer, s_valid=s_valid)


def cross_attend_multi_sharded(q, k8, v8, k_scale, v_scale, layer: int, *,
                               s_valid: int, int8_mxu: bool = False, mesh,
                               heads: int) -> torch.Tensor:
    """B7 on this rank's shard (the JAX
    ``cross_attend_multi_packed_sharded``), as
    ``cross_attend_step_sharded``; q is [B, T, H/tp, 64]."""
    from whisper_tpu_torch.parallel.mesh import check_heads

    check_heads(heads, q.shape[2], mesh, "cross_attend_multi_sharded")
    return cross_attend_multi(q, k8, v8, k_scale, v_scale, layer,
                              s_valid=s_valid, int8_mxu=int8_mxu)
