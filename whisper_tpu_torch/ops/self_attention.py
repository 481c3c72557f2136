"""B3 and B8: one-token decoder self-attention with an in-place cache
insert (port of ``whisper_tpu.ops.self_attention``).

``self_attend_step`` replaces the JAX package's Pallas
``self_attend_step_packed`` (``_kernel``).  The JAX kernel donates its
head-packed cache through ``input_output_aliases``; this port keeps the
prefill layout [L, B, H, S, 64] and writes row ``pos`` of layer ``layer``
IN PLACE, in the kernel and in the plain version alike, so the caller's
cache tensors are the updated cache.

On a CUDA tensor it launches the hand-written Hopper kernel
``csrc/self_attention.cu`` and puts nothing else on the card; on a CPU
tensor it takes ``self_attend_step_plain``.  Any other device raises.
``pos`` is an int or a one-element int32 tensor on q's device: the kernel
reads the tensor itself (the JAX kernel's scalar prefetch), so the wrapper
does not wait for the card and every step of a decode loop is the same
launch.

``self_attend_step_int8`` (B8, rung x7) replaces
``self_attend_step_packed_int8`` (``_kernel_int8``): the same step against
an int8 self cache with one fp32 scale per cached row
(``quantize_self_cache``, the port's ``quantize_pack_self``).  q, k_new and
v_new arrive in bf16 and are quantized per head inside the kernel; the
int8 row and its two scales are inserted in place and attended in the same
call:

  scale = max(absmax, 1e-12) / 127;  x8 = clip(rint(x / scale), +-127)
  scores = (q8 . K8 as int32) * q_scale * k_scale[row]
  e = exp(scores - max) over rows [pad_count[b], pos];  denom = sum e
  p = e * v_scale[row];  ps = max(max p, 1e-30) / 127;  p8 = rint(p / ps)
  ctx = (p8 . V8 as int32) * (ps / denom)

The cache keeps the prefill layout, [L, B, H, S, 64] int8 with
[L, B, H, S] fp32 scale planes (no head packing, no padding of S).  On a
CUDA tensor it launches ``csrc/self_attention_int8.cu`` and puts nothing
else on the card; on a CPU tensor it takes ``self_attend_step_int8_plain``.
``pos`` and ``pad_count`` are taken as by ``self_attend_step``.
"""

from __future__ import annotations

import torch

from whisper_tpu_torch.ops import kernels
from whisper_tpu_torch.ops.common import (
    COUNT_LOCK,
    check_operand,
    div127,
    route,
)

launches = 0  # B3 kernel launches since the last reset (plain excluded)
int8_launches = 0  # B8 kernel launches since the last reset
# Of those, the launches given a pad_count (a left-padded conditioned prompt)
padded_launches = 0
int8_padded_launches = 0


def self_attend_step_plain(q, k_new, v_new, k_cache, v_cache, layer: int,
                           pos, pad_count=None) -> torch.Tensor:
    """Reference version: the JAX kernel's math in plain PyTorch (q widened
    to fp32, fp32 scores and softmax over rows [pad_count[b], pos], each
    p*v product rounded to the cache dtype before the fp32 sum).  ``pos``:
    an int or a one-element integer tensor, which is read here."""
    b, h, s_max = k_cache.shape[1], k_cache.shape[2], k_cache.shape[3]
    pos = int(pos)
    k_cache[layer, :, :, pos] = k_new.to(k_cache.dtype)
    v_cache[layer, :, :, pos] = v_new.to(v_cache.dtype)
    k = k_cache[layer]                                     # [B, H, S, Dh]
    v = v_cache[layer]
    scores = torch.matmul(k.float(), q.float()[..., None])[..., 0]  # [B,H,S]
    rows = torch.arange(s_max, device=q.device)
    pads = (torch.zeros(b, dtype=torch.int32, device=q.device)
            if pad_count is None else pad_count)
    valid = (rows[None, :] <= pos) & (rows[None, :] >= pads[:, None])
    scores = torch.where(valid[:, None, :], scores,
                         torch.finfo(torch.float32).min)
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    probs = e / e.sum(dim=-1, keepdim=True)
    pv_dtype = torch.bfloat16 if q.dtype == torch.bfloat16 else torch.float32
    prod = probs.to(pv_dtype)[..., None] * v.to(pv_dtype)  # [B, H, S, Dh]
    return prod.float().sum(dim=-2).to(q.dtype)


def _pos_args(pos, q: torch.Tensor, n_layers: int, s_max: int, layer: int):
    """(pos, pos_ptr) for a kernel: an int checked here, or a one-element
    int32 tensor on q's device passed by its pointer (pos -1), which the
    kernel reads."""
    pos_ptr = None
    if isinstance(pos, torch.Tensor):
        if (pos.device != q.device or pos.dtype != torch.int32
                or pos.numel() != 1):
            raise ValueError("pos: a tensor must hold one int32 on "
                             f"{q.device}, got {pos.dtype} "
                             f"{tuple(pos.shape)} on {pos.device}")
        pos_ptr, pos = pos.data_ptr(), -1
    elif not 0 <= pos < s_max:
        raise ValueError(f"pos {pos} outside the cache [{n_layers}, {s_max}]")
    if not 0 <= layer < n_layers:
        raise ValueError(f"layer {layer} outside the cache "
                         f"[{n_layers}, {s_max}]")
    return int(pos), pos_ptr


def self_attend_step(q: torch.Tensor, k_new: torch.Tensor,
                     v_new: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, layer: int, pos,
                     pad_count=None) -> torch.Tensor:
    """One self-attention decode step against (and into) the cache.

    q, k_new, v_new: [B, H, 64] (q pre-scaled by 64^-0.5);
    k_cache, v_cache: [L, B, H, S, 64], row ``pos`` of ``layer`` is
    overwritten in place; pos: an int, checked here, or a one-element int32
    tensor on q's device, read by the kernel (outside [0, S) it writes no
    cache row and returns NaN); pad_count: [B] int32 left-pad slots or None.
    Returns ctx [B, H, 64] in q's dtype."""
    if route(q) == "plain":
        return self_attend_step_plain(q, k_new, v_new, k_cache, v_cache,
                                      layer, pos, pad_count)
    global launches, padded_launches
    b, h, dh = q.shape
    n_layers, s_max = k_cache.shape[0], k_cache.shape[3]
    if dh != 64:
        raise ValueError(f"self_attend_step kernel needs head_dim 64, got {dh}")
    pos, pos_ptr = _pos_args(pos, q, n_layers, s_max, layer)
    bf = torch.bfloat16
    for name, x in (("q", q), ("k_new", k_new), ("v_new", v_new)):
        check_operand(name, x, bf, (b, h, dh), q.device)
    for name, x in (("k_cache", k_cache), ("v_cache", v_cache)):
        check_operand(name, x, bf, (n_layers, b, h, s_max, dh), q.device)
    if pad_count is not None:
        check_operand("pad_count", pad_count, torch.int32, (b,), q.device)
    out = torch.empty_like(q)
    lib = kernels.library()
    kernels.check(lib.wt_self_attend_step(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(),
        None if pad_count is None else pad_count.data_ptr(), out.data_ptr(),
        b, h, s_max, int(layer), pos, pos_ptr,
        kernels.stream_ptr(q.device)), "self_attend_step")
    with COUNT_LOCK:
        launches += 1
        padded_launches += pad_count is not None
    return out


def quant_rows(x: torch.Tensor):
    """Symmetric int8 quantization over the last axis, one scale per row
    (the JAX package's ``_quant_rows``): (x8 int8, scale fp32 [...])."""
    x32 = x.float()
    absmax = x32.abs().amax(dim=-1, keepdim=True)
    scale = div127(torch.clamp_min(absmax, 1e-12))
    x8 = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return x8, scale[..., 0]


def quantize_self_cache(k: torch.Tensor, v: torch.Tensor):
    """Quantize the self cache after the prefill for the x7 step (the JAX
    package's ``quantize_pack_self`` without its head packing and its
    padding of S): k, v [L, B, H, S, 64] -> (k8, v8 int8 of that shape,
    k_scale, v_scale fp32 [L, B, H, S]).  Rows at and after the current
    position are rewritten by the step before they are attended."""
    k8, ks = quant_rows(k)
    v8, vs = quant_rows(v)
    return k8, v8, ks.contiguous(), vs.contiguous()


def self_attend_step_int8_plain(q, k_new, v_new, k_cache, v_cache, k_scale,
                                v_scale, layer: int, pos,
                                pad_count=None) -> torch.Tensor:
    """Reference version of B8, with the wrapper's arguments: the JAX
    ``_kernel_int8``'s math in plain PyTorch.  Both integer dots run in
    float64, which holds every partial sum exactly.  ``pos``: an int or a
    one-element integer tensor, which is read here."""
    b, s_max = k_cache.shape[1], k_cache.shape[3]
    pos = int(pos)
    q8, qs = quant_rows(q)                                    # [B,H,64], [B,H]
    k_cache[layer, :, :, pos], k_scale[layer, :, :, pos] = quant_rows(k_new)
    v_cache[layer, :, :, pos], v_scale[layer, :, :, pos] = quant_rows(v_new)
    k8, v8 = k_cache[layer], v_cache[layer]                   # [B, H, S, Dh]
    ks, vs = k_scale[layer], v_scale[layer]                   # [B, H, S]
    dots = torch.matmul(k8.double(), q8.double()[..., None])[..., 0]
    scores = dots.float() * qs[..., None] * ks
    rows = torch.arange(s_max, device=q.device)
    pads = (torch.zeros(b, dtype=torch.int32, device=q.device)
            if pad_count is None else pad_count)
    valid = (rows[None, :] <= pos) & (rows[None, :] >= pads[:, None])
    scores = torch.where(valid[:, None, :], scores,
                         torch.finfo(torch.float32).min)
    e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    denom = e.sum(dim=-1, keepdim=True)                       # [B, H, 1]
    p = e * vs                                                # V scales folded
    ps = div127(torch.clamp_min(p.abs().amax(dim=-1, keepdim=True), 1e-30))
    p8 = torch.round(p / ps)
    ctx = torch.matmul(p8.double()[..., None, :], v8.double())[..., 0, :]
    return (ctx.float() * (ps / denom)).to(q.dtype)


def self_attend_step_int8(q: torch.Tensor, k_new: torch.Tensor,
                          v_new: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, k_scale: torch.Tensor,
                          v_scale: torch.Tensor, layer: int, pos,
                          pad_count=None) -> torch.Tensor:
    """One self-attention decode step against (and into) the int8 cache.

    q, k_new, v_new: [B, H, 64] unquantized (q pre-scaled by 64^-0.5);
    k_cache, v_cache: [L, B, H, S, 64] int8 and k_scale, v_scale:
    [L, B, H, S] fp32, row ``pos`` of ``layer`` overwritten in place in all
    four; pos: an int, checked here, or a one-element int32 tensor on q's
    device, read by the kernel (outside [0, S) it writes no cache row or
    scale and returns NaN); pad_count: [B] int32 left-pad slots or None.
    Returns ctx [B, H, 64] in q's dtype."""
    if route(q) == "plain":
        return self_attend_step_int8_plain(q, k_new, v_new, k_cache, v_cache,
                                           k_scale, v_scale, layer, pos,
                                           pad_count)
    global int8_launches, int8_padded_launches
    b, h, dh = q.shape
    n_layers, s_max = k_cache.shape[0], k_cache.shape[3]
    if dh != 64:
        raise ValueError("self_attend_step_int8 kernel needs head_dim 64, "
                         f"got {dh}")
    pos, pos_ptr = _pos_args(pos, q, n_layers, s_max, layer)
    for name, x in (("q", q), ("k_new", k_new), ("v_new", v_new)):
        check_operand(name, x, torch.bfloat16, (b, h, dh), q.device)
    for name, x in (("k_cache", k_cache), ("v_cache", v_cache)):
        check_operand(name, x, torch.int8, (n_layers, b, h, s_max, dh),
                      q.device)
    for name, x in (("k_scale", k_scale), ("v_scale", v_scale)):
        check_operand(name, x, torch.float32, (n_layers, b, h, s_max),
                      q.device)
    if pad_count is not None:
        check_operand("pad_count", pad_count, torch.int32, (b,), q.device)
    out = torch.empty_like(q)
    lib = kernels.library()
    kernels.check(lib.wt_self_attend_step_int8(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
        None if pad_count is None else pad_count.data_ptr(), out.data_ptr(),
        b, h, s_max, int(layer), pos, pos_ptr, kernels.stream_ptr(q.device)),
        "self_attend_step_int8")
    with COUNT_LOCK:
        int8_launches += 1
        int8_padded_launches += pad_count is not None
    return out
