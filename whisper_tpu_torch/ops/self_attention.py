"""B3: one-token decoder self-attention with an in-place cache insert
(port of ``whisper_tpu.ops.self_attention``).

``self_attend_step`` replaces the JAX package's Pallas
``self_attend_step_packed`` (``_kernel``).  The JAX kernel donates its
head-packed cache through ``input_output_aliases``; this port keeps the
prefill layout [L, B, H, S, 64] and writes row ``pos`` of layer ``layer``
IN PLACE, in the kernel and in the plain version alike, so the caller's
cache tensors are the updated cache.

On a CUDA tensor it launches the hand-written Hopper kernel
``csrc/self_attention.cu``; on a CPU tensor it takes
``self_attend_step_plain``.  Any other device raises.
"""

from __future__ import annotations

import torch

from whisper_tpu_torch.ops import kernels
from whisper_tpu_torch.ops.common import check_operand, route

launches = 0  # kernel launches since the last reset (plain calls excluded)


def self_attend_step_plain(q, k_new, v_new, k_cache, v_cache, layer: int,
                           pos: int, pad_count=None) -> torch.Tensor:
    """Reference version: the JAX kernel's math in plain PyTorch (q widened
    to fp32, fp32 scores and softmax over rows [pad_count[b], pos], each
    p*v product rounded to the cache dtype before the fp32 sum)."""
    b, h, s_max = k_cache.shape[1], k_cache.shape[2], k_cache.shape[3]
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


def self_attend_step(q: torch.Tensor, k_new: torch.Tensor,
                     v_new: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, layer: int, pos: int,
                     pad_count=None) -> torch.Tensor:
    """One self-attention decode step against (and into) the cache.

    q, k_new, v_new: [B, H, 64] (q pre-scaled by 64^-0.5);
    k_cache, v_cache: [L, B, H, S, 64], row ``pos`` of ``layer`` is
    overwritten in place; pad_count: [B] int32 left-pad slots or None.
    Returns ctx [B, H, 64] in q's dtype."""
    if route(q) == "plain":
        return self_attend_step_plain(q, k_new, v_new, k_cache, v_cache,
                                      layer, pos, pad_count)
    global launches
    b, h, dh = q.shape
    n_layers, s_max = k_cache.shape[0], k_cache.shape[3]
    if dh != 64:
        raise ValueError(f"self_attend_step kernel needs head_dim 64, got {dh}")
    if not (0 <= layer < n_layers and 0 <= pos < s_max):
        raise ValueError(f"layer {layer} / pos {pos} outside the cache "
                         f"[{n_layers}, {s_max}]")
    bf = torch.bfloat16
    for name, x in (("q", q), ("k_new", k_new), ("v_new", v_new)):
        check_operand(name, x, bf, (b, h, dh), q.device)
    for name, x in (("k_cache", k_cache), ("v_cache", v_cache)):
        check_operand(name, x, bf, (n_layers, b, h, s_max, dh), q.device)
    if pad_count is None:
        pad_count = torch.zeros(b, dtype=torch.int32, device=q.device)
    check_operand("pad_count", pad_count, torch.int32, (b,), q.device)
    out = torch.empty_like(q)
    lib = kernels.library()
    kernels.check(lib.wt_self_attend_step(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), pad_count.data_ptr(), out.data_ptr(), b, h, s_max,
        int(layer), int(pos), kernels.stream_ptr(q.device)),
        "self_attend_step")
    launches += 1
    return out
