"""B10c and the hybrid decode step (port of
``whisper_tpu.ops.decoder_kernels``: ``mlp_block``, ``build_step_weights``
and ``decoder_step_hybrid``).

``mlp_block`` replaces the JAX package's Pallas ``mlp_block``
(``_mlp_kernel``): for one decode step, x [B, d] -> x + FC2(GELU(FC1(LN(x))))
with fp32 LayerNorm statistics, fp32 accumulation, the **tanh** GELU in
``jax.nn.gelu(approximate=True)``'s evaluation order, and one rounding to
the activation dtype at the end.  On a CUDA tensor it launches the
hand-written Hopper kernel ``csrc/decoder_mlp.cu``; on a CPU tensor it
takes ``mlp_block_plain``.  Any other device raises.

``decoder_step_hybrid`` is the step ``cfg.fused_decoder_step`` selects: one
pre-fused QKV product per layer (``build_step_weights``, once per
session), plain attention against the prefill-layout cache (the ``<= pos``
mask; ``_attend_int8`` against an int8 cross cache), and B10c for the MLP.
It has no pad mask, and it launches none of the decode attention kernels
(B3, B4, B6, B8) at any rung.  The JAX package's ``self_attn_block``,
``cross_attn_block`` and ``decoder_step_fused`` are not ported yet
(ROADMAP queue 2, B10a/B10b).
"""

from __future__ import annotations

from typing import Dict

import torch

from whisper_tpu_torch.models.registry import WhisperDims
from whisper_tpu_torch.ops import kernels
from whisper_tpu_torch.ops.common import SQRT_2_OVER_PI, check_operand, route

LN_EPS = 1e-5
ROW_TILE = 16   # the kernel pads the batch to tiles of 16 rows
F_MULTIPLE = 128  # the kernel splits f over 8 warps in steps of 16

launches = 0  # B10c kernel launches since the last reset (plain excluded)


def _gelu_tanh_jax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=True)``, in its evaluation order."""
    cdf = 0.5 * (1.0 + torch.tanh(SQRT_2_OVER_PI * (x + 0.044715 * (x * x * x))))
    return x * cdf


def mlp_block_plain(x, ln, w1, b1, w2, b2) -> torch.Tensor:
    """Reference version of B10c: the JAX kernel's math in plain PyTorch."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = torch.square(x32 - mean).mean(dim=-1, keepdim=True)
    r = (x32 - mean) * torch.rsqrt(var + LN_EPS)
    r = (r * ln[0].float() + ln[1].float()).to(x.dtype)
    h = torch.matmul(r.float(), w1.float())
    h = _gelu_tanh_jax(h + b1[0].float()).to(x.dtype)
    out = torch.matmul(h.float(), w2.float())
    return (out + b2[0].float() + x32).to(x.dtype)


def mlp_block(x: torch.Tensor, ln: torch.Tensor, w1: torch.Tensor,
              b1: torch.Tensor, w2: torch.Tensor,
              b2: torch.Tensor) -> torch.Tensor:
    """x [B, d]; ln [2, d] (scale, bias); w1 [d, f], b1 [1, f]; w2 [f, d],
    b2 [1, d] -> [B, d]."""
    if route(x) == "plain":
        return mlp_block_plain(x, ln, w1, b1, w2, b2)
    global launches
    b, d = x.shape
    f = w1.shape[1]
    if d % 16 or d > 1280 or f % F_MULTIPLE:
        raise ValueError(f"mlp_block kernel: d={d} must be a multiple of 16 "
                         f"up to 1280 and f={f} a multiple of {F_MULTIPLE}")
    bf = torch.bfloat16
    for name, a, shape in (("x", x, (b, d)), ("ln", ln, (2, d)),
                           ("w1", w1, (d, f)), ("b1", b1, (1, f)),
                           ("w2", w2, (f, d)), ("b2", b2, (1, d))):
        check_operand(name, a, bf, shape, x.device)
    rows = -(-b // ROW_TILE) * ROW_TILE
    h = torch.empty((rows, f), dtype=bf, device=x.device)  # stays in L2
    out = torch.empty_like(x)
    lib = kernels.library()
    kernels.check(lib.wt_decoder_mlp(
        x.data_ptr(), ln.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), h.data_ptr(), out.data_ptr(), b, d, f,
        kernels.stream_ptr(x.device)), "mlp_block")
    launches += 1
    return out


def build_step_weights(params: Dict, dims: WhisperDims) -> Dict:
    """Pre-fuse the decoder weights for the hybrid step: QKV concatenated
    (K's bias zeros), biases as [L, 1, n] rows, LN pairs stacked [L, 2, d].
    int8 ``QTensor`` weights are dequantized once here (q and s each cast
    to the activation dtype, the product rounded in it).  Computed once
    per session."""
    from whisper_tpu_torch.models.whisper import _dequant

    blocks = params["decoder"]["blocks"]
    dtype = params["decoder"]["tok_emb"].dtype

    def w(name):
        return _dequant(blocks[name], dtype)

    zeros_kb = torch.zeros_like(blocks["q_b"])
    ln = lambda s, b: torch.stack([blocks[s], blocks[b]], dim=1)
    row = lambda name: blocks[name][:, None, :]
    return {
        "qkv_w": torch.cat([w("q_w"), w("k_w"), w("v_w")], dim=-1),
        "qkv_b": torch.cat([blocks["q_b"], zeros_kb, blocks["v_b"]],
                           dim=-1)[:, None, :],
        "o_w": w("o_w"), "o_b": row("o_b"),
        "ln1": ln("ln_s", "ln_b"),
        "xq_w": w("xq_w"), "xq_b": row("xq_b"),
        "xo_w": w("xo_w"), "xo_b": row("xo_b"),
        "ln2": ln("x_ln_s", "x_ln_b"),
        "fc1_w": w("fc1_w"), "fc1_b": row("fc1_b"),
        "fc2_w": w("fc2_w"), "fc2_b": row("fc2_b"),
        "ln3": ln("mlp_ln_s", "mlp_ln_b"),
    }


def decoder_step_hybrid(params: Dict, step_weights: Dict, dims: WhisperDims,
                        token: torch.Tensor, pos: int, cache):
    """One-token decoder pass with the pre-fused weights: logits [B, V] and
    the cache, whose self rows at ``pos`` are written in place.  Same
    arguments and results as ``models.whisper.decoder_step``."""
    from whisper_tpu_torch.models.whisper import (
        _attend,
        _attend_int8,
        _layer_norm,
        _logits,
        _merge_heads,
        _split_heads,
    )

    dec = params["decoder"]
    dtype = dec["tok_emb"].dtype
    h = dims.decoder_heads
    d = dims.d_model
    sw = step_weights
    x = dec["tok_emb"][token][:, None, :] + dec["pos_embed"][pos].to(dtype)
    max_len = cache.self_k.shape[3]
    mask = (torch.arange(max_len, device=x.device) <= pos)[None, :]
    int8_cross = cache.cross_k_scale is not None
    for li in range(dims.decoder_layers):
        r = _layer_norm(x, sw["ln1"][li, 0], sw["ln1"][li, 1])
        qkv = torch.matmul(r, sw["qkv_w"][li]) + sw["qkv_b"][li, 0]
        q, k, v = (_split_heads(t, h)
                   for t in (qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]))
        cache.self_k[li, :, :, pos:pos + 1] = k
        cache.self_v[li, :, :, pos:pos + 1] = v
        o = _attend(q, cache.self_k[li], cache.self_v[li], mask)
        x = x + torch.matmul(_merge_heads(o), sw["o_w"][li]) + sw["o_b"][li, 0]

        r = _layer_norm(x, sw["ln2"][li, 0], sw["ln2"][li, 1])
        q = _split_heads(torch.matmul(r, sw["xq_w"][li]) + sw["xq_b"][li, 0],
                         h)
        if int8_cross:
            o = _attend_int8(q, cache.cross_k[li], cache.cross_v[li],
                             cache.cross_k_scale[li], cache.cross_v_scale[li])
        else:
            o = _attend(q, cache.cross_k[li], cache.cross_v[li], None)
        x = x + torch.matmul(_merge_heads(o), sw["xo_w"][li]) \
            + sw["xo_b"][li, 0]

        x = mlp_block(x[:, 0, :].contiguous(), sw["ln3"][li], sw["fc1_w"][li],
                      sw["fc1_b"][li], sw["fc2_w"][li],
                      sw["fc2_b"][li])[:, None, :]
    x = _layer_norm(x, dec["ln_f_s"], dec["ln_f_b"])
    return _logits(params, x)[:, 0, :], cache
