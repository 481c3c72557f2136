"""B10a, B10b, B10c and the two fused decode steps (port of
``whisper_tpu.ops.decoder_kernels``: ``self_attn_block``,
``cross_attn_block``, ``mlp_block``, ``build_step_weights``,
``decoder_step_hybrid`` and ``decoder_step_fused`` with its time-major
cache helpers).

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
(B3, B4, B6, B8) at any rung.

``self_attn_block`` (B10a, ``_self_kernel``) is a layer's whole
self-attention half for one step: LN, one QKV product, the k and v rows
written in place into the **time-major** self cache [S, B, d], attention
over rows <= pos (softmax as p / sum(p), P.V in fp32), the O product and
the residual.  ``cross_attn_block`` (B10b, ``_cross_kernel``) is the
cross-attention half against the **bf16** cross K/V: LN, the Q product, an
online softmax over blocks of 64 keys (``NEG_INF`` = -1e30), the O product
and the residual.  On a CUDA tensor they launch
``csrc/decoder_self_block.cu`` and ``csrc/decoder_cross_block.cu``; on a
CPU tensor they take ``self_attn_block_plain`` and
``cross_attn_block_plain``.  In both, the LayerNorm statistics and the
QKV / Q product are accumulated in float64 and rounded to fp32 once, so
that the value does not depend on the order of a sum and the rows B10a
writes into the cache are bitwise equal between the kernel and the plain
version.  B10a's ``pos`` is an int or a one-element int32 tensor that the
kernel reads on the card (as B3's), so a CUDA graph of the fused step
replays every position.  ``decoder_step_fused`` composes B10a, B10b and
B10c per layer;
as in the JAX package no session path calls it, and no ``RuntimeCfg``
flag selects it.
"""

from __future__ import annotations

import sys
from typing import Dict

import torch

from whisper_tpu_torch.models.registry import WhisperDims
from whisper_tpu_torch.ops import kernels
from whisper_tpu_torch.ops.common import (
    SQRT_2_OVER_PI,
    check_operand,
    count_launch,
    route,
)

LN_EPS = 1e-5
ROW_TILE = 16   # the kernel pads the batch to tiles of 16 rows
D_MULTIPLE = 64   # B10c splits d over 4 warps in steps of 16
F_MULTIPLE = 256  # B10c splits f over a cluster of 4 blocks of 4 warps

NEG_INF = -1e30   # the fused blocks' mask value (not finfo.min)
CROSS_BLOCK = 64  # keys per online-softmax block of cross_attn_block
HEAD_DIM = 64     # the fused attention kernels take head_dim 64 only
SELF_MAX_ROWS = 768     # B10a holds a head's K and V rows: 192 KB

launches = 0  # B10c kernel launches since the last reset (plain excluded)
self_block_launches = 0   # B10a launches since the last reset
cross_block_launches = 0  # B10b launches since the last reset


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
    b, d = x.shape
    f = w1.shape[1]
    if d % D_MULTIPLE or d > 1280 or f % F_MULTIPLE or f > 5120:
        raise ValueError(f"mlp_block kernel: d={d} must be a multiple of "
                         f"{D_MULTIPLE} up to 1280 and f={f} a multiple of "
                         f"{F_MULTIPLE} up to 5120")
    bf = torch.bfloat16
    for name, a, shape in (("x", x, (b, d)), ("ln", ln, (2, d)),
                           ("w1", w1, (d, f)), ("b1", b1, (1, f)),
                           ("w2", w2, (f, d)), ("b2", b2, (1, d))):
        check_operand(name, a, bf, shape, x.device)
    if any(a.data_ptr() % 16 for a in (x, ln, w1, w2)):
        raise ValueError("mlp_block kernel: x, ln, w1 and w2 must start on a "
                         "16-byte boundary (it is copied in 16-byte words)")
    rows = -(-b // ROW_TILE) * ROW_TILE
    h = torch.empty((rows, f), dtype=bf, device=x.device)  # stays in L2
    out = torch.empty_like(x)
    lib = kernels.library()
    kernels.check(lib.wt_decoder_mlp(
        x.data_ptr(), ln.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), h.data_ptr(), out.data_ptr(), b, d, f,
        kernels.stream_ptr(x.device)), "mlp_block")
    count_launch(sys.modules[__name__], launches=1)
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
                        token: torch.Tensor, pos, cache, mesh=None):
    """One-token decoder pass with the pre-fused weights: logits [B, V] and
    the cache, whose self rows at ``pos`` are written in place.  Same
    arguments and results as ``models.whisper.decoder_step``: ``pos`` an
    int or a one-element integer tensor on the tokens' device (one position
    for every row; the mask and the cache writes take it on the device).

    mesh: the QKV, O, XQ and XO weights hold this rank's heads and O and
    XO are summed over "model"; B10c fuses FC2's bias and the residual, so
    its weights are whole on every model rank."""
    from whisper_tpu_torch.models.whisper import (
        _attend,
        _attend_int8,
        _layer_norm,
        _logits,
        _merge_heads,
        _split_heads,
        _whole,
    )

    dec = params["decoder"]
    dtype = dec["tok_emb"].dtype
    sw = step_weights
    dl = sw["qkv_w"].shape[-1] // 3               # the rank's columns
    h = dl // dims.head_dim

    def out(ctx, w):
        """The O / XO product; under a mesh the rank's rows, summed."""
        y = torch.matmul(_merge_heads(ctx), w)
        if mesh is None:
            return y
        from whisper_tpu_torch.parallel.mesh import all_reduce

        return all_reduce(y, mesh)

    if mesh is not None:
        _whole(sw["fc1_w"], dims.d_ffn, "decoder_mlp_block (B10c)")
    x = dec["tok_emb"][token][:, None, :] + dec["pos_embed"][pos].to(dtype)
    max_len = cache.self_k.shape[3]
    mask = (torch.arange(max_len, device=x.device) <= pos)[None, :]
    slot = pos.to(torch.long) if isinstance(pos, torch.Tensor) else None
    int8_cross = cache.cross_k_scale is not None
    for li in range(dims.decoder_layers):
        r = _layer_norm(x, sw["ln1"][li, 0], sw["ln1"][li, 1])
        qkv = torch.matmul(r, sw["qkv_w"][li]) + sw["qkv_b"][li, 0]
        q, k, v = (_split_heads(t, h) for t in (
            qkv[..., :dl], qkv[..., dl:2 * dl], qkv[..., 2 * dl:]))
        if slot is None:
            cache.self_k[li, :, :, pos:pos + 1] = k
            cache.self_v[li, :, :, pos:pos + 1] = v
        else:
            cache.self_k[li].index_copy_(2, slot, k.to(cache.self_k.dtype))
            cache.self_v[li].index_copy_(2, slot, v.to(cache.self_v.dtype))
        o = _attend(q, cache.self_k[li], cache.self_v[li], mask)
        x = x + out(o, sw["o_w"][li]) + sw["o_b"][li, 0]

        r = _layer_norm(x, sw["ln2"][li, 0], sw["ln2"][li, 1])
        q = _split_heads(torch.matmul(r, sw["xq_w"][li]) + sw["xq_b"][li, 0],
                         h)
        if int8_cross:
            o = _attend_int8(q, cache.cross_k[li], cache.cross_v[li],
                             cache.cross_k_scale[li], cache.cross_v_scale[li])
        else:
            o = _attend(q, cache.cross_k[li], cache.cross_v[li], None)
        x = x + out(o, sw["xo_w"][li]) + sw["xo_b"][li, 0]

        x = mlp_block(x[:, 0, :].contiguous(), sw["ln3"][li], sw["fc1_w"][li],
                      sw["fc1_b"][li], sw["fc2_w"][li],
                      sw["fc2_b"][li])[:, None, :]
    x = _layer_norm(x, dec["ln_f_s"], dec["ln_f_b"])
    return _logits(params, x)[:, 0, :], cache


# ---------------------------------------------------------------------------
# B10a, B10b and the fully fused step
# ---------------------------------------------------------------------------

def _ln_exact(x, ln) -> torch.Tensor:
    """LayerNorm of the fused attention blocks: mean, variance and
    1/sqrt(var + eps) in float64, each rounded to fp32 once, then
    (x - mean) * rstd * scale + bias in fp32, one rounding per operation,
    cast to x's dtype.  No value depends on the order of a sum."""
    x64 = x.double()
    mean = x64.mean(dim=-1, keepdim=True)
    var = torch.square(x64 - mean).mean(dim=-1, keepdim=True)
    rstd = (1.0 / torch.sqrt(var + LN_EPS)).float()
    y = (x.float() - mean.float()) * rstd
    return (y * ln[0].float() + ln[1].float()).to(x.dtype)


def _dot_exact(r, w, b) -> torch.Tensor:
    """r @ w + b in fp32, the product accumulated in float64 and rounded
    once (bf16 products are exact there), then the bias added in fp32."""
    return torch.matmul(r.double(), w.double()).float() + b[0].float()


def self_attn_block_plain(x, ln, qkv_w, qkv_b, o_w, o_b, cache_k, cache_v,
                          pos: int, heads: int):
    """Reference version of B10a: the JAX kernel's math in plain PyTorch.
    Writes rows ``pos`` of cache_k / cache_v in place; returns (out,
    cache_k, cache_v)."""
    b, d = x.shape
    dh = d // heads
    qkv = _dot_exact(_ln_exact(x, ln), qkv_w, qkv_b)          # [B, 3d] fp32
    cache_k[pos] = qkv[:, d:2 * d].to(x.dtype)
    cache_v[pos] = qkv[:, 2 * d:].to(x.dtype)
    s_max = cache_k.shape[0]
    q = (qkv[:, :d] * dh ** -0.5).reshape(b, heads, dh)
    keys = cache_k.float().reshape(s_max, b, heads, dh)
    vals = cache_v.float().reshape(s_max, b, heads, dh)
    scores = (q[None] * keys).sum(dim=-1)                     # [S, B, H]
    rows = torch.arange(s_max, device=x.device)[:, None, None]
    scores = torch.where(rows <= pos, scores, NEG_INF)
    p = torch.exp(scores - scores.amax(dim=0, keepdim=True))
    p = p / p.sum(dim=0, keepdim=True)
    ctx = (p[..., None] * vals).sum(dim=0).reshape(b, d).to(x.dtype)
    out = torch.matmul(ctx.float(), o_w.float()) + o_b[0].float() + x.float()
    return out.to(x.dtype), cache_k, cache_v


def _check_block(name, x, ln, w, wb, o_w, o_b, heads):
    """The operands every fused attention block shares: returns (b, d)."""
    b, d = x.shape
    if d != heads * HEAD_DIM or d % 128 or x.dtype != torch.bfloat16:
        raise ValueError(f"{name} kernel needs bf16 x with head_dim "
                         f"{HEAD_DIM} and d a multiple of 128, got {x.dtype}, "
                         f"d={d}, heads={heads}")
    n = w.shape[1]
    for nm, a, shape in (("x", x, (b, d)), ("ln", ln, (2, d)),
                         ("w", w, (d, n)), ("b", wb, (1, n)),
                         ("o_w", o_w, (d, d)), ("o_b", o_b, (1, d))):
        check_operand(f"{name}: {nm}", a, torch.bfloat16, shape, x.device)
    return b, d


def _check_aligned(name, *tensors):
    """The kernels copy x, the LN parameters and the weights in 16-byte
    words (cp.async)."""
    if any(a.data_ptr() % 16 for a in tensors):
        raise ValueError(f"{name} kernel: x, ln and the weights must start "
                         "on a 16-byte boundary (they are copied in 16-byte "
                         "words)")


def _block_scratch(b: int, d: int, device):
    """(q fp32, ctx bf16) scratch of the batch padded to 16-row tiles."""
    rows = -(-b // ROW_TILE) * ROW_TILE
    return (torch.empty((rows, d), dtype=torch.float32, device=device),
            torch.empty((rows, d), dtype=torch.bfloat16, device=device))


def _check_pos(pos, x: torch.Tensor, s_max: int):
    """B10a's ``pos``: an int inside the cache, or a one-element int32
    tensor on x's device (read by the kernel).  Returns the pointer to hand
    the kernel (None for an int) and the int (-1 for a tensor)."""
    if isinstance(pos, torch.Tensor):
        if (pos.device != x.device or pos.dtype != torch.int32
                or pos.numel() != 1):
            raise ValueError("pos: a tensor must hold one int32 on "
                             f"{x.device}, got {pos.dtype} "
                             f"{tuple(pos.shape)} on {pos.device}")
        return pos.data_ptr(), -1
    pos = int(pos)
    if not 0 <= pos < s_max:
        raise ValueError(f"self_attn_block: pos {pos} outside the cache of "
                         f"{s_max} rows")
    return None, pos


def self_attn_block(x: torch.Tensor, ln: torch.Tensor, qkv_w: torch.Tensor,
                    qkv_b: torch.Tensor, o_w: torch.Tensor, o_b: torch.Tensor,
                    cache_k: torch.Tensor, cache_v: torch.Tensor, pos,
                    heads: int):
    """x [B, d]; ln [2, d]; qkv_w [d, 3d], qkv_b [1, 3d]; o_w [d, d], o_b
    [1, d]; cache_k / cache_v TIME-MAJOR [S, B, d], rows ``pos`` written in
    place; pos: an int, checked here, or a one-element int32 tensor on x's
    device, which the kernel reads (the JAX kernel's SMEM scalar: a
    captured CUDA graph replays every step; outside [0, S) the kernel
    writes no cache row and returns NaN).  Returns (out [B, d], cache_k,
    cache_v), the same cache tensors."""
    pos_ptr, pos_int = _check_pos(pos, x, cache_k.shape[0])
    if route(x) == "plain":
        return self_attn_block_plain(x, ln, qkv_w, qkv_b, o_w, o_b, cache_k,
                                     cache_v, pos, heads)
    b, d = _check_block("self_attn_block", x, ln, qkv_w, qkv_b, o_w, o_b,
                        heads)
    s_max = cache_k.shape[0]
    if qkv_w.shape[1] != 3 * d or s_max > SELF_MAX_ROWS:
        raise ValueError(f"self_attn_block: qkv_w {tuple(qkv_w.shape)}, a "
                         f"cache of {s_max} rows (at most {SELF_MAX_ROWS})")
    for nm, a in (("cache_k", cache_k), ("cache_v", cache_v)):
        check_operand(nm, a, torch.bfloat16, (s_max, b, d), x.device)
    _check_aligned("self_attn_block", x, ln, qkv_w, o_w)
    qbuf, ctx = _block_scratch(b, d, x.device)
    out = torch.empty_like(x)
    lib = kernels.library()
    kernels.check(lib.wt_decoder_self_block(
        x.data_ptr(), ln.data_ptr(), qkv_w.data_ptr(), qkv_b.data_ptr(),
        o_w.data_ptr(), o_b.data_ptr(), cache_k.data_ptr(),
        cache_v.data_ptr(), qbuf.data_ptr(), ctx.data_ptr(), out.data_ptr(),
        b, d, heads, s_max, pos_int, pos_ptr, kernels.stream_ptr(x.device)),
        "self_attn_block")
    count_launch(sys.modules[__name__], self_block_launches=1)
    return out, cache_k, cache_v


def cross_attn_block_plain(x, ln, q_w, q_b, o_w, o_b, cross_k, cross_v,
                           heads: int) -> torch.Tensor:
    """Reference version of B10b: the JAX kernel's math in plain PyTorch,
    block of 64 keys by block (running max, sum and accumulator)."""
    b, d = x.shape
    dh = d // heads
    t = cross_k.shape[2]
    q = (_dot_exact(_ln_exact(x, ln), q_w, q_b) * dh ** -0.5).reshape(
        b, heads, dh)
    m = torch.full((b, heads), NEG_INF, dtype=torch.float32, device=x.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, heads, dh), dtype=torch.float32, device=x.device)
    for j in range(0, t, min(CROSS_BLOCK, t)):
        keys = cross_k[:, :, j:j + CROSS_BLOCK].float()       # [B, H, BK, Dh]
        vals = cross_v[:, :, j:j + CROSS_BLOCK].float()
        scores = (q[:, :, None, :] * keys).sum(dim=-1)        # [B, H, BK]
        m_new = torch.maximum(m, scores.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + (p[..., None] * vals).sum(dim=2)
        m = m_new
    ctx = (acc / l[..., None]).reshape(b, d).to(x.dtype)
    out = torch.matmul(ctx.float(), o_w.float()) + o_b[0].float() + x.float()
    return out.to(x.dtype)


def cross_attn_block(x: torch.Tensor, ln: torch.Tensor, q_w: torch.Tensor,
                     q_b: torch.Tensor, o_w: torch.Tensor, o_b: torch.Tensor,
                     cross_k: torch.Tensor, cross_v: torch.Tensor,
                     heads: int) -> torch.Tensor:
    """x [B, d]; ln [2, d]; q_w, o_w [d, d]; q_b, o_b [1, d]; cross_k /
    cross_v [B, H, T, Dh] in x's dtype (one layer's bf16 cross cache).
    Returns [B, d].  No pad mask."""
    if route(x) == "plain":
        return cross_attn_block_plain(x, ln, q_w, q_b, o_w, o_b, cross_k,
                                      cross_v, heads)
    b, d = _check_block("cross_attn_block", x, ln, q_w, q_b, o_w, o_b, heads)
    t = cross_k.shape[2]
    if q_w.shape[1] != d or t < 1:
        raise ValueError(f"cross_attn_block: q_w {tuple(q_w.shape)}, T {t}")
    for nm, a in (("cross_k", cross_k), ("cross_v", cross_v)):
        check_operand(nm, a, torch.bfloat16, (b, heads, t, HEAD_DIM),
                      x.device)
    _check_aligned("cross_attn_block", x, ln, q_w, o_w, cross_k, cross_v)
    qbuf, ctx = _block_scratch(b, d, x.device)
    out = torch.empty_like(x)
    lib = kernels.library()
    kernels.check(lib.wt_decoder_cross_block(
        x.data_ptr(), ln.data_ptr(), q_w.data_ptr(), q_b.data_ptr(),
        o_w.data_ptr(), o_b.data_ptr(), cross_k.data_ptr(),
        cross_v.data_ptr(), qbuf.data_ptr(), ctx.data_ptr(), out.data_ptr(),
        b, d, heads, t, kernels.stream_ptr(x.device)), "cross_attn_block")
    count_launch(sys.modules[__name__], cross_block_launches=1)
    return out


def cache_to_time_major(self_k: torch.Tensor) -> torch.Tensor:
    """[L, B, H, S, Dh] -> [L, S, B, H*Dh], a new contiguous tensor (once
    per generate call)."""
    l, b, h, s, dh = self_k.shape
    return self_k.permute(0, 3, 1, 2, 4).reshape(l, s, b, h * dh)


def cache_from_time_major(tm: torch.Tensor, heads: int) -> torch.Tensor:
    """[L, S, B, H*Dh] -> [L, B, H, S, Dh]."""
    l, s, b, d = tm.shape
    return tm.reshape(l, s, b, heads, d // heads).permute(0, 2, 3, 1, 4)


def decoder_step_fused(params: Dict, step_weights: Dict, dims: WhisperDims,
                       token: torch.Tensor, pos,
                       self_k_tm: torch.Tensor, self_v_tm: torch.Tensor,
                       cross_k: torch.Tensor, cross_v: torch.Tensor):
    """Fully fused decoder step: per layer B10a, B10b and B10c, then the
    final LayerNorm and the logits.  self_k_tm / self_v_tm: [L, S, B, d]
    time-major self cache (``cache_to_time_major``), rows ``pos`` written
    in place; cross_k / cross_v: [L, B, H, T, Dh] in the activation dtype
    (a prefill without ``int8_cross_kv``).  ``pos``: an int, or a
    one-element int32 tensor on the tokens' device, which no step reads on
    the host (B10a reads it on the card), so one captured CUDA graph
    replays every step.  Returns (logits [B, V], self_k_tm, self_v_tm), the
    same cache tensors."""
    from whisper_tpu_torch.models.whisper import _layer_norm, _logits

    dec = params["decoder"]
    dtype = dec["tok_emb"].dtype
    h = dims.decoder_heads
    sw = step_weights
    pe = dec["pos_embed"][pos].to(dtype).reshape(1, -1)   # int or [1] pos
    x = dec["tok_emb"][token] + pe
    for i in range(dims.decoder_layers):
        x, _, _ = self_attn_block(
            x, sw["ln1"][i], sw["qkv_w"][i], sw["qkv_b"][i], sw["o_w"][i],
            sw["o_b"][i], self_k_tm[i], self_v_tm[i], pos, h)
        x = cross_attn_block(
            x, sw["ln2"][i], sw["xq_w"][i], sw["xq_b"][i], sw["xo_w"][i],
            sw["xo_b"][i], cross_k[i], cross_v[i], h)
        x = mlp_block(x, sw["ln3"][i], sw["fc1_w"][i], sw["fc1_b"][i],
                      sw["fc2_w"][i], sw["fc2_b"][i])
    x = _layer_norm(x, dec["ln_f_s"], dec["ln_f_b"])
    return _logits(params, x[:, None, :])[:, 0, :], self_k_tm, self_v_tm
