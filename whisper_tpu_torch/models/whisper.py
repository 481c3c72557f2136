"""PyTorch Whisper encoder/decoder (port of ``whisper_tpu.models.whisper``).

The JAX package's three jitted functions become plain functions over the
same stacked-layer parameter tree (torch tensors; ``QTensor`` int8
weights allowed):

- :func:`encoder_apply`   — log-mel [B, n_mels, 3000] -> states [B, 1500, d]
- :func:`decoder_prefill` — full-prompt pass; self-attention KV for the
  prompt and the cross-attention KV, computed once; a prompt mask takes
  left-padded conditioned prompts
- :func:`decoder_step`    — one token against the static-shape KV cache
  (``pad_count`` masks a conditioned prompt's pad slots on every step)
- :func:`decoder_alignment_weights` — a teacher-forced pass returning the
  cross-attention probabilities, for word timings

``WhisperEncoder`` and ``WhisperDecoder`` are the ``nn.Module``s that hold
the stacked [L, ...] weights on a device, with int8 weights dequantized
ONCE (``q.bf16 * s.bf16``, the exact values the JAX model's per-call
``_dequant`` produces), so layer-indexed code reads one tensor per weight.

Numerics follow the JAX package: LayerNorm and softmax in fp32 whatever
the activation dtype; the conv stem and the unfused blocks use exact erf
GELU, only the fused MLP kernel (B2) uses tanh; logits are an fp32 matmul
of the bf16 operands.  Mutable state is explicit: the KV cache tensors are
written in place (JAX returns new arrays; the port updates where the data
lies and returns the same cache).

Kernels on the path (x3+): ``ops.attention.fused_attention`` (B1) and
``ops.encoder_mlp.fused_encoder_mlp`` (B2) in the encoder; at x4 and x5
the decode step runs ``ops.self_attention.self_attend_step`` (B3) and,
replacing ``_decoder_blocks_packed``, the int8 cross-attention kernel:
``ops.cross_attention.cross_attend_step`` (B4, int8 x int8) at x5,
``ops.cross_attention.cross_attend_step_dequant`` (B6) at x4.  At x7 the
self cache is int8 with per-row scales and the step runs
``ops.self_attention.self_attend_step_int8`` (B8), then B4.  At x6 the
encoder's QKV/O products are W8A8 (``_dense(int8_act=True)``, an exact
int8 product outside any kernel).  ``encoder_apply(fused_block=True)``
runs ``ops.encoder_block`` (B9a, B1, then B9b or a plain O-projection and
B2).  The hybrid and the fully fused decode steps live in
``ops.decoder_kernels``.  Speculative decoding (``runtime.speculative``)
runs ``_decoder_blocks`` at per-row positions with plain self-attention and
cross-attention through B4/B6 (a draft's step) or B7 (the verify pass).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from whisper_tpu_torch.models.registry import WhisperDims
from whisper_tpu_torch.ops.common import div127
from whisper_tpu_torch.variants.quant import QTensor, int8_matmul

Params = Dict
LN_EPS = 1e-5


class KVCache(NamedTuple):
    """Static-shape KV cache, in the prefill layout at every rung.

    self_k/self_v: [L, B, H, S_max, Dh], written in place each step.
    cross_k/cross_v: [L, B, H, T_enc, Dh], computed once at prefill; int8
        with per-(L, B, H) fp32 scales [L, B, H, 1, 1] when int8_cross_kv.
    self_k_scale/self_v_scale: [L, B, H, S_max] fp32, one scale per cached
        row, when the self cache is int8 (x7, ``quantize_self_kv``): each
        row is quantized when it is written, since later rows are unknown.
    """

    self_k: torch.Tensor
    self_v: torch.Tensor
    cross_k: torch.Tensor
    cross_v: torch.Tensor
    cross_k_scale: Optional[torch.Tensor] = None
    cross_v_scale: Optional[torch.Tensor] = None
    self_k_scale: Optional[torch.Tensor] = None
    self_v_scale: Optional[torch.Tensor] = None


def sinusoid_position_embedding(length: int, channels: int) -> np.ndarray:
    """OpenAI Whisper sinusoidal embedding for the encoder (float32)."""
    assert channels % 2 == 0
    log_timescale_increment = np.log(10000.0) / (channels // 2 - 1)
    inv_timescales = np.exp(-log_timescale_increment * np.arange(channels // 2))
    scaled_time = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate(
        [np.sin(scaled_time), np.cos(scaled_time)], axis=1
    ).astype(np.float32)


def clamp_token_ids(ids, vocab_size: int) -> np.ndarray:
    """Host token ids as the JAX model's embedding gather reads them
    (int64 numpy): a negative id counts from the end, as in numpy, and an
    id outside [0, vocab_size) is clamped into it (``jnp.take``'s
    out-of-bounds mode for a gather: ``x[5]`` of 4 rows is row 3).  The
    port's indexing would raise instead (an IndexError on the CPU, a
    device-side assert on the card), so the session clamps every id it
    uploads; ids decoded by an argmax over the vocabulary never need it."""
    ids = np.asarray(ids, dtype=np.int64)
    ids = np.where(ids < 0, ids + vocab_size, ids)
    return np.clip(ids, 0, vocab_size - 1)


def _layer_norm(x, scale, bias):
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = torch.square(x32 - mean).mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + LN_EPS)
    return (y * scale.float() + bias.float()).to(x.dtype)


def _dequant(w, dtype):
    """QTensor -> dense weight in ``dtype`` (q and s each cast, the product
    rounded in ``dtype``); dense weights pass through."""
    if isinstance(w, QTensor):
        return w.q.to(dtype) * w.s.to(dtype)
    return w


def _dense(x, w, b, int8_act: bool = False):
    """x @ w + b.  int8_act with a QTensor weight (W8A8, rung x6): x is
    quantized per row (absmax taken in x's dtype, scale = absmax/127 in
    fp32 with a floor of 1e-12, round half to even, clip +-127), the
    int8 x int8 product is accumulated exactly in int32, and the output
    scale is the row scale times the per-output-channel weight scale; the
    bias adds in x's dtype."""
    if int8_act and isinstance(w, QTensor):
        xq, xs = _quantize_rows(x, x.abs().amax(dim=-1, keepdim=True))
        y = (int8_matmul(xq, w.q).float() * xs * w.s.float()).to(x.dtype)
        return y if b is None else y + b
    y = torch.matmul(x, _dequant(w, x.dtype))
    return y if b is None else y + b


def _quantize_rows(x, absmax):
    """W8A8's activation quantization of x given each row's absmax (in x's
    dtype): (int8 rows, fp32 scales)."""
    xs = torch.clamp_min(div127(absmax.float()), 1e-12)
    xq = torch.clamp(torch.round(x.float() / xs), -127, 127).to(torch.int8)
    return xq, xs


def _rows(w) -> int:
    """Input rows of a [..., in, out] weight (a QTensor's alike)."""
    return (w.q if isinstance(w, QTensor) else w).shape[-2]


def _cols(w) -> int:
    """Output columns of a [..., in, out] weight (a QTensor's alike)."""
    return (w.q if isinstance(w, QTensor) else w).shape[-1]


def _row_dense(x, w, b, mesh, full: int, int8_act: bool = False):
    """x @ w + b for a row-parallel weight (o, xo, fc2) of ``full`` input
    rows.  Without a mesh, ``_dense``.  Under a mesh:

    - w holds this rank's rows (``shard_params``): the partial product is
      summed over "model" and the bias added once, after the sum.  W8A8
      (x6) takes the row's absmax over "model" first and sums the exact
      int32 accumulators, so it stays bitwise the one-process product;
    - w is whole (kept whole for a fused kernel) and x holds the rank's
      heads: x is all-gathered over "model" first;
    - w and x are both whole: ``_dense``.

    A model axis of one takes the first branch, whose sum over one rank
    is no call at all.  Nothing is read on the host: inside a rank's
    captured program (``runtime.generate``) the collectives are captured
    with the products around them."""
    if mesh is None:
        return _dense(x, w, b, int8_act)
    from whisper_tpu_torch.parallel import mesh as pm

    rows = _rows(w)
    if x.shape[-1] != rows:
        x = pm.all_gather(x.contiguous(), mesh, pm.MODEL_AXIS, x.ndim - 1)
        return _dense(x, w, b, int8_act)
    if rows * mesh.model != full:
        return _dense(x, w, b, int8_act)
    if int8_act and isinstance(w, QTensor):
        xq, xs = _quantize_rows(x, pm.all_reduce(
            x.abs().amax(dim=-1, keepdim=True), mesh, op="max"))
        acc = pm.all_reduce(int8_matmul(xq, w.q), mesh)
        y = (acc.float() * xs * w.s.float()).to(x.dtype)
    else:
        y = pm.all_reduce(torch.matmul(x, _dequant(w, x.dtype)), mesh)
    return y if b is None else y + b


def _whole(w, full: int, what: str) -> None:
    """Raise unless a fused kernel's weight is whole (``full`` columns)."""
    if _cols(w) != full:
        raise ValueError(
            f"{what}: the fused kernel needs its weights whole on every "
            f"model rank ({_cols(w)} of {full} columns here); keep them out "
            "of the tensor-parallel split (shard_params(whole=...))")


def _split_heads(x, n_heads: int):
    """[..., S, d] -> [..., H, S, Dh]"""
    *lead, s, d = x.shape
    return x.reshape(*lead, s, n_heads, d // n_heads).movedim(-2, -3)


def _merge_heads(x):
    """[..., H, S, Dh] -> [..., S, d]"""
    x = x.movedim(-3, -2)
    *lead, s, h, dh = x.shape
    return x.reshape(*lead, s, h * dh)


def _attend(q, k, v, mask, fused: bool = False):
    """q [B,H,Sq,Dh], k/v [B,H,Sk,Dh], mask broadcastable to [B,H,Sq,Sk].
    q is pre-scaled by Dh^-0.5 (HF order).  fused=True (no mask) runs the
    B1 kernel."""
    q = q * q.shape[-1] ** -0.5
    if fused and mask is None:
        from whisper_tpu_torch.ops.attention import fused_attention

        return fused_attention(q.contiguous(), k.contiguous(), v.contiguous())
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if mask is not None:
        scores = torch.where(mask, scores, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.matmul(probs, v)


def _attend_int8(q, k8, v8, k_scale, v_scale):
    """Cross attention against int8 K/V with per-head scales [B, H, 1, 1]
    applied after the dots (the prefill's path at x4+)."""
    q = q * q.shape[-1] ** -0.5
    scores = torch.matmul(q.float(), k8.float().transpose(-1, -2)) * k_scale
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    ctx = torch.matmul(probs.float(), v8.float())
    return (ctx * v_scale).to(q.dtype)


def _layer(blocks: Dict, li: int) -> Dict:
    """Layer ``li`` of a stacked block dict (QTensor pairs sliced alike)."""
    return {k: QTensor(v.q[li], v.s[li]) if isinstance(v, QTensor) else v[li]
            for k, v in blocks.items()}


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def _conv1d(x, w, b, stride: int):
    """x [B, C_in, T], w [width, C_in, C_out] (the JAX HIO layout)."""
    return F.conv1d(x, w.permute(2, 1, 0), stride=stride, padding=1) \
        + b[None, :, None]


def encoder_apply(params: Params, dims: WhisperDims, mel: torch.Tensor, *,
                  fused_attention: bool = False,
                  int8_activations: bool = False,
                  fused_mlp: bool = False,
                  fused_block: bool = False, mesh=None) -> torch.Tensor:
    """Encoder forward: mel [B, n_mels, T] -> hidden states [B, T//2, d].

    conv1d(k=3,s=1)+GELU, conv1d(k=3,s=2)+GELU, + sinusoidal positions,
    pre-LN blocks, final LayerNorm.  fused_attention runs B1, fused_mlp
    runs B2 (the port's B2 takes every width, so there is no chunked
    variant to choose).

    int8_activations (rung x6, needs QTensor weights): the blocks' QKV/O
    products, and FC1/FC2 unless fused_mlp keeps the MLP half on B2, run
    W8A8 (``_dense``).

    fused_block: the whole layer through ``ops.encoder_block``: B9a -> B1
    -> B9b ("whole"), or B9a -> B1 -> plain O-projection + residual -> B2
    ("chunked"), chosen by ``fused_block_mode`` exactly where the JAX
    package chooses, or the unfused block where it falls back.  It
    supersedes fused_mlp and ignores int8_activations.

    mesh (``parallel.mesh.Mesh``): params are this rank's shard
    (``shard_params``); attention runs on the rank's heads and the
    row-parallel products are summed over "model" (``_row_dense``).  B2 and
    B9b fuse FC2's bias and the residual into the product, so they take
    whole weights (every model rank runs them whole); B9a and B1 run on the
    rank's columns and heads, and B9b's input is all-gathered over
    "model"."""
    enc = params["encoder"]
    dtype = enc["conv1_w"].dtype
    x = mel.to(dtype)
    x = F.gelu(_conv1d(x, enc["conv1_w"], enc["conv1_b"], 1))
    x = F.gelu(_conv1d(x, enc["conv2_w"], enc["conv2_b"], 2))
    x = x.transpose(1, 2).contiguous()                       # [B, T', d]
    x = x + enc["pos_embed"][: x.shape[1]].to(dtype)
    dh = dims.d_model // dims.encoder_heads
    d, f = dims.d_model, dims.d_ffn
    i8 = int8_activations
    fb_mode = None
    if fused_block:
        from whisper_tpu_torch.ops.encoder_block import fused_block_mode

        fb_mode = fused_block_mode(dims.d_model, dims.d_ffn, dtype)
    for li in range(dims.encoder_layers):
        p = _layer(enc["blocks"], li)
        if fb_mode is not None:
            x = _encoder_block_fused(x, p, dh, f, fb_mode, mesh)
            continue
        r = _layer_norm(x, p["attn_ln_s"], p["attn_ln_b"])
        q = _dense(r, p["q_w"], p["q_b"], i8)
        k = _dense(r, p["k_w"], None, i8)
        v = _dense(r, p["v_w"], p["v_b"], i8)
        h = q.shape[-1] // dh                     # the rank's heads
        o = _attend(_split_heads(q, h), _split_heads(k, h),
                    _split_heads(v, h), None, fused=fused_attention)
        x = x + _row_dense(_merge_heads(o), p["o_w"], p["o_b"], mesh, d, i8)
        if fused_mlp:
            from whisper_tpu_torch.ops.encoder_mlp import fused_encoder_mlp

            _whole(p["fc1_w"], f, "fused_encoder_mlp (B2)")
            x = fused_encoder_mlp(
                x, p["mlp_ln_s"], p["mlp_ln_b"],
                _dequant(p["fc1_w"], x.dtype), p["fc1_b"],
                _dequant(p["fc2_w"], x.dtype), p["fc2_b"])
        else:
            r = _layer_norm(x, p["mlp_ln_s"], p["mlp_ln_b"])
            r = F.gelu(_dense(r, p["fc1_w"], p["fc1_b"], i8))
            x = x + _row_dense(r, p["fc2_w"], p["fc2_b"], mesh, f, i8)
    return _layer_norm(x, enc["ln_f_s"], enc["ln_f_b"])


def fused_qkv(p: Dict, dtype: torch.dtype):
    """[q_w | k_w | v_w] dequantized and [q_b | 0 | v_b] of a block dict
    (one layer or the stacked [L, ...] leaves)."""
    w_qkv = torch.cat([_dequant(p[k], dtype) for k in ("q_w", "k_w", "v_w")],
                      dim=-1)
    b_qkv = torch.cat([p["q_b"], torch.zeros_like(p["q_b"]), p["v_b"]],
                      dim=-1)
    return w_qkv, b_qkv


def _encoder_block_fused(x, p: Dict, dh: int, f: int, mode: str,
                         mesh=None):
    """One encoder layer through the ``ops.encoder_block`` kernels (the JAX
    package's ``block_fused``).  ``p`` may carry the pre-fused ``qkv_w`` /
    ``qkv_b`` (``WhisperEncoder`` builds them once).  Under a mesh B9a and
    B1 run on the rank's columns and heads; B9b (O product, residual,
    LayerNorm, MLP in one) takes the all-gathered context and whole
    weights."""
    from whisper_tpu_torch.ops import encoder_block as eb

    d = x.shape[-1]
    if "qkv_w" in p:
        w_qkv, b_qkv = p["qkv_w"], p["qkv_b"]
    else:
        w_qkv, b_qkv = fused_qkv(p, x.dtype)
    qkv = eb.fused_ln_qkv(x, p["attn_ln_s"], p["attn_ln_b"], w_qkv, b_qkv)
    dl = qkv.shape[-1] // 3                       # the rank's columns
    q, k, v = qkv[..., :dl], qkv[..., dl:2 * dl], qkv[..., 2 * dl:]
    h = dl // dh
    o = _attend(_split_heads(q, h), _split_heads(k, h), _split_heads(v, h),
                None, fused=True)
    if mode == "whole":
        ctx = _merge_heads(o)
        if mesh is not None:
            from whisper_tpu_torch.parallel import mesh as pm

            _whole(p["o_w"], d, "fused_out_mlp (B9b)")
            _whole(p["fc1_w"], f, "fused_out_mlp (B9b)")
            if dl != d:
                ctx = pm.all_gather(ctx.contiguous(), mesh, pm.MODEL_AXIS,
                                    ctx.ndim - 1)
        return eb.fused_out_mlp(
            x, ctx, _dequant(p["o_w"], x.dtype), p["o_b"],
            p["mlp_ln_s"], p["mlp_ln_b"],
            _dequant(p["fc1_w"], x.dtype), p["fc1_b"],
            _dequant(p["fc2_w"], x.dtype), p["fc2_b"])
    from whisper_tpu_torch.ops.encoder_mlp import fused_encoder_mlp

    x = x + _row_dense(_merge_heads(o), p["o_w"], p["o_b"], mesh, d)
    if mesh is not None:
        _whole(p["fc1_w"], f, "fused_encoder_mlp (B2)")
    return fused_encoder_mlp(
        x, p["mlp_ln_s"], p["mlp_ln_b"],
        _dequant(p["fc1_w"], x.dtype), p["fc1_b"],
        _dequant(p["fc2_w"], x.dtype), p["fc2_b"])


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

def init_cache(dims: WhisperDims, batch: int, max_len: int, t_enc: int,
               dtype: torch.dtype, device, heads: Optional[int] = None,
               int8_cross: bool = False) -> KVCache:
    """Zero caches of ``heads`` heads (a tensor-parallel rank's share;
    the model's decoder heads by default); with int8_cross the cross K/V
    int8 beside their fp32 scales [L, B, H, 1, 1], left for the prefill to
    fill."""
    l, dh = dims.decoder_layers, dims.head_dim
    h = dims.decoder_heads if heads is None else heads

    def z(s, dt=dtype):
        return torch.zeros((l, batch, h, s, dh), dtype=dt, device=device)

    cache = KVCache(self_k=z(max_len), self_v=z(max_len),
                    cross_k=z(t_enc, torch.int8 if int8_cross else dtype),
                    cross_v=z(t_enc, torch.int8 if int8_cross else dtype))
    if not int8_cross:
        return cache
    scale = (l, batch, h, 1, 1)
    return cache._replace(
        cross_k_scale=torch.empty(scale, dtype=torch.float32, device=device),
        cross_v_scale=torch.empty(scale, dtype=torch.float32, device=device))


def _decoder_mlp(x, p, dims: WhisperDims, mesh=None):
    r = _layer_norm(x, p["mlp_ln_s"], p["mlp_ln_b"])
    r = F.gelu(_dense(r, p["fc1_w"], p["fc1_b"]))
    return x + _row_dense(r, p["fc2_w"], p["fc2_b"], mesh, dims.d_ffn)


def _decoder_blocks(params: Params, dims: WhisperDims, x, cache: KVCache,
                    pos, self_mask, cross_len: Optional[int] = None,
                    int8_mxu: bool = True, mesh=None):
    """All decoder blocks with plain self-attention (prefill at every rung,
    the step at x0-x3, and every pass of speculative decoding): writes
    self-attention rows [pos, pos+S) of the cache in place and attends per
    ``self_mask``.

    pos: an int (all rows aligned), a one-element tensor (one position for
    every row, read on the device: the graphed decode loop), or a [B]
    tensor of per-row positions (batched speculative decoding, where rows
    accept different draft lengths): row r then writes rows [pos_r,
    pos_r+S).  A tensor writes by one indexed copy per layer and cache, in
    place and without a host sync (at B = 1 both tensor forms are one).

    cross_len (the encoder length) routes cross-attention through the
    kernels against the int8 cross cache, the JAX package's packed-cross
    generic block: one token a row through B4 (int8_mxu) or B6, S > 1 (the
    verify pass) through B7.  An int8 self cache (x7) raises: only the
    single-token kernel step reads it.

    mesh: the params and the caches hold this rank's heads; the kernels
    run through their ``*_sharded`` wrappers and o/xo/fc2 are summed over
    "model" (``_row_dense``)."""
    if cache.self_k_scale is not None:
        raise ValueError(
            "int8 self cache requires the single-token kernel decode step "
            "(kernel_step, scalar pos); use a bf16 cache for multi-token "
            "or per-row-position passes")
    if cross_len is not None and cache.cross_k_scale is None:
        raise ValueError("cross_len (the cross-attention kernels) needs the "
                         "int8 cross cache")
    dec = params["decoder"]
    d, dh = dims.d_model, dims.head_dim
    s = x.shape[1]
    rows = slots = None
    if isinstance(pos, torch.Tensor):
        if pos.ndim != 1:
            raise ValueError(f"pos must be an int or a [B] tensor, got "
                             f"shape {tuple(pos.shape)}")
        pos = pos.to(torch.long)
        if pos.numel() == 1:
            slots = pos + torch.arange(s, device=x.device)      # [S]
        else:
            rows = (torch.arange(x.shape[0], device=x.device)[:, None],
                    pos[:, None] + torch.arange(s, device=x.device)[None, :])
    if cross_len is not None:
        from whisper_tpu_torch.ops import cross_attention as ca

        if mesh is None:
            step = (ca.cross_attend_step if int8_mxu
                    else ca.cross_attend_step_dequant)
            multi = ca.cross_attend_multi
        else:
            def step(*a, **kw):
                return ca.cross_attend_step_sharded(
                    *a, **kw, int8_mxu=int8_mxu, mesh=mesh,
                    heads=dims.decoder_heads)

            def multi(*a, **kw):
                return ca.cross_attend_multi_sharded(
                    *a, **kw, mesh=mesh, heads=dims.decoder_heads)
        scale = dh ** -0.5
        ks = cache.cross_k_scale[:, :, :, 0, 0]                # [L, B, H]
        vs = cache.cross_v_scale[:, :, :, 0, 0]
    for li in range(dims.decoder_layers):
        p = _layer(dec["blocks"], li)
        h = _cols(p["q_w"]) // dh                 # the rank's heads
        r = _layer_norm(x, p["ln_s"], p["ln_b"])
        q = _split_heads(_dense(r, p["q_w"], p["q_b"]), h)
        k = _split_heads(_dense(r, p["k_w"], None), h)
        v = _split_heads(_dense(r, p["v_w"], p["v_b"]), h)
        if slots is not None:
            cache.self_k[li].index_copy_(2, slots, k.to(cache.self_k.dtype))
            cache.self_v[li].index_copy_(2, slots, v.to(cache.self_v.dtype))
        elif rows is None:
            cache.self_k[li, :, :, pos:pos + s] = k
            cache.self_v[li, :, :, pos:pos + s] = v
        else:
            # [B, S] row indices around the head axis: values [B, S, H, Dh]
            cache.self_k[li][rows[0], :, rows[1]] = k.transpose(1, 2)
            cache.self_v[li][rows[0], :, rows[1]] = v.transpose(1, 2)
        o = _attend(q, cache.self_k[li], cache.self_v[li], self_mask)
        x = x + _row_dense(_merge_heads(o), p["o_w"], p["o_b"], mesh, d)

        r = _layer_norm(x, p["x_ln_s"], p["x_ln_b"])
        q = _split_heads(_dense(r, p["xq_w"], p["xq_b"]), h)
        if cross_len is not None and s == 1:
            o = step((q[:, :, 0, :] * scale).contiguous(), cache.cross_k,
                     cache.cross_v, ks, vs, li,
                     s_valid=cross_len)[:, :, None, :]
        elif cross_len is not None:
            qm = (q.transpose(1, 2) * scale).contiguous()    # [B, T, H, Dh]
            o = multi(qm, cache.cross_k, cache.cross_v, ks, vs, li,
                      s_valid=cross_len, int8_mxu=int8_mxu).transpose(1, 2)
        elif cache.cross_k_scale is not None:
            o = _attend_int8(q, cache.cross_k[li], cache.cross_v[li],
                             cache.cross_k_scale[li], cache.cross_v_scale[li])
        else:
            o = _attend(q, cache.cross_k[li], cache.cross_v[li], None)
        x = x + _row_dense(_merge_heads(o), p["xo_w"], p["xo_b"], mesh, d)
        x = _decoder_mlp(x, p, dims, mesh)
    return _layer_norm(x, dec["ln_f_s"], dec["ln_f_b"]), cache


def _decoder_blocks_kernel(params: Params, dims: WhisperDims, x,
                           cache: KVCache, pos: int, cross_len: int,
                           int8_mxu: bool = True, pad_count=None,
                           mesh=None):
    """Single-token decoder step through the x4/x5/x7 kernels, replacing
    the JAX package's ``_decoder_blocks_packed``: per layer, B3 (or, against
    an int8 self cache, B8) attends and writes the self cache in place,
    then B4 (int8_mxu, x5 and x7) or B6 (x4) attends the int8 cross cache.
    The caches keep the prefill layout (no packing step).  pad_count ([B]
    int32 on the cache's device, or None) goes to B3/B8, which then attend
    rows [pad_count, pos] of each row.  pos: an int, or a one-element
    tensor that B3/B8 read on the card (as int32).

    mesh: the counterpart of the JAX ``mesh=`` path, which runs the packed
    kernels per shard through ``shard_map``: here the rank already holds
    its rows and heads, and each kernel runs through its ``*_sharded``
    wrapper (B3/B8 and B4/B6 on the rank's heads); o/xo/fc2 are summed
    over "model"."""
    from whisper_tpu_torch.ops import cross_attention as ca
    from whisper_tpu_torch.ops import self_attention as sa

    int8_self = cache.self_k_scale is not None
    if isinstance(pos, torch.Tensor) and pos.dtype != torch.int32:
        pos = pos.to(torch.int32)
    if mesh is None:
        cross_attend = (ca.cross_attend_step if int8_mxu
                        else ca.cross_attend_step_dequant)
        self_attend, self_attend_i8 = (sa.self_attend_step,
                                       sa.self_attend_step_int8)
    else:
        shard = dict(mesh=mesh, heads=dims.decoder_heads)

        def cross_attend(*a, **kw):
            return ca.cross_attend_step_sharded(*a, **kw, int8_mxu=int8_mxu,
                                                **shard)

        def self_attend(*a):
            return sa.self_attend_step_sharded(*a, **shard)

        def self_attend_i8(*a):
            return sa.self_attend_step_int8_sharded(*a, **shard)

    dec = params["decoder"]
    d, dh = dims.d_model, dims.head_dim
    scale = dh ** -0.5
    ks = cache.cross_k_scale[:, :, :, 0, 0]                    # [L, B, H]
    vs = cache.cross_v_scale[:, :, :, 0, 0]
    for li in range(dims.decoder_layers):
        p = _layer(dec["blocks"], li)
        r = _layer_norm(x, p["ln_s"], p["ln_b"])
        q = _dense(r, p["q_w"], p["q_b"])[:, 0]               # [B, d/tp]
        k = _dense(r, p["k_w"], None)[:, 0]
        v = _dense(r, p["v_w"], p["v_b"])[:, 0]
        h = q.shape[-1] // dh                     # the rank's heads
        qkv = ((q * scale).reshape(-1, h, dh),
               k.reshape(-1, h, dh).contiguous(),
               v.reshape(-1, h, dh).contiguous())
        if int8_self:
            ctx = self_attend_i8(
                *qkv, cache.self_k, cache.self_v, cache.self_k_scale,
                cache.self_v_scale, li, pos, pad_count)
        else:
            ctx = self_attend(*qkv, cache.self_k, cache.self_v, li, pos,
                              pad_count)
        x = x + _row_dense(ctx.reshape(x.shape[0], 1, -1), p["o_w"],
                           p["o_b"], mesh, d)

        r = _layer_norm(x, p["x_ln_s"], p["x_ln_b"])
        q = _dense(r, p["xq_w"], p["xq_b"])[:, 0]
        ctx = cross_attend(
            (q * scale).reshape(-1, h, dh),
            cache.cross_k, cache.cross_v, ks, vs, li, s_valid=cross_len)
        x = x + _row_dense(ctx.reshape(x.shape[0], 1, -1), p["xo_w"],
                           p["xo_b"], mesh, d)
        x = _decoder_mlp(x, p, dims, mesh)
    return _layer_norm(x, dec["ln_f_s"], dec["ln_f_b"]), cache


def _quant_cross(x, q_out=None, s_out=None):
    """Symmetric int8 of ``x`` [..., T, Dh] with one fp32 scale for each
    leading index (absmax over T and Dh): (int8, scale [..., 1, 1]),
    written into ``q_out`` and ``s_out`` where given."""
    x32 = x.float()
    absmax = x32.abs().amax(dim=(-2, -1), keepdim=True)
    scale = div127(torch.clamp_min(absmax, 1e-12))  # a true division
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    if q_out is None:
        return q, scale
    q_out.copy_(q)
    s_out.copy_(scale)
    return q_out, s_out


def quantize_cross_kv(cache: KVCache) -> KVCache:
    """Quantize the cross K/V to symmetric int8 with per-(L,B,H) scales
    (``decoder_prefill`` does so layer by layer, into its cache)."""
    k8, ks = _quant_cross(cache.cross_k)
    v8, vs = _quant_cross(cache.cross_v)
    return cache._replace(cross_k=k8, cross_v=v8,
                          cross_k_scale=ks, cross_v_scale=vs)


def quantize_self_kv(cache: KVCache) -> KVCache:
    """Quantize the self K/V to int8 with one scale per cached row, after
    the prefill, for the x7 step (B8)."""
    from whisper_tpu_torch.ops.self_attention import quantize_self_cache

    k8, v8, ks, vs = quantize_self_cache(cache.self_k, cache.self_v)
    return cache._replace(self_k=k8, self_v=v8, self_k_scale=ks,
                          self_v_scale=vs)


def _logits(params: Params, x):
    """Tied output projection x [B, S, d] @ tok_emb.T in fp32 (an fp32
    matmul of the compute-dtype operands).  With int8 weights,
    ``tok_emb_q`` holds the [d, V] projection.  ``tok_emb_f32``, where the
    tree has it (``WhisperDecoder``), is tok_emb widened once: the same
    operand, not widened again every step."""
    dec = params["decoder"]
    emb_q = dec.get("tok_emb_q")
    if emb_q is not None:
        return torch.matmul(x.float(), _dequant(emb_q, x.dtype).float())
    emb = dec.get("tok_emb_f32")
    if emb is None:
        emb = dec["tok_emb"].float()
    return torch.matmul(x.float(), emb.T)


def decoder_prefill(params: Params, dims: WhisperDims, tokens, enc_states,
                    max_len: int, *, int8_cross_kv: bool = False,
                    prompt_mask=None, mesh=None,
                    cache: Optional[KVCache] = None):
    """Full-prompt decoder pass: logits [B, P, V] and a cache whose self-KV
    holds positions [0, P) and whose cross-KV is final.

    prompt_mask ([B, P] bool, False = a left pad slot) takes left-padded
    prompts of one static length (previous-text conditioning): a real token
    takes the position id of the real slots before it, a pad slot position
    0, and no pad slot is ever attended, so the real rows equal those of
    the unpadded shorter prompt.

    cache: a cache of these shapes (the cross K/V int8 with their scales
    when int8_cross_kv) to write into instead of a new one (a graphed
    loop's static state): its self K/V are zeroed and rows [0, P) written.
    Either way each layer's cross K/V (quantized where int8) go straight
    into their slots, so no stack of every layer's (nor its fp32 copy for
    the quantization) is made.

    mesh: the caches hold this rank's heads (``_decoder_blocks``)."""
    dec = params["decoder"]
    dtype = dec["tok_emb"].dtype
    b, p = tokens.shape
    h = _cols(dec["blocks"]["xk_w"]) // dims.head_dim   # the rank's heads
    enc = enc_states.to(dtype)
    l, t = dims.decoder_layers, enc.shape[1]
    if cache is None:
        cache = init_cache(dims, b, max_len, t, dtype, enc.device, heads=h,
                           int8_cross=int8_cross_kv)
    elif (cache.cross_k_scale is not None) != int8_cross_kv:
        raise ValueError("the cache's cross K/V do not match int8_cross_kv")
    else:
        cache.self_k.zero_()
        cache.self_v.zero_()
    # each layer's cross K/V (quantized where int8) straight into its slots
    for li in range(l):
        pb = _layer(dec["blocks"], li)
        for w, bias, slot, scale in (
                ("xk_w", None, cache.cross_k, cache.cross_k_scale),
                ("xv_w", "xv_b", cache.cross_v, cache.cross_v_scale)):
            x = _split_heads(_dense(enc, pb[w], bias and pb[bias]), h)
            if int8_cross_kv:
                _quant_cross(x, slot[li], scale[li])
            else:
                slot[li].copy_(x)

    ar = torch.arange(max_len, device=enc.device)
    mask = ar[None, :] <= ar[:p, None]                         # [P, S_max]
    if prompt_mask is None:
        x = dec["tok_emb"][tokens] + dec["pos_embed"][:p].to(dtype)
    else:
        prompt_mask = prompt_mask.to(device=enc.device, dtype=torch.bool)
        pos_ids = torch.clamp_min(torch.cumsum(prompt_mask.long(), 1) - 1, 0)
        x = dec["tok_emb"][tokens] + dec["pos_embed"][pos_ids].to(dtype)
        valid_k = torch.cat([prompt_mask, prompt_mask.new_ones(
            (b, max_len - p))], dim=1)                         # [B, S_max]
        mask = (mask[None] & valid_k[:, None, :])[:, None]     # [B,1,P,S]
    x, cache = _decoder_blocks(params, dims, x, cache, 0, mask, mesh=mesh)
    return _logits(params, x), cache


def decoder_alignment_weights(params: Params, dims: WhisperDims, tokens,
                              enc_states, mesh=None) -> torch.Tensor:
    """Teacher-forced pass over ``tokens`` [B, P] (prompt + generated,
    padded): the cross-attention probabilities [L, B, H, P, T_enc], fp32,
    the raw material of word timings (``pipeline.words``).  As in the JAX
    function: causal self-attention over the P tokens alone (no cache), the
    cross K/V in the weights' dtype (never int8), fp32 scores and softmax,
    exact erf GELU; plain products, no kernel.  Under a mesh each rank
    computes its heads and the probabilities are all-gathered over
    "model", so every rank returns all heads."""
    dec = params["decoder"]
    dtype = dec["tok_emb"].dtype
    p = tokens.shape[1]
    d = dims.d_model
    h = _cols(dec["blocks"]["q_w"]) // dims.head_dim    # the rank's heads
    enc = enc_states.to(dtype)
    x = dec["tok_emb"][tokens] + dec["pos_embed"][:p].to(dtype)
    causal = torch.ones((p, p), dtype=torch.bool,
                        device=x.device).tril()[None, None]
    probs = []
    for li in range(dims.decoder_layers):
        pb = _layer(dec["blocks"], li)
        r = _layer_norm(x, pb["ln_s"], pb["ln_b"])
        q = _split_heads(_dense(r, pb["q_w"], pb["q_b"]), h)
        k = _split_heads(_dense(r, pb["k_w"], None), h)
        v = _split_heads(_dense(r, pb["v_w"], pb["v_b"]), h)
        o = _attend(q, k, v, causal)
        x = x + _row_dense(_merge_heads(o), pb["o_w"], pb["o_b"], mesh, d)

        r = _layer_norm(x, pb["x_ln_s"], pb["x_ln_b"])
        q = _split_heads(_dense(r, pb["xq_w"], pb["xq_b"]), h)
        ck = _split_heads(_dense(enc, pb["xk_w"], None), h)
        cv = _split_heads(_dense(enc, pb["xv_w"], pb["xv_b"]), h)
        qs = q * q.shape[-1] ** -0.5
        pr = torch.softmax(torch.matmul(qs.float(),
                                        ck.float().transpose(-1, -2)), -1)
        probs.append(pr)
        o = torch.matmul(pr.to(dtype), cv)
        x = x + _row_dense(_merge_heads(o), pb["xo_w"], pb["xo_b"], mesh, d)
        x = _decoder_mlp(x, pb, dims, mesh)
    probs = torch.stack(probs)
    if mesh is not None:
        from whisper_tpu_torch.parallel import mesh as pm

        probs = pm.all_gather(probs, mesh, pm.MODEL_AXIS, 2)
    return probs


def decoder_step(params: Params, dims: WhisperDims, token, pos,
                 cache: KVCache, *, kernel_step: bool = False,
                 cross_len: Optional[int] = None, int8_mxu: bool = True,
                 pad_count=None, mesh=None):
    """One-token pass at cache slot ``pos``: logits [B, V].  pos is an int
    (all rows aligned), a one-element integer tensor on the tokens' device
    (one position for every row, never read on the host: the graphed
    greedy loop advances it in place), or a [B] tensor that gives each row
    its own position (batched speculative decoding; at B = 1 the two
    tensor forms are one).

    kernel_step runs B3 (B8 against an int8 self cache) and, per int8_mxu,
    B4 (x5, x7) or B6 (x4); it needs the int8 cross cache and one position
    for all rows (an int or a one-element tensor).
    Without it, cross_len (the encoder length) keeps plain self-attention
    and runs cross-attention through B4 or B6 (the step a speculative draft
    takes); with neither, every block is plain torch.  An int8 self cache
    raises outside the kernel step.

    pad_count ([B] integer tensor: the left pad slots of a conditioned
    prompt, see ``decoder_prefill``): ``pos`` stays the cache slot, the
    position embedding takes pos - pad_count, and slots below pad_count are
    never attended, on every step above (B3 and B8 take it as a [B] int32
    tensor on the card).

    mesh: this rank's share of a (data, model) mesh (``parallel.mesh``):
    its rows, its heads in the cache, the row-parallel sums over "model".
    The logits that come back are the same on every model rank."""
    dec = params["decoder"]
    dtype = dec["tok_emb"].dtype
    max_len = cache.self_k.shape[3]
    ar = torch.arange(max_len, device=token.device)
    if kernel_step and isinstance(pos, torch.Tensor) and pos.numel() != 1:
        raise ValueError(
            "the kernel decode step (B3/B8) takes one position for all "
            "rows; per-row positions run the plain self-attention "
            "(kernel_step=False)")
    if pad_count is not None:
        pad_count = pad_count.to(device=token.device, dtype=torch.int32)
        pos_emb = dec["pos_embed"][pos - pad_count.long()].to(dtype)[:, None]
        slot = pos[:, None] if isinstance(pos, torch.Tensor) else pos
        mask = ((ar[None, :] <= slot) & (ar[None, :] >= pad_count[:, None])
                )[:, None, None, :]                            # [B,1,1,S]
    elif isinstance(pos, torch.Tensor):
        pos_emb = dec["pos_embed"][pos].to(dtype)[:, None, :]   # [B, 1, d]
        mask = (ar[None, :] <= pos[:, None])[:, None, None, :]  # [B,1,1,S]
    else:
        pos_emb = dec["pos_embed"][pos].to(dtype)
        mask = (ar <= pos)[None, :]
    x = dec["tok_emb"][token][:, None, :] + pos_emb
    if kernel_step:
        x, cache = _decoder_blocks_kernel(params, dims, x, cache, pos,
                                          cross_len, int8_mxu, pad_count,
                                          mesh=mesh)
    else:
        x, cache = _decoder_blocks(params, dims, x, cache, pos, mask,
                                   cross_len=cross_len, int8_mxu=int8_mxu,
                                   mesh=mesh)
    return _logits(params, x)[:, 0, :], cache


# ---------------------------------------------------------------------------
# Modules: the weights on a device
# ---------------------------------------------------------------------------

def _dense_leaves(tree: Dict, dtype: torch.dtype, keep=()) -> Dict:
    """Dequantize every QTensor of a subtree once (``_dequant``), except
    the leaves named in ``keep``."""
    return {k: _dense_leaves(v, dtype, keep) if isinstance(v, dict)
            else v if k in keep else _dequant(v, dtype)
            for k, v in tree.items()}


class _StackedWeights(nn.Module):
    """Buffers for a nested weight dict (a QTensor leaf as two buffers);
    ``tree()`` rebuilds the dict."""

    def __init__(self, tree: Dict, device):
        super().__init__()
        self._paths = []

        def walk(node, path):
            for k, v in node.items():
                if isinstance(v, dict):
                    walk(v, path + (k,))
                    continue
                name = "__".join(path + (k,))
                self._paths.append((path + (k,), isinstance(v, QTensor)))
                if isinstance(v, QTensor):
                    self.register_buffer(name + "__q", v.q.to(device))
                    self.register_buffer(name + "__s", v.s.to(device))
                else:
                    self.register_buffer(name, v.to(device))
        walk(tree, ())

    def tree(self) -> Dict:
        out: Dict = {}
        for path, quantized in self._paths:
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            name = "__".join(path)
            node[path[-1]] = (QTensor(getattr(self, name + "__q"),
                                      getattr(self, name + "__s"))
                              if quantized else getattr(self, name))
        return out


class WhisperEncoder(_StackedWeights):
    """Encoder weights ([L, ...] stacked) on ``device``; forward =
    :func:`encoder_apply`.  int8 weights are dequantized once, except the
    ones a W8A8 encoder (int8_activations, rung x6) multiplies as int8:
    q/k/v/o, and fc1/fc2 unless fused_mlp keeps the MLP half on B2.  Where
    fused_block engages, the [q|k|v] weight and bias are fused once."""

    def __init__(self, params_encoder: Dict, dims: WhisperDims, *, device,
                 fused_attention: bool = False, fused_mlp: bool = False,
                 int8_activations: bool = False, fused_block: bool = False,
                 mesh=None):
        from whisper_tpu_torch.ops.encoder_block import fused_block_mode

        dtype = params_encoder["conv1_w"].dtype
        fused = fused_block and fused_block_mode(
            dims.d_model, dims.d_ffn, dtype) is not None
        keep = ()
        if int8_activations and not fused:
            keep = ("q_w", "k_w", "v_w", "o_w") + (
                () if fused_mlp else ("fc1_w", "fc2_w"))
        tree = _dense_leaves(params_encoder, dtype, keep)
        if fused:
            blocks = dict(tree["blocks"])
            blocks["qkv_w"], blocks["qkv_b"] = fused_qkv(blocks, dtype)
            for k in ("q_w", "k_w", "v_w", "q_b", "v_b"):
                del blocks[k]
            tree = dict(tree, blocks=blocks)
        super().__init__(tree, device)
        self.dims = dims
        self.fused_attention = fused_attention
        self.fused_mlp = fused_mlp
        self.int8_activations = int8_activations
        self.fused_block = fused_block
        self.mesh = mesh

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        return encoder_apply({"encoder": self.tree()}, self.dims, mel,
                             fused_attention=self.fused_attention,
                             int8_activations=self.int8_activations,
                             fused_mlp=self.fused_mlp,
                             fused_block=self.fused_block, mesh=self.mesh)


class WhisperDecoder(_StackedWeights):
    """Decoder weights ([L, ...] stacked, int8 dequantized once; the int8
    ``tok_emb_q`` projection kept as its fp32-widened bf16 values, the
    operand ``_logits`` multiplies) on ``device``.  Without ``tok_emb_q``,
    ``tree()`` also holds ``tok_emb_f32``, tok_emb widened once (the
    operand ``_logits`` would otherwise widen every step: 4 x V x d bytes
    read and written a step)."""

    def __init__(self, params_decoder: Dict, dims: WhisperDims, *, device):
        dtype = params_decoder["tok_emb"].dtype
        tree = _dense_leaves(params_decoder, dtype)
        if "tok_emb_q" in tree:
            tree["tok_emb_q"] = tree["tok_emb_q"].float()
        super().__init__(tree, device)
        self.register_buffer(
            "tok_emb_f32", None if "tok_emb_q" in tree
            else self.tok_emb.float(), persistent=False)
        self.dims = dims

    def tree(self) -> Dict:
        out = super().tree()
        if self.tok_emb_f32 is not None:
            out["tok_emb_f32"] = self.tok_emb_f32
        return out

    def forward(self, token, pos, cache: KVCache, *,
                kernel_step: bool = False, cross_len: Optional[int] = None,
                int8_mxu: bool = True):
        return decoder_step({"decoder": self.tree()}, self.dims, token, pos,
                            cache, kernel_step=kernel_step,
                            cross_len=cross_len, int8_mxu=int8_mxu)
