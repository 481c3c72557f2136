"""PyTorch Whisper encoder/decoder (port of ``whisper_tpu.models.whisper``).

The JAX package's three jitted functions become plain functions over the
same stacked-layer parameter tree (torch tensors; ``QTensor`` int8
weights allowed):

- :func:`encoder_apply`   — log-mel [B, n_mels, 3000] -> states [B, 1500, d]
- :func:`decoder_prefill` — full-prompt pass; self-attention KV for the
  prompt and the cross-attention KV, computed once
- :func:`decoder_step`    — one token against the static-shape KV cache

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
``ops.encoder_mlp.fused_encoder_mlp`` (B2) in the encoder; at x5 the
decode step runs ``ops.self_attention.self_attend_step`` (B3) and
``ops.cross_attention.cross_attend_step`` (B4), replacing
``_decoder_blocks_packed``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from whisper_tpu_torch.models.registry import WhisperDims
from whisper_tpu_torch.variants.quant import QTensor

Params = Dict
LN_EPS = 1e-5


class KVCache(NamedTuple):
    """Static-shape KV cache, in the prefill layout at every rung.

    self_k/self_v: [L, B, H, S_max, Dh], written in place each step.
    cross_k/cross_v: [L, B, H, T_enc, Dh], computed once at prefill; int8
        with per-(L, B, H) fp32 scales [L, B, H, 1, 1] when int8_cross_kv.
    """

    self_k: torch.Tensor
    self_v: torch.Tensor
    cross_k: torch.Tensor
    cross_v: torch.Tensor
    cross_k_scale: Optional[torch.Tensor] = None
    cross_v_scale: Optional[torch.Tensor] = None


def sinusoid_position_embedding(length: int, channels: int) -> np.ndarray:
    """OpenAI Whisper sinusoidal embedding for the encoder (float32)."""
    assert channels % 2 == 0
    log_timescale_increment = np.log(10000.0) / (channels // 2 - 1)
    inv_timescales = np.exp(-log_timescale_increment * np.arange(channels // 2))
    scaled_time = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate(
        [np.sin(scaled_time), np.cos(scaled_time)], axis=1
    ).astype(np.float32)


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


def _dense(x, w, b):
    y = torch.matmul(x, _dequant(w, x.dtype))
    return y if b is None else y + b


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
                  fused_block: bool = False) -> torch.Tensor:
    """Encoder forward: mel [B, n_mels, T] -> hidden states [B, T//2, d].

    conv1d(k=3,s=1)+GELU, conv1d(k=3,s=2)+GELU, + sinusoidal positions,
    pre-LN blocks, final LayerNorm.  fused_attention runs B1, fused_mlp
    runs B2 (the port's B2 takes every width, so there is no chunked
    variant to choose)."""
    if int8_activations:
        raise NotImplementedError(
            "int8_activations (W8A8 encoder, rung x6) is not ported yet "
            "(ROADMAP queue 1 item 5)")
    if fused_block:
        raise NotImplementedError(
            "fused_encoder_block needs kernels B9a/B9b, not ported yet "
            "(ROADMAP queue 2, B9)")
    enc = params["encoder"]
    dtype = enc["conv1_w"].dtype
    x = mel.to(dtype)
    x = F.gelu(_conv1d(x, enc["conv1_w"], enc["conv1_b"], 1))
    x = F.gelu(_conv1d(x, enc["conv2_w"], enc["conv2_b"], 2))
    x = x.transpose(1, 2).contiguous()                       # [B, T', d]
    x = x + enc["pos_embed"][: x.shape[1]].to(dtype)
    h = dims.encoder_heads
    for li in range(dims.encoder_layers):
        p = _layer(enc["blocks"], li)
        r = _layer_norm(x, p["attn_ln_s"], p["attn_ln_b"])
        q = _dense(r, p["q_w"], p["q_b"])
        k = _dense(r, p["k_w"], None)
        v = _dense(r, p["v_w"], p["v_b"])
        o = _attend(_split_heads(q, h), _split_heads(k, h),
                    _split_heads(v, h), None, fused=fused_attention)
        x = x + _dense(_merge_heads(o), p["o_w"], p["o_b"])
        if fused_mlp:
            from whisper_tpu_torch.ops.encoder_mlp import fused_encoder_mlp

            x = fused_encoder_mlp(
                x, p["mlp_ln_s"], p["mlp_ln_b"],
                _dequant(p["fc1_w"], x.dtype), p["fc1_b"],
                _dequant(p["fc2_w"], x.dtype), p["fc2_b"])
        else:
            r = _layer_norm(x, p["mlp_ln_s"], p["mlp_ln_b"])
            r = F.gelu(_dense(r, p["fc1_w"], p["fc1_b"]))
            x = x + _dense(r, p["fc2_w"], p["fc2_b"])
    return _layer_norm(x, enc["ln_f_s"], enc["ln_f_b"])


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

def init_cache(dims: WhisperDims, batch: int, max_len: int, t_enc: int,
               dtype: torch.dtype, device) -> KVCache:
    l, h, dh = dims.decoder_layers, dims.decoder_heads, dims.head_dim

    def z(s):
        return torch.zeros((l, batch, h, s, dh), dtype=dtype, device=device)

    return KVCache(self_k=z(max_len), self_v=z(max_len),
                   cross_k=z(t_enc), cross_v=z(t_enc))


def _decoder_mlp(x, p):
    r = _layer_norm(x, p["mlp_ln_s"], p["mlp_ln_b"])
    r = F.gelu(_dense(r, p["fc1_w"], p["fc1_b"]))
    return x + _dense(r, p["fc2_w"], p["fc2_b"])


def _decoder_blocks(params: Params, dims: WhisperDims, x, cache: KVCache,
                    pos: int, self_mask):
    """All decoder blocks in plain torch (prefill at every rung, and the
    step at x0-x3): writes self-attention rows [pos, pos+S) of the cache in
    place and attends per ``self_mask``."""
    dec = params["decoder"]
    h = dims.decoder_heads
    s = x.shape[1]
    for li in range(dims.decoder_layers):
        p = _layer(dec["blocks"], li)
        r = _layer_norm(x, p["ln_s"], p["ln_b"])
        q = _split_heads(_dense(r, p["q_w"], p["q_b"]), h)
        cache.self_k[li, :, :, pos:pos + s] = _split_heads(
            _dense(r, p["k_w"], None), h)
        cache.self_v[li, :, :, pos:pos + s] = _split_heads(
            _dense(r, p["v_w"], p["v_b"]), h)
        o = _attend(q, cache.self_k[li], cache.self_v[li], self_mask)
        x = x + _dense(_merge_heads(o), p["o_w"], p["o_b"])

        r = _layer_norm(x, p["x_ln_s"], p["x_ln_b"])
        q = _split_heads(_dense(r, p["xq_w"], p["xq_b"]), h)
        if cache.cross_k_scale is not None:
            o = _attend_int8(q, cache.cross_k[li], cache.cross_v[li],
                             cache.cross_k_scale[li], cache.cross_v_scale[li])
        else:
            o = _attend(q, cache.cross_k[li], cache.cross_v[li], None)
        x = x + _dense(_merge_heads(o), p["xo_w"], p["xo_b"])
        x = _decoder_mlp(x, p)
    return _layer_norm(x, dec["ln_f_s"], dec["ln_f_b"]), cache


def _decoder_blocks_kernel(params: Params, dims: WhisperDims, x,
                           cache: KVCache, pos: int, cross_len: int):
    """Single-token decoder step through the x5 kernels, replacing the JAX
    package's ``_decoder_blocks_packed``: per layer, B3 attends and writes
    the self cache in place, B4 attends the int8 cross cache.  The caches
    keep the prefill layout (no packing step)."""
    from whisper_tpu_torch.ops.cross_attention import cross_attend_step
    from whisper_tpu_torch.ops.self_attention import self_attend_step

    dec = params["decoder"]
    h = dims.decoder_heads
    scale = dims.head_dim ** -0.5
    ks = cache.cross_k_scale[:, :, :, 0, 0]                    # [L, B, H]
    vs = cache.cross_v_scale[:, :, :, 0, 0]
    for li in range(dims.decoder_layers):
        p = _layer(dec["blocks"], li)
        r = _layer_norm(x, p["ln_s"], p["ln_b"])
        q = _dense(r, p["q_w"], p["q_b"])[:, 0]               # [B, d]
        k = _dense(r, p["k_w"], None)[:, 0]
        v = _dense(r, p["v_w"], p["v_b"])[:, 0]
        ctx = self_attend_step(
            (q * scale).reshape(-1, h, dims.head_dim),
            k.reshape(-1, h, dims.head_dim).contiguous(),
            v.reshape(-1, h, dims.head_dim).contiguous(),
            cache.self_k, cache.self_v, li, pos)
        x = x + _dense(ctx.reshape(x.shape), p["o_w"], p["o_b"])

        r = _layer_norm(x, p["x_ln_s"], p["x_ln_b"])
        q = _dense(r, p["xq_w"], p["xq_b"])[:, 0]
        ctx = cross_attend_step(
            (q * scale).reshape(-1, h, dims.head_dim),
            cache.cross_k, cache.cross_v, ks, vs, li, s_valid=cross_len)
        x = x + _dense(ctx.reshape(x.shape), p["xo_w"], p["xo_b"])
        x = _decoder_mlp(x, p)
    return _layer_norm(x, dec["ln_f_s"], dec["ln_f_b"]), cache


def quantize_cross_kv(cache: KVCache) -> KVCache:
    """Quantize the cross K/V to symmetric int8 with per-(L,B,H) scales."""
    def quant(x):
        x32 = x.float()
        absmax = x32.abs().amax(dim=(3, 4), keepdim=True)
        scale = torch.clamp_min(absmax, 1e-12) / 127.0
        q = torch.clamp(torch.round(x32 / scale), -127, 127)
        return q.to(torch.int8), scale

    k8, ks = quant(cache.cross_k)
    v8, vs = quant(cache.cross_v)
    return cache._replace(cross_k=k8, cross_v=v8,
                          cross_k_scale=ks, cross_v_scale=vs)


def _logits(params: Params, x):
    """Tied output projection x [B, S, d] @ tok_emb.T in fp32 (an fp32
    matmul of the compute-dtype operands).  With int8 weights,
    ``tok_emb_q`` holds the [d, V] projection."""
    emb_q = params["decoder"].get("tok_emb_q")
    if emb_q is not None:
        return torch.matmul(x.float(), _dequant(emb_q, x.dtype).float())
    return torch.matmul(x.float(), params["decoder"]["tok_emb"].float().T)


def decoder_prefill(params: Params, dims: WhisperDims, tokens, enc_states,
                    max_len: int, *, int8_cross_kv: bool = False,
                    prompt_mask=None):
    """Full-prompt decoder pass: logits [B, P, V] and a cache whose self-KV
    holds positions [0, P) and whose cross-KV is final."""
    if prompt_mask is not None:
        raise NotImplementedError(
            "left-padded conditioned prompts are not ported yet "
            "(ROADMAP queue 1 item 8, sequential mode)")
    dec = params["decoder"]
    dtype = dec["tok_emb"].dtype
    b, p = tokens.shape
    h = dims.decoder_heads
    enc = enc_states.to(dtype)
    ck, cv = [], []
    for li in range(dims.decoder_layers):
        pb = _layer(dec["blocks"], li)
        ck.append(_split_heads(_dense(enc, pb["xk_w"], None), h))
        cv.append(_split_heads(_dense(enc, pb["xv_w"], pb["xv_b"]), h))
    cache = init_cache(dims, b, max_len, enc.shape[1], dtype, enc.device)
    cache = cache._replace(cross_k=torch.stack(ck), cross_v=torch.stack(cv))
    if int8_cross_kv:
        cache = quantize_cross_kv(cache)

    x = dec["tok_emb"][tokens] + dec["pos_embed"][:p].to(dtype)
    ar = torch.arange(max_len, device=enc.device)
    mask = ar[None, :] <= ar[:p, None]                         # [P, S_max]
    x, cache = _decoder_blocks(params, dims, x, cache, 0, mask)
    return _logits(params, x), cache


def decoder_step(params: Params, dims: WhisperDims, token, pos: int,
                 cache: KVCache, *, kernel_step: bool = False,
                 cross_len: Optional[int] = None):
    """One-token pass at cache slot ``pos`` (all rows aligned): logits
    [B, V].  kernel_step (x5) runs B3/B4 and needs the int8 cross cache."""
    dec = params["decoder"]
    dtype = dec["tok_emb"].dtype
    x = dec["tok_emb"][token][:, None, :] + dec["pos_embed"][pos].to(dtype)
    if kernel_step:
        x, cache = _decoder_blocks_kernel(params, dims, x, cache, pos,
                                          cross_len)
    else:
        max_len = cache.self_k.shape[3]
        mask = (torch.arange(max_len, device=x.device) <= pos)[None, :]
        x, cache = _decoder_blocks(params, dims, x, cache, pos, mask)
    return _logits(params, x)[:, 0, :], cache


# ---------------------------------------------------------------------------
# Modules: the weights on a device
# ---------------------------------------------------------------------------

def _dense_leaves(tree: Dict, dtype: torch.dtype) -> Dict:
    """Dequantize every QTensor of a subtree once (``_dequant``)."""
    return {k: _dense_leaves(v, dtype) if isinstance(v, dict)
            else _dequant(v, dtype) for k, v in tree.items()}


class _StackedWeights(nn.Module):
    """Buffers for a nested weight dict; ``tree()`` rebuilds the dict."""

    def __init__(self, tree: Dict, device):
        super().__init__()
        self._paths = []

        def walk(node, path):
            for k, v in node.items():
                if isinstance(v, dict):
                    walk(v, path + (k,))
                else:
                    self._paths.append(path + (k,))
                    self.register_buffer("__".join(path + (k,)),
                                         v.to(device))
        walk(tree, ())

    def tree(self) -> Dict:
        out: Dict = {}
        for path in self._paths:
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = getattr(self, "__".join(path))
        return out


class WhisperEncoder(_StackedWeights):
    """Encoder weights ([L, ...] stacked, int8 dequantized once) on
    ``device``; forward = :func:`encoder_apply`."""

    def __init__(self, params_encoder: Dict, dims: WhisperDims, *, device,
                 fused_attention: bool = False, fused_mlp: bool = False):
        dtype = params_encoder["conv1_w"].dtype
        super().__init__(_dense_leaves(params_encoder, dtype), device)
        self.dims = dims
        self.fused_attention = fused_attention
        self.fused_mlp = fused_mlp

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        return encoder_apply({"encoder": self.tree()}, self.dims, mel,
                             fused_attention=self.fused_attention,
                             fused_mlp=self.fused_mlp)


class WhisperDecoder(_StackedWeights):
    """Decoder weights ([L, ...] stacked, int8 dequantized once; the int8
    ``tok_emb_q`` projection kept as its fp32-widened bf16 values, the
    operand ``_logits`` multiplies) on ``device``."""

    def __init__(self, params_decoder: Dict, dims: WhisperDims, *, device):
        dtype = params_decoder["tok_emb"].dtype
        tree = _dense_leaves(params_decoder, dtype)
        if "tok_emb_q" in tree:
            tree["tok_emb_q"] = tree["tok_emb_q"].float()
        super().__init__(tree, device)
        self.dims = dims

    def forward(self, token, pos: int, cache: KVCache, *,
                kernel_step: bool = False, cross_len: Optional[int] = None):
        return decoder_step({"decoder": self.tree()}, self.dims, token, pos,
                            cache, kernel_step=kernel_step,
                            cross_len=cross_len)
