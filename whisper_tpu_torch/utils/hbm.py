"""Device-memory footprint estimator (port of ``whisper_tpu.utils.hbm``): a
gate that warns before a decode that cannot fit the card.

A speculative decode keeps TWO models' parameters, KV caches and encoder
states resident.  The sizes follow from static shapes, so they can be
priced before anything is allocated, and an operator can shrink
``max_batch`` while that is still cheap.

Estimates cover the long-lived residents: parameters, KV caches (self and
cross, floating point or int8) and encoder states; for a session whose
decodes run as CUDA-graph programs, also the active program's memory pool
(``program_pool_bytes``: the encoder's and the prefill's temporaries,
which the graph keeps) and what the other programs may keep.  Other
temporaries are excluded.  Treat the numbers as a tight lower bound and
keep 5-10% headroom.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

from whisper_tpu_torch.models.registry import WhisperDims

BUDGET_ENV = "WHISPER_TPU_HBM_GB"  # the JAX package's name, kept


def _param_counts(dims: WhisperDims, tensor_parallel: int = 1) -> tuple:
    """(encoder, decoder) parameter counts of the tree
    ``models.convert.init_params`` builds; with tensor_parallel > 1 those
    of one model rank's shard (``parallel.mesh.shard_params``: q/k/v/o and
    fc1/fc2 split, their o/fc2 biases, norms, convs and embeddings
    whole)."""
    d, f = dims.d_model, dims.d_ffn
    le, ld = dims.encoder_layers, dims.decoder_layers
    tp = tensor_parallel

    attn = (4 * d * d + 2 * d) // tp + d         # q/k/v/o weights, q/v/o bias
    mlp = (d * f + f + f * d) // tp + d          # fc1 + fc2
    ln = 2 * d                                   # scale + bias

    enc_layer = ln + attn + ln + mlp
    enc = (
        3 * dims.n_mels * d + d                  # conv1
        + 3 * d * d + d                          # conv2
        + dims.max_source_positions * d          # (sinusoidal, still stored)
        + le * enc_layer
        + ln                                     # ln_f
    )
    dec_layer = ln + attn + ln + attn + ln + mlp  # self + cross + mlp
    dec = (
        dims.vocab_size * d
        + dims.max_target_positions * d
        + ld * dec_layer
        + ln
    )
    return enc, dec


def param_count(dims: WhisperDims, tensor_parallel: int = 1) -> int:
    """Exact parameter count of the tree ``models.convert.init_params``
    builds (converted checkpoints mirror it), or of one model rank's
    shard."""
    return sum(_param_counts(dims, tensor_parallel))


def param_bytes(dims: WhisperDims, bytes_per_el: int = 2,
                tensor_parallel: int = 1) -> int:
    """Resident weight bytes (2 = bf16, 4 = fp32; the int8 variants store
    the matmul weights at 1 byte plus fp32 scales, about half of bf16)."""
    return param_count(dims, tensor_parallel) * bytes_per_el


def kv_cache_bytes(dims: WhisperDims, batch: int, max_len: int,
                   enc_len: Optional[int] = None, *, kv_bytes: int = 2,
                   int8_cross: bool = False, int8_self: bool = False,
                   heads: Optional[int] = None) -> int:
    """Bytes of one decoder KV cache as ``models.whisper.decoder_prefill``
    allocates it: self_k/self_v [L,B,H,max_len,Dh] and cross_k/cross_v
    [L,B,H,enc_len,Dh] (plus fp32 per-(L,B,H) scales when int8)."""
    enc_len = dims.max_source_positions if enc_len is None else enc_len
    l, h, dh = dims.decoder_layers, heads or dims.decoder_heads, dims.head_dim
    self_el = l * batch * h * max_len * dh
    cross_el = l * batch * h * enc_len * dh
    total = 2 * self_el * (1 if int8_self else kv_bytes)
    total += 2 * cross_el * (1 if int8_cross else kv_bytes)
    scales = 2 * l * batch * h * 4                # fp32 [L,B,H,1,1] k+v
    if int8_cross:
        total += scales
    if int8_self:
        total += scales
    return total


def decode_footprint(dims: WhisperDims, batch: int, max_len: int,
                     enc_len: Optional[int] = None, *, weight_bytes: int = 2,
                     kv_bytes: int = 2, int8_cross: bool = False,
                     int8_self: bool = False,
                     draft_dims: Optional[WhisperDims] = None,
                     shared_draft_params: bool = False,
                     shared_draft_encoder: bool = False,
                     cache_copies: float = 1.0, data_parallel: int = 1,
                     tensor_parallel: int = 1,
                     graph_pool: Optional[int] = None,
                     graph_kept: Optional[int] = None) -> Dict[str, int]:
    """Resident-set breakdown (bytes) of a greedy or speculative decode:
    {'params', 'kv_cache', 'enc_states', 'draft_*', 'total'}.

    draft_dims adds the draft's weights (unless shared_draft_params: the
    same buffers serve both models), its cache, and its encoder states.
    shared_draft_encoder (``set_draft_model(share_encoder=True)``): the
    draft's decoder reads the main model's encoder states, so neither the
    draft's encoder weights nor a second set of encoder states is resident.

    cache_copies multiplies the KV-cache terms.  The port's callers pass
    1.0: its eager loop updates the caches in place, and a graphed program
    (``runtime.generate``) has its prefill write the key's static state in
    place, so neither carries a second copy of them (the JAX package passes
    2.0 for the copies its compiled decode loop holds).

    graph_pool / graph_kept (a session whose decodes run as CUDA-graph
    programs): the active program's memory pools, and the bytes the other
    programs' keys may keep (``generate.GRAPH_MEMORY_SHARE`` of the card),
    each a term of its own; absent (None), the breakdown has neither key.

    data_parallel / tensor_parallel: the footprint of one rank of a
    (data, model) mesh: its share of the batch's rows, its shard of the
    weights and its heads of the main model's caches (the draft is whole on
    every rank)."""
    enc_len = dims.max_source_positions if enc_len is None else enc_len
    batch = -(-batch // data_parallel)
    out = {
        "params": param_bytes(dims, weight_bytes, tensor_parallel),
        "kv_cache": int(cache_copies * kv_cache_bytes(
            dims, batch, max_len, enc_len, kv_bytes=kv_bytes,
            int8_cross=int8_cross, int8_self=int8_self,
            heads=dims.decoder_heads // tensor_parallel)),
        "enc_states": batch * enc_len * dims.d_model * kv_bytes,
    }
    if draft_dims is not None:
        draft_count = (_param_counts(draft_dims)[1] if shared_draft_encoder
                       else param_count(draft_dims))
        out["draft_params"] = (
            0 if shared_draft_params else draft_count * weight_bytes
        )
        out["draft_kv_cache"] = int(cache_copies * kv_cache_bytes(
            draft_dims, batch, max_len, enc_len, kv_bytes=kv_bytes,
            int8_cross=int8_cross, int8_self=int8_self))
        out["draft_enc_states"] = (
            0 if shared_draft_encoder
            else batch * enc_len * draft_dims.d_model * kv_bytes
        )
    if graph_pool is not None:
        out["graph_pool"] = int(graph_pool)
    if graph_kept is not None:
        out["graph_kept"] = int(graph_kept)
    out["total"] = sum(out.values())
    return out


# A graph's private memory pool keeps more than its program's live peak:
# the caching allocator rounds blocks up and reuses a freed block only for
# a request that fits it.  On the card a bucket program's pools were
# 1.27-1.29x the live peak of its warm-up at bucket 16 and 1.28-1.60x at
# bucket 4, whisper-base and whisper-large-v3-turbo (``python -m
# whisper_tpu_torch.profile_ladder --pools``; PERF.md §6).
POOL_SLACK = 1.25


def program_pool_bytes(dims: WhisperDims, batch: int, prompt_len: int = 4,
                       enc_len: Optional[int] = None, *, act_bytes: int = 2,
                       fused_attention: bool = True,
                       draft_dims: Optional[WhisperDims] = None,
                       tensor_parallel: int = 1) -> int:
    """An estimate of the memory pool one bucket program's graph keeps
    (``runtime.generate``): the largest set of temporaries live at once in
    its pre-node work, which the graph holds between launches, times
    ``POOL_SLACK``.  In the encoder, the stem (the mel at fp32 and two conv
    outputs, each [B, d, 2T]) or a block: the six [B, T, d] activations a
    layer's names hold until the next layer rebinds them (the residual,
    LayerNorm's output, q, k, v and the attention's output), beside the
    larger of LayerNorm's four fp32 temporaries [B, T, d] and the MLP's
    (LayerNorm's output and the result [B, T, d], FC1's output and its
    GELU [B, T, d_ffn]: the unfused MLP's; B2 keeps fewer); and without
    the fused attention the fp32 scores and probabilities [B, H, T, T].
    Then the prefill: the encoder states, the fp32 logits [B, P, V] and
    one layer's cross K and V before their cache, with the fp32 copies its
    attention reads.  A draft with its own encoder adds its blocks' set
    (the main states live beside it); that encoder runs plain whatever
    ``fused_attention`` says (``session.set_draft_model``, as in the JAX
    package), so its set holds the scores and probabilities.

    A rank of a mesh: ``batch`` its rows; tensor_parallel its model axis,
    which splits the main encoder's q, k, v, FC1 columns and heads and the
    prefill's cross heads (a draft is whole on every rank)."""
    enc_len = dims.max_source_positions if enc_len is None else enc_len
    b, t, ab, tp = batch, enc_len, act_bytes, tensor_parallel

    def encoder(d: WhisperDims, split: int, fused: bool) -> int:
        stem = b * 2 * t * (4 * d.n_mels + 2 * ab * d.d_model)
        kept = b * t * ab * (2 * d.d_model + 4 * d.d_model // split)
        layer_norm = 4 * 4 * b * t * d.d_model
        mlp = b * t * ab * (2 * d.d_model + 2 * d.d_ffn // split)
        block = kept + max(layer_norm, mlp)
        if not fused:
            block += 2 * 4 * b * d.encoder_heads // split * t * t
        return max(stem, block)

    prefill = (b * t * dims.d_model * ab + 4 * b * prompt_len * dims.vocab_size
               + 2 * b * t * dims.d_model // tp * (ab + 4))
    total = max(encoder(dims, tp, fused_attention), prefill)
    if draft_dims is not None:
        total += encoder(draft_dims, 1, False) + b * t * dims.d_model * ab
    return int(POOL_SLACK * total)


def device_hbm_budget(device=None) -> Optional[int]:
    """The card's memory in bytes: the ``WHISPER_TPU_HBM_GB`` override when
    it parses as a number, else the total memory of ``device`` (the current
    CUDA card).  A malformed override falls through to the card's figure.
    None when there is no card to ask."""
    env = os.environ.get(BUDGET_ENV)
    if env:
        try:
            return int(float(env) * (1 << 30))
        except ValueError:
            pass
    import torch

    if device is not None and torch.device(device).type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    _, total = torch.cuda.mem_get_info(device)
    return int(total)


def check_fit(footprint: Dict[str, int], budget: Optional[int] = None, *,
              label: str = "decode", headroom: float = 0.95,
              device=None) -> Optional[str]:
    """A warning string when footprint['total'] exceeds headroom * budget;
    None when it fits or the budget is unknown.  Callers warn or raise as
    they see fit."""
    budget = device_hbm_budget(device) if budget is None else budget
    if not budget:
        return None
    total = footprint["total"]
    if total <= headroom * budget:
        return None
    gib = 1 << 30
    parts = ", ".join(
        f"{k}={v / gib:.2f}" for k, v in footprint.items() if k != "total"
    )
    return (
        f"{label}: resident device-memory estimate {total / gib:.2f} GiB "
        f"exceeds {headroom:.0%} of the {budget / gib:.2f} GiB budget "
        f"({parts}); reduce batch, shorten max_len, or enable int8 KV"
    )
