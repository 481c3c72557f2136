"""Whisper model-family dimension registry.

The reference loads architecture implicitly from exported ONNX graphs
(scripts/export_onnx_whisper.py:10-30); the TPU framework instead carries an
explicit dimension table for every Whisper family member so models can be
built (random-init or from converted HF weights) without network access.

Dimensions are the public OpenAI/HF Whisper architecture constants.

A copy of ``whisper_tpu.models.registry``, whose package ``__init__``
imports jax.
"""

from __future__ import annotations

from dataclasses import dataclass, asdict
from typing import Dict


@dataclass(frozen=True)
class WhisperDims:
    """Static architecture dimensions for one Whisper variant."""

    n_mels: int
    d_model: int
    encoder_layers: int
    encoder_heads: int
    decoder_layers: int
    decoder_heads: int
    vocab_size: int
    max_source_positions: int = 1500   # encoder output frames (30 s / 20 ms)
    max_target_positions: int = 448    # decoder context
    ffn_mult: int = 4

    @property
    def head_dim(self) -> int:
        return self.d_model // self.encoder_heads

    @property
    def d_ffn(self) -> int:
        return self.d_model * self.ffn_mult

    def to_dict(self) -> Dict:
        return asdict(self)


def _dims(n_mels, d, el, eh, dl, dh, vocab) -> WhisperDims:
    return WhisperDims(
        n_mels=n_mels, d_model=d,
        encoder_layers=el, encoder_heads=eh,
        decoder_layers=dl, decoder_heads=dh,
        vocab_size=vocab,
    )


# Multilingual vocab = 51865; English-only = 51864; large-v3 family = 51866.
MODEL_REGISTRY: Dict[str, WhisperDims] = {
    "openai/whisper-tiny":          _dims(80, 384, 4, 6, 4, 6, 51865),
    "openai/whisper-tiny.en":       _dims(80, 384, 4, 6, 4, 6, 51864),
    "openai/whisper-base":          _dims(80, 512, 6, 8, 6, 8, 51865),
    "openai/whisper-base.en":       _dims(80, 512, 6, 8, 6, 8, 51864),
    "openai/whisper-small":         _dims(80, 768, 12, 12, 12, 12, 51865),
    "openai/whisper-small.en":      _dims(80, 768, 12, 12, 12, 12, 51864),
    "openai/whisper-medium":        _dims(80, 1024, 24, 16, 24, 16, 51865),
    "openai/whisper-medium.en":     _dims(80, 1024, 24, 16, 24, 16, 51864),
    "openai/whisper-large":         _dims(80, 1280, 32, 20, 32, 20, 51865),
    "openai/whisper-large-v2":      _dims(80, 1280, 32, 20, 32, 20, 51865),
    "openai/whisper-large-v3":      _dims(128, 1280, 32, 20, 32, 20, 51866),
    "openai/whisper-large-v3-turbo": _dims(128, 1280, 32, 20, 4, 20, 51866),
    "distil-whisper/distil-large-v3": _dims(128, 1280, 32, 20, 2, 20, 51866),
    "distil-whisper/distil-medium.en": _dims(80, 1024, 24, 16, 2, 16, 51864),
    "distil-whisper/distil-small.en":  _dims(80, 768, 12, 12, 4, 12, 51864),
    # Tiny synthetic config for tests / CI (not a real checkpoint).
    "test/whisper-nano":            _dims(80, 64, 2, 2, 2, 2, 1000),
}


def get_dims(model_id: str) -> WhisperDims:
    """Look up dims for a model id; accepts bare names like 'whisper-base'
    and the barest CLI shorthand ('base', 'large-v3') the reference's
    scripts use (the reference's src/main.rs model-id handling is a plain
    string; our registry normalizes instead)."""
    if model_id in MODEL_REGISTRY:
        return MODEL_REGISTRY[model_id]
    for key in MODEL_REGISTRY:
        suffix = key.split("/", 1)[-1]
        if suffix == model_id or suffix == f"whisper-{model_id}":
            return MODEL_REGISTRY[key]
    raise KeyError(
        f"Unknown model id {model_id!r}; known: {sorted(MODEL_REGISTRY)}"
    )


def dims_from_hf_config(cfg) -> WhisperDims:
    """Build dims from a transformers WhisperConfig-like object or dict."""
    get = (lambda k: getattr(cfg, k)) if not isinstance(cfg, dict) else cfg.__getitem__

    def get_opt(k, default):
        try:
            return get(k)
        except (AttributeError, KeyError):
            return default

    d = get("d_model")
    # Real FFN widths, not an assumed 4*d (fine-tuned/custom checkpoints
    # may differ; the stacked param shapes and the fused-kernel VMEM
    # guards must see the true size).  The stacked pytree shares one
    # d_ffn for both towers — reject checkpoints that split them rather
    # than silently mis-shaping one side.
    e_ffn = get_opt("encoder_ffn_dim", 4 * d)
    d_ffn = get_opt("decoder_ffn_dim", 4 * d)
    if e_ffn != d_ffn:
        raise NotImplementedError(
            f"encoder_ffn_dim ({e_ffn}) != decoder_ffn_dim ({d_ffn}): the "
            "stacked param layout assumes one FFN width for both towers "
            "(a limit the JAX package shares, on no ROADMAP queue)")
    if e_ffn % d != 0:
        raise NotImplementedError(
            f"ffn dim {e_ffn} is not a multiple of d_model {d} (a limit "
            "the JAX package shares, on no ROADMAP queue)")
    return WhisperDims(
        n_mels=get("num_mel_bins"),
        d_model=d,
        encoder_layers=get("encoder_layers"),
        encoder_heads=get("encoder_attention_heads"),
        decoder_layers=get("decoder_layers"),
        decoder_heads=get("decoder_attention_heads"),
        vocab_size=get("vocab_size"),
        max_source_positions=get("max_source_positions"),
        max_target_positions=get("max_target_positions"),
        ffn_mult=e_ffn // d,
    )
