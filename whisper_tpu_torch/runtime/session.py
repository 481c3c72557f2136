"""Inference session (port of ``whisper_tpu.runtime.session``).

``RuntimeCfg`` keeps the JAX package's field names and defaults, so a
ladder rung or a discovery config means the same thing to both packages.
``WhisperSession`` holds the weights on one device and runs the long-form
main path: the streamed slab log-mel, chunk slicing on the device, the
encoder and greedy decoding per batch bucket.

What the slice does not carry raises ``NotImplementedError`` naming its
ROADMAP item; nothing silently takes another path.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from whisper_tpu_torch.models.convert import params_from_numpy
from whisper_tpu_torch.models.registry import WhisperDims
from whisper_tpu_torch.models.whisper import WhisperDecoder, WhisperEncoder
from whisper_tpu_torch.ops.common import disable_tf32
from whisper_tpu_torch.runtime.generate import (
    build_suppress_mask,
    greedy_generate,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass
class RuntimeCfg:
    """Runtime configuration: the JAX package's fields and defaults.

    On the card the port runs fp32 matmuls in full fp32 whatever
    ``matmul_precision`` says ('high', rung x1, runs like 'highest', as the
    JAX package does on a CPU).  ``donate_cache`` has nothing to select:
    the caches are updated in place.  The ORT echo fields (intra_op ...
    allow_spinning) are carried for the schema only."""

    dtype: str = "bfloat16"
    matmul_precision: str = "default"
    max_batch: int = 16
    donate_cache: bool = True
    fused_frontend: bool = False
    fused_attention: bool = False
    int8_weights: bool = False
    int8_kv_cache: bool = False
    packed_cross_kv: bool = False
    int8_mxu_attn: bool = False
    int8_self_kv: bool = False
    int8_encoder_act: bool = False
    fused_encoder_mlp: bool = False
    fused_encoder_block: bool = False
    fused_decoder_step: bool = False
    audio_transfer: str = "int16"
    streamed_mel: bool = True
    mel_slab_frames: int = 7680
    data_parallel: int = 1
    tensor_parallel: int = 1
    intra_op: int = 0
    inter_op: int = 1
    execution_mode: str = "SEQUENTIAL"
    graph_opt: str = "ENABLE_ALL"
    cpu_mem_arena: bool = True
    mem_pattern: bool = True
    allow_spinning: bool = True

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


def _bucket_batch(n: int, cap: int) -> int:
    """Next power of two >= n, capped at `cap`."""
    b = 1
    while b < n and b < cap:
        b <<= 1
    return min(b, cap)


def _check_supported(cfg: RuntimeCfg) -> None:
    """Raise NotImplementedError for configurations the slice lacks."""
    missing = []
    if cfg.data_parallel * cfg.tensor_parallel > 1:
        missing.append("meshes (data/tensor parallel): ROADMAP queue 1 "
                       "item 12")
    if cfg.fused_encoder_block:
        missing.append("fused_encoder_block: kernels B9a/B9b, ROADMAP "
                       "queue 2")
    if cfg.fused_decoder_step:
        missing.append("fused_decoder_step: kernels B10a-c, ROADMAP queue 2")
    if cfg.int8_encoder_act:
        missing.append("int8_encoder_act (rung x6, W8A8 encoder): ROADMAP "
                       "queue 1 item 5")
    if cfg.int8_self_kv:
        missing.append("int8_self_kv (rung x7): kernel B8, ROADMAP queue 2")
    if (cfg.packed_cross_kv and cfg.int8_kv_cache
            and not cfg.int8_mxu_attn):
        missing.append("the x4 decode step (int8 cross cache dequantized "
                       "in the kernel): kernel B6, ROADMAP queue 2")
    if cfg.audio_transfer not in ("int16", "float32"):
        missing.append(f"audio_transfer {cfg.audio_transfer!r}: only int16 "
                       "and float32 are ported (ROADMAP 'Not to port')")
    if missing:
        raise NotImplementedError("; ".join(missing))


class WhisperSession:
    """Weights + dims + cfg on one device, and the long-form path:
    ``compute_mel`` -> ``transcribe_from_mel``."""

    def __init__(self, params: Dict, dims: WhisperDims,
                 cfg: Optional[RuntimeCfg] = None, *, device):
        """params: the numpy tree of ``models.convert.init_params`` (or the
        JAX package's tree read back as numpy).  int8_weights quantizes it
        first with ``variants.quant.quantize_params``."""
        self.cfg = cfg or RuntimeCfg()
        _check_supported(self.cfg)
        disable_tf32()
        self.dims = dims
        self.device = torch.device(device)
        if self.cfg.int8_weights:
            from whisper_tpu_torch.variants.quant import (
                is_quantized,
                quantize_params,
            )

            if not is_quantized(params):
                params = quantize_params(params)
        tree = params_from_numpy(params, self.device, self.cfg.torch_dtype)
        self.encoder = WhisperEncoder(
            tree["encoder"], dims, device=self.device,
            fused_attention=self.cfg.fused_attention,
            fused_mlp=self.cfg.fused_encoder_mlp)
        self.decoder = WhisperDecoder(tree["decoder"], dims,
                                      device=self.device)
        self._decoder_params = {"decoder": self.decoder.tree()}
        # x5: the decode step runs kernels B3/B4 against the int8 cross
        # cache (the JAX package's packed + int8-MXU step).
        self._kernel_step = bool(self.cfg.packed_cross_kv
                                 and self.cfg.int8_kv_cache
                                 and self.cfg.int8_mxu_attn)
        self._masks: Dict = {}

    def _batch_bucket(self, n: int) -> int:
        """Power-of-two batch bucket, capped at max_batch."""
        return _bucket_batch(n, self.cfg.max_batch)

    def _get_masks(self, suppress_ids, begin_suppress_ids):
        key = (tuple(suppress_ids or ()), tuple(begin_suppress_ids or ()))
        if key not in self._masks:
            v = self.dims.vocab_size
            base = build_suppress_mask(v, suppress_ids)
            first = build_suppress_mask(
                v, list(suppress_ids or []) + list(begin_suppress_ids or []))
            self._masks[key] = (torch.from_numpy(base).to(self.device),
                                torch.from_numpy(first).to(self.device))
        return self._masks[key]

    def _encode_transfer(self, audio: np.ndarray) -> np.ndarray:
        """Host-side wire encoding: int16 PCM or float32 as it is."""
        if self.cfg.audio_transfer == "int16" and audio.dtype != np.int16:
            x = np.clip(np.asarray(audio, dtype=np.float32), -1.0, 1.0)
            return np.round(x * 32767.0).astype(np.int16)
        return audio

    def _upload(self, host: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(host)).to(self.device)

    # -- mel ----------------------------------------------------------------

    def compute_mel(self, padded_audio: np.ndarray, n_valid: int,
                    n_frames: int) -> torch.Tensor:
        """Whole-file log-mel [n_mels, n_frames] on the device: the streamed
        slab path for files over ``mel_slab_frames`` (cfg.streamed_mel),
        else the one-shot path."""
        if self.cfg.streamed_mel and n_valid > int(self.cfg.mel_slab_frames):
            return self.compute_mel_streamed(padded_audio, n_valid, n_frames)
        return self._compute_mel_single(padded_audio, n_valid, n_frames)

    def _compute_mel_single(self, padded_audio: np.ndarray, n_valid: int,
                            n_frames: int) -> torch.Tensor:
        """One-shot upload + whole-file mel (x0-x2: plain torch)."""
        if self.cfg.fused_frontend:
            raise NotImplementedError(
                "the one-shot mel at x3+ (files of at most mel_slab_frames "
                "frames) runs the fused mel kernel B5, not ported yet "
                "(ROADMAP queue 2, B5)")
        from whisper_tpu_torch.frontend.mel import log_mel_torch

        return log_mel_torch(self._upload(self._encode_transfer(padded_audio)),
                             n_valid, n_mels=self.dims.n_mels,
                             n_frames=n_frames)

    def encode_host_slab(self, padded_audio: np.ndarray, s0: int,
                         need: int) -> np.ndarray:
        """Samples [s0, s0+need) of the padded signal, zero-filled past its
        end, wire-encoded."""
        avail = padded_audio[s0: s0 + need]
        if avail.shape[0] < need:
            buf = np.zeros(need, dtype=np.float32)
            buf[: avail.shape[0]] = avail
        else:
            buf = np.ascontiguousarray(avail)
        return self._encode_transfer(buf)

    def compute_mel_streamed(self, padded_audio: np.ndarray, n_valid: int,
                             n_frames: int) -> torch.Tensor:
        """Whole-file log-mel computed slab by slab: per-slab raw log-specs
        and masked maxes, then one assembly with global max = max of the
        slab maxes (equal to the one-shot result, since frame f depends
        only on padded samples [160f, 160f+400))."""
        from whisper_tpu_torch.frontend.golden import HOP, WIN
        from whisper_tpu_torch.frontend.mel import log_spec_slab, normalize

        sf = int(self.cfg.mel_slab_frames)
        if n_valid <= sf:
            return self._compute_mel_single(padded_audio, n_valid, n_frames)
        n_slabs = -(-n_valid // sf)
        need = (sf + 2) * HOP
        assert need >= (sf - 1) * HOP + WIN
        padded_audio = np.asarray(padded_audio, dtype=np.float32)
        slabs, vmaxes = [], []
        for k in range(n_slabs):
            f0 = k * sf
            enc = self._upload(self.encode_host_slab(padded_audio, f0 * HOP,
                                                     need))
            ls, vm = log_spec_slab(enc, max(0, min(n_valid - f0, sf)),
                                   n_mels=self.dims.n_mels, n_frames=sf)
            slabs.append(ls)
            vmaxes.append(vm)
        ls = torch.cat(slabs, dim=1)
        total = n_slabs * sf
        if total > n_frames:
            ls = ls[:, :n_frames]
        elif total < n_frames:
            ls = F.pad(ls, (0, n_frames - total))
        return normalize(ls, torch.stack(vmaxes).amax(), n_valid)

    # -- chunks -> tokens ---------------------------------------------------

    def transcribe_from_mel(self, mel: torch.Tensor,
                            frame_starts: Sequence[int],
                            prompt: Sequence[int], max_new_tokens: int,
                            eot_id: int,
                            suppress_ids: Sequence[int] | None = None,
                            begin_suppress_ids: Sequence[int] | None = None,
                            *, num_beams: int = 1, ts_cfg=None,
                            temperature: float = 0.0, pad_count=None,
                            speculative: bool = False) -> np.ndarray:
        """Transcribe the 3000-frame chunks sliced (on the device) from a
        whole-file mel [n_mels, F]: tokens [len(frame_starts),
        max_new_tokens]."""
        for flag, item in ((num_beams > 1, "beam search: ROADMAP queue 1 "
                            "item 8"),
                           (ts_cfg is not None, "timestamp decoding: "
                            "ROADMAP queue 1 item 8"),
                           (temperature > 0.0, "temperature sampling: "
                            "ROADMAP queue 1 item 4"),
                           (pad_count is not None, "conditioned prompts: "
                            "ROADMAP queue 1 item 8"),
                           (speculative, "speculative decoding: ROADMAP "
                            "queue 1 item 11")):
            if flag:
                raise NotImplementedError(item)
        return self.gather_tokens(
            self.transcribe_from_mel_async(
                mel, frame_starts, prompt, max_new_tokens, eot_id,
                suppress_ids, begin_suppress_ids),
            len(frame_starts), max_new_tokens)

    def transcribe_from_mel_async(self, mel, frame_starts, prompt,
                                  max_new_tokens, eot_id, suppress_ids=None,
                                  begin_suppress_ids=None):
        """Per batch bucket: [(device tokens, start, n), ...]."""
        from whisper_tpu_torch.pipeline.chunk import CHUNK_FRAMES

        c = len(frame_starts)
        n_frames = mel.shape[1]
        mel_pad = F.pad(mel, (0, CHUNK_FRAMES))
        prompt_t = torch.as_tensor(np.asarray(prompt, dtype=np.int64),
                                   device=self.device)
        base_mask, first_mask = self._get_masks(suppress_ids,
                                                begin_suppress_ids)
        pieces = []
        start = 0
        while start < c:
            n = min(self.cfg.max_batch, c - start)
            bucket = self._batch_bucket(n)
            # Padding rows start at n_frames: they slice the zero tail.
            starts = [int(s) for s in frame_starts[start:start + n]]
            starts += [n_frames] * (bucket - n)
            chunks = torch.stack([mel_pad[:, s:s + CHUNK_FRAMES]
                                  for s in starts])
            enc = self.encoder(chunks)
            toks = greedy_generate(
                self._decoder_params, self.dims, enc, prompt_t, base_mask, first_mask,
                max_new_tokens=max_new_tokens, eot_id=eot_id,
                int8_cross_kv=self.cfg.int8_kv_cache,
                kernel_step=self._kernel_step)
            pieces.append((toks, start, n))
            start += n
        return pieces

    @staticmethod
    def gather_tokens(pieces, c: int, max_new_tokens: int) -> np.ndarray:
        """Copy the results of transcribe_from_mel_async to the host."""
        out = np.empty((c, max_new_tokens), dtype=np.int32)
        for toks, start, n in pieces:
            out[start:start + n] = toks[:n].cpu().numpy()
        return out
