"""Inference session (port of ``whisper_tpu.runtime.session``).

``RuntimeCfg`` keeps the JAX package's field names and defaults, so a
ladder rung or a discovery config means the same thing to both packages;
``suggested_cfg`` and ``load_best_cfg_from_discovery`` build one as the
JAX CLI does.  ``WhisperSession`` holds the weights on one device (one
rank's shard of them under a mesh, see below) and runs
the long-form path: the whole-file log-mel (streamed in slabs, or one shot
through kernel B5 at x3+), chunk slicing on the device, the encoder and
greedy decoding per batch bucket.

Every flag of ``RuntimeCfg`` runs for the greedy path: the ladder's rungs
x0-x7 (x6: the W8A8 encoder; x7: the int8 self cache through kernel B8),
``fused_encoder_block`` (kernels B9a, B1 and B9b, or B2 at d >= 1024) and
``fused_decoder_step`` (the hybrid step with kernel B10c).  The decoding
options of the JAX session run too: the timestamp grammar (``ts_cfg``),
temperature sampling with a seed and the scores the fallback ladder reads
(``with_scores``), and beam search (``num_beams``, ``runtime.beam``: B4 or
B6 at B*K rows).  ``set_draft_model`` attaches a draft for speculative
decoding (``transcribe_from_mel(speculative=True)``,
``runtime.speculative``: the verify pass runs kernel B7 where the greedy
step runs B4 or B6).  Left-padded conditioned prompts (``pad_count``) run
through the prefill and every step, B3 and B8 included, and
``alignment_weights`` gives the cross-attention of a teacher-forced pass
for word timings.  ``chunk_norm_n_valid`` takes a raw log-spec slab and
normalizes each chunk with its own max (``chunk_norm``,
``chunk_norm_window``: the pipelined long-form mode).  The serving
engine's short path, ``transcribe_short_batch`` and
``transcribe_short_speculative`` (and their ``_async`` forms, which leave
the tokens on the device), runs a batch of
reflect-padded utterances of at most 30 s through the plain mel, the
encoder and greedy or speculative decoding; ``transcribe_chunks`` and
``warmup`` take host mel chunks.

Greedy decoding, beam search and speculative decoding on a card run each
batch bucket as one launch of a CUDA graph captured once per key, the JAX
session's one program a bucket (``runtime.generate``, ``runtime.beam``,
``runtime.speculative``; the session keeps them all in ``graphs``, with
its encoder and the draft's weights once ``set_draft_model`` attaches
them, and ``warmup`` captures a bucket's program): a call gathers the
bucket's windows from the file's mel into the key's static chunks (the
short path copies its rows in as shipped), and the graph runs the chunk
normalisation, the encoder(s), the prefill and the first pick
(``generate.Front``, the loops' ``prepare``), then the step (a
speculative round) as the body of a while node that the card runs until
every row is done or the bound is reached, where the JAX ``while_loop``
stops.  No form reads ``done`` on the host there:
the ``_async`` forms of greedy decoding, beam search and speculative
decoding return once the work is queued, and ``gather_tokens`` (or the caller's
``.cpu()``) is the sync; the synchronous forms read once, at the end,
where the launches of the graphs' bodies are added
(``ops.common.settle_launches``).  ``eager_decode`` runs the loops
eagerly on the card (for comparisons), reading ``done`` once a step, as
the JAX loop stops.

``data_parallel`` x ``tensor_parallel`` > 1 (or an explicit ``mesh=``)
runs the session as one rank of a (data, model) mesh of processes
(``parallel.mesh``: one process a card, a ``torch.distributed`` group):
the weights are this rank's tensor-parallel shard, each batch bucket's
rows are split over "data" and the tokens all-gathered, and every rank
returns the whole batch's tokens.  On a card a rank's bucket runs as one
launch of its program, as without a mesh, wherever its collectives can be
captured (``generate.graphed``: a model axis of one rank, or one over
NCCL), the tokens' gather over "data" queued after the launch; a model
axis over gloo runs its loops eagerly, by that rule and before any
capture (``decode_path`` says which a call takes).

``audio_transfer`` picks the upload wire of every path that uploads audio
(the one-shot and streamed mels, the pipelined slabs, the short batch and
its speculative form), as in the JAX session: float32 ("f32", "float32",
"auto"), int16 PCM, or a compact encoding (dint16, dint16p, ulaw8, pcm12,
pcm14; ``utils.pcmpack``), encoded on the host and decoded on the device
(``frontend.mel.decode_transfer``).  A mode that names no wire raises.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from whisper_tpu_torch.models.convert import params_from_numpy
from whisper_tpu_torch.models.registry import WhisperDims
from whisper_tpu_torch.models.whisper import WhisperDecoder, WhisperEncoder
from whisper_tpu_torch.ops.common import disable_tf32, settle_launches
from whisper_tpu_torch.runtime.generate import (
    DecodeGraphs,
    Front,
    Gather,
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


def suggested_cfg() -> RuntimeCfg:
    """Built-in heuristic config (analog of suggested_optimum_cfg, ref
    src/main.rs:108-122): bf16, batch bucket 16, one device."""
    return RuntimeCfg(intra_op=min(os.cpu_count() or 8, 16))


def _coerce_bool(v, default: bool) -> bool:
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float)):
        return v != 0
    if isinstance(v, str):
        return v.strip().lower() in ("1", "true", "yes", "y", "on")
    return default


def _coerce_int(v, default: int) -> int:
    if isinstance(v, bool):
        return int(v)
    if isinstance(v, (int, float)):
        return int(v)
    if isinstance(v, str):
        try:
            return int(v.strip())
        except ValueError:
            return default
    return default


def _coerce_str(v, default: str) -> str:
    return v if isinstance(v, str) else default


def load_best_cfg_from_discovery(path: str) -> RuntimeCfg:
    """A tuned config from ``{"best": {...}}`` with the reference's lenient
    coercion rules (ref src/main.rs:124-167), extended with the TPU-native
    keys, as ``whisper_tpu.runtime.session.load_best_cfg_from_discovery``:
    a missing or ill-typed value takes the default."""
    with open(path) as f:
        outer = json.load(f)
    best = outer.get("best") or {}
    fb = suggested_cfg()
    coerce = {bool: _coerce_bool, int: _coerce_int, str: _coerce_str}
    values = {}
    for fld in dataclasses.fields(RuntimeCfg):
        default = getattr(fb, fld.name)
        values[fld.name] = coerce[type(default)](best.get(fld.name), default)
    return RuntimeCfg(**values)


def _bucket_batch(n: int, cap: int) -> int:
    """Next power of two >= n, capped at `cap`."""
    b = 1
    while b < n and b < cap:
        b <<= 1
    return min(b, cap)


# The encoded upload wires and their dtypes (utils.pcmpack,
# audio.resample.ulaw_encode); the other modes upload float32 as it is, as
# the JAX session's _encode_transfer does ("auto" is the CLI's probe, which
# names the wire before a session is made).
WIRE_DTYPES = {"int16": np.int16, "dint16": np.uint16, "dint16p": np.int8,
               "ulaw8": np.uint8, "pcm12": np.uint8, "pcm14": np.uint8}
TRANSFERS = ("f32", "float32", "auto") + tuple(WIRE_DTYPES)


def _check_supported(cfg: RuntimeCfg) -> None:
    """Raise ValueError for a configuration no session runs: an
    ``audio_transfer`` that names no upload wire (the JAX session would
    upload it as float32; the port never falls back)."""
    if cfg.audio_transfer not in TRANSFERS:
        raise ValueError(f"audio_transfer {cfg.audio_transfer!r} names no "
                         f"upload wire: one of {', '.join(TRANSFERS)}")


def chunk_norm(chunks: torch.Tensor, starts, n_valid) -> torch.Tensor:
    """Per-chunk normalization of raw log-spec windows [B, n_mels, 3000]
    cut at frame ``starts`` of a slab with ``n_valid`` valid frames (the
    JAX session's ``chunk_norm`` branch): each window's max over its valid
    frames (start + i < n_valid), a clamp at that max - 8, (x + 4) / 4,
    invalid frames 0.  A window with no valid frame (a bucket's padding
    row) has max -inf, leaves the clamp idle and comes out all zeros.
    starts: host ints or a [B] int64 tensor on the chunks' device; n_valid:
    an int or a one-element tensor there (a bucket program reads both on
    the card)."""
    from whisper_tpu_torch.pipeline.chunk import CHUNK_FRAMES

    dev = chunks.device
    if not torch.is_tensor(starts):
        starts = torch.as_tensor(list(starts), dtype=torch.int64).to(dev)
    frame_ix = starts[:, None] + torch.arange(CHUNK_FRAMES, device=dev)
    valid = (frame_ix < n_valid)[:, None, :]
    vmax = torch.where(valid, chunks, -torch.inf).amax(dim=(1, 2),
                                                       keepdim=True)
    out = (torch.maximum(chunks, vmax - 8.0) + 4.0) / 4.0
    return torch.where(valid, out, 0.0)


class WhisperSession:
    """Weights + dims + cfg on one device (a mesh rank's shard under
    data/tensor parallelism), and the long-form path:
    ``compute_mel`` -> ``transcribe_from_mel``."""

    def __init__(self, params: Dict, dims: WhisperDims,
                 cfg: Optional[RuntimeCfg] = None, *, device, mesh=None):
        """params: the numpy tree of ``models.convert.init_params`` (or the
        JAX package's tree read back as numpy).  int8_weights quantizes it
        first with ``variants.quant.quantize_params``.

        mesh: this process's ``parallel.mesh.Mesh``; without one,
        ``cfg.data_parallel * cfg.tensor_parallel > 1`` makes it over the
        process group (``make_mesh``, which raises naming torchrun when
        there is none).  The weights are then cut to this rank's shard
        (``shard_params``) before they reach the device."""
        self.cfg = cfg or RuntimeCfg()
        _check_supported(self.cfg)
        disable_tf32()
        self.dims = dims
        self.device = torch.device(device)
        n_mesh = self.cfg.data_parallel * self.cfg.tensor_parallel
        if mesh is None and n_mesh > 1:
            from whisper_tpu_torch.parallel.mesh import make_mesh

            mesh = make_mesh(n_mesh, model_parallel=self.cfg.tensor_parallel)
        self.mesh = mesh
        self._replicate_warned: set = set()
        if self.cfg.int8_weights:
            from whisper_tpu_torch.variants.quant import (
                is_quantized,
                quantize_params,
            )

            if not is_quantized(params):
                params = quantize_params(params)
        if mesh is not None:
            from whisper_tpu_torch.parallel.mesh import shard_params

            self._check_mesh(dims, mesh)
            params = shard_params(params, mesh, whole=self._whole_leaves())
        tree = params_from_numpy(params, self.device, self.cfg.torch_dtype)
        # W8A8 encoder (x6): only meaningful when the block weights are
        # QTensors, since the int8 product needs the int8 weight operand.
        self._enc_i8 = bool(self.cfg.int8_encoder_act
                            and self.cfg.int8_weights)
        if self._enc_i8 and self.cfg.fused_encoder_mlp:
            # Precedence (as in encoder_apply): the fused MLP kernel
            # dequantizes FC1/FC2 and runs bf16 products, overriding W8A8
            # for the MLP half.
            import warnings

            warnings.warn(
                "fused_encoder_mlp overrides int8_encoder_act for the "
                "encoder MLP half (bf16 fused kernel; W8A8 still applies "
                "to QKV/O)", stacklevel=2)
        self.encoder = WhisperEncoder(
            tree["encoder"], dims, device=self.device,
            fused_attention=self.cfg.fused_attention,
            fused_mlp=self.cfg.fused_encoder_mlp,
            int8_activations=self._enc_i8,
            fused_block=self.cfg.fused_encoder_block, mesh=mesh)
        self.decoder = WhisperDecoder(tree["decoder"], dims,
                                      device=self.device)
        self._decoder_params = {"decoder": self.decoder.tree()}
        # Pre-fused decoder weights for the hybrid step (built once).
        self._step_weights = None
        if self.cfg.fused_decoder_step:
            from whisper_tpu_torch.ops.decoder_kernels import (
                build_step_weights,
            )

            self._step_weights = build_step_weights(self._decoder_params,
                                                    dims)
        # x4/x5: the decode step runs kernel B3 and, against the int8 cross
        # cache, B4 (int8 x int8, x5) or B6 (dequantizing, x4): the JAX
        # package's packed step, which it takes for head_dim 64 and an even
        # head count only (generate.py:129-130), and under a mesh where the
        # head pairs divide the model axis (session.py:287-289); other dims
        # keep the plain step there and here.
        from whisper_tpu_torch.runtime.speculative import _kernel_cross

        self._packed = _kernel_cross(self.cfg.packed_cross_kv,
                                     self.cfg.int8_kv_cache, dims, mesh)
        self._kernel_step = self._packed
        self._int8_mxu = bool(self.cfg.int8_mxu_attn and self._kernel_step)
        # x7: the int8 self cache and kernel B8, only with the int8 x int8
        # step; on dims without the kernel step x7 behaves as x5 does there.
        self._int8_self = bool(self.cfg.int8_self_kv and self._int8_mxu)
        self._masks: Dict = {}
        # the captured decode loops on a card (greedy, beams, speculative
        # rounds), one per key, their state within a quarter of the card's
        # memory; eager_decode runs the loops on the card without them
        # (for comparisons)
        self.graphs = DecodeGraphs(self._decoder_params, self._step_weights,
                                   encoder=self.encoder)
        self.eager_decode = False
        self._draft = None  # (encoder or None, decoder params, dims)
        # (verify rounds [1], committed tokens [B], both on the device) per
        # batch bucket of the last speculative transcribe_from_mel call
        self.speculative_stats: list = []

    @staticmethod
    def _check_mesh(dims: WhisperDims, mesh) -> None:
        """Tensor parallelism splits whole heads and MLP columns."""
        tp = mesh.model
        for what, n in (("encoder heads", dims.encoder_heads),
                        ("decoder heads", dims.decoder_heads),
                        ("d_ffn", dims.d_ffn)):
            if n % tp:
                raise ValueError(f"tensor_parallel={tp} must divide the "
                                 f"{what} ({n})")

    def _whole_leaves(self) -> tuple:
        """Weights kept whole on every model rank: those of the fused
        kernels whose fusion crosses the row-parallel sum (FC2's bias and
        the residual inside B2, B9b and B10c; B9b's O product too)."""
        mlp = ("fc1_w", "fc1_b", "fc2_w")
        whole = []
        if self.cfg.fused_encoder_mlp or self.cfg.fused_encoder_block:
            whole += [f"encoder/blocks/{k}" for k in mlp]
        if self.cfg.fused_encoder_block:
            whole.append("encoder/blocks/o_w")
        if self.cfg.fused_decoder_step:
            whole += [f"decoder/blocks/{k}" for k in mlp]
        return tuple(whole)

    def _batch_bucket(self, n: int) -> int:
        """Power-of-two batch bucket, capped at max_batch and, under a
        mesh, rounded up to the data axis so its rows divide evenly (a
        40 s file is 2 chunks; on a data axis of 4 it buckets to 4)."""
        b = _bucket_batch(n, self.cfg.max_batch)
        if self.mesh is not None:
            b = max(b, self.mesh.data)
        return b

    def _data_rows(self, n: int):
        """(lo, hi): this rank's contiguous rows of a batch of n (all of
        them without a mesh).  A batch that does not divide the data axis
        runs replicated on every rank, with a warning once a size (the
        JAX session's ``_put_batch``)."""
        from whisper_tpu_torch.parallel.mesh import data_rows

        rows = data_rows(n, self.mesh)
        if rows is not None:
            return rows
        if n not in self._replicate_warned:
            self._replicate_warned.add(n)
            import warnings

            warnings.warn(
                f"batch of {n} does not divide the data-parallel axis "
                f"({self.mesh.data}); running replicated on every rank (no "
                "DP speedup) for this batch", stacklevel=3)
        return 0, n

    @property
    def decode_path(self) -> str:
        """Which path the session's decode loops take (``generate.graphed``,
        the one rule): "graphed" (one launch of a bucket's program), else
        "eager (...)" with the rule's reason."""
        from whisper_tpu_torch.runtime.generate import graphed

        if graphed(self.device, self.mesh, self.eager_decode):
            return "graphed"
        if self.eager_decode:
            return "eager (eager_decode)"
        if self.device.type != "cuda":
            return "eager (not a card)"
        return (f"eager (the model axis of {self.mesh.model} ranks over "
                f"{self.mesh.model_backend}: its collectives go through "
                "the host and cannot be captured)")

    def _gather_rows(self, result, n: int):
        """A result of this rank's rows of a batch of n (a tensor or a
        tuple of them) as the whole batch's: all-gathered over "data"
        under a mesh, unless the batch ran replicated.  Queued on the
        stream behind the rank's program, read nothing on the host (over
        gloo the gather waits for the stream, as every gloo call does)."""
        if self.mesh is None or n % self.mesh.data:
            return result
        from whisper_tpu_torch.parallel.mesh import all_gather_rows

        if isinstance(result, tuple):
            return tuple(all_gather_rows(t, self.mesh) for t in result)
        return all_gather_rows(result, self.mesh)

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

    def _token_ids(self, ids) -> torch.Tensor:
        """Host token ids (a prompt, a prefix, teacher-forced tokens) as an
        int64 tensor on the host, clamped into the vocabulary as the JAX
        model's gather clamps them (``whisper.clamp_token_ids``): a decode
        program copies it into its static prompt."""
        from whisper_tpu_torch.models.whisper import clamp_token_ids

        return torch.from_numpy(clamp_token_ids(ids, self.dims.vocab_size))

    def _token_tensor(self, ids) -> torch.Tensor:
        """``_token_ids`` on the device."""
        return self._token_ids(ids).to(self.device)

    def _transfer_tag(self) -> str:
        """The decode's ``transfer`` tag for cfg.audio_transfer."""
        from whisper_tpu_torch.frontend.mel import transfer_tag

        return transfer_tag(self.cfg.audio_transfer)

    def _encode_transfer(self, audio: np.ndarray) -> np.ndarray:
        """Host-side upload encoding in cfg.audio_transfer, [..., L] (a
        batch's rows each on their own), as the JAX session's: int16 PCM;
        the compact wires of ``utils.pcmpack`` and ulaw8; float32 as it is
        for the float modes.  Audio already in the wire's dtype passes."""
        from whisper_tpu_torch.audio.resample import ulaw_encode
        from whisper_tpu_torch.utils.pcmpack import encode_wire

        mode = self.cfg.audio_transfer
        if mode not in WIRE_DTYPES or audio.dtype == WIRE_DTYPES[mode]:
            return audio
        return ulaw_encode(audio) if mode == "ulaw8" else encode_wire(audio,
                                                                      mode)

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
        """One-shot upload + whole-file mel: kernel B5 when
        cfg.fused_frontend (x3+), else the plain torch front end; the wire
        decoded on the device."""
        audio = self._upload(self._encode_transfer(padded_audio))
        if self.cfg.fused_frontend:
            from whisper_tpu_torch.ops.log_mel import log_mel
        else:
            from whisper_tpu_torch.frontend.mel import log_mel_torch as log_mel
        return log_mel(audio, n_valid, n_mels=self.dims.n_mels,
                       n_frames=n_frames, transfer=self._transfer_tag())

    def encode_host_slab(self, padded_audio: np.ndarray, s0: int,
                         need: int) -> np.ndarray:
        """Samples [s0, s0+need) of the padded signal, zero-filled past its
        end in float32 and then wire-encoded (zero bytes of a wire are not
        silence: dint16's running sum and pcm12's biased codes)."""
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
                                   n_mels=self.dims.n_mels, n_frames=sf,
                                   transfer=self._transfer_tag())
            slabs.append(ls)
            vmaxes.append(vm)
        ls = torch.cat(slabs, dim=1)
        total = n_slabs * sf
        if total > n_frames:
            ls = ls[:, :n_frames]
        elif total < n_frames:
            ls = F.pad(ls, (0, n_frames - total))
        return normalize(ls, torch.stack(vmaxes).amax(), n_valid)

    def chunk_norm_window(self, raw_ls: torch.Tensor, frame_start: int,
                          n_valid: int) -> torch.Tensor:
        """One normalized [n_mels, 3000] window sliced from a RAW log-spec
        slab, with its own masked max (the pipelined mode's language
        detection and word alignment): the slab given CHUNK_FRAMES zero
        columns, the window at ``frame_start``, then ``chunk_norm``."""
        from whisper_tpu_torch.pipeline.chunk import CHUNK_FRAMES

        win = F.pad(raw_ls, (0, CHUNK_FRAMES))[
            :, frame_start:frame_start + CHUNK_FRAMES]
        return chunk_norm(win[None], [frame_start], n_valid)[0]

    # -- chunks -> tokens ---------------------------------------------------

    def transcribe_from_mel(self, mel: torch.Tensor,
                            frame_starts: Sequence[int],
                            prompt: Sequence[int], max_new_tokens: int,
                            eot_id: int,
                            suppress_ids: Sequence[int] | None = None,
                            begin_suppress_ids: Sequence[int] | None = None,
                            *, num_beams: int = 1,
                            length_penalty: float = 1.0, ts_cfg=None,
                            temperature: float = 0.0, seed: int = 0,
                            with_scores: bool = False, pad_count=None,
                            chunk_norm_n_valid: int | None = None,
                            speculative: bool = False, draft_k: int = 4):
        """Transcribe the 3000-frame chunks sliced (on the device) from a
        whole-file mel [n_mels, F]: tokens [len(frame_starts),
        max_new_tokens]; with with_scores also (sum_lp, n_tok) per chunk,
        the quality signal of the temperature fallback.

        num_beams > 1: beam search (``runtime.beam``) with length_penalty.
        ts_cfg: the timestamp grammar.  temperature > 0 samples, each batch
        piece under the key of a generator seeded with ``seed * 100003 +
        start``, as the JAX session keys its draws (the key held in the
        loop's state, ``runtime.generate``).  speculative: draft-and-verify over the
        chunk batch with the attached draft model (``set_draft_model``),
        ``draft_k`` proposals a round; plain greedy decoding only.
        pad_count (an int): the prompt's first pad_count slots are left
        padding, the same for every chunk (``pipeline.sequential``'s
        previous-text conditioning); such a decode never takes the hybrid
        step (``fused_decoder_step``).
        chunk_norm_n_valid: ``mel`` is a RAW log-spec slab with this many
        valid frames (counted from its start), and each chunk window is
        normalized with its own masked max before the encoder
        (``chunk_norm``: the per-chunk semantics of
        ``pipeline.pipelined``), on every branch; not with pad_count."""
        if num_beams > 1 and (with_scores or temperature > 0.0):
            raise ValueError("num_beams > 1 does not compose with "
                             "with_scores/temperature (beam search is "
                             "deterministic and returns tokens only)")
        return self.gather_tokens(
            self.transcribe_from_mel_async(
                mel, frame_starts, prompt, max_new_tokens, eot_id,
                suppress_ids, begin_suppress_ids, num_beams=num_beams,
                length_penalty=length_penalty, ts_cfg=ts_cfg,
                temperature=temperature, seed=seed, with_scores=with_scores,
                pad_count=pad_count, chunk_norm_n_valid=chunk_norm_n_valid,
                speculative=speculative, draft_k=draft_k, early_exit=True),
            len(frame_starts), max_new_tokens, with_scores)

    def transcribe_from_mel_async(self, mel, frame_starts, prompt,
                                  max_new_tokens, eot_id, suppress_ids=None,
                                  begin_suppress_ids=None, *,
                                  num_beams: int = 1,
                                  length_penalty: float = 1.0, ts_cfg=None,
                                  temperature: float = 0.0, seed: int = 0,
                                  with_scores: bool = False, pad_count=None,
                                  chunk_norm_n_valid: int | None = None,
                                  speculative: bool = False,
                                  draft_k: int = 4,
                                  early_exit: bool = False):
        """Per batch bucket: [(device result, start, n), ...], the result
        the tokens or, with with_scores, (tokens, sum_lp, n_tok).  On a
        card greedy decoding, beam search (num_beams > 1) and speculative
        decoding read nothing on the host (the graphed loops stop on the
        card), so this returns once the buckets' work is queued, under a
        mesh with each bucket's gather over "data" (over NCCL; gloo waits
        for the stream); ``speculative_stats`` then holds each bucket's
        round count on the device, to read after the results.  early_exit
        is the eager loop's (the CPU, a model axis over gloo,
        ``eager_decode``): it reads ``done`` once a block of steps
        (``transcribe_from_mel``'s form), else every step runs; its
        speculative rounds always read."""
        if chunk_norm_n_valid is not None and pad_count is not None:
            raise ValueError("chunk_norm and conditioned prompts are "
                             "mutually exclusive")
        if speculative:
            if not self.has_draft:
                raise RuntimeError(
                    "speculative=True requires set_draft_model first")
            if (num_beams > 1 or ts_cfg is not None or temperature > 0.0
                    or with_scores or pad_count is not None):
                raise ValueError(
                    "speculative long-form composes with plain greedy only "
                    "(no beams/timestamps/temperature/scores/conditioning)")
        self.speculative_stats = []
        from whisper_tpu_torch.pipeline.chunk import CHUNK_FRAMES

        c = len(frame_starts)
        n_frames = mel.shape[1]
        # every window of the file's mel as a view [F + 1, n_mels, 3000]: a
        # bucket's are gathered by one indexed read into its program's
        # static chunks, outside the graph (the file's length stays out of
        # the key)
        windows = F.pad(mel, (0, CHUNK_FRAMES)).unfold(
            1, CHUNK_FRAMES, 1).transpose(0, 1)
        prompt_ids = self._token_ids(prompt)
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
            # this rank's rows under a mesh (all of them without one)
            lo, hi = self._data_rows(bucket)
            starts_t = torch.tensor(starts[lo:hi], dtype=torch.int64).to(
                self.device)
            front = self._chunk_front(Gather(windows, starts_t), starts_t,
                                      chunk_norm_n_valid, speculative)
            pads = None
            if pad_count is not None:
                pads = torch.full((hi - lo,), int(pad_count),
                                  dtype=torch.int32, device=self.device)
            if speculative:
                result, (rounds, committed) = self._speculative_tokens(
                    front, None, prompt_ids, base_mask, first_mask,
                    max_new_tokens, eot_id, draft_k, row0=lo)
                self.speculative_stats.append(
                    (rounds, self._gather_rows(committed, bucket)))
            elif num_beams > 1:
                from whisper_tpu_torch.runtime.beam import beam_generate

                result, _ = beam_generate(
                    self._decoder_params, self.dims, front, prompt_ids,
                    base_mask, first_mask, max_new_tokens, eot_id, num_beams,
                    length_penalty, ts_cfg=ts_cfg,
                    int8_cross_kv=self.cfg.int8_kv_cache,
                    packed_cross=self._packed,
                    int8_mxu=self._int8_mxu, pad_count=pads, mesh=self.mesh,
                    row0=lo, early_exit=early_exit, eager=self.eager_decode,
                    graphs=self.graphs)
            else:
                gen = None
                if temperature > 0.0:
                    gen = torch.Generator(device=self.device)
                    gen.manual_seed(seed * 100003 + start)
                result = self._greedy(front, prompt_ids, base_mask,
                                      first_mask, max_new_tokens, eot_id,
                                      ts_cfg=ts_cfg, temperature=temperature,
                                      generator=gen, with_scores=with_scores,
                                      pads=pads, row0=lo,
                                      early_exit=early_exit)
            pieces.append((self._gather_rows(result, bucket), start, n))
            start += n
        return pieces

    def _encoder_key(self, draft: bool) -> tuple:
        """What a bucket program's encoder work depends on: the session's
        encoder flags and, with a draft, whether the draft runs an encoder
        of its own."""
        key = (self.cfg.fused_attention, self.cfg.fused_encoder_mlp,
               self._enc_i8, self.cfg.fused_encoder_block)
        if draft:
            key += ("draft", self._draft[0] is None)
        return key

    def _encode(self, mel: torch.Tensor, draft: bool):
        """The encoder states of ``mel`` [B, n_mels, 3000]; with a draft,
        (the main model's, the draft's: its own encoder's, or with
        ``share_encoder`` the main one's)."""
        enc = self.encoder(mel)
        if not draft:
            return enc
        d_encoder = self._draft[0]
        return enc, (enc if d_encoder is None else d_encoder(mel))

    def _front(self, kind: tuple, inputs: tuple, encode, rows: int,
               draft: bool) -> Front:
        from whisper_tpu_torch.pipeline.chunk import CHUNK_FRAMES

        t_enc = (CHUNK_FRAMES + 1) // 2          # the stem's stride 2
        weights = (self.encoder,)
        if draft and self._draft[0] is not None:
            weights += (self._draft[0],)
        return Front(encode, inputs, kind + self._encoder_key(draft), rows,
                     t_enc, self.device, weights,
                     draft_length=t_enc if draft else None)

    def _chunk_front(self, chunks, starts_t: torch.Tensor, n_valid,
                     draft: bool) -> Front:
        """A chunk bucket's work ahead of the prefill, as the JAX
        session's ``_get_mel_fn`` program: with ``n_valid`` (a raw log-spec
        slab's valid frames) each window normalized with its own max
        (``chunk_norm``, reading the rows' starts and n_valid on the card),
        then the encoder, and with ``draft`` the draft's.  chunks: the
        bucket's windows (a ``Gather``)."""
        norm = n_valid is not None
        inputs = (chunks,)
        if norm:
            inputs += (starts_t, torch.full((1,), int(n_valid),
                                            dtype=torch.int64,
                                            device=self.device))

        def encode(x, starts=None, nv=None):
            if norm:
                x = chunk_norm(x, starts, nv)
            return self._encode(x, draft)

        kind = ("chunk-normalised chunks",) if norm else ("chunks",)
        return self._front(kind, inputs, encode, len(starts_t), draft)

    def _greedy(self, enc, prompt_t, base_mask, first_mask,
                max_new_tokens: int, eot_id: int, *, ts_cfg=None,
                temperature: float = 0.0, generator=None,
                with_scores: bool = False, pads=None, row0: int = 0,
                early_exit: bool = True):
        """``greedy_generate`` over encoder states with the session's
        rung: its kernels, its cross cache, its step, its mesh and its
        graphs."""
        return greedy_generate(
            self._decoder_params, self.dims, enc, prompt_t, base_mask,
            first_mask, max_new_tokens=max_new_tokens, eot_id=eot_id,
            ts_cfg=ts_cfg, int8_cross_kv=self.cfg.int8_kv_cache,
            kernel_step=self._kernel_step, int8_mxu=self._int8_mxu,
            int8_self=self._int8_self,
            # conditioned programs never take the hybrid step, which has no
            # pad mask (the JAX session's rule)
            step_weights=None if pads is not None else self._step_weights,
            temperature=temperature, generator=generator,
            return_logprobs=with_scores, pad_count=pads, mesh=self.mesh,
            row0=row0, early_exit=early_exit, graphs=self.graphs,
            eager=self.eager_decode)

    # -- short-utterance batch (serving fast path) --------------------------

    def _short_mel_device(self, audio: torch.Tensor,
                          n_valid: torch.Tensor) -> torch.Tensor:
        """The mel [B, n_mels, 3000] of wire-encoded rows on the device, as
        the JAX short program makes it: the wire decode, the zero tail up
        to the full window (the engine's trimmed uploads ship rows shorter)
        or the cut back to it, then one batched plain log-mel over every
        row's own valid frames (``n_valid`` [B] on the device).  The
        one-shot kernel B5 is not on this path: the JAX short program calls
        ``log_mel_jax`` whatever ``fused_frontend`` says."""
        from whisper_tpu_torch.frontend.mel import (
            decode_transfer,
            log_mel_batch,
        )
        from whisper_tpu_torch.pipeline.chunk import CHUNK_FRAMES

        full = CHUNK_FRAMES * 160 + 400
        audio = decode_transfer(audio, self._transfer_tag())
        short = full - audio.shape[-1]
        if short > 0:
            audio = F.pad(audio, (0, short))
        elif short < 0:      # rows shipped, or a pcm pack group, past it
            audio = audio[..., :full]
        return log_mel_batch(audio, n_valid, n_mels=self.dims.n_mels,
                             n_frames=CHUNK_FRAMES)

    def _short_rows(self, padded_audio: np.ndarray, n_valid_frames):
        """This rank's rows (all of them without a mesh) as host tensors:
        the audio wire-encoded as shipped, the valid frames int64."""
        lo, hi = self._data_rows(len(padded_audio))
        audio = np.ascontiguousarray(self._encode_transfer(
            np.asarray(padded_audio)[lo:hi]))
        n_valid = np.asarray(n_valid_frames)[lo:hi].astype(np.int64)
        return torch.from_numpy(audio), torch.from_numpy(n_valid)

    def _short_mel(self, padded_audio: np.ndarray,
                   n_valid_frames: np.ndarray) -> torch.Tensor:
        """The mel [B, n_mels, 3000] of a batch of reflect-padded rows of
        at most 30 s, run eagerly (``_short_mel_device``)."""
        audio, n_valid = self._short_rows(padded_audio, n_valid_frames)
        return self._short_mel_device(audio.to(self.device),
                                      n_valid.to(self.device))

    def _short_front(self, padded_audio, n_valid_frames,
                     draft: bool) -> Front:
        """The short program's work ahead of the prefill (the JAX
        session's short program): the rows uploaded into the key's static
        buffer as shipped (the key holds their length and wire), then on
        the card their mel (``_short_mel_device``), the encoder, and with
        ``draft`` the draft's.  The key holds the decode's tag beside the
        rows' dtype: ulaw8 and pcm12 rows are both uint8."""
        audio, n_valid = self._short_rows(padded_audio, n_valid_frames)

        def encode(a, nv):
            return self._encode(self._short_mel_device(a, nv), draft)

        return self._front(("short audio", self._transfer_tag()),
                           (audio, n_valid), encode, audio.shape[0], draft)

    def transcribe_short_batch(
        self,
        padded_audio: np.ndarray,        # [B, L] reflect-padded, <=30s each
        n_valid_frames: np.ndarray,      # [B] true frame counts
        prompt: Sequence[int],
        max_new_tokens: int,
        eot_id: int,
        suppress_ids: Sequence[int] | None = None,
        begin_suppress_ids: Sequence[int] | None = None,
        ts_cfg=None,
    ) -> np.ndarray:
        """A batch of short utterances through mel, encoder and greedy
        decoding (the continuous-batching serving path): tokens [B,
        max_new_tokens] int32."""
        toks = self.transcribe_short_batch_async(
            padded_audio, n_valid_frames, prompt, max_new_tokens, eot_id,
            suppress_ids, begin_suppress_ids, ts_cfg, early_exit=True,
        ).cpu().numpy().astype(np.int32)
        settle_launches()
        return toks

    def transcribe_short_batch_async(
        self,
        padded_audio: np.ndarray,
        n_valid_frames: np.ndarray,
        prompt: Sequence[int],
        max_new_tokens: int,
        eot_id: int,
        suppress_ids: Sequence[int] | None = None,
        begin_suppress_ids: Sequence[int] | None = None,
        ts_cfg=None,
        *,
        early_exit: bool = False,
    ) -> torch.Tensor:
        """transcribe_short_batch without the copy to the host: the tokens
        [B, max_new_tokens] as a tensor on the session's device.

        Rows may be shipped shorter than the 30 s window
        (``serve/engine.py``'s trimmed uploads); the zero tail is made on
        the device after the wire decode.  As the JAX program, this returns
        once the work is queued, before the decode ends: the greedy loop
        reads nothing on the host (one launch of a CUDA graph's while node
        on a card, stopping there once every row is done), so the engine's tick
        pipeline overlaps tick k's decode with the dispatch of tick k+1.
        early_exit is the eager loop's: it reads ``done`` once a block of
        steps (``transcribe_short_batch``'s form)."""
        base_mask, first_mask = self._get_masks(suppress_ids,
                                                begin_suppress_ids)
        front = self._short_front(padded_audio, n_valid_frames, False)
        return self._gather_rows(
            self._greedy(front, self._token_ids(prompt), base_mask,
                         first_mask, max_new_tokens, eot_id, ts_cfg=ts_cfg,
                         row0=self._data_rows(len(padded_audio))[0],
                         early_exit=early_exit),
            len(padded_audio))

    # -- word alignment --------------------------------------------------------

    def alignment_weights(self, mel_chunk, prompt: list,
                          gen_tokens: list) -> np.ndarray:
        """Cross-attention probabilities [L, H, P_pad, T_enc] (fp32 numpy)
        of one decoded chunk, teacher-forced
        (``whisper.decoder_alignment_weights``), for word timings.  The
        token rows are padded with zeros to a multiple of 16, as in the JAX
        session.  The encoder takes the JAX call's flags:
        ``fused_attention`` only (B1 at x3+), no fused MLP, no fused block,
        no W8A8 (``langdetect._plain_encoder_tree``); the decoder's cross
        K/V stay in the weights' dtype."""
        from whisper_tpu_torch.models import whisper
        from whisper_tpu_torch.runtime.langdetect import _plain_encoder_tree

        n = len(prompt) + len(gen_tokens)
        p_pad = max(16, -(-n // 16) * 16)
        toks = torch.zeros((1, p_pad), dtype=torch.long, device=self.device)
        toks[0, :n] = self._token_tensor(list(prompt) + list(gen_tokens))
        mel = torch.as_tensor(mel_chunk).to(self.device)
        enc = whisper.encoder_apply(
            {"encoder": _plain_encoder_tree(self)}, self.dims, mel[None],
            fused_attention=self.cfg.fused_attention, mesh=self.mesh)
        w = whisper.decoder_alignment_weights(self._decoder_params, self.dims,
                                              toks, enc, mesh=self.mesh)
        return w[:, 0].float().cpu().numpy()

    # -- speculative decoding ------------------------------------------------

    def set_draft_model(self, draft_params: Dict, draft_dims: WhisperDims,
                        share_encoder: bool = False) -> None:
        """Attach a draft model (e.g. a distilled decoder) for speculative
        decoding at any batch size (``runtime.speculative``; per-row cache
        positions let rows accept different draft lengths).  draft_params:
        a numpy weight tree, as the session's own.

        share_encoder: feed the MAIN model's encoder states to the draft's
        decoder instead of running the draft's encoder (right for
        distil-whisper checkpoints, whose decoder was distilled against the
        frozen teacher encoder).  It needs equal widths; the draft's encoder
        weights then never reach the device."""
        if share_encoder and draft_dims.d_model != self.dims.d_model:
            raise ValueError(
                "share_encoder requires the draft to share the main "
                f"model's width (draft d_model={draft_dims.d_model}, "
                f"main {self.dims.d_model})")
        if share_encoder:
            draft_params = {"decoder": draft_params["decoder"]}
        tree = params_from_numpy(draft_params, self.device,
                                 self.cfg.torch_dtype)
        # The draft's encoder runs plain: none of the fused flags.
        encoder = None if share_encoder else WhisperEncoder(
            tree["encoder"], draft_dims, device=self.device)
        decoder = WhisperDecoder(tree["decoder"], draft_dims,
                                 device=self.device)
        self._draft = (encoder, {"decoder": decoder.tree()}, draft_dims)
        # the speculative loops captured with an earlier draft go
        self.graphs.set_draft(self._draft[1], encoder)

        # Sizing is advisory and never fatal: both models' parameters, KV
        # caches and encoder states stay resident during a speculative
        # decode (``speculative_footprint``).
        warn = None
        try:
            from whisper_tpu_torch.utils import hbm

            warn = hbm.check_fit(
                self.speculative_footprint(draft_dims, share_encoder),
                label="speculative decode "
                f"(max_batch={self.cfg.max_batch})", device=self.device)
        except Exception:  # noqa: BLE001 (the estimate is a courtesy)
            pass
        if warn:
            import warnings

            warnings.warn(warn, ResourceWarning, stacklevel=2)

    def speculative_footprint(self, draft_dims: WhisperDims,
                              share_encoder: bool = False) -> dict:
        """The device bytes a speculative decode at max_batch keeps
        (``utils.hbm.decode_footprint``): both models' parameters, KV caches
        and encoder states, with max_len 132 = prompt (4) + the chunk
        decode's default 128 new tokens (the cross caches dominate the total
        anyway).  One copy of each cache: the eager loop updates it in
        place, and a graphed program's prefill writes its key's state in
        place.  A graphed session (``generate.graphed``: a card, not
        ``eager_decode``, a mesh whose collectives can be captured) also
        keeps the active key's graph pools (its encoders' and prefills'
        temporaries: the largest measured so far, or
        ``hbm.program_pool_bytes`` before any) and the budget other keys may
        keep (``generate.GRAPH_MEMORY_SHARE`` of the card's memory,
        ``generate._budget``).  Under a mesh every term is this rank's: its
        rows of the batch, its shard of the weights and heads, its
        program's pools; each rank keeps the budget on its own card (two
        ranks sharing one card keep a quarter each)."""
        from whisper_tpu_torch.runtime import generate
        from whisper_tpu_torch.utils import hbm

        wb = torch.empty((), dtype=self.cfg.torch_dtype).element_size()
        m = self.mesh
        dp, tp = (1, 1) if m is None else (m.data, m.model)
        graph = {}
        if generate.graphed(self.device, m, self.eager_decode):
            pool = hbm.program_pool_bytes(
                self.dims, -(-self.cfg.max_batch // dp), 4, act_bytes=wb,
                fused_attention=self.cfg.fused_attention,
                draft_dims=None if share_encoder else draft_dims,
                tensor_parallel=tp)
            pool = max([pool, *self.graphs.pools().values()])
            graph = dict(graph_pool=pool,
                         graph_kept=generate._budget(self.device))
        return hbm.decode_footprint(
            self.dims, self.cfg.max_batch, 132, weight_bytes=wb,
            kv_bytes=wb, int8_cross=self.cfg.int8_kv_cache,
            draft_dims=draft_dims, shared_draft_encoder=share_encoder,
            cache_copies=1.0, data_parallel=dp, tensor_parallel=tp, **graph)

    @property
    def has_draft(self) -> bool:
        return self._draft is not None

    def transcribe_short_speculative(
        self,
        padded_audio: np.ndarray,     # [B, L] reflect-padded, <=30s
        n_valid_frames: np.ndarray,   # [B]
        prompt: Sequence[int],
        max_new_tokens: int,
        eot_id: int,
        suppress_ids: Sequence[int] | None = None,
        begin_suppress_ids: Sequence[int] | None = None,
        draft_k: int = 4,
    ) -> np.ndarray:
        """The short batch of ``transcribe_short_batch`` decoded by
        draft-and-verify with the attached draft (``set_draft_model``):
        tokens [B, max_new_tokens] int32, the greedy tokens at the
        session's precision and cross-KV quantization."""
        toks = self.transcribe_short_speculative_async(
            padded_audio, n_valid_frames, prompt, max_new_tokens, eot_id,
            suppress_ids, begin_suppress_ids, draft_k,
        ).cpu().numpy().astype(np.int32)
        settle_launches()
        return toks

    def transcribe_short_speculative_async(
        self,
        padded_audio: np.ndarray,
        n_valid_frames: np.ndarray,
        prompt: Sequence[int],
        max_new_tokens: int,
        eot_id: int,
        suppress_ids: Sequence[int] | None = None,
        begin_suppress_ids: Sequence[int] | None = None,
        draft_k: int = 4,
    ) -> torch.Tensor:
        """transcribe_short_speculative without the copy to the host (the
        serving tick's speculative leg): the main encoder, the draft's own
        or with ``share_encoder`` the main one's states, then
        ``speculative_generate`` (its verify pass through B7).  Its rounds
        run on a card as one launch of a CUDA graph whose while node stops
        once every row is done, so like ``transcribe_short_batch_async`` it
        reads nothing and returns once that launch is queued, whatever the
        draft."""
        if not self.has_draft:
            raise RuntimeError("no draft model attached (set_draft_model)")
        base_mask, first_mask = self._get_masks(suppress_ids,
                                                begin_suppress_ids)
        toks, _ = self._speculative_tokens(
            self._short_front(padded_audio, n_valid_frames, True), None,
            self._token_ids(prompt), base_mask, first_mask, max_new_tokens,
            eot_id, draft_k, row0=self._data_rows(len(padded_audio))[0])
        return self._gather_rows(toks, len(padded_audio))

    def _speculative_tokens(self, chunks, enc, prompt_t, base_mask,
                            first_mask, max_new_tokens: int, eot_id: int,
                            draft_k: int, row0: int = 0):
        """Draft-and-verify over one chunk batch: (device tokens [B,
        max_new_tokens], (verify rounds, committed tokens [B]), all on the
        device).  chunks: the bucket's mel, whose draft states the draft's
        encoder makes here beside the main states ``enc``; or a ``Front``
        that runs both encoders in the program, and enc None.  row0: this
        rank's first row of the batch under a mesh.  The cross
        caches follow cfg.int8_kv_cache and the kernels the session's rung:
        the draft's steps through B4/B6, the verify pass through B7."""
        from whisper_tpu_torch.runtime.speculative import speculative_generate

        d_encoder, d_params, d_dims = self._draft
        enc_d = None
        if not isinstance(chunks, Front):
            enc_d = enc if d_encoder is None else d_encoder(chunks)
        else:
            enc = chunks
        packed = bool(self.cfg.packed_cross_kv and self.cfg.int8_kv_cache)
        toks, rounds, n_committed = speculative_generate(
            self._decoder_params, self.dims, d_params, d_dims, enc, enc_d,
            prompt_t, base_mask, first_mask, max_new_tokens=max_new_tokens,
            eot_id=eot_id, draft_k=draft_k,
            int8_cross_kv=self.cfg.int8_kv_cache, packed_draft=packed,
            packed_main=packed,
            int8_mxu=bool(self.cfg.int8_mxu_attn and packed), mesh=self.mesh,
            row0=row0, eager=self.eager_decode, graphs=self.graphs)
        return toks, (rounds, n_committed)

    # -- mel chunks -> tokens -------------------------------------------------

    def transcribe_chunks(
        self,
        mel_chunks: np.ndarray,          # [C, n_mels, 3000]
        prompt: Sequence[int],
        max_new_tokens: int,
        eot_id: int,
        suppress_ids: Sequence[int] | None = None,
        begin_suppress_ids: Sequence[int] | None = None,
    ) -> np.ndarray:
        """Transcribe C host mel chunks: tokens [C, max_new_tokens] int32.
        Chunks run in power-of-two buckets capped at max_batch, the padding
        rows all zeros, as in the JAX session."""
        from whisper_tpu_torch.pipeline.chunk import CHUNK_FRAMES

        c, n_mels, n_frames = mel_chunks.shape
        if n_frames != CHUNK_FRAMES:
            raise ValueError(f"mel chunks of {n_frames} frames, expected "
                             f"{CHUNK_FRAMES}")
        # Side by side on the frame axis, each chunk is the slice at its
        # own start; transcribe_from_mel's padding rows slice zeros.
        mel = torch.from_numpy(np.ascontiguousarray(
            np.asarray(mel_chunks, dtype=np.float32).transpose(1, 0, 2)
        ).reshape(n_mels, c * CHUNK_FRAMES)).to(self.device)
        return self.transcribe_from_mel(
            mel, [i * CHUNK_FRAMES for i in range(c)], prompt,
            max_new_tokens, eot_id, suppress_ids, begin_suppress_ids)

    def warmup(self, n_chunks: int, prompt: Sequence[int],
               max_new_tokens: int, eot_id: int) -> None:
        """Run the bucket that ``n_chunks`` lands in once on zeros.  There
        is nothing to compile: the first run builds the kernels (at first
        use), creates the libraries' handles, fills the allocator's cache at
        the bucket's sizes and, on a card, captures the bucket's program
        (the chunks' gather aside: the encoder, the prefill and the greedy
        loop in one graph), so that no later run of that key captures,
        whatever the file's length."""
        from whisper_tpu_torch.pipeline.chunk import CHUNK_FRAMES

        bucket = _bucket_batch(min(n_chunks, self.cfg.max_batch),
                               self.cfg.max_batch)
        mel = np.zeros((bucket, self.dims.n_mels, CHUNK_FRAMES),
                       dtype=np.float32)
        self.transcribe_chunks(mel, prompt, max_new_tokens, eot_id)

    @staticmethod
    def gather_tokens(pieces, c: int, max_new_tokens: int,
                      with_scores: bool = False):
        """Copy the results of transcribe_from_mel_async to the host:
        tokens [c, max_new_tokens] int32, with with_scores also sum_lp [c]
        fp32 and n_tok [c] int32; then the launches of the graphs' bodies
        that ran are counted (``ops.common.settle_launches``)."""
        out = np.empty((c, max_new_tokens), dtype=np.int32)
        sum_lp = np.zeros(c, dtype=np.float32)
        n_tok = np.zeros(c, dtype=np.int32)
        for result, start, n in pieces:
            if with_scores:
                toks, lp, nt = result
                sum_lp[start:start + n] = lp[:n].cpu().numpy()
                n_tok[start:start + n] = nt[:n].cpu().numpy()
            else:
                toks = result
            out[start:start + n] = toks[:n].cpu().numpy()
        settle_launches()
        if with_scores:
            return out, sum_lp, n_tok
        return out
