"""Benchmark CLI of the port: ``python -m whisper_tpu_torch.bench [flags]``
(port of ``whisper_tpu.bench.cli``, the reference binary's flag surface and
main loop: ref ``Args`` src/main.rs:23-86 and ``main`` :1065-1271).

``build_parser`` accepts every flag of the JAX CLI with the same names,
defaults and choices, and the three output files and the stdout report
keep its schemas.  The run is the chunked long-form path on the first CUDA
card (the kernels per ``--variant`` and the discovery config).  Without a
card the CLI exits with an error; it runs on the CPU, with the kernels'
plain versions, only when the caller asks for it: ``main(argv,
device="cpu")`` in process, or ``WHISPER_TPU_TORCH_DEVICE=cpu`` in the
environment of ``python -m whisper_tpu_torch.bench`` (the parser stays the
JAX CLI's, so there is no flag for it).  ``--onnx-dir`` keeps its name and
points at a model dir in the JAX package's format (``params.safetensors``
+ ``config.json`` + ``tokenizer.json`` + ``generation_config.json``).

Working flags: the chunked path, ``--variant x0..x7|int8``, ``--dtype``,
``--matmul-precision``, ``--max-batch``, ``--chunk-parallelism``,
``--audio-transfer`` (every wire of the JAX CLI; ``auto`` and
``auto-pcm`` time the candidates on the link to the card first:
``utils.wireprobe``, which prints ``[wire-probe] <mode>=<rate>MB/s ... ->
<mode>`` to stderr), ``--discovery-best-json``, ``--intra-op``
and ``--inter-op`` (``intra_op >= 2`` prefetches the next file and its mel
on a second thread), ``--warmup``, ``--limit-files``, ``--write-txt``,
``--tokenizer-json``, ``--allow-random-init``, ``--onnx-dir``,
``--profile-dir`` (a ``torch.profiler`` Chrome trace in place of the JAX
trace), speculative decoding (``--draft-dir`` or ``--draft-model-id``,
``--draft-k``, ``--draft-share-encoder``) and the decoding options:
``--timestamps``, ``--language auto``, ``--num-beams`` with
``--length-penalty``, ``--temperatures`` (the fallback ladder,
``pipeline.fallback``), ``--longform-mode sequential`` with
``--condition-on-prev-text`` (``pipeline.sequential``), ``--initial-prompt``
(``tokenizer.bpe.encode_text``, which needs the ``tokenizers`` package),
``--word-timestamps`` (``words`` in the per-file JSON, ``pipeline.words``),
``--write-srt``/``--write-vtt`` (``bench.subtitles``), ``--vad-filter``
with ``--vad-threshold-db`` (``audio.vad``) and ``--longform-mode
pipelined`` with ``--slab-chunks`` (per-chunk mel normalization, slab by
slab: ``pipeline.pipelined``), any file libav decodes (wav, flac, mp3:
``audio.io`` through the native decoder, built at first use), and
``--data-parallel``/``--tensor-parallel`` over a mesh of processes, one a
card (``parallel.mesh``): ``torchrun --nproc-per-node N -m
whisper_tpu_torch.bench --data-parallel N ...``, or ``--dcn-coordinator
host:port --dcn-num-processes N --dcn-process-id R`` in each process (0
and -1, the defaults, take ``WORLD_SIZE`` and ``RANK`` from the
environment).  Every rank decodes; rank 0 alone writes the CSV, the JSON,
the summary, the transcripts and the report.  The JAX CLI's refusals of
combinations stay as they are there; no flag is silently ignored.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from pathlib import Path
from typing import List, Optional

from whisper_tpu_torch.utils.device import DEVICE_ENV  # noqa: F401
from whisper_tpu_torch.utils.device import resolve_device as _device

AUDIO_EXTS = (".wav", ".flac", ".mp3")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="whisper_tpu_torch_bench",
        description="Whisper inference benchmark on an NVIDIA card "
                    "(reference-compatible CLI of the PyTorch port)",
    )
    # --- reference flag surface (ref src/main.rs:23-86) ---
    p.add_argument("--audio-dir", default="audio")
    p.add_argument("--model-id", default="openai/whisper-base")
    p.add_argument("--onnx-dir", default="whisper-base-with-past",
                   help="model dir (framework params + sidecars); reference "
                        "flag name kept for artifact compatibility")
    p.add_argument("--language", default="en",
                   help="language code, or 'auto' to detect from the first "
                        "30s window")
    p.add_argument("--task", default="transcribe")
    p.add_argument("--max-new-tokens", type=int, default=128)
    p.add_argument("--warmup", type=int, default=0)
    p.add_argument("--limit-files", type=int, default=0)
    p.add_argument("--discovery-best-json", default="")
    p.add_argument("--out-csv", default="results/benchmarks/inference_per_file.csv")
    p.add_argument("--out-json", default="results/benchmarks/inference_per_file.json")
    p.add_argument("--out-summary-json",
                   default="results/benchmarks/inference_summary.json")
    p.add_argument("--intra-op", type=int, default=0)
    p.add_argument("--inter-op", type=int, default=0)
    p.add_argument("--write-txt", action="store_true")
    p.add_argument("--write-srt", action="store_true",
                   help="write <stem>.srt subtitles (needs --word-timestamps "
                        "or --longform-mode sequential)")
    p.add_argument("--write-vtt", action="store_true",
                   help="write <stem>.vtt subtitles (needs --word-timestamps "
                        "or --longform-mode sequential)")
    p.add_argument("--tokenizer-json", default="")
    p.add_argument("--timestamps", action="store_true",
                   help="timestamp decoding (the grammar enforced; "
                        "<|x.xx|> markers in the text)")
    p.add_argument("--chunk-parallelism", type=int, default=0,
                   help="reference: rayon threads; here: chunk-batch cap "
                        "(rounded to a power of two)")
    p.add_argument("--chunk-length-s", type=float, default=30.0)
    p.add_argument("--overlap-s", type=float, default=5.0)
    p.add_argument("--num-beams", type=int, default=1,
                   help="beam search width (1 = greedy, matching the "
                        "reference rust SUT; >1 matches the python SUTs)")
    p.add_argument("--length-penalty", type=float, default=1.0)
    # --- extras of the JAX package ---
    p.add_argument("--variant", default="",
                   choices=["", "x0", "x1", "x2", "x3", "x4", "x5", "x6",
                            "x7", "int8"],
                   help="optimization-ladder variant: x0..x7, or int8 (= x4)")
    p.add_argument("--dtype", default="", choices=["", "float32", "bfloat16"])
    p.add_argument("--matmul-precision", default="",
                   choices=["", "default", "high", "highest", "float32"])
    p.add_argument("--max-batch", type=int, default=0)
    p.add_argument("--audio-transfer", default="",
                   choices=["", "f32", "int16", "dint16", "dint16p",
                            "pcm12", "pcm14", "ulaw8", "auto", "auto-pcm"],
                   help="host-to-card audio upload encoding; 'auto' "
                        "times int16 against the delta codings on this "
                        "link at startup and picks one; 'auto-pcm' also "
                        "races pcm12 (bit-packed truncated PCM: 25%% fewer "
                        "bytes, quantization noise near the log-mel clamp "
                        "floor; utils/pcmpack.py); pcm14 is explicit-only, "
                        "its 12.5%% cannot clear the probe's margin")
    p.add_argument("--allow-random-init", action="store_true",
                   help="build random-weight params from --model-id when the "
                        "model dir has no params.safetensors (benchmarking "
                        "without converted weights)")
    p.add_argument("--draft-dir", default="",
                   help="speculative decoding: model dir of a draft model "
                        "(e.g. a distilled decoder); the text stays the "
                        "greedy text")
    p.add_argument("--draft-model-id", default="",
                   help="with --allow-random-init semantics: build a "
                        "random-weight draft from this registry id")
    p.add_argument("--draft-k", type=int, default=4,
                   help="draft tokens proposed per verify round")
    p.add_argument("--draft-share-encoder", action="store_true",
                   help="feed the main model's encoder states to the draft's "
                        "decoder (the draft's encoder never runs; needs "
                        "equal d_model)")
    p.add_argument("--temperatures", default="",
                   help="comma list (e.g. '0,0.2,0.4,0.6,0.8,1') enabling "
                        "openai-whisper-style temperature-fallback decoding")
    p.add_argument("--longform-mode", default="chunked",
                   choices=["chunked", "sequential", "pipelined"],
                   help="chunked = reference rust strategy (fixed 30s windows"
                        " + overlap stitching); sequential = seek by the "
                        "predicted timestamps; pipelined = per-chunk mel "
                        "normalization, decoded slab by slab")
    p.add_argument("--slab-chunks", type=int, default=4)
    p.add_argument("--word-timestamps", action="store_true")
    p.add_argument("--vad-filter", action="store_true")
    p.add_argument("--vad-threshold-db", type=float, default=9.0)
    p.add_argument("--initial-prompt", default="")
    p.add_argument("--condition-on-prev-text", action="store_true")
    p.add_argument("--data-parallel", type=int, default=0)
    p.add_argument("--tensor-parallel", type=int, default=0)
    p.add_argument("--profile-dir", default="",
                   help="write a torch.profiler Chrome trace of the measured "
                        "loop to <dir>/trace.json")
    p.add_argument("--dcn-coordinator", default="")
    p.add_argument("--dcn-num-processes", type=int, default=0)
    p.add_argument("--dcn-process-id", type=int, default=-1)
    return p


def list_audio_files(audio_dir: str, limit: int) -> List[str]:
    """Sorted wav/flac/mp3 file names (ref src/main.rs:1111-1128)."""
    files = sorted(
        e.name
        for e in Path(audio_dir).iterdir()
        if e.is_file() and e.suffix.lower() in AUDIO_EXTS
    )
    if limit > 0:
        files = files[:limit]
    return files


def _build_session(args, cfg, device):
    from whisper_tpu_torch.models import convert
    from whisper_tpu_torch.models.registry import get_dims
    from whisper_tpu_torch.runtime.session import WhisperSession

    model_dir = args.onnx_dir
    params_path = os.path.join(model_dir, convert.PARAMS_FILE)
    if os.path.isfile(params_path):
        params, dims = convert.load_params(model_dir)
    elif args.allow_random_init:
        dims = get_dims(args.model_id)
        params = convert.init_params(dims, seed=0)
    else:
        raise SystemExit(
            f"model dir does not exist or has no {convert.PARAMS_FILE}: "
            f"{model_dir} (convert a checkpoint with python -m "
            f"whisper_tpu_torch.models.convert_cli --hf-dir HF_DIR --out-dir "
            f"{model_dir}, or pass --allow-random-init)"
        )
    return WhisperSession(params, dims, cfg, device=device)


def _join_processes(args, n_mesh: int) -> int:
    """Join the process group the run asks for and return this rank (0 in
    a world of one): ``--dcn-*`` (any of them given) over TCP, else the
    environment ``torchrun`` sets when the mesh has more than one process.
    A mesh of n_mesh > 1 processes in a world of one exits naming
    torchrun; it never runs on one card in silence."""
    import torch.distributed as dist

    from whisper_tpu_torch.parallel import mesh as pm

    defaults = build_parser().parse_args([])
    dcn = any(getattr(args, k) != getattr(defaults, k) for k in (
        "dcn_coordinator", "dcn_num_processes", "dcn_process_id"))
    if not dist.is_initialized():
        try:
            if dcn:
                pm.init_distributed(args.dcn_coordinator,
                                    args.dcn_num_processes,
                                    args.dcn_process_id)
            elif n_mesh > 1 and int(os.environ.get("WORLD_SIZE", "1")) > 1:
                pm.init_distributed()
        except RuntimeError as e:
            raise SystemExit(f"error: {e}")
    world = pm.world_size()
    if n_mesh > 1 and world == 1:
        raise SystemExit(
            f"error: --data-parallel x --tensor-parallel = {n_mesh} needs "
            f"{n_mesh} processes, one a card, and this is a world of one: "
            f"run {pm.torchrun_hint(n_mesh)}")
    if world > 1 and n_mesh != world:
        raise SystemExit(
            f"error: the process group holds {world} processes; pass "
            f"--data-parallel and --tensor-parallel whose product is {world}")
    return dist.get_rank() if dist.is_initialized() else 0


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: Optional[List[str]] = None, *, device=None) -> int:
    """Run the benchmark; ``device`` (``"cpu"``, ``"cuda"``) overrides the
    environment and the default, see ``_device``."""
    args = build_parser().parse_args(argv)
    if args.draft_k < 1:
        print(f"error: --draft-k must be >= 1, got {args.draft_k}",
              file=sys.stderr)
        return 2
    # the JAX CLI's refusals of combinations, in its order
    if args.vad_filter and args.longform_mode != "chunked":
        raise SystemExit("--vad-filter is supported in chunked long-form "
                         "mode (timestamps from other modes would be in "
                         "condensed time)")
    if args.temperatures and (args.initial_prompt or args.num_beams > 1
                              or args.word_timestamps or args.timestamps
                              or args.write_srt or args.write_vtt):
        # the fallback ladder decodes greedy or sampled, without prompts,
        # beams or timing output
        raise SystemExit("--temperatures does not compose with "
                         "--initial-prompt/--num-beams/--timestamps/"
                         "--word-timestamps/--write-srt/--write-vtt")
    if (args.write_srt or args.write_vtt) and not (
            args.word_timestamps or args.longform_mode == "sequential"):
        raise SystemExit(
            "--write-srt/--write-vtt need a cue timing source: pass "
            "--word-timestamps (any long-form mode) or "
            "--longform-mode sequential (timestamped segments)")
    device = _device(device)

    # Ensure output dirs (ref src/main.rs:1068-1071).
    for out in (args.out_csv, args.out_json, args.out_summary_json):
        parent = os.path.dirname(out)
        if parent:
            os.makedirs(parent, exist_ok=True)

    # Config resolution: heuristics < discovery json < CLI flags
    # (ref src/main.rs:1073-1084; SURVEY.md §5.6).
    from whisper_tpu_torch.runtime.session import (
        load_best_cfg_from_discovery,
        suggested_cfg,
    )

    cfg = (
        load_best_cfg_from_discovery(args.discovery_best_json)
        if args.discovery_best_json
        else suggested_cfg()
    )
    if args.intra_op > 0:
        cfg.intra_op = args.intra_op
    if args.inter_op > 0:
        cfg.inter_op = args.inter_op

    variant_note = ""
    if args.variant:
        from whisper_tpu_torch.variants.ladder import apply_variant

        cfg, spec = apply_variant(cfg, args.variant)
        variant_note = spec.description
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    if args.matmul_precision:
        cfg = dataclasses.replace(cfg, matmul_precision=args.matmul_precision)
    if args.max_batch > 0:
        cfg = dataclasses.replace(cfg, max_batch=args.max_batch)
    if args.audio_transfer in ("auto", "auto-pcm"):
        # time the candidate wires on this process's link to the card and
        # take the fastest (utils/wireprobe.py)
        from whisper_tpu_torch.utils.wireprobe import choose_audio_transfer

        mode, mbps = choose_audio_transfer(
            allow_pcm=args.audio_transfer == "auto-pcm", device=device)
        rates = " ".join(f"{m}={v:.0f}MB/s" for m, v in mbps.items())
        print(f"[wire-probe] {rates} -> {mode}", file=sys.stderr)
        cfg = dataclasses.replace(cfg, audio_transfer=mode)
    elif args.audio_transfer:
        cfg = dataclasses.replace(cfg, audio_transfer=args.audio_transfer)
    if args.data_parallel > 0:
        cfg = dataclasses.replace(cfg, data_parallel=args.data_parallel)
    if args.tensor_parallel > 0:
        cfg = dataclasses.replace(cfg, tensor_parallel=args.tensor_parallel)
    if args.chunk_parallelism > 0 and args.max_batch <= 0:
        # Reference semantics: cap on concurrently-processed chunks; an
        # explicit --max-batch outranks it.
        b = 1
        while b < args.chunk_parallelism and b < 64:
            b <<= 1
        cfg = dataclasses.replace(cfg, max_batch=b)
    rank = _join_processes(args, cfg.data_parallel * cfg.tensor_parallel)

    from whisper_tpu_torch.runtime.genconfig import load_generation_cfg
    from whisper_tpu_torch.tokenizer.specials import resolve_tokenizer

    tok = resolve_tokenizer(args.tokenizer_json, args.onnx_dir, args.model_id)
    tokenizer = tok[0] if tok else None
    tokenizer_path = str(tok[1]) if tok else ""
    gen_cfg = load_generation_cfg(
        os.path.join(args.onnx_dir, "generation_config.json")
    )

    initial_prompt_ids = None
    if args.initial_prompt:
        if not tokenizer_path:
            raise SystemExit("--initial-prompt needs a resolvable "
                             "tokenizer.json (pass --tokenizer-json or use "
                             "a model dir with one)")
        from whisper_tpu_torch.tokenizer.bpe import encode_text

        initial_prompt_ids = encode_text(tokenizer_path, args.initial_prompt)

    session = _build_session(args, cfg, device)

    speculative = bool(args.draft_dir or args.draft_model_id)
    if speculative:
        if (args.longform_mode not in ("chunked", "pipelined")
                or args.num_beams > 1
                or args.timestamps or args.word_timestamps
                or args.temperatures):
            raise SystemExit(
                "--draft-dir/--draft-model-id (speculative decoding) "
                "composes with plain greedy chunked/pipelined modes only")
        from whisper_tpu_torch.models import convert
        from whisper_tpu_torch.models.registry import get_dims

        if args.draft_dir:
            d_params, d_dims = convert.load_params(args.draft_dir)
        else:
            d_dims = get_dims(args.draft_model_id)
            d_params = convert.init_params(d_dims, seed=1)
        session.set_draft_model(d_params, d_dims,
                                share_encoder=args.draft_share_encoder)

    files = list_audio_files(args.audio_dir, args.limit_files)
    if not files:
        raise SystemExit(f"No audio files found in {args.audio_dir}")

    from whisper_tpu_torch.audio.io import load_audio_16k_mono
    from whisper_tpu_torch.bench.writers import (
        RowOut,
        build_summary,
        write_per_file_csv,
        write_per_file_json,
    )
    from whisper_tpu_torch.frontend import golden
    from whisper_tpu_torch.pipeline.chunk import mel_frame_bucket
    from whisper_tpu_torch.pipeline.longform import transcribe_longform

    def _transcribe(audio, pre_mel=None, words=None):
        return transcribe_longform(
            session, audio, args.language, args.task, args.max_new_tokens,
            args.chunk_length_s, args.overlap_s, tokenizer, args.timestamps,
            gen_cfg, args.num_beams, args.length_penalty,
            precomputed_mel=pre_mel, word_collector=words,
            initial_prompt_ids=initial_prompt_ids, speculative=speculative,
            draft_k=args.draft_k)

    def _vad_condense(audio):
        """--vad-filter: the audio condensed to its speech spans, and the
        map back to file time (None without the flag)."""
        if not args.vad_filter:
            return audio, None
        from whisper_tpu_torch.audio.vad import (
            VadOptions,
            collect_chunks,
            detect_speech,
        )

        spans = detect_speech(
            audio, VadOptions(threshold_db=args.vad_threshold_db))
        return collect_chunks(audio, spans)

    def _pipelined(audio, words=None):
        from whisper_tpu_torch.pipeline.pipelined import (
            transcribe_longform_pipelined,
        )

        return transcribe_longform_pipelined(
            session, audio, args.language, args.task, args.max_new_tokens,
            args.chunk_length_s, args.overlap_s, tokenizer, args.timestamps,
            gen_cfg, args.num_beams, args.length_penalty,
            slab_chunks=args.slab_chunks, word_collector=words,
            initial_prompt_ids=initial_prompt_ids, speculative=speculative,
            draft_k=args.draft_k)

    # Warmup (ref src/main.rs:1131-1152), and beyond it one run of every
    # (mel bucket, batch bucket) shape the files will hit, at the condensed
    # durations under --vad-filter.  The pipelined mode warms its own
    # entry point, one file per distinct duration (its slab geometry follows
    # the duration), then --warmup runs of the first file; every other mode
    # warms the chunked path, as the JAX CLI does.
    if args.warmup > 0 and args.longform_mode == "pipelined":
        a0 = _vad_condense(load_audio_16k_mono(
            os.path.join(args.audio_dir, files[0]))[0])[0]
        seen_durs = {round(len(a0) / 16000.0, 3)}
        for f in files[1:]:
            a, _, dur = load_audio_16k_mono(os.path.join(args.audio_dir, f))
            if round(dur, 3) not in seen_durs:
                seen_durs.add(round(dur, 3))
                _pipelined(a)
        for _ in range(args.warmup):
            _pipelined(a0)
    elif args.warmup > 0:
        from whisper_tpu_torch.pipeline.warmup import warm_buckets

        loaded = [_vad_condense(load_audio_16k_mono(
            os.path.join(args.audio_dir, f))[0])[0] for f in files]
        warm_buckets(
            session, durations_s=[len(a) / 16000.0 for a in loaded
                                  if len(a)],
            language=args.language, task=args.task,
            max_new_tokens=args.max_new_tokens,
            chunk_length_s=args.chunk_length_s, overlap_s=args.overlap_s,
            tokenizer=tokenizer, timestamps=args.timestamps, gen_cfg=gen_cfg,
            num_beams=args.num_beams, length_penalty=args.length_penalty,
            initial_prompt_ids=initial_prompt_ids,
            speculative=speculative, draft_k=args.draft_k)
        for _ in range(args.warmup):
            if len(loaded[0]) == 0:     # VAD condensed it to nothing
                break
            _transcribe(loaded[0])

    rows: List[RowOut] = []
    end2end, load_l, pre_l, model_l, dec_l, rtf_l = [], [], [], [], [], []
    txt_dir = os.path.dirname(args.out_csv) or "."

    # Host-side pipelining: with intra_op >= 2 the next file's decode,
    # resample, upload and mel (B5 on a one-shot file) run on a second
    # thread while the current file transcribes.  PyTorch gives both
    # threads the same default stream, so the device runs the two in the
    # order they were enqueued; transcribe_longform synchronizes before
    # preprocess_s is read, so load_s and preprocess_s measure only the
    # waits incurred.
    executor = None
    next_future = None
    if cfg.intra_op >= 2 and len(files) > 1:
        from concurrent.futures import ThreadPoolExecutor

        executor = ThreadPoolExecutor(max_workers=1)

    def _load(fnm, with_mel=False):
        """Load and resample; under --vad-filter condense to the speech
        spans (dur stays the file's: faster-whisper's RTF accounting); with
        with_mel also the device mel of a chunked run."""
        audio, sr, dur = load_audio_16k_mono(os.path.join(args.audio_dir, fnm))
        audio, smap = _vad_condense(audio)
        pre_mel = None
        # the fallback ladder and the sequential mode compute their own mel
        if (with_mel and len(audio) and not args.temperatures
                and args.longform_mode == "chunked"):
            total = golden.num_frames(len(audio))
            pre_mel = (session.compute_mel(golden.reflect_pad(audio), total,
                                           mel_frame_bucket(total)), total)
        return audio, sr, dur, pre_mel, smap

    if executor is not None:
        next_future = executor.submit(_load, files[0], True)

    prof = None
    if args.profile_dir:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()

    try:
        for idx, fnm in enumerate(files):
            tl0 = time.perf_counter()
            if executor is not None:
                audio, sr, dur, pre_mel, smap = next_future.result()
            else:
                audio, sr, dur, pre_mel, smap = _load(fnm)
            load_s = time.perf_counter() - tl0
            assert sr == 16_000
            if executor is not None and idx + 1 < len(files):
                next_future = executor.submit(_load, files[idx + 1], True)

            words = [] if args.word_timestamps else None
            segments = None
            if args.vad_filter and len(audio) == 0:
                # All silence: nothing to transcribe; the file still gets
                # its row and its (empty) outputs.
                from whisper_tpu_torch.utils.timing import Timing

                text, t = "", Timing(0.0, 0.0, 0.0, 0.0)
            elif args.longform_mode == "pipelined":
                text, t = _pipelined(audio, words)
            elif args.longform_mode == "sequential":
                from whisper_tpu_torch.pipeline.sequential import (
                    transcribe_sequential,
                )

                text, segments, t = transcribe_sequential(
                    session, audio, args.language, args.task,
                    args.max_new_tokens, tokenizer, gen_cfg,
                    condition_on_prev_text=args.condition_on_prev_text,
                    initial_prompt_ids=initial_prompt_ids,
                    num_beams=args.num_beams,
                    length_penalty=args.length_penalty,
                    word_collector=words)
            elif args.temperatures:
                from whisper_tpu_torch.pipeline.fallback import (
                    transcribe_longform_fallback,
                )

                temps = tuple(float(x) for x in args.temperatures.split(","))
                text, t, _info = transcribe_longform_fallback(
                    session, audio, args.language, args.task,
                    args.max_new_tokens, args.chunk_length_s, args.overlap_s,
                    tokenizer, gen_cfg, temperatures=temps)
            else:
                text, t = _transcribe(audio, pre_mel, words)

            if smap is not None and words:
                # condensed-signal times back to file time
                # (faster-whisper's restore_speech_timestamps)
                for w in words:
                    w["start"] = round(smap.restore_time(w["start"]), 3)
                    w["end"] = round(smap.restore_time(w["end"]), 3)

            e2e = load_s + t.end_to_end_s
            rtf = e2e / max(dur, 1e-9)
            rows.append(RowOut.make(fnm, dur, e2e, rtf, text, words=words))
            load_l.append(load_s)
            pre_l.append(t.preprocess_s)
            model_l.append(t.model_only_s)
            dec_l.append(t.decode_s)
            end2end.append(e2e)
            rtf_l.append(rtf)

            if rank != 0:
                continue
            if args.write_txt:
                stem = Path(fnm).stem
                with open(os.path.join(txt_dir, f"{stem}.transcript.txt"),
                          "w") as f:
                    f.write(text.strip() + "\n")

            if args.write_srt or args.write_vtt:
                from whisper_tpu_torch.bench.subtitles import (
                    cues_from_segments,
                    cues_from_words,
                    write_subtitles,
                )

                # word timings are the finer source, else the sequential
                # mode's segments (the flags' check ensured one)
                cues = (cues_from_words(words) if words
                        else cues_from_segments(segments or []))
                stem = Path(fnm).stem
                if args.write_srt:
                    write_subtitles(os.path.join(txt_dir, f"{stem}.srt"), cues)
                if args.write_vtt:
                    write_subtitles(os.path.join(txt_dir, f"{stem}.vtt"), cues)
    finally:
        # Finalize the trace and stop the prefetcher even when a file
        # fails mid-loop.
        if prof is not None:
            _sync(device)
            prof.__exit__(None, None, None)
            if rank == 0:
                os.makedirs(args.profile_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(args.profile_dir,
                                                      "trace.json"))
        if executor is not None:
            executor.shutdown(wait=True)

    if rank != 0:
        return 0       # every rank decoded; rank 0 writes the outputs
    write_per_file_csv(rows, args.out_csv)
    write_per_file_json(rows, args.out_json)

    where = "CPU (the kernels' plain versions)"
    if device.type == "cuda":
        import torch

        where = f"CUDA card {torch.cuda.get_device_name(device)}"
    notes = {
        "longform": f"{where}: chunked 30s windows with overlap; chunks "
                    "batched into one encoder + greedy decode per batch "
                    "bucket",
        "token_decode": (
            "Tokenizer decode (skip_special_tokens=true)" if tokenizer
            else "Prints token IDs unless you provide tokenizer.json."
        ),
    }
    if variant_note:
        notes["variant"] = variant_note

    config_echo = cfg.to_dict()
    config_echo["num_beams"] = args.num_beams
    summary = build_summary(
        config_used=config_echo,
        rows=rows,
        end2end=end2end, load=load_l, preprocess=pre_l,
        model_only=model_l, decode=dec_l, rtf_end2end=rtf_l,
        model_id=args.model_id, onnx_dir=args.onnx_dir,
        language=args.language, task=args.task,
        max_new_tokens=args.max_new_tokens,
        tokenizer_json=tokenizer_path, timestamps=args.timestamps,
        notes=notes,
    )
    with open(args.out_summary_json, "w") as f:
        json.dump(summary, f, indent=2)

    # stdout report (ref src/main.rs:1261-1268)
    print("DONE")
    print("Config used:")
    print(json.dumps(cfg.to_dict(), indent=2))
    print(f"Per-file CSV: {args.out_csv}")
    print(f"Per-file JSON: {args.out_json}")
    print(f"Summary JSON: {args.out_summary_json}")
    p95 = summary["latency_end_to_end_s"]["p95"]
    print(f"End-to-end p95(s): {p95:.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
