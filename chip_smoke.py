"""Smoke run of the PyTorch/CUDA port on one NVIDIA card: ``python3 chip_smoke.py``.

What it does, in order (any failure raises and exits non-zero):

1. Requires CUDA; prints the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
   them.
2. Builds the CUDA kernels of ``whisper_tpu_torch/csrc`` with nvcc
   (sm_90a; one nvcc per source, all started together) and prints the
   build time, each kernel's register use and, from the library's SASS,
   that B1 and the products of B2, B9a and B9b hold warpgroup products and
   tensor-map loads, B3, B8, B4, B6 and both B7 kernels bulk copies, B7-i8
   int8 mma.sync, that B5's two kernels are there, B10c's two kernels
   cp.async, ldmatrix and bf16 mma.sync, and
   of B10a's
   and B10b's kernels the LN-and-product kernel cp.async and fp64 mma.sync
   (DMMA), B10a's attention cp.async, B10b's bulk copies and the O product
   cp.async, ldmatrix and bf16 mma.sync.
3. Runs each kernel (B1-B10c, sixteen rows) against its plain PyTorch
   version on the card at the shapes its path gives it (whisper-base, batch
   bucket 16: B1-B4 at x5, B6 at x4, B8 at x7, B9a/B9b with the fused
   encoder block, B10c in the hybrid decode step, B7 with five queries a
   row as the speculative verify pass gives it at draft_k = 4, B10a and B10b
   in the fully fused decode step; B5 at the one-shot limit of 7,680
   frames, beside the composition of PyTorch calls around ``torch.stft``
   (cuFFT) that computes the same function; B2 and B9a also at
   whisper-medium's d=1024), prints the
   largest difference, the time of one call of each (median of five runs
   of 20 calls), the least time the card could take for the same work (the
   larger of its bytes over 3.35 TB/s and its operations over the peak rate
   for their type) and, where one PyTorch call computes the same function,
   that call's time.  B1 (wgmma, scores in registers) is also held at
   whisper-medium's bucket-1 shape (16 heads) and at T = 100, and prints a
   second bound, the 111 GFLOP its two-pass contract executes; B4 (a
   cluster of blocks a head) also at bucket 1 with 6 heads and at S = 1504
   with 1,500 valid columns, and its wrapper must put exactly one operation
   on the card a call (counted by torch.profiler); B6 (B4's cluster,
   dequantizing) at S = 96, 192, 193, 1500, 1504 (1,500 valid) and 2000
   (1,999 valid), at bucket 16 with 8 heads and at bucket 1 with 6, and it
   and B7-dq one operation a call; B4 and B6 also at the 64 rows of beam
   search at K = 4 (the cache tiled per beam, the scales as views), each
   beam's rows bitwise the call on the untiled cache.  B7 is also held, query by query and
   bitwise, against the single-token kernels B4 and B6 at T = 1, 2, 5, 9
   and 17 and S = 96, 193, 1500, 1504 and 2000, and timed at T = 5
   beside five calls of B4 or B6; B10c beside the bf16 composition of five
   PyTorch calls that computes it; what B10a writes into the cache bitwise
   against the plain version at pos 0, 70 and 131, with ``pos`` as an int
   and as a device tensor; B10b at T = 1500, 96, 100 and 1731 (a short last
   key block); two calls of each bitwise equal and at most three device
   operations a call.  B2 (LayerNorm
   and two tiled wgmma products) is also held at 1, 1,499 and 24,000 rows at
   d = 512 and at 1,500 rows at d = 1,024 and 1,280, must put exactly its
   three kernels on the card a call, and is printed beside the bf16
   composition of five PyTorch calls that computes the same function; B9a
   and B9b (B2's LayerNorm kernel and products under names of their own)
   at 1, 1,499 and 24,000 rows, B9a also at d = 1,280 and B9b at d = 128,
   384 and 768, two calls of each bitwise equal, two device operations a
   call for B9a and four for B9b, each beside the bf16 composition of
   PyTorch calls that computes it; B3
   (bulk copies of its cache rows) at pos 0, 70 and S - 1 with mixed pads,
   with ``pos`` as an int and as a device tensor (bitwise the same output and
   caches), one operation a call with and without ``pad_count``.  B8 the
   same at S = 131, 132 and 448, its four buffers bitwise the plain
   version's; B5 at 1, 16, 17, 3,000 and 7,680 valid frames in buckets of
   3,000 and 12,000, both wires, 80 and 128 mels (within 1e-4 of the plain
   version, or of its float64 evaluation where the plain version itself is
   farther from that), two calls bitwise equal and two device operations a
   call.  An empty
   kernel launched through the same C interface is timed and printed beside
   the kernels whose bound is under 20 microseconds.
4. Holds the port on the card against the port on the CPU (the kernels'
   plain versions) on a small input: an 80 s clip through the front end,
   the encoder and twelve teacher-forced decode steps.
5. Drives the main path, ``whisper_tpu_torch.headline``'s workload
   (whisper-base, random weights from seed 0, rung x5, the 301.574 s
   synthetic file), once to warm up and then three timed times, with every
   kernel's launch count set to 0 just before each run and read just after;
   asserts the token shape, identical tokens across runs, finite encoder
   states and logits, and that every kernel of the path was launched.
6. Drives the same file at whisper-base through the rest of the ladder
   and ``RuntimeCfg``, a warm-up and three timed runs each, counts set to 0
   just before each and read just after: rung x7 (B8 and B4 once per layer and
   step, no B3), rung x6 (the W8A8 encoder; kernels as at x5), and x5 with
   ``fused_encoder_block`` and ``fused_decoder_step`` (B9a, B1 and B9b once
   per encoder layer, B10c once per layer and step, none of B2, B3, B4);
   then a 4 s file at whisper-medium with ``fused_encoder_block`` (the
   d >= 1024 composition: B9a, B1 and B2 once per layer, no B9b; one more
   run under torch.profiler for B9a's and B2's in-situ times at d = 1,024).
   Prints e2e, model time and launches of each beside x5's.
7. Speculative decoding on the same file: x5 with a random whisper-tiny
   draft (draft_k = 4; B7 once per layer and verify round), x5 with
   whisper-base as its own draft sharing the encoder (the accept path:
   about ceil(128 / 5) rounds), x4 with the tiny draft (B7's dequantizing
   kernel).  The two x5 runs must give the same tokens (one rejects nearly
   every proposal, the other accepts nearly all: the same arithmetic,
   opposite bookkeeping), each chunk's first token must be the greedy
   run's, and the share of tokens equal to the greedy run's is printed with
   rounds and tokens committed per round.
7b. The decoding options on the same file (``check_decoding``, ``[decoding]``
   lines): the timestamp grammar at x5 and x7, every row checked by a
   grammar checker, two runs equal; scores at T = 0, the tokens bitwise the
   main path's and each count the row's length to its first EOT; the
   fallback ladder 0, 0.2 ... 1.0 with every gate failing (every chunk walks
   every rung; 64 tokens), twice with one seed (equal at every rung) and
   once with another (different), no suppressed id drawn; beam search K = 1
   against greedy decoding on the step beam search takes (equal), and K = 4
   at x5 (B4 at 64 rows) and x4 (B6), with the share of tokens equal to
   greedy x5's.
7c. Conditioned prompts, the sequential mode, word timings and the judge
   (``check_prompts_words``, ``[prompts]`` lines): the same file's bucket of
   16 decoded at x5 (B3) and x7 (B8) with ``[<|startofprev|>] + tail``
   left-padded to 64 slots (three pad counts across rows) against each
   row's unpadded prompt, every first divergence judged by
   ``variants.diagnose.divergence_report`` (one that is not a tie-flip
   fails), B3 and B8 launched with a ``pad_count`` on every step; the
   sequential mode at x5 and x7 on a 76 s file, conditioned on the previous
   text with an initial prompt, twice (equal tokens); word timings at x5,
   chunked and sequential (alignment rows summing to 1 within 1e-3, words in
   order within each chunk and inside the file, the card's words within
   0.02 s of the CPU's at fp32); the judge on x7 against x5 and on
   speculative against greedy at x5 and x4 (printed, never failing); the CLI
   over the four files with ``--longform-mode sequential
   --condition-on-prev-text``, ``--word-timestamps --write-srt --write-vtt``
   (every cue file parses) and ``--vad-filter --word-timestamps``.
7d. Serving (``check_serve``, ``[serve]`` lines), whisper-base, 128 tokens:
   (a) the engine's short lane at x4 (the server's default) and x5, a
   burst of 16 synthetic clips of 1-30 s, each row against the clip alone
   through ``transcribe_short_batch`` at bucket 1 (equal, or every first
   divergence a tie-flip by ``divergence_report``), B1, B2, B3 and B6 (x4)
   or B4 (x5) launched and B5 not, four clips of 1-3.5 s trimmed and at
   full width (equal); (b) a 76 s file on the long lane while 16 clips are
   in flight (the shorts resolve first, its text is ``transcribe_longform``'s
   alone, the short lane's p95 with and without it); (c) 4 TCP clients x 4
   requests through ``serve.server`` and then through ``serve.router`` in
   front of it (the same answers, or tie-flips), ``{"stats": true}``;
   (d) the OpenAI HTTP API: json, srt, verbose_json with words, SSE,
   /healthz, /v1/models; (e) the speculative leg, whisper-base's own int8
   weights as draft (B7), against the greedy burst; (f) a lone 5 s request
   and ``serve_bench``'s 64 streams of 30 s, three times (aggregate x real
   time, p50, p95); then the card test of two threads launching B3 and B8
   across 48 KB at once, in a fresh process.
7e. The pipelined long-form mode and the last user tools
   (``check_pipelined``, ``[pipelined]`` lines), whisper-base, 128 tokens:
   (a) the same file at x5 through ``transcribe_longform_pipelined`` at
   ``slab_chunks`` 4 and 16 (per-chunk mel normalization, slab by slab),
   B1, B2, B3 and B4 launched and B5 not, the rows of slab 4 against slab
   16's with every first divergence a tie-flip by ``divergence_report`` on
   the chunk-normalized windows; (b) ``chunk_norm_window`` on the card
   against numpy on the host (atol 1e-6), a ragged bucket's padding rows
   all zeros; (c) speculative over pipelined with the model's own int8
   weights as draft (B7), against greedy pipelined; (d) ``save_params`` /
   ``load_params`` of whisper-base value for value without the
   ``safetensors`` package, the CLI from that dir at x5 and from its
   ``quantize_model_dir`` copy at int8 (B6), each text the in-memory
   session's; (e) ``bench.discover`` over x4, x5 and x7 on 60 s, then the
   CLI with its JSON; (f) the CLI with ``--longform-mode pipelined`` over
   the four CLI files, plain and with ``--word-timestamps --language
   auto``, then ``results.summarize`` and ``results.accumulate`` over its
   output.
8. The fully fused decode step (``decoder_step_fused``: B10a, B10b, B10c per
   layer) for 127 steps from a bf16 prefill at bucket 16: the first step's
   logits within 5e-2 of ``decoder_step`` on the same cache, finite tokens
   equal across two runs, 127 x 6 launches of B10a and of B10b; the same
   127 steps replayed from one captured CUDA graph of a step (token and
   ``pos`` on the card), whose tokens must equal the eager loop's; the time
   per step of both beside the x5 kernel step's and the hybrid step's; then
   the 127 eager steps once more under torch.profiler: B10a's, B10b's and
   B10c's in-situ time a call, by kernel, and the device time a step.
9. Drives the benchmark CLI (``whisper_tpu_torch.bench.cli.main``, in
   process) over four synthetic WAV files (4 s; 29.5 s at 44.1 kHz stereo;
   76 s, just under the one-shot limit; 150 s, streamed) at whisper-base
   ``--variant x5`` and ``--variant int8``, then over the 4 s file at
   whisper-medium x5, every kernel's count set to 0 just before each run
   and read just after; asserts rc 0, the reference's CSV header and
   summary keys, four rows of the files' durations, B5 on every one-shot
   mel, B4 and not B6 at x5, B6 and not B4 at int8, B2 at d=1024 in the
   medium run; prints each run's per-file e2e, p95 and peak device memory.
   One more run at ``--variant x7`` over the four files (B8 and B4, no B3),
   one at x5 with each decoding flag (``--timestamps``, ``--language auto``,
   ``--temperatures 0,0.2,0.4``, ``--num-beams 4``; 32 tokens), and one at x5
   with ``--draft-model-id openai/whisper-tiny`` over the 4 s file (B7).
10. Prints one JSON line with the kernels, then, as the last line,
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import csv
import itertools
import json
import os
import statistics
import sys
import tempfile
import time


def _median_ms(fn, runs: int = 5, calls: int = 20) -> float:
    """Time of one call of ``fn``: CUDA events around ``calls`` calls back
    to back, a synchronize after each run, the median over ``runs`` runs.
    A wrapper's host work (launches, its small torch ops) is inside it."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


# Published peaks of one H100 SXM (dense): device memory 3.35 TB/s; bf16
# 989 TFLOP/s and int8 1,979 TOP/s on the tensor cores; fp32 67 TFLOP/s.
PEAK_BYTES = 3.35e12
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}


def _bound(n_bytes: float, n_ops: float, kind: str):
    """The least time (ms) the card could take: the larger of the bytes the
    function must move (each input read once, each output written once)
    over the memory rate and its operations over the peak for their type;
    and which of the two it is."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES, n_ops / PEAK_OPS[kind]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _bf16_steps(got, want) -> float:
    """Largest |got - want| in bf16 spacings (2^-7 relative) of the larger
    magnitude, the mean magnitude of ``want`` as the floor near zero."""
    import torch

    got, want = got.float(), want.float()
    scale = torch.maximum(torch.maximum(got.abs(), want.abs()),
                          want.abs().mean())
    return float(((got - want).abs() / (scale * 2.0 ** -7)).max())


def check_sass(lib_path) -> None:
    """What the compiler made of the kernels built on Hopper's own
    instructions, read from the library with cuobjdump: the encoder
    attention kernel and the encoder MLP's products must hold warpgroup
    products (HGMMA) and tensor-map loads (UTMALDG), the self- and the
    cross-attention steps (B3, B8, B4, B6) and both verify passes bulk
    copies (UBLKCP), the int8 verify pass int8 mma.sync (IMMA), B5's two
    kernels present (its FFT on the CUDA cores), the decoder MLP's two kernels
    cp.async copies (LDGSTS), ldmatrix (LDSM) and bf16 mma.sync (HMMA), and
    of the fused attention blocks the LN-and-product kernel cp.async copies
    and fp64 mma.sync (DMMA), B10a's attention cp.async copies, B10b's bulk
    copies and the O product cp.async, ldmatrix and bf16 mma.sync."""
    import re
    import shutil
    import subprocess

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.isfile(tool):
        print("[sass] cuobjdump not found: instruction counts not read",
              flush=True)
        return
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    # the mangled names, with their lengths: no other kernel's name ends so
    want = {"11attn_kernelE": ("HGMMA", "UTMALDG"),
            "11gemm_kernelI": ("HGMMA", "UTMALDG"),
            "16self_step_kernelE": ("UBLKCP",),
            "21self_step_int8_kernelE": ("UBLKCP",),
            "19mel_spectrum_kernelI": (),
            "20mel_normalize_kernelE": (),
            "17cross_step_kernelE": ("UBLKCP",),
            "20cross_dequant_kernelE": ("UBLKCP",),
            "26cross_multi_dequant_kernelE": ("UBLKCP",),
            "23cross_multi_int8_kernelE": ("UBLKCP", "IMMA"),
            "14ln_gemm_kernelE": ("LDGSTS", "DMMA"),
            "16self_attn_kernelE": ("LDGSTS",),
            "17cross_attn_kernelE": ("UBLKCP",),
            "15out_proj_kernelE": ("LDGSTS", "LDSM", "HMMA"),
            "10fc1_kernelE": ("LDGSTS", "LDSM", "HMMA"),
            "10fc2_kernelE": ("LDGSTS", "LDSM", "HMMA")}
    seen = set()
    for part in sass.split("Function : ")[1:]:
        name = part.split("\n", 1)[0]
        for kernel, ops in want.items():
            if kernel not in name:
                continue
            seen.add(kernel)
            counts = {op: len(re.findall(rf"\b{op}\b", part))
                      for op in ops + ("SYNCS", "MUFU")}
            print(f"[sass] {kernel[2:-1]}: {counts}", flush=True)
            missing = [op for op in ops if counts[op] == 0]
            if missing:
                raise AssertionError(f"{kernel[2:-1]}: no {missing} in its "
                                     "SASS")
    if seen != set(want):
        raise AssertionError(f"kernels not found in the SASS: "
                             f"{sorted(set(want) - seen)}")


def check_kernels(card: str) -> list:
    """Each kernel against its plain version at its path's shapes."""
    import numpy as np
    import torch

    from whisper_tpu_torch.frontend import golden
    from whisper_tpu_torch.headline import synth_audio
    from whisper_tpu_torch.ops import attention, cross_attention, encoder_mlp
    from whisper_tpu_torch.ops import decoder_kernels, encoder_block
    from whisper_tpu_torch.ops import kernels, log_mel, self_attention
    from whisper_tpu_torch.pipeline.chunk import mel_frame_bucket
    from whisper_tpu_torch.profile_ladder import mel_composition

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def randn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

    b, h, t, dh, d, f = 16, 8, 1500, 64, 512, 2048
    n_l, s_max, layer, pos = 6, 132, 3, 70
    rows = []
    # name -> (bytes moved, operations, their type) of one call, for the
    # bound; and the one PyTorch call that computes the same function,
    # where there is one.
    work, library = {}, {}
    n = b * t                                         # encoder rows

    # B1: q pre-scaled, as the encoder passes it.
    q, k, v = randn(b, h, t, dh, scale=dh ** -0.5), randn(b, h, t, dh), \
        randn(b, h, t, dh)
    rows.append(("fused_attention", (attention, "launches"), "attention.cu",
                 "whisper_tpu/ops/attention.py:75",
                 lambda: attention.fused_attention(q, k, v),
                 lambda: attention.fused_attention_plain(q, k, v), 2.0))
    work["fused_attention"] = (4 * b * h * t * dh * 2,
                               4 * b * h * t * t * dh, "bf16")
    library["fused_attention"] = \
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, scale=1.0)

    # B2: dequantized int8 weights, as the encoder passes them.
    x = randn(b, t, d)
    ln_s, ln_b = 1.0 + randn(d, scale=0.1), randn(d, scale=0.1)
    w1 = (torch.randint(-127, 128, (d, f), generator=g, device=dev).to(bf)
          * torch.tensor(3e-4, dtype=bf))
    w2 = (torch.randint(-127, 128, (f, d), generator=g, device=dev).to(bf)
          * torch.tensor(3e-4, dtype=bf))
    b1, b2 = randn(f, scale=0.1), randn(d, scale=0.1)
    mlp_args = (x, ln_s, ln_b, w1, b1, w2, b2)
    rows.append(("fused_encoder_mlp", (encoder_mlp, "launches"),
                 "encoder_mlp.cu", "whisper_tpu/ops/encoder_mlp.py:224",
                 lambda: encoder_mlp.fused_encoder_mlp(*mlp_args),
                 lambda: encoder_mlp.fused_encoder_mlp_plain(*mlp_args), 2.0))
    work["fused_encoder_mlp"] = ((2 * n * d + 2 * d * f + 3 * d + f) * 2,
                                 4 * n * d * f, "bf16")

    # B2 at whisper-medium's width (the TPU's FFN-chunked kernel, B2c):
    # the 4 s file of the CLI phase is one chunk, bucket 1.
    dm, fm = 1024, 4096
    xm = randn(1, t, dm)
    med_args = (xm, 1.0 + randn(dm, scale=0.1), randn(dm, scale=0.1),
                (torch.randint(-127, 128, (dm, fm), generator=g, device=dev)
                 .to(bf) * torch.tensor(2e-4, dtype=bf)), randn(fm, scale=0.1),
                (torch.randint(-127, 128, (fm, dm), generator=g, device=dev)
                 .to(bf) * torch.tensor(2e-4, dtype=bf)), randn(dm, scale=0.1))
    rows.append(("fused_encoder_mlp_d1024", (encoder_mlp, "launches"),
                 "encoder_mlp.cu", "whisper_tpu/ops/encoder_mlp.py:163",
                 lambda: encoder_mlp.fused_encoder_mlp(*med_args),
                 lambda: encoder_mlp.fused_encoder_mlp_plain(*med_args), 2.0))
    work["fused_encoder_mlp_d1024"] = (
        (2 * t * dm + 2 * dm * fm + 3 * dm + fm) * 2, 4 * t * dm * fm, "bf16")

    # B3: the kernel writes row `pos` of the cache in place, so the kernel
    # and the plain version each get their own copy.
    qs, kn, vn = randn(b, h, dh, scale=dh ** -0.5), randn(b, h, dh), \
        randn(b, h, dh)
    kc, vc = randn(n_l, b, h, s_max, dh), randn(n_l, b, h, s_max, dh)
    kc2, vc2 = kc.clone(), vc.clone()
    # no pad_count, as the x5 step calls it
    rows.append(("self_attend_step", (self_attention, "launches"),
                 "self_attention.cu",
                 "whisper_tpu/ops/self_attention.py:470",
                 lambda: self_attention.self_attend_step(
                     qs, kn, vn, kc, vc, layer, pos),
                 lambda: self_attention.self_attend_step_plain(
                     qs, kn, vn, kc2, vc2, layer, pos), 2.0))
    # Rows [pad, pos] of K and V are read (the data decides how many), the
    # new row written; scores and P.V in fp32 on the CUDA cores.
    work["self_attend_step"] = (
        b * h * dh * 2 * (2 * (pos + 1) + 6), 4 * b * h * (pos + 1) * dh,
        "fp32")

    # B8 (x7): the same step against the int8 self cache with per-row
    # scales; the kernel and the plain version each get their own copies
    # of the four buffers they write.  No pad_count, as the x7 step calls it.
    i8 = self_attention.quantize_self_cache(kc, vc)
    i8_plain = [x.clone() for x in i8]
    rows.append(("self_attend_step_int8", (self_attention, "int8_launches"),
                 "self_attention_int8.cu",
                 "whisper_tpu/ops/self_attention.py:327",
                 lambda: self_attention.self_attend_step_int8(
                     qs, kn, vn, *i8, layer, pos),
                 lambda: self_attention.self_attend_step_int8_plain(
                     qs, kn, vn, *i8_plain, layer, pos), 2.0))
    work["self_attend_step_int8"] = (
        b * h * (2 * (pos + 1) * (dh + 4) + 4 * dh * 2 + 2 * (dh + 4)),
        4 * b * h * (pos + 1) * dh, "int8")

    # B4: the int8 cross cache as quantize_cross_kv leaves it.
    qx = randn(b, h, dh, scale=dh ** -0.5)
    k8 = torch.randint(-127, 128, (n_l, b, h, t, dh), generator=g,
                       device=dev, dtype=torch.int8)
    v8 = torch.randint(-127, 128, (n_l, b, h, t, dh), generator=g,
                       device=dev, dtype=torch.int8)
    ks = torch.rand(n_l, b, h, generator=g, device=dev) * 0.02 + 1e-3
    vs = torch.rand(n_l, b, h, generator=g, device=dev) * 0.02 + 1e-3
    rows.append(("cross_attend_step", (cross_attention, "launches"),
                 "cross_attention.cu",
                 "whisper_tpu/ops/cross_attention.py:533",
                 lambda: cross_attention.cross_attend_step(
                     qx, k8, v8, ks, vs, 2, s_valid=t),
                 lambda: cross_attention.cross_attend_step_plain(
                     qx, k8, v8, ks, vs, 2, s_valid=t), 2.0))
    cross_bytes = b * h * (2 * t * dh + 2 * dh * 2 + 8)
    work["cross_attend_step"] = (cross_bytes, 4 * b * h * t * dh, "int8")
    work["cross_attend_step_dequant"] = (cross_bytes, 4 * b * h * t * dh,
                                         "fp32")

    # B6 (x4): the same cache, dequantized in the kernel.
    rows.append(("cross_attend_step_dequant",
                 (cross_attention, "dequant_launches"),
                 "cross_attention_dequant.cu",
                 "whisper_tpu/ops/cross_attention.py:533",
                 lambda: cross_attention.cross_attend_step_dequant(
                     qx, k8, v8, ks, vs, 2, s_valid=t),
                 lambda: cross_attention.cross_attend_step_dequant_plain(
                     qx, k8, v8, ks, vs, 2, s_valid=t), 2.0))

    # B5: a file at the one-shot limit (7,680 valid frames in its
    # 12,000-frame bucket), int16 upload as at x3+; tolerance 1e-4 on the
    # normalized mel, the card-vs-CPU mel bound of check_against_cpu.
    nv = 7680
    audio = synth_audio(nv * golden.HOP / 16000.0)
    pcm = np.round(np.clip(golden.reflect_pad(audio), -1, 1) * 32767.0)
    wire = torch.from_numpy(pcm.astype(np.int16)).to(dev)
    nf = mel_frame_bucket(nv)
    rows.append(("log_mel", (log_mel, "launches"), "log_mel.cu",
                 "whisper_tpu/ops/pallas_mel.py:129",
                 lambda: log_mel.log_mel(wire, nv, 80, nf),
                 lambda: log_mel.log_mel_plain(wire, nv, 80, nf), 1e-4))
    # What the inputs need: the valid frames' samples, the [80, n_frames]
    # output and the tables (twiddles, window, bands, weights) once; per
    # valid frame an FFT of 400 real points (2.5 N log2 N), the power of 201
    # bins (3 operations each) and the 391 nonzero mel weights (2 each).
    tables = sum(x.numel() * x.element_size()
                 for x in log_mel._device_tables(torch.device(dev), 80))
    nnz = log_mel.mel_bands(80)[1].size
    work["log_mel"] = (((nv - 1) * golden.HOP + golden.WIN) * 2
                       + 80 * nf * 4 + tables,
                       nv * (2.5 * 400 * np.log2(400) + 3 * 201 + 2 * nnz),
                       "fp32")
    library["log_mel"] = lambda: mel_composition(wire, nv, 80, nf)

    # B9a and B9b: one encoder layer's two kernels (fused_encoder_block),
    # dequantized int8 weights as the encoder passes them.
    def qweight(rows_, cols, s=3e-4):
        return (torch.randint(-127, 128, (rows_, cols), generator=g,
                              device=dev).to(bf) * torch.tensor(s, dtype=bf))

    w_qkv, b_qkv = qweight(d, 3 * d), randn(3 * d, scale=0.1)
    qkv_args = (x, ln_s, ln_b, w_qkv, b_qkv)
    rows.append(("fused_ln_qkv", (encoder_block, "ln_qkv_launches"),
                 "encoder_block.cu", "whisper_tpu/ops/encoder_block.py:178",
                 lambda: encoder_block.fused_ln_qkv(*qkv_args),
                 lambda: encoder_block.fused_ln_qkv_plain(*qkv_args), 2.0))
    work["fused_ln_qkv"] = ((n * d + n * 3 * d + d * 3 * d + 5 * d) * 2,
                            2 * n * d * 3 * d, "bf16")
    qkv_med = (xm, med_args[1], med_args[2], qweight(dm, 3 * dm, 2e-4),
               randn(3 * dm, scale=0.1))
    rows.append(("fused_ln_qkv_d1024", (encoder_block, "ln_qkv_launches"),
                 "encoder_block.cu", "whisper_tpu/ops/encoder_block.py:178",
                 lambda: encoder_block.fused_ln_qkv(*qkv_med),
                 lambda: encoder_block.fused_ln_qkv_plain(*qkv_med), 2.0))
    work["fused_ln_qkv_d1024"] = (
        (t * dm + t * 3 * dm + dm * 3 * dm + 5 * dm) * 2,
        2 * t * dm * 3 * dm, "bf16")
    out_args = (x, randn(b, t, d), qweight(d, d), randn(d, scale=0.1), ln_s,
                ln_b, w1, b1, w2, b2)
    rows.append(("fused_out_mlp", (encoder_block, "out_mlp_launches"),
                 "encoder_block.cu", "whisper_tpu/ops/encoder_block.py:257",
                 lambda: encoder_block.fused_out_mlp(*out_args),
                 lambda: encoder_block.fused_out_mlp_plain(*out_args), 2.0))
    work["fused_out_mlp"] = ((3 * n * d + d * d + 2 * d * f + 4 * d + f) * 2,
                             2 * n * d * (d + 2 * f), "bf16")

    # B10c: the decoder MLP of one step (the hybrid step), bucket 16.
    mlp_step = (randn(b, d), torch.stack([ln_s, ln_b]), w1, b1[None], w2,
                b2[None])
    rows.append(("decoder_mlp_block", (decoder_kernels, "launches"),
                 "decoder_mlp.cu", "whisper_tpu/ops/decoder_kernels.py:270",
                 lambda: decoder_kernels.mlp_block(*mlp_step),
                 lambda: decoder_kernels.mlp_block_plain(*mlp_step), 2.0))
    work["decoder_mlp_block"] = ((2 * b * d + 2 * d * f + 3 * d + f) * 2,
                                 4 * b * d * f, "bf16")

    # B7: the verify pass of speculative decoding at draft_k = 4, five
    # queries a row against the cache B4 and B6 read; int8 x int8 (x5) and
    # dequantizing (x4).  One stream of K and V for all five.
    n_q = 5
    qm = randn(b, n_q, h, dh, scale=dh ** -0.5)
    for name, mxu, kind in (("cross_attend_multi", True, "int8"),
                            ("cross_attend_multi_dequant", False, "fp32")):
        rows.append((name, (cross_attention, "multi_launches"),
                     "cross_attention_multi.cu",
                     "whisper_tpu/ops/cross_attention.py:398",
                     lambda mxu=mxu: cross_attention.cross_attend_multi(
                         qm, k8, v8, ks, vs, 2, s_valid=t, int8_mxu=mxu),
                     lambda mxu=mxu: cross_attention.cross_attend_multi_plain(
                         qm, k8, v8, ks, vs, 2, s_valid=t, int8_mxu=mxu),
                     2.0))
        work[name] = (b * h * (2 * t * dh + 8) + 2 * b * n_q * h * dh * 2,
                      4 * b * n_q * h * t * dh, kind)

    # B10a and B10b: a layer's two attention blocks of the fully fused
    # decode step.  B10a writes row `pos` of the time-major self cache in
    # place, so the kernel and the plain version each get their own copy.
    xs = randn(b, d)
    ln2 = torch.stack([ln_s, ln_b])
    qkv_w1, qkv_b1 = qweight(d, 3 * d), randn(1, 3 * d, scale=0.1)
    o_w1, o_b1 = qweight(d, d), randn(1, d, scale=0.1)
    tk, tv = randn(s_max, b, d), randn(s_max, b, d)
    tk2, tv2 = tk.clone(), tv.clone()
    self_args = (xs, ln2, qkv_w1, qkv_b1, o_w1, o_b1)
    rows.append(("decoder_self_block",
                 (decoder_kernels, "self_block_launches"),
                 "decoder_self_block.cu",
                 "whisper_tpu/ops/decoder_kernels.py:120",
                 lambda: decoder_kernels.self_attn_block(
                     *self_args, tk, tv, pos, h)[0],
                 lambda: decoder_kernels.self_attn_block_plain(
                     *self_args, tk2, tv2, pos, h)[0], 2.0))
    work["decoder_self_block"] = (
        (4 * d * d + 6 * d + 2 * b * d + 2 * (pos + 1) * b * d) * 2,
        2 * b * d * 4 * d + 4 * b * (pos + 1) * d, "bf16")
    xk, xv = randn(b, h, t, dh), randn(b, h, t, dh)
    cross_args = (xs, ln2, o_w1, o_b1, qweight(d, d), randn(1, d, scale=0.1))
    rows.append(("decoder_cross_block",
                 (decoder_kernels, "cross_block_launches"),
                 "decoder_cross_block.cu",
                 "whisper_tpu/ops/decoder_kernels.py:222",
                 lambda: decoder_kernels.cross_attn_block(
                     *cross_args, xk, xv, h),
                 lambda: decoder_kernels.cross_attn_block_plain(
                     *cross_args, xk, xv, h), 2.0))
    # bf16 K and V streamed once; the scores and P.V in fp32.
    work["decoder_cross_block"] = (
        (2 * b * h * t * dh + 2 * d * d + 4 * d + 2 * b * d) * 2,
        4 * b * h * t * dh + 4 * b * d * d, "fp32")

    # What a launch through the library's C interface costs when the kernel
    # does nothing: the floor under every kernel whose bound is microseconds.
    lib = kernels.library()
    stream = kernels.stream_ptr(torch.device(dev))
    floor_ms = _median_ms(
        lambda: kernels.check(lib.wt_launch_floor(stream), "launch_floor"))
    print(f"[kernel] launch floor: an empty kernel through the same ctypes "
          f"route {floor_ms:.4f} ms a call on {card}", flush=True)

    out = []
    for name, counter, src, replaces, kern, plain, tol in rows:
        got = kern()
        torch.cuda.synchronize()
        want = plain()
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        if not torch.isfinite(got.float()).all():
            raise AssertionError(f"{name}: non-finite kernel output")
        if got.dtype == torch.float32:  # B5: absolute error of the mel
            steps, unit = err, "abs"
        else:
            steps, unit = _bf16_steps(got, want), "bf16 steps"
        if steps > tol:
            raise AssertionError(f"{name}: {steps:.3g} {unit} from the "
                                 f"plain version (tolerance {tol})")
        # the in-place inserts must leave every buffer bitwise equal to
        # the plain version's
        written = {"self_attend_step": ((kc, kc2), (vc, vc2)),
                   "self_attend_step_int8": tuple(zip(i8, i8_plain)),
                   "decoder_self_block": ((tk, tk2), (tv, tv2))}
        for mine, theirs in written.get(name, ()):
            if not torch.equal(mine, theirs):
                raise AssertionError(f"{name}: a cache buffer differs from "
                                     "the plain version's after the insert")
        ms, plain_ms = _median_ms(kern), _median_ms(plain)
        bound_ms, bound_by = _bound(*work[name])
        library_ms = _median_ms(library[name]) if name in library else None
        print(f"[kernel] {name}: max_abs_err {err:.3g} ({steps:.3g} {unit}, "
              f"tolerance {tol}); {ms:.4f} ms vs plain {plain_ms:.4f} ms, "
              f"bound {bound_ms:.5f} ms by {bound_by}, library call "
              + (f"{library_ms:.4f} ms" if library_ms is not None else "none")
              + (f", an empty launch {floor_ms:.4f} ms" if bound_ms < 0.02
                 else "") + f" on {card}", flush=True)
        out.append({"name": name, "route": "cuda",
                    "source": f"whisper_tpu_torch/csrc/{src}",
                    "replaces": replaces, "counter": counter,
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": library_ms})
        if bound_ms < 0.02:
            out[-1]["launch_floor_ms"] = floor_ms

    by_name = {r["name"]: r for r in out}
    comp_ms = _median_ms(lambda: _mlp_composition(*mlp_step))
    by_name["decoder_mlp_block"]["composition_ms"] = comp_ms
    print(f"[kernel] B10c at bucket 16, d = {d}: "
          f"{by_name['decoder_mlp_block']['ms']:.4f} ms against a composition "
          f"of five PyTorch calls in bf16 (layer_norm, linear, gelu, linear, "
          f"add; no one call computes B10c) {comp_ms:.4f} ms on {card}",
          flush=True)
    check_b1_b4_edges(card, by_name, randn, q.shape, (qx, k8, v8, ks, vs))
    check_b6_edges(card, by_name, randn, (qx, k8, v8, ks, vs), qm)
    check_b2_b3_edges(card, by_name, randn, mlp_args, med_args,
                      (qs, kn, vn, kc, vc))
    check_b9_edges(card, by_name, randn, qkv_args, qkv_med, out_args)
    check_b8_b5_edges(card, by_name, randn, (qs, kn, vn, kc, vc), wire)

    # B7 against the kernels it repeats: every query bitwise the
    # single-token kernel's (B4, B6) on that query, at T = 1, 2, 5, 9 and 17
    # (both take their queries in chunks of 8) and S = 96, 193, 1500, 1504
    # (1,500 valid) and 2000 (1,999 valid: eleven segments), and its time
    # beside T calls of that kernel.
    caches = {t: (k8, v8, ks, vs, 2)}
    for s_ in (96, 193, 1504, 2000):
        caches[s_] = (torch.randint(-127, 128, (2, b, h, s_, dh), generator=g,
                                    device=dev, dtype=torch.int8),
                      torch.randint(-127, 128, (2, b, h, s_, dh), generator=g,
                                    device=dev, dtype=torch.int8),
                      torch.rand(2, b, h, generator=g, device=dev) * 0.02
                      + 1e-3,
                      torch.rand(2, b, h, generator=g, device=dev) * 0.02
                      + 1e-3, 1)
    valid_of = {96: 96, 193: 193, t: t, 1504: 1500, 2000: 1999}
    for mxu, one, label in ((True, cross_attention.cross_attend_step, "B4"),
                            (False, cross_attention.cross_attend_step_dequant,
                             "B6")):
        for (s_, (*cache, lay)), n_t in itertools.product(caches.items(),
                                                         (1, 2, 5, 9, 17)):
            qt = randn(b, n_t, h, dh, scale=dh ** -0.5)
            valid = valid_of[s_]
            got = cross_attention.cross_attend_multi(
                qt, *cache, lay, s_valid=valid, int8_mxu=mxu)
            for i in range(n_t):
                want = one(qt[:, i].contiguous(), *cache, lay, s_valid=valid)
                if not torch.equal(got[:, i], want):
                    raise AssertionError(
                        f"B7 (int8_mxu={mxu}), T = {n_t}, S = {s_}: query "
                        f"{i} is not bitwise {label}'s")
            plain = cross_attention.cross_attend_multi_plain(
                qt, *cache, lay, s_valid=valid, int8_mxu=mxu)
            if _bf16_steps(got, plain) > 2.0:
                raise AssertionError(f"B7 (int8_mxu={mxu}), T = {n_t}, S = "
                                     f"{s_}: {_bf16_steps(got, plain):.3g} "
                                     "bf16 steps from the plain version")
        q1 = qm[:, 0].contiguous()
        one_ms = _median_ms(lambda: one(q1, k8, v8, ks, vs, 2, s_valid=t))
        multi_ms = _median_ms(lambda: cross_attention.cross_attend_multi(
            qm, k8, v8, ks, vs, 2, s_valid=t, int8_mxu=mxu))
        print(f"[kernel] B7 (int8_mxu={mxu}): every query bitwise {label}'s "
              f"at T = 1, 2, 5, 9, 17 and S = 96, 193, 1500, 1504, 2000; T = "
              f"{n_q}: {multi_ms:.4f} ms against "
              f"{n_q} x {label} = {n_q * one_ms:.4f} ms on {card}",
              flush=True)

    # B10a at the first, the path's and the last cache row, with `pos` as an
    # int and as a device tensor; B10b at the path's encoder, a short one,
    # one whose length is no multiple of its 64-key blocks and one whose
    # split leaves a short last key block (1,731: three keys); two calls of
    # each bitwise equal, and each call at most three device operations.
    for p_, form in itertools.product((0, pos, s_max - 1), ("int", "tensor")):
        a, b_, c_ = ([x.clone() for x in (tk, tv)] for _ in range(3))
        p_arg = (torch.tensor([p_], dtype=torch.int32, device=dev)
                 if form == "tensor" else p_)
        got = decoder_kernels.self_attn_block(*self_args, *a, p_arg, h)[0]
        want = decoder_kernels.self_attn_block_plain(*self_args, *b_, p_,
                                                     h)[0]
        again = decoder_kernels.self_attn_block(*self_args, *c_, p_arg, h)[0]
        steps = _bf16_steps(got, want)
        same = all(torch.equal(m_, t_) for m_, t_ in zip(a, b_))
        kept = all(torch.equal(m_[p_ + 1:], o_[p_ + 1:])
                   and torch.equal(m_[:p_], o_[:p_])
                   for m_, o_ in zip(a, (tk, tv)))
        repeat = torch.equal(got, again) and all(
            torch.equal(m_, t_) for m_, t_ in zip(a, c_))
        if steps > 2.0 or not (same and kept and repeat):
            raise AssertionError(f"B10a at pos {p_} ({form}): {steps:.3g} "
                                 f"bf16 steps, caches bitwise {same}, other "
                                 f"rows untouched {kept}, two calls bitwise "
                                 f"{repeat}")
    xk_long, xv_long = randn(b, h, 1731, dh), randn(b, h, 1731, dh)
    for t_enc in (t, 96, 100, 1731):
        src_k, src_v = (xk, xv) if t_enc <= t else (xk_long, xv_long)
        xk_s = src_k[:, :, :t_enc].contiguous()
        xv_s = src_v[:, :, :t_enc].contiguous()
        got = decoder_kernels.cross_attn_block(*cross_args, xk_s, xv_s, h)
        steps = _bf16_steps(
            got, decoder_kernels.cross_attn_block_plain(*cross_args, xk_s,
                                                        xv_s, h))
        repeat = torch.equal(got, decoder_kernels.cross_attn_block(
            *cross_args, xk_s, xv_s, h))
        if steps > 2.0 or not repeat:
            raise AssertionError(f"B10b at T = {t_enc}: {steps:.3g} bf16 "
                                 "steps from the plain version, two calls "
                                 f"bitwise {repeat}")
    pos_t = torch.tensor([pos], dtype=torch.int32, device=dev)
    for name, fn in (
            ("decoder_self_block", lambda: decoder_kernels.self_attn_block(
                *self_args, tk, tv, pos_t, h)),
            ("decoder_cross_block", lambda: decoder_kernels.cross_attn_block(
                *cross_args, xk, xv, h))):
        ops = _device_ops_per_call(fn)
        if ops > 3:
            raise AssertionError(f"{name}: {ops} device operations a call, "
                                 "expected its three kernels")
        by_name[name]["device_ops_per_call"] = ops
    print(f"[kernel] B10a at pos 0, {pos}, {s_max - 1} (int and device "
          "tensor): caches bitwise the plain version's, other rows "
          f"untouched; B10b at T = {t}, 96, 100, 1731 within 2 bf16 steps; "
          "two calls of each bitwise equal; device operations a call: B10a "
          f"{by_name['decoder_self_block']['device_ops_per_call']:g}, B10b "
          f"{by_name['decoder_cross_block']['device_ops_per_call']:g}",
          flush=True)
    return out


def _mlp_composition(x, ln, w1, b1, w2, b2):
    """B10c's function as five PyTorch calls in bf16 (the yardstick beside
    it: no one call computes it)."""
    import torch.nn.functional as F

    r = F.layer_norm(x, x.shape[-1:], ln[0], ln[1], 1e-5)
    h = F.gelu(F.linear(r, w1.t(), b1[0]), approximate="tanh")
    return x + F.linear(h, w2.t(), b2[0])


def _traced(fn):
    """``fn()`` under torch.profiler: profile_ladder's summary of the trace
    (device operations, busy ms, in-situ kernel times, call spans)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from whisper_tpu_torch.profile_ladder import summarize

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return summarize(prof)


def _in_situ(summary) -> str:
    """The in-situ means of a trace summary, in µs, as one line."""
    parts = [f"{k} {1e3 * v['mean_ms']:.2f} ({v['launches']})"
             for k, v in summary["kernels"].items()]
    parts += [f"{k} a call {1e3 * v['mean_ms']:.2f} ({v['calls']})"
              for k, v in summary["calls"].items()]
    return "; ".join(parts)


def _device_ops_per_call(fn, calls: int = 5, names=None) -> float:
    """Operations (kernels, copies, memsets) that one call of ``fn`` puts on
    the card, counted by torch.profiler over ``calls`` calls; their names
    are added to the set ``names`` where one is given.  The profiler now
    and then drops an event from a trace of short calls (PERF.md §7), which
    only ever lowers the count, so the largest count of three traces is
    taken: an operation a wrapper adds shows in every trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    counts = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if names is not None:
            names.update(e.key for e in events)
        counts.append(sum(e.count for e in events) / calls)
    return max(counts)


def _at_beam_rows(label: str, step, plain, randn, args, k: int = 4):
    """B4 or B6 (``step``, ``plain`` its plain version) at the rows beam
    search gives it: the main path's cache (``args``: q, k8, v8, k_scale,
    v_scale) tiled per beam as ``runtime.beam`` tiles it
    (``repeat_interleave(k, dim=1)``, scales as the [..., 0, 0] views of a
    [L, B*K, H, 1, 1] tensor), B*K queries.  Each beam's rows must be
    bitwise the kernel's rows on the untiled cache; returns (bf16 steps
    from the plain version, bitwise equal to it, ms a call)."""
    import torch

    q, k8, v8, ks, vs = args
    b, h, dh = q.shape
    s = k8.shape[3]
    tiled = [x.repeat_interleave(k, dim=1) for x in (k8, v8)] + [
        x[..., None, None].repeat_interleave(k, dim=1)[..., 0, 0]
        for x in (ks, vs)]
    qk = randn(b * k, h, dh, scale=0.125)
    got = step(qk, *tiled, 2, s_valid=s)
    for j in range(k):
        rows = torch.arange(b, device=q.device) * k + j
        if not torch.equal(got[rows], step(qk[rows].contiguous(), k8, v8, ks,
                                           vs, 2, s_valid=s)):
            raise AssertionError(f"{label} at {b * k} beam rows: beam {j} is "
                                 "not bitwise its rows on the untiled cache")
    want = plain(qk, *tiled, 2, s_valid=s)
    ms = _median_ms(lambda: step(qk, *tiled, 2, s_valid=s))
    return _bf16_steps(got, want), torch.equal(got, want), ms


def check_b1_b4_edges(card: str, by_name, randn, b1_shape, b4_args) -> None:
    """B1 and B4 beyond the main path's shape, and what their redesign
    promises: B1's second bound (the operations its two-pass contract
    executes: Q.K^T twice, P.V once), B1 at whisper-medium's bucket-1 shape
    and at T = 100; B4 with 6 heads at bucket 1 and with a masked tail; one
    device operation a call of B4's wrapper."""
    import torch

    from whisper_tpu_torch.ops import attention, cross_attention

    b, h, t, dh = b1_shape
    row = by_name["fused_attention"]
    row["two_pass_bound_ms"] = 6 * b * h * t * t * dh / PEAK_OPS["bf16"] * 1e3
    print(f"[kernel] fused_attention: {row['ms']:.4f} ms against the "
          f"function's bound {row['bound_ms']:.5f} ms, the two-pass "
          f"contract's {row['two_pass_bound_ms']:.5f} ms (6 B H T^2 Dh "
          f"operations) and the library call {row['library_ms']:.4f} ms on "
          f"{card}", flush=True)
    for bh, t_ in ((16, 1500), (16, 100)):
        qe, ke, ve = (randn(1, bh, t_, dh, scale=dh ** -0.5),
                      randn(1, bh, t_, dh), randn(1, bh, t_, dh))
        got = attention.fused_attention(qe, ke, ve)
        steps = _bf16_steps(got, attention.fused_attention_plain(qe, ke, ve))
        if steps > 2.0 or not torch.isfinite(got.float()).all():
            raise AssertionError(f"B1 at B*H = {bh}, T = {t_}: {steps:.3g} "
                                 "bf16 steps from the plain version")
        ms = _median_ms(lambda: attention.fused_attention(qe, ke, ve))
        lib = _median_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qe, ke, ve, scale=1.0))
        print(f"[kernel] B1 at B*H = {bh}, T = {t_}: {steps:.3g} bf16 steps; "
              f"{ms:.4f} ms, library call {lib:.4f} ms on {card}", flush=True)

    qx, k8, v8, ks, vs = b4_args
    n_l, _, _, s, _ = k8.shape
    g = torch.Generator(device="cuda").manual_seed(1)
    cases = []
    # bucket 1 with whisper-tiny's 6 heads: a layer's scales off the
    # 16-byte grid; then a cache padded to 1,504 with 1,500 valid columns
    for b_, h_, s_, valid in ((1, 6, s, s), (16, 8, 1504, 1500)):
        k8e = torch.randint(-127, 128, (n_l, b_, h_, s_, 64), generator=g,
                            device="cuda", dtype=torch.int8)
        v8e = torch.randint(-127, 128, (n_l, b_, h_, s_, 64), generator=g,
                            device="cuda", dtype=torch.int8)
        kse = torch.rand(n_l, b_, h_, generator=g, device="cuda") * 0.02 + 1e-3
        vse = torch.rand(n_l, b_, h_, generator=g, device="cuda") * 0.02 + 1e-3
        qe = randn(b_, h_, 64, scale=0.125)
        args = (qe, k8e, v8e, kse, vse, 1)
        got = cross_attention.cross_attend_step(*args, s_valid=valid)
        steps = _bf16_steps(got, cross_attention.cross_attend_step_plain(
            *args, s_valid=valid))
        again = cross_attention.cross_attend_step(*args, s_valid=valid)
        if steps > 2.0 or not torch.equal(got, again):
            raise AssertionError(f"B4 at B = {b_}, H = {h_}, S = {s_}, "
                                 f"s_valid = {valid}: {steps:.3g} bf16 steps,"
                                 " or two calls differ")
        ms = _median_ms(lambda: cross_attention.cross_attend_step(
            *args, s_valid=valid))
        cases.append(f"B = {b_}, H = {h_}, S = {s_}/{valid}: {steps:.3g} "
                     f"bf16 steps, {ms:.4f} ms")
    ops = _device_ops_per_call(lambda: cross_attention.cross_attend_step(
        qx, k8, v8, ks, vs, 2, s_valid=s))
    by_name["cross_attend_step"]["device_ops_per_call"] = ops
    if ops != 1.0:
        raise AssertionError(f"B4's wrapper puts {ops} operations on the "
                             "card a call, expected its one kernel")
    # bitwise the plain version only where no 7-bit probability sits on a
    # rounding edge (the path's inputs above); at random queries B4 keeps
    # its 2 bf16 steps, and each beam's rows are bitwise the untiled call's
    steps, bitwise, ms = _at_beam_rows(
        "B4", cross_attention.cross_attend_step,
        cross_attention.cross_attend_step_plain, randn, b4_args)
    if steps > 2.0:
        raise AssertionError(f"B4 at {4 * b4_args[0].shape[0]} beam rows: "
                             f"{steps:.3g} bf16 steps from the plain version")
    cases.append(f"beam rows B*K = {4 * b4_args[0].shape[0]} (the cache "
                 f"tiled per beam): {steps:.3g} bf16 steps, bitwise the plain "
                 f"version {bitwise}, each beam bitwise the untiled call, "
                 f"{ms:.4f} ms")
    print(f"[kernel] B4: {ops:g} device operation a call (torch.profiler); "
          + "; ".join(cases) + f" on {card}", flush=True)


def check_b6_edges(card: str, by_name, randn, b6_args, q_multi) -> None:
    """B6 (B4's cluster of row segments, dequantizing) at the edges its
    segments make: one segment short and exactly one (a cluster of one
    block), one row more, the 1,500 of the path, a masked tail and eleven
    segments (three blocks own two), at bucket 16 with 8 heads and at
    bucket 1 with 6 (a layer's slice of the scales off the 16-byte grid);
    each within 2 bf16 steps of the plain version and two calls bitwise
    equal.  B6's and B7-dq's wrappers each put one operation on the card a
    call."""
    import torch

    from whisper_tpu_torch.ops import cross_attention

    qx, k8, v8, ks, vs = b6_args
    g = torch.Generator(device="cuda").manual_seed(2)
    cases = []
    for (b_, h_), (s_, valid) in itertools.product(
            ((16, 8), (1, 6)), ((96, 96), (192, 192), (193, 193), (1500, 1500),
                                (1504, 1500), (2000, 1999))):
        k8e = torch.randint(-127, 128, (2, b_, h_, s_, 64), generator=g,
                            device="cuda", dtype=torch.int8)
        v8e = torch.randint(-127, 128, (2, b_, h_, s_, 64), generator=g,
                            device="cuda", dtype=torch.int8)
        kse = torch.rand(2, b_, h_, generator=g, device="cuda") * 0.02 + 1e-3
        vse = torch.rand(2, b_, h_, generator=g, device="cuda") * 0.02 + 1e-3
        args = (randn(b_, h_, 64, scale=0.125), k8e, v8e, kse, vse, 1)
        got = cross_attention.cross_attend_step_dequant(*args, s_valid=valid)
        steps = _bf16_steps(
            got, cross_attention.cross_attend_step_dequant_plain(
                *args, s_valid=valid))
        again = cross_attention.cross_attend_step_dequant(*args, s_valid=valid)
        if steps > 2.0 or not torch.equal(got, again):
            raise AssertionError(f"B6 at B = {b_}, H = {h_}, S = {s_}, "
                                 f"s_valid = {valid}: {steps:.3g} bf16 steps,"
                                 " or two calls differ")
        cases.append(f"{b_}x{h_}, S = {s_}/{valid}: {steps:.3g}")
    s = k8.shape[3]
    calls = {"cross_attend_step_dequant":
             lambda: cross_attention.cross_attend_step_dequant(
                 qx, k8, v8, ks, vs, 2, s_valid=s),
             "cross_attend_multi_dequant":
             lambda: cross_attention.cross_attend_multi(
                 q_multi, k8, v8, ks, vs, 2, s_valid=s)}
    for name, call in calls.items():
        ops = _device_ops_per_call(call)
        by_name[name]["device_ops_per_call"] = ops
        if ops != 1.0:
            raise AssertionError(f"{name}'s wrapper puts {ops} operations on "
                                 "the card a call, expected its one kernel")
    # B6 sums its bf16 p.v products in another order than the plain version
    # (0.3 bf16 steps at the path's inputs): its 2 steps, and each beam's
    # rows bitwise the untiled call's
    steps, bitwise, ms = _at_beam_rows(
        "B6", cross_attention.cross_attend_step_dequant,
        cross_attention.cross_attend_step_dequant_plain, randn, b6_args)
    if steps > 2.0:
        raise AssertionError(f"B6 at {4 * b6_args[0].shape[0]} beam rows: "
                             f"{steps:.3g} bf16 steps from the plain version")
    cases.append(f"beam rows B*K = {4 * b6_args[0].shape[0]} (the cache "
                 f"tiled per beam): {steps:.3g}, bitwise the plain version "
                 f"{bitwise}, each beam bitwise the untiled call, {ms:.4f} ms")
    print(f"[kernel] B6 and B7-dq: 1 device operation a call each "
          "(torch.profiler); B6 within 2 bf16 steps, two calls equal, at "
          + "; ".join(cases) + f" (bf16 steps) on {card}", flush=True)


def check_b2_b3_edges(card: str, by_name, randn, mlp_args, med_args,
                      b3_args) -> None:
    """B2 and B3 beyond the main path's shape, and what their redesign
    promises.  B2: 1 row, 1,499 rows (a ragged last tile) and the 24,000 of
    the main path at d = 512, 1,500 rows at d = 1,024 and 1,280; its three
    hand-written kernels and nothing else on the card a call; its time
    beside the bf16 composition of five PyTorch calls.  B3: pos 0, 70 and
    S - 1 with mixed pads, ``pos`` as an int and as a device tensor bitwise
    the same in output and caches; one device operation a call with and
    without ``pad_count``."""
    import torch
    import torch.nn.functional as F

    from whisper_tpu_torch.ops import encoder_mlp, self_attention

    cases = []
    for args, n_rows in ((mlp_args, 1), (mlp_args, 1499), (mlp_args, None),
                         (med_args, None)):
        xe = args[0].reshape(1, -1, args[0].shape[-1])
        xe = xe if n_rows is None else xe[:, :n_rows].contiguous()
        got = encoder_mlp.fused_encoder_mlp(xe, *args[1:])
        steps = _bf16_steps(got, encoder_mlp.fused_encoder_mlp_plain(
            xe, *args[1:]))
        if steps > 2.0 or not torch.isfinite(got.float()).all():
            raise AssertionError(f"B2 at {tuple(xe.shape)}: {steps:.3g} bf16 "
                                 "steps from the plain version")
        cases.append(f"{xe.shape[1]} x {xe.shape[2]}: {steps:.3g}")
    g = torch.Generator(device="cuda").manual_seed(2)
    dl, fl, bf = 1280, 5120, torch.bfloat16
    large = (randn(1, 1500, dl), 1.0 + randn(dl, scale=0.1),
             randn(dl, scale=0.1),
             torch.randint(-127, 128, (dl, fl), generator=g, device="cuda")
             .to(bf) * torch.tensor(2e-4, dtype=bf), randn(fl, scale=0.1),
             torch.randint(-127, 128, (fl, dl), generator=g, device="cuda")
             .to(bf) * torch.tensor(2e-4, dtype=bf), randn(dl, scale=0.1))
    got = encoder_mlp.fused_encoder_mlp(*large)
    steps = _bf16_steps(got, encoder_mlp.fused_encoder_mlp_plain(*large))
    if steps > 2.0:
        raise AssertionError(f"B2 at d = {dl}: {steps:.3g} bf16 steps from "
                             "the plain version")
    large_ms = _median_ms(lambda: encoder_mlp.fused_encoder_mlp(*large))
    cases.append(f"1500 x {dl}: {steps:.3g} ({large_ms:.4f} ms)")
    names = set()
    ops = _device_ops_per_call(
        lambda: encoder_mlp.fused_encoder_mlp(*mlp_args), names=names)
    by_name["fused_encoder_mlp"]["device_ops_per_call"] = ops
    if ops != 3.0 or not all("mlp_ln_kernel" in n or "gemm_kernel" in n
                             for n in names):
        raise AssertionError(f"B2's wrapper puts {ops} operations on the "
                             f"card a call, expected its three kernels: "
                             f"{sorted(names)}")

    def composition(a):
        xc, s_, b_, w1_, b1_, w2_, b2_ = a
        r = F.layer_norm(xc, xc.shape[-1:], s_, b_, 1e-5)
        h = F.gelu(F.linear(r, w1_.t(), b1_), approximate="tanh")
        return xc + F.linear(h, w2_.t(), b2_)

    for label, args, row in (("d = 512, 24,000 rows", mlp_args,
                              "fused_encoder_mlp"),
                             ("d = 1,024, 1,500 rows", med_args,
                              "fused_encoder_mlp_d1024")):
        comp_ms = _median_ms(lambda: composition(args))
        peak = by_name[row]["bound_ms"] / by_name[row]["ms"]
        print(f"[kernel] B2 at {label}: {by_name[row]['ms']:.4f} ms "
              f"({100 * peak:.1f}% of the bf16 peak) against a composition "
              f"of five PyTorch calls in bf16 (layer_norm, linear, gelu, "
              f"linear, add; no one call computes B2) {comp_ms:.4f} ms on "
              f"{card}", flush=True)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    encoder_mlp.fused_encoder_mlp(*mlp_args)
    torch.cuda.synchronize()
    scratch = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    print(f"[kernel] B2: {ops:g} device operations a call, all its own "
          f"kernels; bf16 steps from the plain version at rows x d "
          + ", ".join(cases) + f"; output and scratch of a call at 24,000 "
          f"rows {scratch:.1f} MiB on {card}", flush=True)

    q, kn, vn, kc, vc = b3_args
    n_b, s_max = q.shape[0], kc.shape[3]
    pads = torch.arange(n_b, dtype=torch.int32, device="cuda") % 5
    worst = 0.0
    for pos in (0, 70, s_max - 1):
        pad = torch.clamp(pads * (pos // 4), max=pos).to(torch.int32)
        caches = [[t.clone() for t in (kc, vc)] for _ in range(3)]
        pos_t = torch.tensor([pos], dtype=torch.int32, device="cuda")
        got = self_attention.self_attend_step(q, kn, vn, *caches[0], 3, pos,
                                              pad)
        got_t = self_attention.self_attend_step(q, kn, vn, *caches[1], 3,
                                                pos_t, pad)
        want = self_attention.self_attend_step_plain(q, kn, vn, *caches[2],
                                                     3, pos, pad)
        steps = _bf16_steps(got, want)
        worst = max(worst, steps)
        same = torch.equal(got, got_t) and all(
            torch.equal(a, b_) and torch.equal(a, c)
            for a, b_, c in zip(*caches))
        if steps > 2.0 or not same:
            raise AssertionError(f"B3 at pos {pos}: {steps:.3g} bf16 steps; "
                                 f"int and device pos and the plain "
                                 f"version's caches bitwise equal: {same}")
    pos_t = torch.tensor([70], dtype=torch.int32, device="cuda")
    zero = torch.zeros(n_b, dtype=torch.int32, device="cuda")
    ops = {_device_ops_per_call(lambda: self_attention.self_attend_step(
        q, kn, vn, kc, vc, 3, p_, pad_))
        for p_ in (70, pos_t) for pad_ in (None, zero)}
    by_name["self_attend_step"]["device_ops_per_call"] = max(ops)
    if ops != {1.0}:
        raise AssertionError(f"B3's wrapper puts {sorted(ops)} operations on "
                             "the card a call, expected its one kernel")
    dev_ms = _median_ms(lambda: self_attention.self_attend_step(
        q, kn, vn, kc, vc, 3, pos_t))
    by_name["self_attend_step"]["device_pos_ms"] = dev_ms
    print(f"[kernel] B3: 1 device operation a call with and without "
          f"pad_count, pos an int or a device tensor; at pos 0, 70, "
          f"{s_max - 1} with mixed pads at most {worst:.3g} bf16 steps from "
          f"the plain version, the two forms of pos bitwise equal in output "
          f"and caches; with pos on the device {dev_ms:.4f} ms a call "
          f"(an int: {by_name['self_attend_step']['ms']:.4f}) on {card}",
          flush=True)


def check_b9_edges(card: str, by_name, randn, qkv_args, qkv_med,
                   out_args) -> None:
    """B9a and B9b (B2's LayerNorm kernel and tiled products under names of
    their own) at the edges of the tiles: B9a at 1 and 1,499 rows and at
    d = 1,280, B9b at 1, 1,499 and 24,000 rows and at d = 128, 384 and 768,
    each within 2 bf16 steps of the plain version; two calls of each
    bitwise equal; B9a puts its two kernels on the card a call and B9b its
    four, each by its name; their times beside the bf16 composition of
    PyTorch calls that computes the same function (no one call does)."""
    import torch
    import torch.nn.functional as F

    from whisper_tpu_torch.ops import encoder_block as eb

    g = torch.Generator(device="cuda").manual_seed(3)
    bf = torch.bfloat16

    def qweight(rows_, cols, s):
        return (torch.randint(-127, 128, (rows_, cols), generator=g,
                              device="cuda").to(bf)
                * torch.tensor(s, dtype=bf))

    def first(a, n_rows):
        return a.reshape(1, -1, a.shape[-1])[:, :n_rows].contiguous()

    cases = []

    def hold(label, call, plain, args):
        got = call(*args)
        steps = _bf16_steps(got, plain(*args))
        if steps > 2.0 or not torch.isfinite(got.float()).all():
            raise AssertionError(f"{label}: {steps:.3g} bf16 steps from the "
                                 "plain version")
        if not torch.equal(got, call(*args)):
            raise AssertionError(f"{label}: two calls differ")
        cases.append(f"{label} {steps:.3g}")

    qkv, out_mlp = (eb.fused_ln_qkv, eb.fused_ln_qkv_plain), \
        (eb.fused_out_mlp, eb.fused_out_mlp_plain)
    for n_rows in (1, 1499, None):
        hold(f"B9a {n_rows or 24000} x 512", *qkv,
             (first(qkv_args[0], n_rows),) + qkv_args[1:])
        hold(f"B9b {n_rows or 24000} x 512", *out_mlp,
             (first(out_args[0], n_rows), first(out_args[1], n_rows))
             + out_args[2:])
    hold("B9a' 1500 x 1024", *qkv, qkv_med)
    dl = 1280
    hold(f"B9a 1500 x {dl}", *qkv,
         (randn(1, 1500, dl), 1.0 + randn(dl, scale=0.1),
          randn(dl, scale=0.1), qweight(dl, 3 * dl, 2e-4),
          randn(3 * dl, scale=0.1)))
    for dw in (128, 384, 768):
        fw = 4 * dw
        hold(f"B9b 1500 x {dw}", *out_mlp,
             (randn(1, 1500, dw), randn(1, 1500, dw), qweight(dw, dw, 3e-4),
              randn(dw, scale=0.1), 1.0 + randn(dw, scale=0.1),
              randn(dw, scale=0.1), qweight(dw, fw, 3e-4),
              randn(fw, scale=0.1), qweight(fw, dw, 3e-4),
              randn(dw, scale=0.1)))

    for row, call, args, want in (
            ("fused_ln_qkv", eb.fused_ln_qkv, qkv_args,
             ("qkv_ln_kernel", "QkvBias")),
            ("fused_ln_qkv_d1024", eb.fused_ln_qkv, qkv_med,
             ("qkv_ln_kernel", "QkvBias")),
            ("fused_out_mlp", eb.fused_out_mlp, out_args,
             ("OutProjResidual", "out_ln_kernel", "OutFc1Gelu",
              "OutFc2Residual"))):
        names = set()
        ops = _device_ops_per_call(lambda: call(*args), names=names)
        by_name[row]["device_ops_per_call"] = ops
        if ops != len(want) or not all(any(fn in n for n in names)
                                       for fn in want):
            raise AssertionError(f"{row}'s wrapper puts {ops} operations on "
                                 f"the card a call, expected its kernels "
                                 f"{want}: {sorted(names)}")

    def qkv_composition(x, ln_s, ln_b, w, bias):
        r = F.layer_norm(x, x.shape[-1:], ln_s, ln_b, 1e-5)
        return F.linear(r, w.t(), bias)

    def out_mlp_composition(x, ctx, o_w, o_b, ln_s, ln_b, w1, b1, w2, b2):
        y = x + F.linear(ctx, o_w.t(), o_b)
        r = F.layer_norm(y, y.shape[-1:], ln_s, ln_b, 1e-5)
        h = F.gelu(F.linear(r, w1.t(), b1), approximate="tanh")
        return y + F.linear(h, w2.t(), b2)

    for row, comp, args, calls in (
            ("fused_ln_qkv", qkv_composition, qkv_args,
             "layer_norm, linear"),
            ("fused_ln_qkv_d1024", qkv_composition, qkv_med,
             "layer_norm, linear"),
            ("fused_out_mlp", out_mlp_composition, out_args,
             "linear, add, layer_norm, linear, gelu, linear, add")):
        comp_ms = _median_ms(lambda: comp(*args))
        by_name[row]["composition_ms"] = comp_ms
        peak = by_name[row]["bound_ms"] / by_name[row]["ms"]
        print(f"[kernel] {row}: {by_name[row]['ms']:.4f} ms "
              f"({100 * peak:.1f}% of its bound), "
              f"{by_name[row]['device_ops_per_call']:g} device operations a "
              f"call, against a composition of PyTorch calls in bf16 "
              f"({calls}; no one call computes it) {comp_ms:.4f} ms on "
              f"{card}", flush=True)
    print(f"[kernel] B9a and B9b: bf16 steps from the plain version at rows "
          f"x d: " + "; ".join(cases) + f"; two calls of each bitwise equal "
          f"on {card}", flush=True)


def check_b8_b5_edges(card: str, by_name, randn, b3_args, wire) -> None:
    """B8 and B5 beyond the main path's shape, and what their redesign
    promises.  B8: pos 0, 70 and S - 1 with mixed pads and with none, at
    S = 132, 131 (the scale planes off the 16-byte grid) and 448 (more
    shared memory than a launch gets unasked), ``pos`` as an int and as a
    device tensor: output and the four buffers bitwise equal between the
    two, the buffers bitwise the plain version's, the output within 2 bf16
    steps of it; one device operation a call with and without
    ``pad_count``.  B5: 1, 16, 17, 3,000 and 7,680 valid frames in buckets
    of 3,000 and 12,000, int16 and float32 wires, 80 and 128 mels: within
    1e-4 of the plain version or, where the plain version itself stands
    farther than 1e-4 from its function evaluated in float64 (cuBLAS orders
    its fp32 sums by the shape), within 1e-4 of that; the invalid frames
    exactly 0, two calls bitwise equal, its two kernels and nothing else on
    the card a call; the cuFFT composition's error beside its time."""
    import numpy as np
    import torch

    from whisper_tpu_torch.frontend import golden
    from whisper_tpu_torch.ops import log_mel, self_attention
    from whisper_tpu_torch.ops.common import disable_tf32
    from whisper_tpu_torch.profile_ladder import mel_composition

    q, kn, vn, kc, vc = b3_args
    n_b, n_h = q.shape[:2]
    worst = 0.0
    for s_ in (132, 131, 448):
        k8, v8, ks, vs = self_attention.quantize_self_cache(
            randn(2, n_b, n_h, s_, 64), randn(2, n_b, n_h, s_, 64))
        for pos, mixed in itertools.product((0, 70, s_ - 1), (True, False)):
            pad = (torch.clamp(torch.arange(n_b, device="cuda") % 5
                               * (pos // 4), max=pos).to(torch.int32)
                   if mixed else None)
            bufs = [[x.clone() for x in (k8, v8, ks, vs)] for _ in range(3)]
            pos_t = torch.tensor([pos], dtype=torch.int32, device="cuda")
            got = self_attention.self_attend_step_int8(q, kn, vn, *bufs[0], 1,
                                                       pos, pad)
            got_t = self_attention.self_attend_step_int8(q, kn, vn, *bufs[1],
                                                         1, pos_t, pad)
            want = self_attention.self_attend_step_int8_plain(
                q, kn, vn, *bufs[2], 1, pos, pad)
            steps = _bf16_steps(got, want)
            worst = max(worst, steps)
            same = torch.equal(got, got_t) and all(
                torch.equal(a, b_) and torch.equal(a, c)
                for a, b_, c in zip(*bufs))
            if steps > 2.0 or not same:
                raise AssertionError(
                    f"B8 at S = {s_}, pos {pos}, pads {mixed}: {steps:.3g} "
                    "bf16 steps; int and device pos and the plain version's "
                    f"buffers bitwise equal: {same}")
    i8 = self_attention.quantize_self_cache(kc, vc)
    pos_t = torch.tensor([70], dtype=torch.int32, device="cuda")
    zero = torch.zeros(n_b, dtype=torch.int32, device="cuda")
    ops = {_device_ops_per_call(lambda: self_attention.self_attend_step_int8(
        q, kn, vn, *i8, 3, p_, pad_))
        for p_ in (70, pos_t) for pad_ in (None, zero)}
    by_name["self_attend_step_int8"]["device_ops_per_call"] = max(ops)
    if ops != {1.0}:
        raise AssertionError(f"B8's wrapper puts {sorted(ops)} operations on "
                             "the card a call, expected its one kernel")
    dev_ms = _median_ms(lambda: self_attention.self_attend_step_int8(
        q, kn, vn, *i8, 3, pos_t))
    by_name["self_attend_step_int8"]["device_pos_ms"] = dev_ms
    print(f"[kernel] B8: 1 device operation a call with and without "
          f"pad_count, pos an int or a device tensor; at S = 132, 131, 448 "
          f"and pos 0, 70, S - 1, mixed pads and none, at most {worst:.3g} "
          f"bf16 steps from the plain version, the four buffers bitwise its "
          f"own, the two forms of pos bitwise equal; with pos on the device "
          f"{dev_ms:.4f} ms a call (an int: "
          f"{by_name['self_attend_step_int8']['ms']:.4f}) on {card}",
          flush=True)

    disable_tf32()
    rng = np.random.default_rng(4)
    worst, cases, by_float64 = 0.0, 0, []
    for (valid, n_frames), n_mels, form in itertools.product(
            ((1, 3000), (16, 3000), (17, 3000), (3000, 3000), (1, 12000),
             (16, 12000), (17, 12000), (3000, 12000), (7680, 12000)),
            (80, 128), ("int16", "float32")):
        n = valid * golden.HOP
        t_ = np.arange(n) / 16000.0
        audio = (0.3 * np.sin(2 * np.pi * 440 * t_)
                 + 0.05 * rng.standard_normal(n)).astype(np.float32)
        padded = golden.reflect_pad(audio)
        if form == "int16":
            padded = np.round(np.clip(padded, -1, 1) * 32767).astype(np.int16)
        x = torch.from_numpy(padded).cuda()
        got = log_mel.log_mel(x, valid, n_mels, n_frames)
        again = log_mel.log_mel(x, valid, n_mels, n_frames)
        want = log_mel.log_mel_plain(x, valid, n_mels, n_frames)
        exact = log_mel.log_mel_float64(x, valid, n_mels, n_frames)
        err, err64, plain64 = (float((a - b).abs().max())
                               for a, b in ((got, want), (got, exact),
                                            (want, exact)))
        label = f"{valid} of {n_frames} frames, {n_mels} mels, {form}"
        if err > 1e-4 and plain64 > 1e-4:
            by_float64.append(f"{label}: {err:.3g} from the plain version, "
                              f"which is {plain64:.3g} from float64; "
                              f"{err64:.3g} from float64")
            err = err64
        worst = max(worst, err)
        if (err > 1e-4 or not torch.equal(got, again)
                or not bool((got[:, valid:] == 0).all())):
            raise AssertionError(
                f"B5 at {label}: {err:.3g} from the plain version (tolerance "
                f"1e-4; the plain version {plain64:.3g} from float64), two "
                f"calls bitwise {torch.equal(got, again)}")
        cases += 1
        if valid in (1, 7680):
            names = set()
            ops = _device_ops_per_call(
                lambda: log_mel.log_mel(x, valid, n_mels, n_frames),
                names=names)
            if ops != 2.0 or not all(
                    any(k in n_ for n_ in names)
                    for k in ("mel_spectrum_kernel", "mel_normalize_kernel")):
                raise AssertionError(f"B5's wrapper puts {ops} operations on "
                                     f"the card a call: {sorted(names)}")
    by_name["log_mel"]["device_ops_per_call"] = 2.0
    nv, nf = 7680, 12000
    comp_err = float((mel_composition(wire, nv, 80, nf)
                      - log_mel.log_mel_plain(wire, nv, 80, nf)).abs().max())
    row = by_name["log_mel"]
    row["library_err"] = comp_err
    print(f"[kernel] B5: 2 device operations a call (its two kernels); "
          f"within {worst:.3g} of the plain version at {cases} cases (1, 16, "
          f"17, 3,000, 7,680 valid frames in buckets of 3,000 and 12,000, "
          f"int16 and float32, 80 and 128 mels; held against float64 where "
          f"the plain version is out: {by_float64 or 'none'}), invalid "
          f"frames 0, two calls bitwise equal; at 7,680 of 12,000 frames "
          f"{row['ms']:.4f} ms "
          f"against the composition around torch.stft {row['library_ms']:.4f}"
          f" ms (its error against the plain version {comp_err:.3g}) on "
          f"{card}", flush=True)


# The kernels of the headline main path (x5, a 301.574 s file: streamed
# mel, so no B5; int8 x int8 cross-attention, so no B6).
MAIN_PATH_KERNELS = ("fused_attention", "fused_encoder_mlp",
                     "self_attend_step", "cross_attend_step")


def _counts(results) -> dict:
    return {r["name"]: getattr(*r["counter"]) for r in results}


def _zero_counts(results) -> None:
    for r in results:
        setattr(*r["counter"], 0)


def check_against_cpu(params, dims) -> None:
    """The port on the card (kernels) against the port on the CPU (plain
    versions) on an 80 s clip: mel, encoder states, prefill logits and twelve
    decode steps teacher-forced with the CPU's tokens."""
    import torch

    from whisper_tpu_torch.frontend import golden
    from whisper_tpu_torch.headline import make_session, synth_audio
    from whisper_tpu_torch.models import whisper
    from whisper_tpu_torch.pipeline.chunk import (
        CHUNK_FRAMES,
        chunk_starts,
        mel_frame_bucket,
    )

    audio = synth_audio(80.0)
    padded = golden.reflect_pad(audio)
    nv = golden.num_frames(len(audio))
    sessions = {dev: make_session(dev, params) for dev in ("cuda", "cpu")}
    mels = {dev: s.compute_mel(padded, nv, mel_frame_bucket(nv)).float().cpu()
            for dev, s in sessions.items()}
    mel_err = float((mels["cuda"] - mels["cpu"]).abs().max())
    starts = [p // golden.HOP for p in chunk_starts(len(audio), 480_000,
                                                    400_000)]
    chunks = torch.stack([torch.nn.functional.pad(
        mels["cpu"], (0, CHUNK_FRAMES))[:, s:s + CHUNK_FRAMES]
        for s in starts])
    enc = {dev: s.encoder(chunks.to(dev)) for dev, s in sessions.items()}
    enc_steps = _bf16_steps(enc["cuda"].cpu(), enc["cpu"])

    prompt = torch.tensor([50258, 50259, 50359, 50363])
    tokens = prompt[None].expand(len(starts), -1)
    logits, caches = {}, {}
    for dev, s in sessions.items():
        p = s._decoder_params
        logits[dev], caches[dev] = whisper.decoder_prefill(
            p, dims, tokens.to(dev), enc["cpu"].to(dev), 4 + 12,
            int8_cross_kv=True)
    errs = [float((logits["cuda"].cpu() - logits["cpu"]).abs().max())]
    last = logits["cpu"][:, -1].argmax(-1)
    for i in range(12):
        step = {}
        for dev, s in sessions.items():
            step[dev], caches[dev] = whisper.decoder_step(
                s._decoder_params, dims, last.to(dev), 4 + i, caches[dev],
                kernel_step=True, cross_len=enc["cpu"].shape[1])
        if not torch.isfinite(step["cuda"]).all():
            raise AssertionError(f"non-finite logits at step {i}")
        errs.append(float((step["cuda"].cpu() - step["cpu"]).abs().max()))
        last = step["cpu"].argmax(-1)
    scale = float(logits["cpu"].abs().max())
    print(f"[reference] card vs CPU on an 80 s clip: mel max diff "
          f"{mel_err:.3g}; encoder {enc_steps:.2f} bf16 steps; logits max "
          f"diff prefill {errs[0]:.3g}, steps {max(errs[1:]):.3g} "
          f"(logit scale {scale:.3g})", flush=True)
    if mel_err > 1e-4:
        raise AssertionError(f"mel differs by {mel_err} (tolerance 1e-4)")
    if enc_steps > 8.0:
        raise AssertionError(f"encoder differs by {enc_steps:.2f} bf16 "
                             "steps (tolerance 8)")
    if max(errs) > 5e-2:
        raise AssertionError(f"logits differ by {max(errs)} (tolerance "
                             "5e-2)")


def _bucket_encoder_states(session, audio):
    """Encoder states of the file's chunk bucket (the 301.574 s file: 12
    chunks in a bucket of 16, the padding rows slicing zeros), and a prompt
    row (en, transcribe, no timestamps) for each."""
    import torch

    from whisper_tpu_torch.frontend import golden
    from whisper_tpu_torch.pipeline.chunk import (
        CHUNK_FRAMES,
        chunk_starts,
        mel_frame_bucket,
    )

    nv = golden.num_frames(len(audio))
    mel = session.compute_mel(golden.reflect_pad(audio), nv,
                              mel_frame_bucket(nv))
    starts = [p // golden.HOP for p in chunk_starts(len(audio), 480_000,
                                                    400_000)]
    starts += [mel.shape[1]] * (session._batch_bucket(len(starts))
                                - len(starts))
    mel_pad = torch.nn.functional.pad(mel, (0, CHUNK_FRAMES))
    enc = session.encoder(torch.stack([mel_pad[:, s:s + CHUNK_FRAMES]
                                       for s in starts]))
    prompt = torch.tensor([[50258, 50259, 50359, 50363]] * len(starts),
                          device=enc.device)
    return enc, prompt


def check_main_path_finite(session, audio, dims) -> None:
    """The main path's encoder states and prefill logits for the file's
    chunk bucket are finite."""
    import torch

    from whisper_tpu_torch.models import whisper

    enc, prompt = _bucket_encoder_states(session, audio)
    logits, _ = whisper.decoder_prefill(session._decoder_params, dims, prompt,
                                        enc, 4 + 128, int8_cross_kv=True)
    if not (torch.isfinite(enc).all() and torch.isfinite(logits).all()):
        raise AssertionError("non-finite encoder states or logits on the "
                             "main path")


def _timed_run(session, audio, results, max_new_tokens: int = 128,
               runs: int = 1, **decode):
    """A warm-up, then ``runs`` runs, each with every kernel's count set to
    0 just before it and read just after; the runs must give equal tokens
    and counts.  ``decode``: run_once's decoding options (speculative,
    draft_k).  The median run by e2e: (e2e s, Timing, tokens, counts)."""
    import torch

    from whisper_tpu_torch.headline import run_once

    run_once(session, audio, max_new_tokens=max_new_tokens, **decode)
    out = []
    for _ in range(runs):
        _zero_counts(results)
        collector = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, timing = run_once(session, audio, token_collector=collector,
                             max_new_tokens=max_new_tokens, **decode)
        out.append((time.perf_counter() - t0, timing, collector[0],
                    _counts(results)))
        if not ((out[-1][2] == out[0][2]).all() and out[-1][3] == out[0][3]):
            raise AssertionError("two runs gave different tokens or launches")
    return sorted(out, key=lambda r: r[0])[len(out) // 2]


def check_ladder(card: str, results, params, dims, audio, x5) -> dict:
    """The 301.574 s file at whisper-base through x7, x6 and x5 with the
    fused encoder block and the hybrid decode step; ``x5``: (e2e, Timing,
    tokens, counts) of the main path's run, printed beside each.  Returns
    each configuration's (e2e, Timing, tokens, counts)."""
    import warnings

    from whisper_tpu_torch.headline import make_session

    n_l, n_e = dims.decoder_layers, dims.encoder_layers
    configs = (("x7", "x7", {}),
               ("x6", "x6", {}),
               ("x5+fused_encoder_block+fused_decoder_step", "x5",
                dict(fused_encoder_block=True, fused_decoder_step=True)))
    runs = {"x5": x5}
    for label, variant, overrides in configs:
        with warnings.catch_warnings():
            # x6: "fused_encoder_mlp overrides int8_encoder_act ..."
            warnings.simplefilter("ignore", UserWarning)
            session = make_session("cuda", params, variant, **overrides)
        e2e, timing, toks, c = _timed_run(session, audio, results)
        runs[label] = (e2e, timing, toks, c)
        if toks.shape != x5[2].shape:
            raise AssertionError(f"{label}: tokens {toks.shape}")
        if not ((toks >= 0) & (toks < dims.vocab_size)).all():
            raise AssertionError(f"{label}: token ids outside the vocabulary")
        check_main_path_finite(session, audio, dims)
        enc = (c["fused_attention"], c["fused_encoder_mlp"],
               c["fused_ln_qkv"], c["fused_out_mlp"])
        step = (c["self_attend_step"], c["self_attend_step_int8"],
                c["cross_attend_step"], c["decoder_mlp_block"])
        layers_steps = max(step)
        ok = layers_steps > 0 and layers_steps % n_l == 0 \
            and c["cross_attend_step_dequant"] == 0
        if label == "x7":      # B8 then B4, once per layer and step; no B3
            ok = ok and enc == (n_e, n_e, 0, 0) \
                and step == (0, layers_steps, layers_steps, 0)
        elif label == "x6":    # the kernels of x5
            ok = ok and enc == (n_e, n_e, 0, 0) \
                and step == (layers_steps, 0, layers_steps, 0)
        else:                  # B9a, B1, B9b per encoder layer; B10c per step
            ok = ok and enc == (n_e, 0, n_e, n_e) \
                and step == (0, 0, 0, layers_steps)
        if not ok:
            raise AssertionError(f"{label}: launches {c}")
        del session
    # x7 shares x5's prefill, so every chunk's first token is x5's; after
    # that a flipped near-tie (random weights) carries to the chunk's end.
    if not (runs["x7"][2][:, 0] == x5[2][:, 0]).all():
        raise AssertionError("x7: a first token differs from x5's")
    same = float((runs["x7"][2] == x5[2]).mean())
    print(f"[ladder] x7 tokens equal to x5's: {same:.4f} of "
          f"{x5[2].size}", flush=True)
    for label, (e2e, timing, _, c) in runs.items():
        steps = max(c["cross_attend_step"], c["decoder_mlp_block"]) // n_l
        print(f"[ladder] whisper-base {label}, {len(audio) / 16000:.3f} s, "
              f"on {card}: e2e {e2e:.4f} s, model {timing.model_only_s:.4f} "
              f"s, preprocess {timing.preprocess_s:.4f} s, {steps} decode "
              f"steps (x5: median of 3 runs, the others one run); launches "
              f"{c}", flush=True)
    return runs


def check_speculative(card: str, results, params, dims, audio, x5) -> dict:
    """Speculative decoding of the 301.574 s file (one bucket of 16, 128
    tokens, draft_k = 4): x5 with a random whisper-tiny draft, x5 with
    whisper-base as its own draft on the shared encoder, x4 with the tiny
    draft; ``x5``: (e2e, Timing, tokens, counts) of the greedy main path's
    run.  Returns the launch counts of the x5 and the x4 run with the tiny
    draft, and for each of the two its (greedy tokens, speculative
    tokens)."""
    import numpy as np

    from whisper_tpu_torch.headline import make_session
    from whisper_tpu_torch.models.convert import init_params
    from whisper_tpu_torch.models.registry import get_dims
    from whisper_tpu_torch.variants.quant import quantize_params

    n_l, k = dims.decoder_layers, 4
    tiny = get_dims("openai/whisper-tiny")
    tiny_params = init_params(tiny, seed=1)

    def run(label, variant, draft, draft_dims, share, greedy):
        session = make_session("cuda", params, variant)
        if greedy is None:      # this rung's greedy run, for comparison
            greedy = _timed_run(session, audio, results)
        session.set_draft_model(draft, draft_dims, share_encoder=share)
        e2e, timing, toks, c = _timed_run(session, audio, results,
                                          speculative=True, draft_k=k)
        rounds = sum(r for r, _ in session.speculative_stats)
        committed = np.concatenate(
            [n.cpu().numpy() for _, n in session.speculative_stats])
        if toks.shape != greedy[2].shape or not (
                (toks >= 0) & (toks < dims.vocab_size)).all():
            raise AssertionError(f"{label}: tokens {toks.shape}")
        if c["cross_attend_multi"] != rounds * n_l or rounds < 1:
            raise AssertionError(f"{label}: B7 launched "
                                 f"{c['cross_attend_multi']} times in "
                                 f"{rounds} rounds of {n_l} layers")
        if c["self_attend_step"] or c["self_attend_step_int8"]:
            raise AssertionError(f"{label}: B3/B8 launched: {c}")
        # The prefill is the greedy run's, so every chunk's first token is.
        if not (toks[:, 0] == greedy[2][:, 0]).all():
            raise AssertionError(f"{label}: a first token differs from the "
                                 "greedy run's")
        same = float((toks == greedy[2]).mean())
        print(f"[speculative] whisper-base {label}, draft_k {k}, on {card}: "
              f"e2e {e2e:.4f} s, model {timing.model_only_s:.4f} s (greedy "
              f"{greedy[0]:.4f} / {greedy[1].model_only_s:.4f} s); {rounds} "
              f"verify rounds, {committed.sum() / rounds / len(committed):.3f}"
              f" tokens committed per round and row; tokens equal to the "
              f"greedy run's: {same:.4f} of {toks.size}; launches {c}",
              flush=True)
        return toks, rounds, c, greedy

    adv, _, c5, _ = run("x5 + whisper-tiny draft", "x5", tiny_params, tiny,
                     False, x5)
    if not (c5["cross_attend_step"] > 0
            and c5["cross_attend_step_dequant"] == 0):
        raise AssertionError(f"x5 draft steps: launches {c5}")
    # the main model's own int8 weights, so that draft and main differ only
    # in the shape of their passes (one token against five)
    own, rounds, _, _ = run("x5 + its own weights as draft, shared encoder",
                         "x5", quantize_params(params), dims, True, x5)
    # One run rejects nearly every proposal, the other accepts nearly all:
    # the committed sequence must not depend on the draft.
    if not (adv == own).all():
        raise AssertionError(
            "speculative tokens depend on the draft: "
            f"{float((adv == own).mean()):.4f} equal")
    if rounds > 2 * -(-128 // (k + 1)):
        raise AssertionError(f"own-weights draft: {rounds} rounds, expected "
                             f"about {-(-128 // (k + 1))}")
    spec4, _, c4, greedy4 = run("x4 + whisper-tiny draft", "x4", tiny_params,
                                tiny, False, None)
    if not (c4["cross_attend_step_dequant"] > 0
            and c4["cross_attend_step"] == 0):
        raise AssertionError(f"x4 draft steps: launches {c4}")
    return {"x5": c5, "x4": c4}, {"x5": (x5[2], adv),
                                  "x4": (greedy4[2], spec4)}


def check_fused_step(card: str, results, params, dims, audio) -> dict:
    """``decoder_step_fused`` (B10a, B10b, B10c per layer) driven greedily
    for 127 steps at whisper-base from a bf16 prefill of the 301.574 s
    file's bucket of 16, eagerly and replayed from one captured CUDA graph
    of a step (token and ``pos`` on the card, advanced inside the graph);
    its time per step beside the x5 kernel step's and the hybrid step's
    over the same 127 steps.  Returns the launch counts of one eager run."""
    import torch

    from whisper_tpu_torch.headline import make_session
    from whisper_tpu_torch.models import whisper
    from whisper_tpu_torch.ops import decoder_kernels as dk

    session = make_session("cuda", params)
    p = session._decoder_params
    enc, prompt = _bucket_encoder_states(session, audio)
    n_p, n_new = prompt.shape[1], 128
    sw = dk.build_step_weights(p, dims)

    def prefill(int8):
        logits, cache = whisper.decoder_prefill(p, dims, prompt, enc,
                                                n_p + n_new,
                                                int8_cross_kv=int8)
        return logits[:, -1].argmax(-1), cache

    def loop(step, first):
        """127 greedy steps without a host sync: (tokens, ms per step)."""
        toks, last = [first], first
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(1, n_new):
            last = step(last, n_p + i - 1).argmax(-1)
            toks.append(last)
        torch.cuda.synchronize()
        return (torch.stack(toks, 1),
                (time.perf_counter() - t0) * 1e3 / (n_new - 1))

    def fused_setup():
        first, cache = prefill(False)
        k_tm = dk.cache_to_time_major(cache.self_k)
        v_tm = dk.cache_to_time_major(cache.self_v)

        def step(tok, pos):
            return dk.decoder_step_fused(p, sw, dims, tok, pos, k_tm, v_tm,
                                         cache.cross_k, cache.cross_v)[0]

        return first, cache, k_tm, v_tm, step

    def fused_run():
        first, cache, k_tm, v_tm, step = fused_setup()
        # the first step against the port's plain step on the same cache
        plain_cache = cache._replace(self_k=cache.self_k.clone(),
                                     self_v=cache.self_v.clone())
        want, _ = whisper.decoder_step(p, dims, first, n_p, plain_cache)
        k0, v0 = k_tm.clone(), v_tm.clone()
        got = dk.decoder_step_fused(p, sw, dims, first, n_p, k0, v0,
                                    cache.cross_k, cache.cross_v)[0]
        err = float((got - want).abs().max())
        _zero_counts(results)
        toks, ms = loop(step, first)
        return toks, ms, err, _counts(results)

    def graph_run():
        """The 127 steps replayed from one graph of a step: (tokens, ms per
        step on the host clock, one sync at the end)."""
        first, cache, k_tm, v_tm, _ = fused_setup()
        saved = (k_tm.clone(), v_tm.clone())
        tok = first.clone()
        pos_t = torch.tensor([n_p], dtype=torch.int32, device="cuda")
        toks = torch.zeros((first.shape[0], n_new), dtype=first.dtype,
                           device="cuda")

        def step():
            logits = dk.decoder_step_fused(p, sw, dims, tok, pos_t, k_tm,
                                           v_tm, cache.cross_k,
                                           cache.cross_v)[0]
            tok.copy_(logits.argmax(-1))
            toks.index_copy_(1, (pos_t - (n_p - 1)).long(), tok[:, None])
            pos_t.add_(1)

        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step()                   # warm before the capture
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            step()
        for buf, s_ in zip((k_tm, v_tm), saved):
            buf.copy_(s_)
        tok.copy_(first)
        pos_t.fill_(n_p)
        toks[:, 0] = first
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_new - 1):
            graph.replay()
        torch.cuda.synchronize()
        return toks, (time.perf_counter() - t0) * 1e3 / (n_new - 1)

    fused_run()                                   # warm-up
    toks, ms, err, c = fused_run()
    toks2, ms2, _, c2 = fused_run()
    graph_run()                                   # warm-up
    g_toks, g_ms = graph_run()
    g_toks2, g_ms2 = graph_run()
    first, _, _, _, step = fused_setup()
    traced = _traced(lambda: loop(step, first))
    n_steps = (n_new - 1) * dims.decoder_layers
    step_ms = traced["device_busy_ms"] / (n_new - 1)
    print(f"[fused step] in situ over 127 traced eager steps, µs "
          f"(launches): {_in_situ(traced)}; {traced['device_ops']} device "
          f"operations, busy {traced['device_busy_ms']:.2f} ms = "
          f"{step_ms:.4f} ms of device time a step on {card}", flush=True)
    if err > 5e-2:
        raise AssertionError(f"fused step: first-step logits differ from "
                             f"decoder_step's by {err} (tolerance 5e-2)")
    if not ((toks >= 0) & (toks < dims.vocab_size)).all() \
            or not torch.equal(toks, toks2):
        raise AssertionError("fused step: tokens outside the vocabulary or "
                             "not repeatable")
    if not (torch.equal(g_toks, toks) and torch.equal(g_toks2, toks)):
        raise AssertionError("fused step: the tokens replayed from a CUDA "
                             "graph differ from the eager loop's")
    if not (c["decoder_self_block"] == c["decoder_cross_block"]
            == c["decoder_mlp_block"] == n_steps and c == c2):
        raise AssertionError(f"fused step: launches {c}, expected {n_steps} "
                             "of B10a, B10b and B10c")
    if any(v for k_, v in c.items() if k_ not in (
            "decoder_self_block", "decoder_cross_block",
            "decoder_mlp_block")):
        raise AssertionError(f"fused step: other kernels launched: {c}")

    first8, cache8 = prefill(True)

    def x5_step(tok, pos):
        return whisper.decoder_step(p, dims, tok, pos, cache8,
                                    kernel_step=True,
                                    cross_len=enc.shape[1])[0]

    loop(x5_step, first8)
    _, x5_ms = loop(x5_step, first8)
    first16, cache16 = prefill(False)

    def hybrid_step(tok, pos):
        return dk.decoder_step_hybrid(p, sw, dims, tok, pos, cache16)[0]

    loop(hybrid_step, first16)
    _, hybrid_ms = loop(hybrid_step, first16)
    print(f"[fused step] whisper-base, bucket {enc.shape[0]}, 127 steps from "
          f"a bf16 prefill, on {card}: eager {ms:.4f} and {ms2:.4f} ms a "
          f"step (host clock, one sync at the end), replayed from one CUDA "
          f"graph of a step {g_ms:.4f} and {g_ms2:.4f} ms a step (tokens "
          f"equal to the eager loop's), against the x5 kernel step "
          f"{x5_ms:.4f} ms and the hybrid step {hybrid_ms:.4f} ms; device "
          f"time {step_ms:.4f} ms a step; first-step logits within "
          f"{err:.3g} of decoder_step's; tokens equal across two runs; "
          f"launches {c}", flush=True)
    return c


def check_medium_fused_block(card: str, results) -> dict:
    """A 4 s file at whisper-medium (random weights from seed 0) at x5 with
    fused_encoder_block: at d = 1024 the composition is B9a, B1, a plain
    O-projection and B2, once per encoder layer, and never B9b."""
    from whisper_tpu_torch.headline import make_session, run_once, synth_audio
    from whisper_tpu_torch.models.registry import get_dims

    model_id = "openai/whisper-medium"
    dims = get_dims(model_id)
    session = make_session("cuda", None, "x5", model_id,
                           fused_encoder_block=True)
    e2e, timing, toks, c = _timed_run(session, synth_audio(4.0), results,
                                      max_new_tokens=16)
    n_l = dims.encoder_layers
    if not (c["fused_ln_qkv"] == c["fused_encoder_mlp"]
            == c["fused_attention"] == n_l and c["fused_out_mlp"] == 0
            and c["self_attend_step"] == c["cross_attend_step"] > 0):
        raise AssertionError(f"whisper-medium fused block: launches {c}")
    if toks.shape != (1, 16) or not ((toks >= 0)
                                     & (toks < dims.vocab_size)).all():
        raise AssertionError(f"whisper-medium fused block: tokens {toks}")
    traced = _traced(lambda: run_once(session, synth_audio(4.0),
                                      max_new_tokens=16))
    print(f"[medium] whisper-medium x5+fused_encoder_block, 4 s, 16 tokens, "
          f"on {card}: e2e {e2e:.4f} s, model {timing.model_only_s:.4f} s; "
          f"launches {c}; in situ, µs (launches; at d = 1,024 B9a is B9a' "
          f"and B2 B2c): {_in_situ(traced)}", flush=True)
    return c


def _grammar_errors(row, cfg) -> list:
    """What one generated row breaks of the timestamp grammar
    (``runtime.timestamps``): the first token a timestamp at most
    ``max_initial_timestamp_index`` steps in, no <|notimestamps|>, pairs
    closed (after text and a timestamp no text; after two timestamps no
    third), timestamps never decreasing.  The row is read up to its first
    EOT."""
    gen = []
    for t in row:
        if t == cfg.eot_id:
            break
        gen.append(int(t))
    tsb = cfg.timestamp_begin
    if not gen:
        return ["no first token"]
    errs = []
    if not tsb <= gen[0] <= tsb + cfg.max_initial_timestamp_index:
        errs.append(f"first token {gen[0]}")
    if cfg.no_timestamps_id in gen:
        errs.append("<|notimestamps|>")
    stamps = [t for t in gen if t >= tsb]
    if stamps != sorted(stamps):
        errs.append("timestamps decrease")
    for j in range(1, len(gen)):
        last, pen = gen[j - 1] >= tsb, j < 2 or gen[j - 2] >= tsb
        if last and pen and gen[j] >= tsb:
            errs.append(f"a third timestamp at {j}")
        if last and not pen and gen[j] < cfg.eot_id:
            errs.append(f"an open pair at {j}")
    return errs


def _decode_run(results, fn):
    """``fn()`` with every kernel's count set to 0 just before it and read
    just after: (its result, host seconds, counts)."""
    import torch

    _zero_counts(results)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, _counts(results)


def check_decoding(card: str, results, params, dims, audio, x5) -> None:
    """The decoding options on the 301.574 s file (12 chunks, one bucket of
    16, 128 tokens) at whisper-base: (a) the timestamp grammar at x5 and x7
    (B8), every row checked, two runs equal; (b) scores at T = 0, tokens
    bitwise the greedy main path's; (c) the fallback ladder 0-1.0 with every
    gate failing, so every chunk walks every rung (64 tokens a chunk), run
    twice with one seed and once with another; (d) beam search, K = 4 at x5 (B4 at 64 rows) and
    x4 (B6), and K = 1 against greedy decoding on the step beam search
    takes; ``x5``: (e2e, Timing, tokens, counts) of the main path's run.
    Each result on a ``[decoding]`` line."""
    import numpy as np
    import torch

    from whisper_tpu_torch.frontend import golden
    from whisper_tpu_torch.headline import make_session
    from whisper_tpu_torch.models import whisper
    from whisper_tpu_torch.pipeline.chunk import chunk_starts, mel_frame_bucket
    from whisper_tpu_torch.pipeline.fallback import (
        DEFAULT_TEMPERATURES,
        transcribe_longform_fallback,
    )
    from whisper_tpu_torch.pipeline.longform import transcribe_longform
    from whisper_tpu_torch.runtime.beam import beam_generate
    from whisper_tpu_torch.runtime.genconfig import GenerationCfg
    from whisper_tpu_torch.runtime.timestamps import TimestampCfg
    from whisper_tpu_torch.tokenizer.specials import special_tokens

    t_phase = time.perf_counter()
    n_l = dims.decoder_layers
    special = special_tokens("en", "transcribe", None)
    ts_cfg = TimestampCfg(special.no_timestamps + 1, special.eot,
                          special.no_timestamps)
    greedy = x5[2]

    def longform(session, **kw):
        tokens = []
        _, timing = transcribe_longform(session, audio, "en", "transcribe",
                                        128, token_collector=tokens, **kw)
        return tokens[0], timing

    # (a) the timestamp grammar at x5 (B3, B4) and x7 (B8, B4)
    sessions = {v: make_session("cuda", params, v) for v in ("x5", "x7")}
    for variant, session in sessions.items():
        again, _ = longform(session, timestamps=True)        # and warm-up
        (toks, timing), e2e, c = _decode_run(
            results, lambda: longform(session, timestamps=True))
        errs = {r: _grammar_errors(row, ts_cfg) for r, row in enumerate(toks)}
        errs = {r: e for r, e in errs.items() if e}
        self_step = "self_attend_step_int8" if variant == "x7" \
            else "self_attend_step"
        if toks.shape != greedy.shape or errs or not (again == toks).all():
            raise AssertionError(f"timestamps at {variant}: rows breaking "
                                 f"the grammar {errs}, two runs equal "
                                 f"{bool((again == toks).all())}")
        if not (c[self_step] > 0 and c[self_step] == c["cross_attend_step"]
                and c["fused_attention"] > 0):
            raise AssertionError(f"timestamps at {variant}: launches {c}")
        stamps = float((toks >= ts_cfg.timestamp_begin).sum(1).mean())
        print(f"[decoding] (a) timestamps, whisper-base {variant}, on {card}: "
              f"e2e {e2e:.4f} s, model {timing.model_only_s:.4f} s (greedy "
              f"x5 {x5[0]:.4f} / {x5[1].model_only_s:.4f} s); every row of "
              f"{len(toks)} keeps the grammar, {stamps:.2f} timestamps a row, "
              f"two runs equal; {c[self_step] // n_l} steps; launches {c}",
              flush=True)

    # (b) scores at T = 0: the greedy main path's tokens, bitwise
    session = sessions["x5"]
    nv = golden.num_frames(len(audio))
    mel = session.compute_mel(golden.reflect_pad(audio), nv,
                              mel_frame_bucket(nv))
    starts = [p // golden.HOP for p in chunk_starts(len(audio), 480_000,
                                                    400_000)]
    (toks, sum_lp, n_tok), secs, c = _decode_run(
        results, lambda: session.transcribe_from_mel(
            mel, starts, [special.sot, special.lang, special.task,
                          special.no_timestamps], 128, special.eot,
            with_scores=True))
    ends = [int(np.argmax(row == special.eot)) + 1
            if (row == special.eot).any() else len(row) for row in toks]
    if not ((toks == greedy).all() and np.isfinite(sum_lp).all()
            and list(n_tok) == ends):
        raise AssertionError(f"scores at T = 0: tokens equal the greedy "
                             f"run's {bool((toks == greedy).all())}, sum_lp "
                             f"{sum_lp}, n_tok {n_tok.tolist()} against "
                             f"{ends}")
    print(f"[decoding] (b) scores at T = 0, whisper-base x5, on {card}: "
          f"{secs:.4f} s; tokens bitwise the greedy main path's; avg "
          f"log-probability a token {float(sum_lp.sum() / n_tok.sum()):.4f}; "
          f"n_tok {n_tok.tolist()}", flush=True)

    # (c) the fallback ladder, every gate failing: every chunk every rung,
    # 64 tokens a chunk (three ladders of six rungs: the phase's time)
    supp = list(range(1, special.eot, 97)) + list(range(special.sot + 100,
                                                         special.sot + 106))
    gen_cfg = GenerationCfg(suppress_tokens=supp,
                            begin_suppress_tokens=[220, special.eot])
    ladders = []
    for seed in (0, 0, 1):
        rungs = []
        (_, timing, info), secs, c = _decode_run(
            results, lambda: transcribe_longform_fallback(
                session, audio, "en", "transcribe", 64, gen_cfg=gen_cfg,
                logprob_threshold=float("inf"), seed=seed,
                token_collector=rungs))
        if info["accepted_at"] != [1.0] * len(starts) or [
                (t, i) for t, i, _ in rungs] != [
                (t, list(range(len(starts)))) for t in DEFAULT_TEMPERATURES]:
            raise AssertionError(f"ladder, seed {seed}: accepted at "
                                 f"{info['accepted_at']}, rungs "
                                 f"{[(t, i) for t, i, _ in rungs]}")
        drawn = np.concatenate([r[2].reshape(-1) for r in rungs])
        if np.isin(drawn, supp).any():
            raise AssertionError(f"ladder, seed {seed}: a suppressed id drawn")
        ladders.append([r[2] for r in rungs])
        print(f"[decoding] (c) fallback ladder {DEFAULT_TEMPERATURES}, seed "
              f"{seed}, whisper-base x5, on {card}: e2e {secs:.4f} s, model "
              f"{timing.model_only_s:.4f} s for {len(rungs)} rungs of "
              f"{len(starts)} chunks; every chunk accepted at 1.0; no "
              f"suppressed id among {drawn.size} tokens; B4 launches "
              f"{c['cross_attend_step']}", flush=True)
    same = all((a == b).all() for a, b in zip(*ladders[:2]))
    other = [float((a == b).mean()) for a, b in zip(ladders[0], ladders[2])]
    if not same or min(other[1:]) == 1.0:
        raise AssertionError(f"ladder: one seed twice equal {same}; another "
                             f"seed's share of equal tokens by rung {other}")
    print(f"[decoding] (c) two runs with seed 0 equal at every rung; seed 1 "
          f"against seed 0, share of equal tokens by rung: "
          + ", ".join(f"{t} {x:.4f}" for t, x in zip(DEFAULT_TEMPERATURES,
                                                     other)), flush=True)

    # (d) beam search: K = 1 against greedy on the same step, K = 4 at x5, x4
    enc, prompt = _bucket_encoder_states(session, audio)
    zero = torch.zeros(dims.vocab_size, device="cuda")
    toks1, _ = beam_generate(session._decoder_params, dims, enc, prompt[0],
                             zero, zero, 128, special.eot, 1,
                             int8_cross_kv=True, packed_cross=True,
                             int8_mxu=True)
    logits, cache = whisper.decoder_prefill(session._decoder_params, dims,
                                            prompt, enc, 132,
                                            int8_cross_kv=True)
    want = [logits[:, -1].float().argmax(-1)]
    done = want[0] == special.eot
    for i in range(1, 128):
        lg, cache = whisper.decoder_step(session._decoder_params, dims,
                                         want[-1], 3 + i, cache,
                                         cross_len=enc.shape[1],
                                         int8_mxu=True)
        want.append(torch.where(done, special.eot, lg.float().argmax(-1)))
        done = done | (want[-1] == special.eot)
    if not torch.equal(toks1, torch.stack(want, dim=1)):
        raise AssertionError("beam K = 1 differs from greedy decoding on "
                             "the same step")
    print(f"[decoding] (d) beam K = 1 equals greedy decoding on its step "
          f"(plain self-attention, B4) for the {enc.shape[0]} rows of the "
          f"bucket, on {card}", flush=True)
    del sessions, session, cache
    for variant, on, off in (("x5", "cross_attend_step",
                              "cross_attend_step_dequant"),
                             ("x4", "cross_attend_step_dequant",
                              "cross_attend_step")):
        session = make_session("cuda", params, variant)
        again, _ = longform(session, num_beams=4)             # and warm-up
        (toks, timing), e2e, c = _decode_run(
            results, lambda: longform(session, num_beams=4))
        steps = c[on] // n_l
        if not (toks.shape == greedy.shape and (again == toks).all()
                and c[on] == steps * n_l > 0 and c[off] == 0
                and c["self_attend_step"] == 0):
            raise AssertionError(f"beam K = 4 at {variant}: two runs equal "
                                 f"{bool((again == toks).all())}, launches "
                                 f"{c}")
        print(f"[decoding] (d) beam K = 4, whisper-base {variant}, 64 beam "
              f"rows, on {card}: e2e {e2e:.4f} s, model "
              f"{timing.model_only_s:.4f} s, {steps} steps; tokens equal to "
              f"greedy x5's: {float((toks == greedy).mean()):.4f} of "
              f"{toks.size}; two runs equal; launches {c}", flush=True)
        del session
    print(f"[decoding] phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)


# The CLI phase's files: (name, seconds, sample rate, channels).  Sorted by
# name, the 4 s file comes first: the warm-up file and the medium run's.
CLI_FILES = (("a_4s.wav", 4.0, 16000, 1),
             ("b_29s5_44k_stereo.wav", 29.5, 44100, 2),
             ("c_76s.wav", 76.0, 16000, 1),       # 7,600 frames: one shot
             ("d_150s.wav", 150.0, 16000, 1))     # streamed slabs
CSV_HEADER = ["file", "duration_s", "end_to_end_s", "rtf", "text"]
DECODING_FLAGS = {"timestamps": ["--timestamps"],
                  "language-auto": ["--language", "auto"],
                  "temperatures": ["--temperatures", "0,0.2,0.4"],
                  "beams": ["--num-beams", "4"]}
SUMMARY_KEYS = {"config_used", "n_files", "latency_end_to_end_s",
                "breakdown_s", "rtf_end_to_end", "model_id", "onnx_dir",
                "language", "task", "max_new_tokens", "tokenizer_json",
                "timestamps", "notes"}


def _write_wav(path: str, seconds: float, sr: int, channels: int) -> None:
    """16-bit PCM WAV of the headline's synthetic signal (the second
    channel at 0.8 of the first)."""
    import struct

    import numpy as np

    from whisper_tpu_torch.headline import synth_audio

    x = synth_audio(seconds, sr=sr)
    x = np.stack([x, 0.8 * x][:channels], axis=1).reshape(-1)
    pcm = np.clip(x * 32768.0, -32768, 32767).astype("<i2").tobytes()
    hdr = struct.pack("<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + len(pcm), b"WAVE",
                      b"fmt ", 16, 1, channels, sr, sr * channels * 2,
                      channels * 2, 16, b"data", len(pcm))
    with open(path, "wb") as f:
        f.write(hdr + pcm)


def _one_shot_mels(durations, warmup: int) -> int:
    """B5 launches of one CLI run: one per one-shot mel, that is per warmed
    shape (``warm_buckets``) of a one-shot file, per warm-up run of the
    first file and per one-shot file (at most 7,680 frames)."""
    from whisper_tpu_torch.frontend.golden import num_frames
    from whisper_tpu_torch.pipeline.warmup import _shape_key

    def one_shot(d):
        return int(num_frames(int(round(d * 16000))) <= 7680)

    seen, warmed = set(), 0
    for d in durations:
        key = _shape_key(d, 30.0, 5.0, 16)
        if key not in seen:
            seen.add(key)
            warmed += one_shot(d)
    return warmed + warmup * one_shot(durations[0]) + sum(map(one_shot,
                                                               durations))


def run_cli(label: str, card: str, results, audio_dir: str, out_dir: str,
            args, mel_seconds=None) -> dict:
    """One in-process run of the benchmark CLI with every kernel count set
    to 0 just before it; checks its outputs and returns the counts.
    mel_seconds: the durations the front end sees, where they are not the
    files' (``--vad-filter``)."""
    import csv
    import math

    import torch

    from whisper_tpu_torch.bench.cli import main as cli_main

    out = os.path.join(out_dir, label)
    _zero_counts(results)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rc = cli_main(["--audio-dir", audio_dir, "--onnx-dir",
                   os.path.join(out_dir, "no-model"), "--allow-random-init",
                   "--warmup", "1", "--out-csv", f"{out}/c.csv", "--out-json",
                   f"{out}/j.json", "--out-summary-json", f"{out}/s.json",
                   *args])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts(results)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n = len(os.listdir(audio_dir))
    with open(f"{out}/c.csv") as f:
        table = list(csv.reader(f))
    rows = json.load(open(f"{out}/j.json"))
    summary = json.load(open(f"{out}/s.json"))
    want = [(name, secs) for name, secs, _, _ in CLI_FILES][:n]
    if rc != 0 or table[0] != CSV_HEADER or len(table) != n + 1:
        raise AssertionError(f"{label}: rc {rc}, CSV {table[:1]} with "
                             f"{len(table) - 1} rows, expected {n}")
    if set(summary) != SUMMARY_KEYS or summary["n_files"] != n:
        raise AssertionError(f"{label}: summary keys {sorted(summary)}")
    got = [(r["file"], r["duration_s"]) for r in rows]
    if [(f, round(d, 2)) for f, d in got] != want:
        raise AssertionError(f"{label}: rows {got}, expected {want}")
    e2e = [r["end_to_end_s"] for r in rows]
    if not all(math.isfinite(x) and x > 0 for x in e2e):
        raise AssertionError(f"{label}: per-file e2e {e2e}")
    mels = _one_shot_mels(mel_seconds or [secs for _, secs in want],
                          warmup=1)
    if counts["log_mel"] != mels:
        raise AssertionError(f"{label}: B5 launched {counts['log_mel']} "
                             f"times, expected {mels} (one per one-shot "
                             "mel)")
    p95 = summary["latency_end_to_end_s"]["p95"]
    print(f"[cli] {label} on {card}: per-file e2e "
          + ", ".join(f"{f} {x:.4f} s" for (f, _), x in zip(want, e2e))
          + f"; p95 {p95:.4f} s; wall {wall:.1f} s with warm-up; peak "
          f"device memory {peak:.3f} GiB; launches {counts}", flush=True)
    return counts


def check_cli(card: str, results) -> dict:
    """The CLI at whisper-base x5, int8 and x7 over the four files, then at
    whisper-medium x5 and at whisper-base x5 with a whisper-tiny draft over
    the 4 s file; returns each run's counts."""
    with tempfile.TemporaryDirectory() as tmp:
        audio_dir = os.path.join(tmp, "audio")
        os.makedirs(audio_dir)
        for name, secs, sr, ch in CLI_FILES:
            _write_wav(os.path.join(audio_dir, name), secs, sr, ch)
        # No tokenizer.json anywhere: rows carry token ids, as in the
        # reference; HF_HOME points the hub-cache lookup into the run.
        os.environ["HF_HOME"] = os.path.join(tmp, "hf")
        base = ["--model-id", "openai/whisper-base", "--max-new-tokens",
                "128"]
        runs = {
            "whisper-base x5": run_cli("base-x5", card, results, audio_dir,
                                       tmp, base + ["--variant", "x5"]),
            "whisper-base int8": run_cli("base-int8", card, results,
                                         audio_dir, tmp,
                                         base + ["--variant", "int8"]),
            "whisper-base x7": run_cli("base-x7", card, results, audio_dir,
                                       tmp, base + ["--variant", "x7"]),
        }
        # the decoding flags, at 32 tokens a chunk to bound the run time
        for label, flags in DECODING_FLAGS.items():
            runs[f"whisper-base x5 {label}"] = run_cli(
                f"base-x5-{label}", card, results, audio_dir, tmp,
                ["--model-id", "openai/whisper-base", "--max-new-tokens", "32",
                 "--variant", "x5", *flags])
        for name in os.listdir(audio_dir):
            if name != CLI_FILES[0][0]:
                os.remove(os.path.join(audio_dir, name))
        runs["whisper-medium x5"] = run_cli(
            "medium-x5", card, results, audio_dir, tmp,
            ["--model-id", "openai/whisper-medium", "--max-new-tokens", "16",
             "--variant", "x5"])
        runs["whisper-base x5 draft"] = run_cli(
            "base-x5-draft", card, results, audio_dir, tmp,
            base + ["--variant", "x5", "--draft-model-id",
                    "openai/whisper-tiny", "--draft-k", "4"])
    x5, x4, med = (runs["whisper-base x5"], runs["whisper-base int8"],
                   runs["whisper-medium x5"])
    for label, c, on, off in (("x5", x5, "cross_attend_step",
                               "cross_attend_step_dequant"),
                              ("int8", x4, "cross_attend_step_dequant",
                               "cross_attend_step"),
                              ("medium x5", med, "cross_attend_step",
                               "cross_attend_step_dequant")):
        if not (c[on] > 0 and c[off] == 0 and c["self_attend_step"] > 0
                and c["fused_attention"] > 0 and c["fused_encoder_mlp"] > 0):
            raise AssertionError(f"CLI {label}: launches {c}")
    x7 = runs["whisper-base x7"]
    if not (x7["self_attend_step_int8"] == x7["cross_attend_step"] > 0
            and x7["self_attend_step"] == 0
            and x7["cross_attend_step_dequant"] == 0
            and x7["fused_attention"] > 0 and x7["fused_encoder_mlp"] > 0):
        raise AssertionError(f"CLI x7: launches {x7}")
    for label in DECODING_FLAGS:
        c = runs[f"whisper-base x5 {label}"]
        step_ok = c["self_attend_step"] == 0 if label == "beams" \
            else c["self_attend_step"] == c["cross_attend_step"]
        if not (c["cross_attend_step"] > 0 and step_ok
                and c["cross_attend_step_dequant"] == 0
                and c["fused_attention"] > 0):
            raise AssertionError(f"CLI x5 {label}: launches {c}")
    dr = runs["whisper-base x5 draft"]
    if not (dr["cross_attend_multi"] > 0 and dr["cross_attend_step"] > 0
            and dr["cross_attend_multi"] % 6 == 0
            and dr["self_attend_step"] == 0 and dr["log_mel"] > 0):
        raise AssertionError(f"CLI x5 with a draft: launches {dr}")
    return runs


def _judge(session_ref, session_var, mel, prompt, ref_rows, var_rows, eot,
           name):
    """``divergence_report`` on each chunk's pair of chains (one round a
    chunk: the report's rounds suppress earlier rounds' tokens):
    (divergences, of them tie-flips, max |delta logit| over the chains, the
    largest reference margin at a divergence, the divergences that are not
    tie-flips)."""
    import torch

    from whisper_tpu_torch.pipeline.chunk import CHUNK_FRAMES
    from whisper_tpu_torch.runtime.generate import strip_generated
    from whisper_tpu_torch.variants.diagnose import divergence_report

    mel_pad = torch.nn.functional.pad(mel, (0, CHUNK_FRAMES))
    divs, d_max = [], 0.0
    for (s0, pr), ref, var in zip(prompt, ref_rows, var_rows):
        c_ref, c_var = strip_generated(ref, eot), strip_generated(var, eot)
        if c_ref == c_var:
            continue
        chunk = mel_pad[:, s0:s0 + CHUNK_FRAMES]
        diag = divergence_report(name, session_ref, session_var, chunk, chunk,
                                 pr, [c_ref], [c_var], eot_id=eot)
        divs += diag.divergences
        d_max = max(d_max, diag.max_dlogit_chain)
    flips = sum(d.tie_flip for d in divs)
    margin = max((d.x0_margin for d in divs), default=0.0)
    return len(divs), flips, d_max, margin, [d for d in divs
                                             if not d.tie_flip]


def _parse_cues(path: str) -> list:
    """(start s, end s, text) of every cue of an .srt or .vtt file."""
    import re

    stamp = r"(\d+):(\d\d):(\d\d)[,.](\d\d\d)"
    cues = []
    for line in open(path).read().splitlines():
        m = re.fullmatch(stamp + r" --> " + stamp, line)
        if m:
            g = [int(x) for x in m.groups()]
            cues.append([g[0] * 3600 + g[1] * 60 + g[2] + g[3] / 1000,
                         g[4] * 3600 + g[5] * 60 + g[6] + g[7] / 1000, ""])
        elif cues and line.strip() and not line.isdigit():
            cues[-1][2] += line
    return cues


def check_prompts_words(card: str, results, params, dims, audio,
                        judged) -> None:
    """Conditioned prompts, the sequential mode, word timings and the
    quality judge at whisper-base, each result on a ``[prompts]`` line:
    (a) the 301.574 s file's bucket of 16 decoded at x5 (B3) and x7 (B8)
    with ``[<|startofprev|>] + tail`` left-padded to 64 slots (three pad
    counts across rows), against the same rows decoded with each row's
    unpadded prompt: every first divergence judged by ``divergence_report``
    and any that is not a tie-flip fails the phase; B3 and B8 launched
    with a ``pad_count``; (b) the sequential mode at x5 and x7 on the 76 s
    file, conditioned on the previous text with an initial prompt, twice
    (equal); (c) word timings at x5, chunked and sequential: rows of the
    alignment sum to 1, words monotone within each chunk and inside the
    file, the card's words within 0.02 s of the port on the CPU for one
    chunk; (d) the judge on ``judged`` ({name: (reference tokens, variant
    tokens)} of the 301 s file's chunks: x7 against x5, speculative
    against greedy), printed, never failing; (e) the CLI over the four
    files with ``--longform-mode sequential --condition-on-prev-text``,
    ``--word-timestamps --write-srt --write-vtt`` and ``--vad-filter
    --word-timestamps``."""
    import numpy as np
    import torch

    from whisper_tpu_torch.audio.io import load_audio_16k_mono
    from whisper_tpu_torch.audio.vad import (
        VadOptions,
        collect_chunks,
        detect_speech,
    )
    from whisper_tpu_torch.frontend import golden
    from whisper_tpu_torch.headline import make_session, synth_audio
    from whisper_tpu_torch.ops import self_attention
    from whisper_tpu_torch.pipeline.chunk import (
        CHUNK_FRAMES,
        chunk_starts,
        mel_frame_bucket,
    )
    from whisper_tpu_torch.pipeline.longform import transcribe_longform
    from whisper_tpu_torch.pipeline.sequential import transcribe_sequential
    from whisper_tpu_torch.pipeline.words import align_chunk_words
    from whisper_tpu_torch.runtime.genconfig import GenerationCfg
    from whisper_tpu_torch.runtime.generate import (
        greedy_generate,
        strip_generated,
    )
    from whisper_tpu_torch.tokenizer.specials import special_tokens
    from whisper_tpu_torch.variants.diagnose import KERNEL_EPS

    t_phase = time.perf_counter()
    n_e = dims.encoder_layers
    special = special_tokens("en", "transcribe", None)
    eot = special.eot
    base = [special.sot, special.lang, special.task, special.no_timestamps]
    gen_cfg = GenerationCfg()
    rng = np.random.default_rng(13)
    prev = [special.sot_prev] + rng.integers(220, 50000, 63).tolist()
    prompt = prev + base                                      # 68 slots
    sessions = {v: make_session("cuda", params, v) for v in ("x5", "x7")}

    # (a) padded against unpadded, through B3 (x5) and B8 (x7)
    starts = [p // golden.HOP for p in chunk_starts(len(audio), 480_000,
                                                    400_000)]
    n = len(starts)
    for variant, session in sessions.items():
        enc, _ = _bucket_encoder_states(session, audio)
        b = enc.shape[0]
        pads = [(5, 21, 40)[r % 3] for r in range(b)]
        masks = session._get_masks(gen_cfg.suppress_tokens,
                                   gen_cfg.begin_suppress_tokens)
        x7 = variant == "x7"

        def decode(rows, row_prompt, pad_count=None):
            return greedy_generate(
                session._decoder_params, dims, enc[rows],
                torch.tensor(row_prompt, device=enc.device), *masks, 128, eot,
                int8_cross_kv=True, kernel_step=True, int8_mxu=True,
                int8_self=x7, pad_count=pad_count).cpu().numpy()

        self_attention.padded_launches = 0
        self_attention.int8_padded_launches = 0
        (padded, secs, c) = _decode_run(results, lambda: decode(
            list(range(b)), prompt,
            torch.tensor(pads, dtype=torch.int32, device=enc.device)))
        launched = (self_attention.int8_padded_launches if x7
                    else self_attention.padded_launches)
        kernel = "self_attend_step_int8" if x7 else "self_attend_step"
        if not 0 < launched == c[kernel]:
            raise AssertionError(f"(a) {variant}: {launched} launches with a "
                                 f"pad_count of {c[kernel]}")
        unpadded = np.empty_like(padded)
        for pad in sorted(set(pads)):
            rows = [r for r in range(b) if pads[r] == pad]
            unpadded[rows] = decode(rows, prompt[pad:])
        nv = golden.num_frames(len(audio))
        mel = session.compute_mel(golden.reflect_pad(audio), nv,
                                  mel_frame_bucket(nv))
        same = float((padded[:n] == unpadded[:n]).mean())
        n_div, flips, d_max, _, drift = _judge(
            session, session, mel, [(s, prompt[pads[r]:])
                                    for r, s in enumerate(starts)],
            unpadded[:n], padded[:n], eot, f"padded {variant}")
        print(f"[prompts] (a) whisper-base {variant}, {b} rows, prompt of "
              f"{len(prompt)} slots left-padded by {sorted(set(pads))}, on "
              f"{card}: {secs:.4f} s padded; tokens equal to the unpadded "
              f"prompts': {same:.4f} of {padded[:n].size}; {n_div} first "
              f"divergences, {flips} tie-flips (max |dlogit| {d_max:.4f}); "
              f"{'B8' if x7 else 'B3'} launched {launched} times with a "
              f"pad_count", flush=True)
        if drift:
            raise AssertionError(f"(a) {variant}: divergences that are not "
                                 f"tie-flips: {drift}")

    # (b) the sequential mode, conditioned, with an initial prompt
    audio76 = synth_audio(76.0)
    init_ids = rng.integers(220, 50000, 12).tolist()
    seq = {}
    for variant, session in sessions.items():
        runs = []
        for _ in range(2):
            self_attention.padded_launches = 0
            self_attention.int8_padded_launches = 0
            (text, segs, timing), e2e, c = _decode_run(
                results, lambda: transcribe_sequential(
                    session, audio76, "en", "transcribe", 128,
                    condition_on_prev_text=True,
                    initial_prompt_ids=init_ids))
            padded_launches = (self_attention.int8_padded_launches
                               if variant == "x7"
                               else self_attention.padded_launches)
            runs.append(([s.tokens for s in segs], segs, e2e, timing, c,
                         padded_launches))
        toks, segs, e2e, timing, c, padded_launches = runs[1]
        windows = c["fused_attention"] // n_e
        starts_s = [s.start_s for s in segs]
        past = sum(s.end_s > 76.0 for s in segs)
        # Segments start in order, inside the windows the seek loop
        # opened (each starts before 76 s): the grammar has no rule on the
        # audio's end, so with random weights a closed segment of the last
        # window can end, or start, past the file, in the JAX package alike.
        ok = (runs[0][0] == toks and segs and windows < 1000
              and starts_s == sorted(starts_s) and starts_s[0] >= 0.0
              and starts_s[-1] < 76.0 + 30.0 and padded_launches > 0)
        print(f"[prompts] (b) sequential, whisper-base {variant}, 76 s, "
              f"conditioned on the previous text with a 12-token initial "
              f"prompt, on {card}: {windows} windows, {len(segs)} segments "
              f"({past} ending past the file), e2e {e2e:.4f} s, model "
              f"{timing.model_only_s:.4f} s; two runs equal "
              f"{runs[0][0] == toks}; {padded_launches} launches with a "
              f"pad_count; launches {c}", flush=True)
        if not ok:
            raise AssertionError(f"(b) {variant}: segments "
                                 f"{[(s.start_s, s.end_s) for s in segs]}")
        seq[variant] = (segs, timing)

    # (c) word timings at x5, chunked and sequential
    session = sessions["x5"]
    nv = golden.num_frames(len(audio76))
    mel = session.compute_mel(golden.reflect_pad(audio76), nv,
                              mel_frame_bucket(nv))
    mel_pad = torch.nn.functional.pad(mel, (0, CHUNK_FRAMES))
    tokens, words = [], []
    _, timing = transcribe_longform(session, audio76, "en", "transcribe", 128,
                                    token_collector=tokens,
                                    word_collector=words)
    starts76 = [p // golden.HOP for p in chunk_starts(len(audio76), 480_000,
                                                      400_000)]
    def word_err(got, want):
        """The largest start or end difference of two equal word lists."""
        if [x.word for x in got] != [x.word for x in want]:
            raise AssertionError("(c) the card's words are not the CPU's")
        return max((max(abs(a.start_s - b.start_s), abs(a.end_s - b.end_s))
                    for a, b in zip(got, want)), default=0.0)

    per_chunk = []
    for i, row in enumerate(tokens[0]):
        gen = [t for t in strip_generated(row, eot)
               if t <= special.no_timestamps]
        chunk = mel_pad[:, starts76[i]:starts76[i] + CHUNK_FRAMES]
        kw = dict(offset_s=starts76[i] * 0.01,
                  audio_len_s=min(30.0, (nv - starts76[i]) * 0.01))
        per_chunk.append(align_chunk_words(session, chunk, base, gen, **kw))
        if i == 0:
            gen0, chunk0, kw0 = gen, chunk, kw
    w = session.alignment_weights(chunk0, base, gen0)
    row_err = float(np.abs(w.sum(-1) - 1.0).max())
    # The card against the port on the CPU, chunk 0's tokens teacher-forced:
    # at x5 (bf16: the encoders agree within a few bf16 steps, and on random
    # weights the attention over 1,500 frames is nearly flat, so DTW's path
    # may move with them) as information, and held at x0 (fp32).
    cpu = make_session("cpu", params, "x5")
    w_err = float(np.abs(w - cpu.alignment_weights(chunk0.cpu(), base,
                                                   gen0)).max())
    x5_err = word_err(per_chunk[0], align_chunk_words(cpu, chunk0.cpu(), base,
                                                      gen0, **kw0))
    card0 = make_session("cuda", params, "x0")
    cpu0 = make_session("cpu", params, "x0")
    cpu_err = word_err(
        align_chunk_words(card0, chunk0, base, gen0, **kw0),
        align_chunk_words(cpu0, chunk0.cpu(), base, gen0, **kw0))
    del cpu, card0, cpu0
    flat = [x.to_dict() for c_ in per_chunk for x in c_]
    monotone = all(a.start_s <= b.start_s and a.start_s <= a.end_s
                   for c_ in per_chunk for a, b in zip(c_, c_[1:] + c_[-1:]))
    inside = all(0.0 <= x.start_s <= x.end_s <= 76.0 + 1e-6
                 for c_ in per_chunk for x in c_)
    seq_words, marks = [], []
    transcribe_sequential(session, audio76, "en", "transcribe", 128,
                          word_collector=seq_words,
                          segment_callback=lambda _: marks.append(
                              len(seq_words)))
    windows = [seq_words[a:b] for a, b in zip([0] + marks, marks)]
    seq_ok = all(0.0 <= x["start"] <= x["end"] <= 76.0 + 1e-6
                 for x in seq_words) and all(
        a["start"] <= b["start"] for w_ in windows for a, b in zip(w_,
                                                                 w_[1:]))
    print(f"[prompts] (c) word timings, whisper-base x5, 76 s, on {card}: "
          f"chunked {len(words)} words in {len(per_chunk)} chunks "
          f"(transcribe_longform's list equal to the chunks' {flat == words}), "
          f"rows of the alignment within {row_err:.2e} of 1, monotone within "
          f"each chunk {monotone}, inside the file {inside}; chunk 0 against "
          f"the CPU: "
          f"x0 (fp32) words within {cpu_err:.4f} s, x5 alignment weights "
          f"within {w_err:.3g} and words within {x5_err:.4f} s; sequential "
          f"{len(seq_words)} words in {len(windows)} windows, monotone and "
          f"inside {seq_ok}; chunked e2e {timing.end_to_end_s:.4f} s "
          f"(alignment in decode_s {timing.decode_s:.4f} s)", flush=True)
    if not (row_err <= 1e-3 and monotone and inside and seq_ok
            and flat == words and words and cpu_err <= 0.02):
        raise AssertionError("(c) word timings fail their checks")

    # (d) the judge on the open items of ROADMAP queue 3
    del sessions
    nv = golden.num_frames(len(audio))
    for name, (ref, var) in judged.items():
        variant = "x4" if "x4" in name else "x5"
        s_ref = make_session("cuda", params, variant)
        s_var = make_session("cuda", params, "x7") if "x7" in name else s_ref
        mel = s_ref.compute_mel(golden.reflect_pad(audio), nv,
                                mel_frame_bucket(nv))
        n_div, flips, d_max, margin, drift = _judge(
            s_ref, s_var, mel, [(s, base) for s in starts], ref, var, eot,
            name)
        print(f"[prompts] (d) judge, {name}, whisper-base, 301.574 s, on "
              f"{card}: tokens equal {float((ref == var).mean()):.4f} of "
              f"{ref.size}; {n_div} chunks diverge, {flips} tie-flips "
              f"(largest reference margin at a divergence {margin:.4f}, "
              f"KERNEL_EPS {KERNEL_EPS}); max_dlogit_chain {d_max:.4f}; not "
              "tie-flips: "
              + ("; ".join(f"step {d.step}: {d.x0_token} -> {d.var_token}, "
                           f"margin {d.x0_margin:.4f}, variant margin "
                           f"{d.var_margin:.4f}" for d in drift) or "none"),
              flush=True)
        del s_ref, s_var

    # (e) the CLI with each new flag over the four files
    with tempfile.TemporaryDirectory() as tmp:
        audio_dir = os.path.join(tmp, "audio")
        os.makedirs(audio_dir)
        for name, secs, sr, ch in CLI_FILES:
            _write_wav(os.path.join(audio_dir, name), secs, sr, ch)
        os.environ["HF_HOME"] = os.path.join(tmp, "hf")
        condensed = [len(collect_chunks(a, detect_speech(a, VadOptions()))[0])
                     / 16000.0 for a in (
            load_audio_16k_mono(os.path.join(audio_dir, f))[0]
            for f, _, _, _ in CLI_FILES)]
        base_args = ["--model-id", "openai/whisper-base", "--max-new-tokens",
                     "32", "--variant", "x5"]
        for label, flags in (
                ("sequential", ["--longform-mode", "sequential",
                                "--condition-on-prev-text"]),
                ("words", ["--word-timestamps", "--write-srt",
                           "--write-vtt"]),
                ("vad", ["--vad-filter", "--word-timestamps"])):
            self_attention.padded_launches = 0
            c = run_cli(f"base-x5-{label}", card, results, audio_dir, tmp,
                        base_args + flags,
                        mel_seconds=condensed if label == "vad" else None)
            out = os.path.join(tmp, f"base-x5-{label}")
            rows = json.load(open(f"{out}/j.json"))
            if label == "sequential":
                ok = self_attention.padded_launches > 0
                note = (f"{self_attention.padded_launches} B3 launches with "
                        "a pad_count")
            else:
                ok = all(isinstance(r.get("words"), list) for r in rows) \
                    and any(r["words"] for r in rows)
                note = f"{sum(len(r['words']) for r in rows)} words"
            if label == "words":
                # Cues follow the words, chunk after chunk: in order within
                # a chunk, and at most one step back where the next chunk's
                # 5 s overlap begins (the JAX CLI's cues alike).
                backs = []
                for name, secs, _, _ in CLI_FILES:
                    stem = os.path.splitext(name)[0]
                    srt, vtt = (_parse_cues(f"{out}/{stem}.{ext}")
                                for ext in ("srt", "vtt"))
                    n_chunks = len(chunk_starts(int(secs * 16000), 480_000,
                                                400_000))
                    back = sum(b[0] < a[0] for a, b in zip(srt, srt[1:]))
                    backs.append(back)
                    ok = ok and bool(srt) and srt == vtt \
                        and back < n_chunks and all(
                            0.0 <= c[0] and c[1] <= secs + 0.5 for c in srt)
                note += (f"; every .srt and .vtt parses (equal cues), in "
                         f"order within each chunk (steps back at chunk "
                         f"overlaps by file: {backs})")
            print(f"[prompts] (e) CLI {label}: {note}; launches {c}",
                  flush=True)
            if not ok or c["self_attend_step"] == 0:
                raise AssertionError(f"(e) CLI {label}: {note}, launches "
                                     f"{c}")
    print(f"[prompts] phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def _engine_tokens(text: str) -> list:
    """The generated ids of a tokenizer-less engine text ("[TOKENS:a b]")."""
    if not text:
        return []
    if not (text.startswith("[TOKENS:") and text.endswith("]")):
        raise AssertionError(f"not a tokenizer-less engine text: {text!r}")
    return [int(t) for t in text[len("[TOKENS:"):-1].split()]


def _serve_clips(n: int, seed: int, lo: float = 1.0, hi: float = 30.0):
    """n synthetic clips of lo..hi seconds (a tone and noise each)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    secs = rng.uniform(lo, hi, n)
    secs[0], secs[-1] = lo, hi        # both ends of the range
    out = []
    for i, s in enumerate(secs):
        t = np.arange(int(s * 16000)) / 16000.0
        out.append((0.1 * np.sin(2 * np.pi * (150 + 23 * i) * t)
                    + 0.03 * rng.standard_normal(len(t))).astype(np.float32))
    return out


def _one_row(clip):
    """A clip as the engine ships it alone: (its reflect-padded row in the
    full 30 s window [1, 480,400], its valid frames [1])."""
    import numpy as np

    from whisper_tpu_torch.frontend import golden

    pad = golden.reflect_pad(clip)
    row = np.zeros((1, 480_000 + 400), dtype=np.float32)
    row[0, :len(pad)] = pad
    return row, np.array([golden.num_frames(len(clip))], np.int32)


def _judge_rows(session, clips, prompt, eot, got_rows, want_rows,
                label: str) -> str:
    """Rows of two runs of the same clips: equal, or each first divergence
    judged by ``_judge`` on the clip's own short-path mel (both chains
    teacher-forced through ``session``); one that is not a tie-flip fails.
    Returns a summary."""
    import numpy as np

    n_div = flips = 0
    for clip, got, want in zip(clips, got_rows, want_rows):
        if got == want:
            continue
        mel = session._short_mel(*_one_row(clip))[0]
        d, f, _, _, bad = _judge(session, session, mel, [(0, prompt)],
                                 [np.array(want)], [np.array(got)], eot,
                                 label)
        if bad:
            raise AssertionError(f"{label}: a divergence that is not a "
                                 f"tie-flip: {bad}")
        n_div, flips = n_div + d, flips + f
    same = sum(g == w for g, w in zip(got_rows, want_rows))
    return (f"{same} of {len(got_rows)} rows equal, {n_div} divergences, "
            f"{flips} tie-flips")


def _latencies(engine, clips):
    """Submit every clip at once; (texts, seconds from the submit to each
    future's end).  A future holding an exception raises here."""
    t0 = time.perf_counter()
    done = {}
    futs = []
    for i, c in enumerate(clips):
        f = engine.submit(c)
        f.add_done_callback(lambda _, i=i: done.__setitem__(
            i, time.perf_counter()))
        futs.append(f)
    texts = [f.result(timeout=600) for f in futs]
    return texts, [done[i] - t0 for i in range(len(clips))]


def _pct(lat, q: float) -> float:
    """serve_bench's nearest-rank percentile of a list of latencies."""
    from whisper_tpu_torch.serve.serve_bench import percentile

    return percentile(sorted(lat), q)


def check_serve(card: str, results, params, dims) -> None:
    """The serving path at whisper-base (``[serve]`` lines): the engine's
    short lane at x4 (the server's default) and x5, its long lane, the TCP
    server and the router, the OpenAI HTTP API, the speculative leg and
    the load of 64 streams, then the card test of two threads launching B3
    and B8 at once in a fresh process.  Every future's result is read (an
    exception fails the phase); each lane's kernels must have launched."""
    import asyncio
    import base64
    import socket
    import subprocess
    import threading
    import urllib.request

    import numpy as np

    from whisper_tpu_torch.headline import make_session, synth_audio
    from whisper_tpu_torch.pipeline.longform import transcribe_longform
    from whisper_tpu_torch.runtime.genconfig import GenerationCfg
    from whisper_tpu_torch.runtime.generate import strip_generated
    from whisper_tpu_torch.serve import serve_bench
    from whisper_tpu_torch.serve.engine import EngineConfig, StreamingEngine
    from whisper_tpu_torch.serve.http_server import (
        TranscriptionService,
        make_server,
    )
    from whisper_tpu_torch.serve.router import serve_router
    from whisper_tpu_torch.serve.server import serve
    from whisper_tpu_torch.tokenizer.specials import special_tokens
    from whisper_tpu_torch.variants.quant import quantize_params

    t_phase = time.perf_counter()
    special = special_tokens("en", "transcribe", None)
    prompt = [special.sot, special.lang, special.task, special.no_timestamps]
    eot = special.eot
    gen = GenerationCfg()
    clips = _serve_clips(16, seed=14)

    def alone(session, clip):
        """The clip by itself through the session's short path (bucket 1,
        the full window)."""
        toks = session.transcribe_short_batch(
            *_one_row(clip), prompt, 128, eot,
            suppress_ids=gen.suppress_tokens,
            begin_suppress_ids=gen.begin_suppress_tokens)
        return strip_generated(toks[0], eot)

    # (a) the short lane: a burst of 16 clips against each clip alone
    engines, burst = {}, {}
    for rung, cross in (("x4", "cross_attend_step_dequant"),
                        ("x5", "cross_attend_step")):
        session = make_session("cuda", params, rung)
        eng = StreamingEngine(session, cfg=EngineConfig(
            max_new_tokens=128, batch_window_ms=20))
        engines[rung] = eng
        eng.warmup(batch=16)
        ticks = eng.stats["batches"]
        _zero_counts(results)
        t0 = time.perf_counter()
        texts, lat = _latencies(eng, clips)
        wall = time.perf_counter() - t0
        c = _counts(results)
        ticks = eng.stats["batches"] - ticks
        rows = [_engine_tokens(t) for t in texts]
        burst[rung] = rows
        need = ("fused_attention", "fused_encoder_mlp", "self_attend_step",
                cross)
        if any(c[n] == 0 for n in need) or c["log_mel"]:
            raise AssertionError(f"(a) {rung} short lane: launches {c}")
        verdict = _judge_rows(session, clips, prompt, eot,
                              rows, [alone(session, a) for a in clips],
                              f"(a) {rung} batched against alone")
        # trimmed against full-width uploads: four clips under 1/8 window
        short = _serve_clips(4, seed=15, lo=1.0, hi=3.5)
        trimmed = [f.result(timeout=600) for f in
                   [eng.submit(a) for a in short]]
        eng.cfg.trim_upload = False
        widths = [f.result(timeout=600) for f in
                  [eng.submit(a) for a in short]]
        eng.cfg.trim_upload = True
        if trimmed != widths:
            raise AssertionError(f"(a) {rung}: trimmed uploads give other "
                                 "tokens than full-width ones")
        print(f"[serve] (a) short lane {rung}, 16 clips of 1-30 s, on {card}:"
              f" {ticks} tick(s), wall {wall:.4f} s, "
              f"latency p50 {_pct(lat, 0.5):.4f} s p95 "
              f"{_pct(lat, 0.95):.4f} s; "
              f"{verdict} against each clip alone at bucket 1; trimmed "
              f"uploads equal full-width ones (4 clips of 1-3.5 s); "
              f"launches {c}", flush=True)
    x4 = engines["x4"]

    # (b) the long lane: a 76 s file while 16 short clips are in flight
    long_audio = synth_audio(76.0)
    _, lat_alone = _latencies(x4, clips)
    done = {}
    t0 = time.perf_counter()
    shorts = []
    for i, c in enumerate(clips):
        f = x4.submit(c)
        f.add_done_callback(lambda _, i=i: done.__setitem__(
            i, time.perf_counter()))
        shorts.append(f)
    # Past the coalescing window, the tick of 16 decodes (~1 s on the card)
    # when the long request arrives on its own lane.
    time.sleep(0.3)
    n_long = x4.stats["longform"]
    _zero_counts(results)
    long_fut = x4.submit(long_audio)
    long_fut.add_done_callback(lambda _: done.__setitem__(
        "long", time.perf_counter()))
    for f in shorts:
        f.result(timeout=600)
    long_text = long_fut.result(timeout=600)
    c = _counts(results)
    if c["log_mel"] != 1 or c["cross_attend_step_dequant"] == 0:
        raise AssertionError(f"(b) lanes: launches {c}")
    if max(done[i] for i in range(16)) > done["long"]:
        raise AssertionError("(b) the long request resolved before the "
                             "short ones")
    want, _ = transcribe_longform(x4.session, long_audio, "en", "transcribe",
                                  128, 30.0, 5.0, None, False, gen)
    if long_text != want or x4.stats["longform"] != n_long + 1:
        raise AssertionError("(b) the long lane's text is not the long-form "
                             "text of the file alone")
    lat_long = [done[i] - t0 for i in range(16)]
    print(f"[serve] (b) long lane x4, 76 s beside 16 short clips, on {card}: "
          f"shorts done {max(lat_long):.4f} s, the long request "
          f"{done['long'] - t0:.4f} s after the burst; its text equals "
          f"transcribe_longform alone; short-lane p95 "
          f"{_pct(lat_long, 0.95):.4f} s with the long request, "
          f"{_pct(lat_alone, 0.95):.4f} s without; launches "
          f"of both lanes {c} (B5 once: the long file's one-shot mel)",
          flush=True)

    # (c) the TCP server, then the router in front of it
    def run_loop(coro_fn):
        ready, holder = threading.Event(), {}

        def target():
            async def main_():
                class Ev:
                    def set(self):
                        ready.set()

                holder["loop"] = asyncio.get_running_loop()
                holder["task"] = asyncio.current_task()
                try:
                    await coro_fn(Ev())
                except asyncio.CancelledError:
                    pass

            asyncio.run(main_())

        th = threading.Thread(target=target, daemon=True)
        th.start()
        if not ready.wait(30):
            raise AssertionError("(c) a server did not start")

        def stop():
            holder["loop"].call_soon_threadsafe(holder["task"].cancel)
            th.join(timeout=30)

        return stop

    def free_port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    def ask(port, payload):
        with socket.create_connection(("127.0.0.1", port), timeout=300) as s:
            s.settimeout(300)
            s.sendall((json.dumps(payload) + "\n").encode())
            buf = b""
            while not buf.endswith(b"\n"):
                chunk = s.recv(1 << 20)
                if not chunk:
                    break
                buf += chunk
        return json.loads(buf)

    pcm = [(np.clip(a, -1, 1) * 32767).astype("<i2") for a in clips]
    reqs = [{"id": f"r{i}", "pcm16_b64": base64.b64encode(p.tobytes())
             .decode()} for i, p in enumerate(pcm)]

    def four_clients(port):
        out, errors = {}, []

        def client(k):
            try:
                for r in reqs[4 * k:4 * k + 4]:
                    out[r["id"]] = ask(port, r)
            except Exception as e:  # noqa: BLE001 (reported below)
                errors.append(repr(e))

        ths = [threading.Thread(target=client, args=(k,)) for k in range(4)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(timeout=600)
        if errors or len(out) != 16:
            raise AssertionError(f"(c) clients: {errors or sorted(out)}")
        for r in reqs:
            resp = out[r["id"]]
            if "error" in resp or set(resp) != {"id", "text", "latency_s"}:
                raise AssertionError(f"(c) response {resp}")
        return [_engine_tokens(out[r["id"]]["text"]) for r in reqs]

    port = free_port()
    stop_server = run_loop(lambda ev: serve(x4, "127.0.0.1", port, ev))
    try:
        t0 = time.perf_counter()
        direct = four_clients(port)
        t_direct = time.perf_counter() - t0
        stats = ask(port, {"id": "s", "stats": True})
        if set(stats["stats"]) < {"batches", "batched_requests", "longform"}:
            raise AssertionError(f"(c) stats {stats}")
        rport = free_port()
        stop_router = run_loop(lambda ev: serve_router(
            [("127.0.0.1", port)], "127.0.0.1", rport, ev))
        try:
            t0 = time.perf_counter()
            routed = four_clients(rport)
            t_routed = time.perf_counter() - t0
            merged = ask(rport, {"id": "m", "stats": True})["stats"]
        finally:
            stop_router()
    finally:
        stop_server()
    decoded = [p.astype(np.float32) / 32768.0 for p in pcm]
    verdict = _judge_rows(x4.session, decoded, prompt, eot, routed, direct,
                          "(c) router against server")
    print(f"[serve] (c) TCP x4, 4 clients x 4 requests, on {card}: "
          f"{t_direct:.4f} s through the server, {t_routed:.4f} s through "
          f"the router; router answers against the server's: {verdict}; "
          f"stats {stats['stats']}; router's merged backends "
          f"{len(merged['backends'])}", flush=True)

    # (d) the OpenAI HTTP API
    service = TranscriptionService(x4, "openai/whisper-base")
    httpd = make_server(service, "127.0.0.1", 0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        def wav(audio):
            import struct

            data = (np.clip(audio, -1, 1) * 32767).astype("<i2").tobytes()
            return struct.pack(
                "<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + len(data), b"WAVE",
                b"fmt ", 16, 1, 1, 16000, 32000, 2, 16, b"data",
                len(data)) + data

        def post(fields, audio):
            b = "servephaseboundary"
            parts = [(f"--{b}\r\nContent-Disposition: form-data; name="
                      f"\"{k}\"\r\n\r\n{v}\r\n").encode()
                     for k, vs in fields.items()
                     for v in (vs if isinstance(vs, list) else [vs])]
            parts.append((f"--{b}\r\nContent-Disposition: form-data; name="
                          "\"file\"; filename=\"a.wav\"\r\n\r\n").encode()
                         + wav(audio) + b"\r\n" + f"--{b}--\r\n".encode())
            req = urllib.request.Request(
                url + "/v1/audio/transcriptions", data=b"".join(parts),
                headers={"Content-Type": f"multipart/form-data; boundary={b}"},
                method="POST")
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=600) as r:
                body = r.read().decode()
                return (r.status, r.headers["Content-Type"], body,
                        time.perf_counter() - t0)

        def get(path):
            with urllib.request.urlopen(url + path, timeout=60) as r:
                return json.loads(r.read())

        if get("/healthz") != {"status": "ok"}:
            raise AssertionError("(d) /healthz")
        models = get("/v1/models")
        if models["data"][0]["id"] != "openai/whisper-base":
            raise AssertionError(f"(d) /v1/models {models}")
        clip = clips[3]
        took = {}
        _zero_counts(results)
        st, ct, body, took["json"] = post({"response_format": "json"}, clip)
        if st != 200 or set(json.loads(body)) != {"text"}:
            raise AssertionError(f"(d) json: {st} {body[:200]}")
        st, ct, body, took["srt"] = post({"response_format": "srt"}, clip)
        if st != 200 or "-->" not in body or not ct.startswith("text/plain"):
            raise AssertionError(f"(d) srt: {st} {body[:200]}")
        st, ct, body, took["verbose_json"] = post(
            {"response_format": "verbose_json",
             "timestamp_granularities[]": ["word", "segment"]}, clip)
        out = json.loads(body)
        if st != 200 or set(out) != {"task", "language", "duration", "text",
                                     "segments", "words"} \
                or not out["words"] or not out["segments"]:
            raise AssertionError(f"(d) verbose_json: {st} {body[:300]}")
        st, ct, body, took["sse"] = post({"stream": "true"}, clip)
        events = [json.loads(line[6:]) for line in body.splitlines()
                  if line.startswith("data: ")]
        if st != 200 or not ct.startswith("text/event-stream") or not events \
                or events[-1]["type"] != "transcript.text.done":
            raise AssertionError(f"(d) sse: {st} {body[:300]}")
        c = _counts(results)
        if c["fused_attention"] == 0 or c["self_attend_step"] == 0:
            raise AssertionError(f"(d) HTTP lanes: launches {c}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=30)
    print(f"[serve] (d) HTTP x4, a {len(clip) / 16000:.2f} s upload, on "
          f"{card}: json (short lane) {took['json']:.4f} s, srt "
          f"{took['srt']:.4f} s, verbose_json with {len(out['words'])} words "
          f"{took['verbose_json']:.4f} s (direct lane), SSE "
          f"{len(events)} events {took['sse']:.4f} s; /healthz, /v1/models; "
          f"launches {c}", flush=True)

    # (e) the speculative leg: whisper-base's own int8 weights as draft
    spec_session = make_session("cuda", params, "x5")
    spec_session.set_draft_model(quantize_params(params), dims,
                                 share_encoder=True)
    spec = StreamingEngine(spec_session, cfg=EngineConfig(
        max_new_tokens=128, batch_window_ms=20))
    try:
        _zero_counts(results)
        t0 = time.perf_counter()
        texts, _ = _latencies(spec, clips)
        wall = time.perf_counter() - t0
        c = _counts(results)
        if c["cross_attend_multi"] == 0 or spec.stats["speculative"] != 16:
            raise AssertionError(f"(e) speculative leg: launches {c}, "
                                 f"stats {spec.stats}")
        verdict = _judge_rows(spec_session, clips, prompt, eot,
                              [_engine_tokens(t) for t in texts],
                              burst["x5"], "(e) speculative against greedy")
    finally:
        spec.close()
    print(f"[serve] (e) speculative leg x5, own int8 weights as draft, 16 "
          f"clips, on {card}: wall {wall:.4f} s; against the greedy x5 "
          f"burst: {verdict}; launches {c}", flush=True)

    # (f) a lone 5 s request three times, then the load: 64 streams of 30 s,
    # three repetitions
    x5 = engines["x5"]
    lone = []
    for _ in range(3):
        lone += _latencies(x5, serve_bench.make_streams(1, 5.0))[1]
    print(f"[serve] (f) a lone 5 s request, x5, on {card}: "
          f"{', '.join(f'{t:.4f}' for t in lone)} s", flush=True)
    streams = serve_bench.make_streams(64, 30.0)
    reps = serve_bench.run_bench(x5, streams, reps=3)
    for i, r in enumerate(reps):
        print(f"[serve] (f) load x5, 64 streams x 30 s, rep {i}, on {card}: "
              f"wall {r['wall_s']:.4f} s, {r['x_real_time']:.2f}x real time "
              f"aggregate, latency p50 {r['p50_s']:.4f} s p95 "
              f"{r['p95_s']:.4f} s max {r['max_s']:.4f} s, ticks so far "
              f"{r['ticks']}", flush=True)
    for eng in engines.values():
        eng.close()

    # the two-thread launch test, in a fresh process of its own
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-p",
         "no:cacheprovider", "-q", "-m", "cuda",
         "tests/test_torch_cuda.py::"
         "test_b3_b8_two_threads_raise_the_limit_at_once"],
        capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    if proc.returncode != 0 or " passed" not in proc.stdout:
        raise AssertionError(f"two-thread launch test: {proc.stdout[-2000:]}"
                             f"{proc.stderr[-2000:]}")
    print(f"[serve] two threads launching B3 and B8 across 48 KB at once: "
          f"passed ({time.perf_counter() - t0:.1f} s)", flush=True)
    print(f"[serve] phase: {time.perf_counter() - t_phase:.1f} s", flush=True)


def _pipelined_windows(session, audio, slab_chunks: int):
    """The pipelined mode's front end replayed on its own: per slab
    of ``pipelined._slab_plan`` its raw log-spec on the card, and each
    chunk's normalized window (``session.chunk_norm_window``).  Returns
    (raw slabs, [(n_valid, local starts)], windows [n_chunks] of
    [n_mels, 3000])."""
    from whisper_tpu_torch.frontend import golden
    from whisper_tpu_torch.frontend.mel import log_spec_slab
    from whisper_tpu_torch.pipeline import pipelined
    from whisper_tpu_torch.pipeline.chunk import chunk_starts

    padded = golden.reflect_pad(audio)
    total = golden.num_frames(len(audio))
    starts = [p // golden.HOP for p in chunk_starts(len(audio), 480_000,
                                                    400_000)]
    cap, plan = pipelined._slab_plan(starts, total, slab_chunks)
    slabs, geometry, windows = [], [], []
    for f0, n_valid, local in plan:
        enc = session._upload(session.encode_host_slab(
            padded, f0 * golden.HOP, (cap + 2) * golden.HOP))
        ls, _ = log_spec_slab(enc, n_valid, n_mels=session.dims.n_mels,
                              n_frames=cap)
        slabs.append(ls)
        geometry.append((n_valid, local))
        windows += [session.chunk_norm_window(ls, s, n_valid) for s in local]
    return slabs, geometry, windows


def check_pipelined(card: str, results, params, dims, audio) -> dict:
    """The pipelined long-form mode at whisper-base, 128 tokens
    (``[pipelined]`` lines): (a) the 301.574 s file at x5 through
    ``transcribe_longform_pipelined`` at ``slab_chunks`` 4 and 16, a
    warm-up and a run each, counts set to 0 just before the run and read
    just after: B1, B2, B3 and B4 launched, B5 not (the slab front end is
    the plain ``log_spec_slab``, as in JAX); the rows of slab 4 against
    slab 16's, every first divergence judged by ``divergence_report`` on the
    chunk-normalized windows (one that is not a tie-flip fails); (b)
    ``chunk_norm_window`` on the card against a numpy evaluation of the
    same raw slab copied to the host at frame 0, mid-file and n_valid - 100
    (atol 1e-6), and ``chunk_norm`` on a ragged bucket's padding rows (all
    zeros, finite); (c) speculative over pipelined, x5 with its own int8
    weights as draft: B7 launched, rows against greedy pipelined's, every
    divergence a tie-flip; (d) the converter with neither jax nor the
    ``safetensors`` package: ``save_params`` then ``load_params`` value for
    value, the CLI at x5 from that dir on the 4 s file with the in-memory
    session's text, ``quantize_model_dir`` and the CLI ``--variant int8``
    from the int8 dir with the text of a session that quantizes in memory,
    B6 launched; (e) ``bench.discover`` on 60 s of synthetic audio over x4,
    x5 and x7 with one run each, then the CLI with its JSON, the winner's
    kernels launched; (f) the CLI with ``--longform-mode pipelined`` over
    ``check_cli``'s four files at x5, plain and with ``--word-timestamps
    --language auto``, then ``results.summarize`` and
    ``results.accumulate`` over its output (one timed summary row).
    Returns the launch counts of (a) at slab 4."""
    import numpy as np
    import torch

    from whisper_tpu_torch.audio.io import load_audio_16k_mono
    from whisper_tpu_torch.bench import discover
    from whisper_tpu_torch.bench.cli import main as cli_main
    from whisper_tpu_torch.headline import make_session
    from whisper_tpu_torch.models import convert
    from whisper_tpu_torch.pipeline.chunk import CHUNK_FRAMES
    from whisper_tpu_torch.pipeline.longform import transcribe_longform
    from whisper_tpu_torch.pipeline.pipelined import (
        transcribe_longform_pipelined,
    )
    from whisper_tpu_torch.results import accumulate, summarize
    from whisper_tpu_torch.runtime.session import chunk_norm
    from whisper_tpu_torch.tokenizer.specials import special_tokens
    from whisper_tpu_torch.variants.quant import quantize_params
    from whisper_tpu_torch.variants.quantize_int8 import quantize_model_dir

    t_phase = time.perf_counter()
    special = special_tokens("en", "transcribe", None)
    prompt = [special.sot, special.lang, special.task, special.no_timestamps]
    eot = special.eot
    session = make_session("cuda", params, "x5")

    def run(slab: int, **kw):
        """A warm-up, then one run with the counts zeroed before it and
        read after: (e2e s, Timing, rows [chunks, 128] as the mode copied
        them to the host, counts)."""
        rows = []

        def gather(pieces, c, max_new, with_scores=False):
            out = type(session).gather_tokens(pieces, c, max_new,
                                              with_scores)
            rows.append(out)
            return out

        session.gather_tokens = gather
        try:
            transcribe_longform_pipelined(session, audio, "en", "transcribe",
                                          128, slab_chunks=slab, **kw)
            rows.clear()
            _zero_counts(results)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, timing = transcribe_longform_pipelined(
                session, audio, "en", "transcribe", 128, slab_chunks=slab,
                **kw)
            e2e = time.perf_counter() - t0
            c = _counts(results)
        finally:
            del session.gather_tokens
        return e2e, timing, np.concatenate(rows), c

    def judged(ref_rows, var_rows, windows, label):
        mel = torch.cat(windows, dim=1)
        n_div, flips, _, margin, bad = _judge(
            session, session, mel,
            [(i * CHUNK_FRAMES, prompt) for i in range(len(windows))],
            ref_rows, var_rows, eot, label)
        if bad:
            raise AssertionError(f"{label}: a divergence that is not a "
                                 f"tie-flip: {bad}")
        same = sum(bool((a == b).all()) for a, b in zip(ref_rows, var_rows))
        return (f"{same} of {len(ref_rows)} rows equal, {n_div} divergences, "
                f"{flips} tie-flips")

    # (a) slab 4 against slab 16
    need = ("fused_attention", "fused_encoder_mlp", "self_attend_step",
            "cross_attend_step")
    runs = {}
    for slab in (4, 16):
        runs[slab] = run(slab)
        e2e, t, rows, c = runs[slab]
        if any(c[n] == 0 for n in need) or c["log_mel"]:
            raise AssertionError(f"(a) slab {slab}: launches {c}")
        if rows.shape != (12, 128) or not (
                (rows >= 0) & (rows < dims.vocab_size)).all():
            raise AssertionError(f"(a) slab {slab}: rows {rows.shape}")
    slabs, geometry, windows16 = _pipelined_windows(session, audio, 16)
    verdict = judged(runs[16][2], runs[4][2], windows16,
                     "(a) slab 4 against slab 16")
    for slab in (4, 16):
        e2e, t, _, c = runs[slab]
        print(f"[pipelined] (a) whisper-base x5, 301.574 s, slab_chunks "
              f"{slab}, on {card}: e2e {e2e:.4f} s, preprocess "
              f"{t.preprocess_s:.4f} s, model {t.model_only_s:.4f} s, decode "
              f"{t.decode_s:.4f} s; launches {c}", flush=True)
    print(f"[pipelined] (a) slab 4 against slab 16: {verdict}", flush=True)

    # (b) the normalized window on the card against numpy on the host, on
    # slab 16's one raw slab (the whole file)
    raw, (n_valid, _) = slabs[0], geometry[0]
    host = raw.float().cpu().numpy()
    worst = 0.0
    for start in (0, n_valid // 2, n_valid - 100):
        win = np.zeros((dims.n_mels, CHUNK_FRAMES), np.float32)
        avail = max(0, min(start + CHUNK_FRAMES, n_valid) - start)
        win[:, :avail] = host[:, start:start + avail]
        mask = start + np.arange(CHUNK_FRAMES) < n_valid
        win = (np.maximum(win, win[:, mask].max() - np.float32(8.0))
               + np.float32(4.0)) / np.float32(4.0)
        win[:, ~mask] = 0.0
        got = session.chunk_norm_window(raw, start, n_valid).cpu().numpy()
        worst = max(worst, float(np.abs(got - win).max()))
    width = raw.shape[1]
    mel_pad = torch.nn.functional.pad(raw, (0, CHUNK_FRAMES))
    starts = [0, n_valid // 2, width, width]
    bucket = chunk_norm(torch.stack([mel_pad[:, s:s + CHUNK_FRAMES]
                                     for s in starts]), starts, n_valid)
    if worst > 1e-6 or not torch.isfinite(bucket).all() \
            or (bucket[2:] != 0).any():
        raise AssertionError(f"(b) chunk_norm_window: {worst:.3g} from "
                             "numpy, or padding rows not zeros")
    print(f"[pipelined] (b) chunk_norm_window on {card} against numpy on "
          f"the host at frames 0, {n_valid // 2}, {n_valid - 100} of "
          f"{n_valid}: max diff {worst:.3g} (atol 1e-6); a bucket of 4 with "
          "2 padding rows: padding rows all zeros, finite", flush=True)

    # (c) speculative over pipelined: its own int8 weights as draft
    session.set_draft_model(quantize_params(params), dims, share_encoder=True)
    try:
        e2e, t, spec_rows, c = run(4, speculative=True, draft_k=4)
    finally:
        session._draft = None
    if c["cross_attend_multi"] == 0 or c["log_mel"]:
        raise AssertionError(f"(c) speculative pipelined: launches {c}")
    _, _, windows4 = _pipelined_windows(session, audio, 4)
    verdict = judged(runs[4][2], spec_rows, windows4,
                     "(c) speculative against greedy, slab 4")
    print(f"[pipelined] (c) speculative x5 over pipelined, slab 4, own int8 "
          f"weights as draft, on {card}: e2e {e2e:.4f} s, model "
          f"{t.model_only_s:.4f} s; against greedy pipelined: {verdict}; "
          f"launches {c}", flush=True)

    saved_hf = os.environ.get("HF_HOME")
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["HF_HOME"] = os.path.join(tmp, "hf")
        audio_dir = os.path.join(tmp, "audio")
        one_dir = os.path.join(tmp, "one")
        for d in (audio_dir, one_dir):
            os.makedirs(d)
        for name, secs, sr, ch in CLI_FILES:
            _write_wav(os.path.join(audio_dir, name), secs, sr, ch)
        _write_wav(os.path.join(one_dir, CLI_FILES[0][0]), *CLI_FILES[0][1:])
        one_audio = load_audio_16k_mono(
            os.path.join(one_dir, CLI_FILES[0][0]))[0]

        def cli(label, directory, *args):
            out = os.path.join(tmp, "out", label)
            _zero_counts(results)
            t0 = time.perf_counter()
            rc = cli_main(["--audio-dir", directory, "--model-id",
                           "openai/whisper-base", "--max-new-tokens", "128",
                           "--out-csv", f"{out}/inference_per_file.csv",
                           "--out-json", f"{out}/inference_per_file.json",
                           "--out-summary-json",
                           f"{out}/inference_summary.json", *args])
            wall = time.perf_counter() - t0
            c = _counts(results)
            rows = json.load(open(f"{out}/inference_per_file.json"))
            if rc != 0 or len(rows) != len(os.listdir(directory)):
                raise AssertionError(f"{label}: rc {rc}, {len(rows)} rows")
            return rows, c, wall, out

        # (d) the converter and the int8 quantizer
        t0 = time.perf_counter()
        model_dir = os.path.join(tmp, "whisper-base")
        convert.save_params(params, dims, model_dir,
                            {"model_id": "openai/whisper-base"})
        back, dims2 = convert.load_params(model_dir)
        flat, flat_back = convert._flatten(params), convert._flatten(back)
        if dims2 != dims or sorted(flat) != sorted(flat_back) or not all(
                np.array_equal(flat[k], flat_back[k]) for k in flat):
            raise AssertionError("(d) load_params(save_params(x)) != x")
        int8_dir = quantize_model_dir(model_dir)
        qback, _ = convert.load_params(int8_dir)
        qflat, qwant = convert._flatten(qback), convert._flatten(
            quantize_params(params))
        if sorted(qflat) != sorted(qwant) or not all(
                np.array_equal(qflat[k], qwant[k]) for k in qwant):
            raise AssertionError("(d) the int8 dir is not quantize_params")
        t_files = time.perf_counter() - t0
        if "safetensors" in sys.modules or "jax" in sys.modules:
            raise AssertionError("(d) safetensors or jax was imported")
        rows, c5, w5, _ = cli("from-dir-x5", one_dir, "--onnx-dir",
                              model_dir, "--variant", "x5")
        want, _ = transcribe_longform(session, one_audio, "en", "transcribe",
                                      128)
        if rows[0]["text"] != want:
            raise AssertionError("(d) the CLI from the model dir gives other "
                                 "tokens than the in-memory session")
        rows, c4, w4, _ = cli("from-dir-int8", one_dir, "--onnx-dir",
                              int8_dir, "--variant", "int8")
        want, _ = transcribe_longform(make_session("cuda", params, "x4"),
                                      one_audio, "en", "transcribe", 128)
        if rows[0]["text"] != want or c4["cross_attend_step_dequant"] == 0:
            raise AssertionError(f"(d) the CLI from the int8 dir: launches "
                                 f"{c4}, or other tokens than a session "
                                 "that quantizes in memory")
        print(f"[pipelined] (d) converter on {card}'s machine (no jax, no "
              f"safetensors): whisper-base written, read back value for "
              f"value and quantized in {t_files:.1f} s; the CLI from the dir "
              f"at x5 ({w5:.1f} s) and from the int8 dir at int8 "
              f"({w4:.1f} s) on the 4 s file: text equal to the in-memory "
              f"sessions'; launches int8 {c4}", flush=True)

        # (e) the discovery tuner, then the CLI with its JSON
        best = os.path.join(tmp, "best.json")
        t0 = time.perf_counter()
        if discover.main(["--synthetic-s", "60", "--variants", "x4,x5,x7",
                          "--runs", "1", "--out", best]) != 0:
            raise AssertionError("(e) discover failed")
        t_disc = time.perf_counter() - t0
        found = json.load(open(best))
        winner = found["sweep"][0]["variant"]
        _, c, _, _ = cli("discovered", one_dir, "--allow-random-init",
                         "--discovery-best-json", best)
        step = {"x4": "cross_attend_step_dequant", "x5": "cross_attend_step",
                "x7": "self_attend_step_int8"}[winner]
        if c[step] == 0 or c["fused_attention"] == 0:
            raise AssertionError(f"(e) the CLI with the {winner} JSON: "
                                 f"launches {c}")
        print(f"[pipelined] (e) discover, 60 s synthetic, x4/x5/x7, one run "
              f"each, on {card}: {t_disc:.1f} s; sweep "
              + ", ".join(f"{r['variant']} {r['e2e_s']:.4f} s"
                          for r in found["sweep"])
              + f"; the CLI with its JSON ran {winner}: launches {c}",
              flush=True)

        # (f) the CLI in the pipelined mode, then the results tools
        res = os.path.join(tmp, "out")
        rows, c, wall, out = cli("whisper_tpu_torch_x5", audio_dir,
                                 "--allow-random-init", "--variant", "x5",
                                 "--longform-mode", "pipelined",
                                 "--warmup", "1")
        if any(c[n] == 0 for n in need) or c["log_mel"]:
            raise AssertionError(f"(f) CLI pipelined: launches {c}")
        e2e = [r["end_to_end_s"] for r in rows]
        wrows, wc, wwall, _ = cli("pipelined-words", audio_dir,
                                  "--allow-random-init", "--variant", "x5",
                                  "--longform-mode", "pipelined",
                                  "--word-timestamps", "--language", "auto")
        n_words = sum(len(r.get("words") or []) for r in wrows)
        if not all("words" in r for r in wrows) or wc["log_mel"]:
            raise AssertionError(f"(f) CLI pipelined with words: launches "
                                 f"{wc}")
        if summarize.main(["--results-dir", res]) != 0:
            raise AssertionError("(f) results.summarize failed")
        table = list(csv.DictReader(open(os.path.join(
            res, "summary_table.csv"))))
        timed = [r for r in table if r["time_s"]]
        if [r["implementation"] for r in timed] != [
                "whisper-tpu-torch (int8 x int8)"]:
            raise AssertionError(f"(f) summary rows with a time: {timed}")
        if accumulate.main([
                "--results-md", os.path.join(tmp, "RESULTS.md"),
                "--summary-table", os.path.join(res, "summary_table.md"),
                "--summary-csv", os.path.join(res, "summary_table.csv"),
                "--sut-name", "h100", "--core-count",
                str(os.cpu_count() or 1), "--memory-gb", "80",
                "--results-csv", os.path.join(tmp, "RESULTS.csv")]) != 0:
            raise AssertionError("(f) results.accumulate failed")
        hist = list(csv.DictReader(open(os.path.join(tmp, "RESULTS.csv"))))
        if [r["time_s"] for r in hist if r["time_s"]] != [timed[0]["time_s"]]:
            raise AssertionError("(f) RESULTS.csv does not hold the run")
        print(f"[pipelined] (f) CLI --longform-mode pipelined x5 over the "
              f"four files, on {card}: per-file e2e "
              + ", ".join(f"{x:.4f}" for x in e2e)
              + f" s, wall {wall:.1f} s with warm-up; launches {c}; with "
              f"--word-timestamps --language auto: {n_words} words, wall "
              f"{wwall:.1f} s; summary row {timed[0]['implementation']} "
              f"{timed[0]['time_s']} s, RESULTS.md/.csv written", flush=True)
    if saved_hf is None:
        os.environ.pop("HF_HOME", None)
    else:
        os.environ["HF_HOME"] = saved_hf
    print(f"[pipelined] phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return runs[4][3]


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card: "
                         "torch.cuda.is_available() is false")
    from whisper_tpu_torch.headline import (
        AUDIO_SECONDS,
        MODEL_ID,
        card_info,
        make_session,
        synth_audio,
    )
    from whisper_tpu_torch.models.convert import init_params
    from whisper_tpu_torch.models.registry import get_dims
    from whisper_tpu_torch.ops import kernels
    from whisper_tpu_torch.pipeline.chunk import chunk_starts

    card = card_info()
    print(card, flush=True)

    t_start = t0 = time.perf_counter()
    lib = kernels.build(extra_flags=("-Xptxas", "-v"))
    print(f"[build] {lib.parent.name}: {time.perf_counter() - t0:.1f} s "
          f"(nvcc: {kernels.build_seconds if kernels.build_seconds else 0:.1f}"
          " s, 0 = already built)", flush=True)
    log = lib.parent / "nvcc.log"
    if log.is_file():
        for line in log.read_text().splitlines():
            if "Used" in line or "spill" in line:
                print(f"[ptxas] {line.strip()}", flush=True)
    check_sass(lib)

    results = check_kernels(card)

    dims = get_dims(MODEL_ID)
    params = init_params(dims, seed=0)
    check_against_cpu(params, dims)

    session = make_session("cuda", params)
    audio = synth_audio(AUDIO_SECONDS)
    # A warm-up, then three timed runs that must give equal tokens and
    # launch counts; the median run by e2e.
    x5_run = _timed_run(session, audio, results, runs=3)
    e2e, timing, toks, main_counts = x5_run
    idle = [n for n in MAIN_PATH_KERNELS if main_counts[n] == 0]
    if idle:
        raise AssertionError(f"kernels not launched on the main path: {idle}")
    n_chunks = len(chunk_starts(len(audio), 480_000, 400_000))  # 12
    if toks.shape != (n_chunks, 128):
        raise AssertionError(f"tokens {toks.shape}, expected "
                             f"({n_chunks}, 128)")
    if not ((toks >= 0) & (toks < dims.vocab_size)).all():
        raise AssertionError("token ids outside the vocabulary")
    check_main_path_finite(session, audio, dims)
    print(f"[main path] whisper-base x5, {AUDIO_SECONDS} s, on {card}: "
          f"e2e {e2e:.4f} s, preprocess {timing.preprocess_s:.4f} s, model "
          f"{timing.model_only_s:.4f} s, decode {timing.decode_s:.4f} s, "
          f"{AUDIO_SECONDS / e2e:.2f}x real time (median of 3); launches "
          f"per run {main_counts}", flush=True)

    del session
    ladder_runs = check_ladder(card, results, params, dims, audio, x5_run)
    ladder = {label: r[3] for label, r in ladder_runs.items()}
    spec, spec_tokens = check_speculative(card, results, params, dims, audio,
                                          x5_run)
    check_decoding(card, results, params, dims, audio, x5_run)
    check_prompts_words(card, results, params, dims, audio,
                        {"x7 against x5": (x5_run[2], ladder_runs["x7"][2]),
                         "speculative x5 against greedy x5":
                             spec_tokens["x5"],
                         "speculative x4 against greedy x4":
                             spec_tokens["x4"]})
    check_serve(card, results, params, dims)
    check_pipelined(card, results, params, dims, audio)
    fused_step = check_fused_step(card, results, params, dims, audio)
    medium = check_medium_fused_block(card, results)
    cli = check_cli(card, results)
    # Each kernel's launches in the run of its own path.  The two rows at
    # d = 1024 share their kernels' counters with the d = 512 rows.
    fused = ladder["x5+fused_encoder_block+fused_decoder_step"]
    path_of = {"log_mel": cli["whisper-base x5"]["log_mel"],
               "cross_attend_step_dequant":
                   cli["whisper-base int8"]["cross_attend_step_dequant"],
               "fused_encoder_mlp_d1024":
                   cli["whisper-medium x5"]["fused_encoder_mlp"],
               "self_attend_step_int8": ladder["x7"]["self_attend_step_int8"],
               "fused_ln_qkv": fused["fused_ln_qkv"],
               "fused_out_mlp": fused["fused_out_mlp"],
               "decoder_mlp_block": fused["decoder_mlp_block"],
               "fused_ln_qkv_d1024": medium["fused_ln_qkv"],
               "cross_attend_multi": spec["x5"]["cross_attend_multi"],
               "cross_attend_multi_dequant":
                   spec["x4"]["cross_attend_multi_dequant"],
               "decoder_self_block": fused_step["decoder_self_block"],
               "decoder_cross_block": fused_step["decoder_cross_block"]}
    for r in results:
        r["launches"] = path_of.get(r["name"], main_counts[r["name"]])
        if r["launches"] < 1:
            raise AssertionError(f"{r['name']}: not launched on its path")
        del r["counter"]
    print(f"[time] chip_smoke.py: {time.perf_counter() - t_start:.0f} s, the "
          "kernels' build included", flush=True)
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
