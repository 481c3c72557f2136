"""Where the device time goes, rung by rung:
``python -m whisper_tpu_torch.profile_ladder``.

Runs the headline workload (whisper-base, random weights from seed 0, the
301.574 s synthetic file, 128 greedy tokens) on the card at x5, x6, x7, x4
(the dequantizing cross-attention, B6) and at x5 with
``fused_encoder_block`` and ``fused_decoder_step``, and at x5 and at x4
decoded speculatively with the model's own int8 weights as the draft on the
shared encoder (draft_k 4: the verify pass runs B7-i8 at x5, B7-dq at x4),
each once to warm up and once under ``torch.profiler``, and prints for
each, on one JSON line: the wall time of the traced run (the profiler slows
the host, so it is no e2e figure), the device operations it launched
(kernels, copies and memsets) in all and per decode step, the device's busy
time and share, the mean in-situ time of each hand-written kernel (B2 as
its three kernels, whose means add up to one call; B9a and B9b as theirs),
the mean span of a call of the wrappers that launch several kernels on one
another's heels (B9a, B9b; B10c's FC1 and FC2, which overlap; B10a, B10b),
and the five largest other device operations.  It needs a CUDA card and
raises without one.

``python -m whisper_tpu_torch.profile_ladder --fused-block`` runs only the
fused encoder block's two runs: the 301.574 s file at x5 with both fused
flags (B9a and B9b at d = 512), and a 4 s file at whisper-medium (random
weights, 16 tokens) at x5 with ``fused_encoder_block`` (B9a at d = 1,024,
B1, B2), one JSON line each as above.  The file also runs against an older
tree of the package (that tree on ``PYTHONPATH``, this file run by its
path).

``python -m whisper_tpu_torch.profile_ladder --fused-step`` runs only
whisper-base's fully fused decode step (``decoder_step_fused``: B10a, B10b
and B10c per layer; no session path calls it): 127 steps at bucket 16 from
a bf16 prefill against random encoder states of 1,500 positions, once to
warm up and once under ``torch.profiler``, on one JSON line with the same
keys and the device operations and busy ms a step.  It passes ``pos`` as
an int, so the file also runs against an older tree of the package (that
tree on ``PYTHONPATH``, this file run by its path).

``python -m whisper_tpu_torch.profile_ladder --x7-one-shot`` runs only
what the int8 self-attention step (B8) and the one-shot front end (B5)
touch: the 301.574 s file at x7 (traced as above), the share of its tokens
equal to x5's, x5 on a 76 s file (7,600 frames: one shot through B5,
traced), and B5 alone at the one-shot limit (7,680 valid frames of a
12,000-frame bucket, int16) and B8 alone at bucket 16 (``pos`` 70 of 132,
no ``pad_count``): 20 calls back to back traced (device operations and
busy time a call, the kernels' in-situ means, B5's call as the span of its
two kernels), each wrapper's time (CUDA events over 20 calls, median of 5)
and, beside B5's, the composition of PyTorch calls around ``torch.stft``
(cuFFT) that computes the same function.  The profiler can miss a few
operations of so short a trace: a wrapper's device operations are counted
exactly by ``chip_smoke.py``.  It calls only what older trees have, so it
also runs against one (that tree on ``PYTHONPATH``, this file run by its
path).

Greedy decoding, beam search and speculative rounds on the card run each
decode as one launch of a CUDA graph (``runtime.generate``,
``runtime.beam``, ``runtime.speculative``), and the warm-up run captures
them, so the traced run launches graphs.  Each step is the body of a while
node, whose kernels torch.profiler does not always name right (one trace
named B3 a step where B8 ran): for a graphed run, read its counts of
the hand-written kernels beside the launch counters, or trace the loop
eagerly (``--graph``).

``python -m whisper_tpu_torch.profile_ladder --decode-ms`` runs only x5
over the 301.574 s file, five times (e2e, host clock), and the graphed
decode of its bucket of 16 and of its first chunk alone with no row ending
(128 tokens, no read): the device ms of the decode and of a step (the
prefill taken out), CUDA events, median of 7, and the host ms to queue it;
then the device operations of an iteration of the bucket's while node
(``_GraphLoop.body_ops``, from the body graph's nodes), without and with
scores.
It calls only what trees since the graphed loop have, so it also runs
against an older one (that tree on ``PYTHONPATH``, this file run by its
path): the cost of the loops' conditional node, tree against tree.

``python -m whisper_tpu_torch.profile_ladder --conditional`` runs only the
decode programs' forms against each other, in one process, on fresh graphs
of one x5 session, in turns: the program (the bucket's encoder, prefill and
first pick captured ahead of the loop's while node: one launch from the
gathered chunks to the tokens), the while node alone with the encoder and
the prefill run eagerly before its launch (the form before the program),
and the step captured flat (``runtime.generate._while_node`` replaced by
a block that adds nothing but the step's own tally; its loop tail then
sets no condition) behind the same eager work and launched once a
step (``CUDAGraph.replay`` repeated).  For ``transcribe_from_mel_async``
over the 301.574 s file's chunks in a bucket of 16 with no row ending: the
host ms to queue a 128-token decode beside one graph launch's host ms, a
one-token decode's and the encoder's alone, device ms of the decode and
of a step (median of 5), graph launches a decode, the kernels of one
traced decode and the program's pool bytes.  For the speculative rounds
over the same chunks with a random whisper-tiny draft and with the
model's own int8 weights (128 tokens, no row ending): graph launches a
call, the host ms of a launch (median), the launch at which the host first
waits more than 2 ms when the card is held busy 300 ms first (how many
launches the CUDA launch queue holds ahead), and the dispatch's host ms
beside the card's span of its work, median of 3, for the long form and for
``transcribe_short_speculative_async`` (16 windows of 30 s).

``python -m whisper_tpu_torch.profile_ladder --graph`` runs only x5 twice,
graphed and with the session's greedy loop run eagerly
(``eager_decode``), one JSON line each as above: what the graph takes off
the host and what it leaves on the card.

``python -m whisper_tpu_torch.profile_ladder --decoding`` runs only the
decoding options on one x5 session over the 301.574 s file's mel (computed
once; each run is the encoder and 128 tokens of ``transcribe_from_mel``):
plain greedy, with scores, with the timestamp grammar, sampled at T = 0.5
with scores, and beam search at K = 4, graphed and run eagerly
(``eager_decode``), each once to warm up, then ROUNDS rounds in turns (the
order rotated each round), then once traced.  One JSON line each: the
median and quartiles of its host seconds, the median of its paired
difference with greedy's run of the same round, and the traced run's
device operations (in all and a decode step), busy ms, the hand-written
kernels' in-situ times and the five largest other device operations (for
beams: the stable sort, the gathers).

``python -m whisper_tpu_torch.profile_ladder --pools`` runs only the bucket
programs' memory: whisper-base and whisper-large-v3-turbo at x5, the
301.574 s file (12 chunks, bucket 16) and a 76 s file (3 chunks, bucket 4),
one session a model.  For each program, the live peak of its pre-node
work in the capture's warm-up (``torch.cuda.max_memory_allocated`` above
what was allocated before it: the encoder's and the prefill's
temporaries) and of its step's, the bytes of its graph's two memory pools
(the pre-node program's and the while node's body's) after their trial
captures and after the capture, and ``utils.hbm.program_pool_bytes`` at
its rows; one JSON line each.
"""

from __future__ import annotations

import json
import re
import time
import warnings

import numpy as np

# kernel function name in csrc/ (for a gemm_kernel, its epilogue's) -> the
# kernel's number
KERNELS = {"attn_kernel": "B1",
           "mlp_ln_kernel": "B2 (LayerNorm)", "BiasGelu": "B2 (FC1 product)",
           "BiasResidual": "B2 (FC2 product)",
           "self_step_int8_kernel": "B8", "self_step_kernel": "B3",
           "cross_step_kernel": "B4", "cross_dequant_kernel": "B6",
           "cross_multi_int8_kernel": "B7-i8",
           "cross_multi_dequant_kernel": "B7-dq",
           "log_mel_kernel": "B5",
           "mel_spectrum_kernel": "B5 (spectrum)",
           "mel_normalize_kernel": "B5 (normalization)",
           "qkv_ln_kernel": "B9a (LayerNorm)", "QkvBias": "B9a (QKV product)",
           "OutProjResidual": "B9b (O product)",
           "out_ln_kernel": "B9b (LayerNorm)",
           "OutFc1Gelu": "B9b (FC1 product)",
           "OutFc2Residual": "B9b (FC2 product)",
           # the first ports of B9a and B9b, one kernel each: so that this
           # file, run by its path against an older tree, times that tree
           "ln_qkv_kernel": "B9a", "out_mlp_kernel": "B9b",
           "fc1_kernel": "B10c (FC1)", "fc2_kernel": "B10c (FC2)",
           "ln_gemm_kernel": "B10a/B10b (LN and product)",
           "self_attn_kernel": "B10a (attention)",
           "cross_attn_kernel": "B10b (attention)",
           "out_proj_kernel": "B10a/B10b (O product)"}
# A wrapper that launches several kernels, as they follow each other on the
# stream: a call's in-situ time is the span from its first kernel's start to
# its last one's end (B10c's FC2 starts before FC1 ends, so the two kernels'
# own times overlap and do not add up to a call).
CALLS = {"B5": ("mel_spectrum_kernel", "mel_normalize_kernel"),
         "B9a": ("qkv_ln_kernel", "QkvBias"),
         "B9b": ("OutProjResidual", "out_ln_kernel", "OutFc1Gelu",
                 "OutFc2Residual"),
         "B10a": ("ln_gemm_kernel", "self_attn_kernel", "out_proj_kernel"),
         "B10b": ("ln_gemm_kernel", "cross_attn_kernel", "out_proj_kernel"),
         "B10c": ("fc1_kernel", "fc2_kernel")}
CONFIGS = (("x5", "x5", {}), ("x6", "x6", {}), ("x7", "x7", {}),
           ("x4", "x4", {}),
           ("x5+fused_encoder_block+fused_decoder_step", "x5",
            dict(fused_encoder_block=True, fused_decoder_step=True)))
# (label, variant) of the runs decoded speculatively
SPECULATIVE = (
    ("x5+speculative (own int8 weights as draft, shared encoder)", "x5"),
    ("x4+speculative (own int8 weights as draft, shared encoder)", "x4"))
DECODE_STEPS = 127  # 128 new tokens: the prefill gives the first
FUSED_BUCKET = 16   # the 301.574 s file's 12 chunks in a bucket of 16
FUSED_BLOCK = CONFIGS[-1]
# (label, model_id, seconds of audio, new tokens) of the whisper-medium run
MEDIUM = ("whisper-medium x5+fused_encoder_block, 4 s",
          "openai/whisper-medium", 4.0, 16)
ONE_SHOT_SECONDS = 76.0   # 7,600 frames: the one-shot front end (B5)
B5_VALID = 7680           # the one-shot limit, in a bucket of 12,000 frames


def _named(fn: str, name: str) -> bool:
    """``fn`` is the whole of a name in ``name`` (attn_kernel is not
    cross_attn_kernel): a kernel's, or for gemm_kernel<BLOCKS, Epilogue>
    its epilogue's."""
    return re.search(rf"(?:^|[\s:]){re.escape(fn)}(?:[<(>]|$)",
                     name) is not None


def _kernel_of(name: str):
    for fn, label in KERNELS.items():
        if _named(fn, name):
            return label
    return None


def summarize(prof) -> dict:
    """Device operations, busy time and the hand-written kernels' in-situ
    times of a torch.profiler trace (see the module's docstring)."""
    from torch.autograd import DeviceType

    ops, busy_us, mine, other = 0, 0.0, {}, []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        ops += e.count
        busy_us += us
        k = _kernel_of(e.key)
        if k is None:
            other.append((us, e.count, e.key[:80]))
        else:
            n, total = mine.get(k, (0, 0.0))
            mine[k] = (n + e.count, total + us)
    if busy_us <= 0:
        raise RuntimeError("the profiler recorded no device time")
    other.sort(reverse=True)
    return {
        "device_ops": ops, "device_busy_ms": busy_us / 1e3,
        "kernels": {k: {"launches": n, "mean_ms": total / n / 1e3,
                        "total_ms": total / 1e3}
                    for k, (n, total) in sorted(mine.items())},
        "calls": call_spans(prof),
        "largest_other": [{"name": name, "count": n, "total_ms": us / 1e3}
                          for us, n, name in other[:5]],
    }


def _calls(prof):
    """(label, its kernels' events) of each call of the wrappers in
    ``CALLS`` found in the trace, in the order of the stream."""
    from torch.autograd import DeviceType

    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    i = 0
    while i < len(events):
        for label, seq in CALLS.items():
            group = events[i:i + len(seq)]
            if len(group) == len(seq) and all(
                    _named(fn, e.name) for fn, e in zip(seq, group)):
                yield label, group
                i += len(seq)
                break
        else:
            i += 1


def call_spans(prof) -> dict:
    """Mean in-situ time of each call of the wrappers in ``CALLS`` found in
    the trace, each call the span of its kernels (see ``CALLS``)."""
    spans = {}
    for label, group in _calls(prof):
        n, total = spans.get(label, (0, 0.0))
        spans[label] = (n + 1, total + group[-1].time_range.end
                        - group[0].time_range.start)
    return {k: {"calls": n, "mean_ms": total / n / 1e3}
            for k, (n, total) in sorted(spans.items())}


def call_timelines(prof) -> dict:
    """For each wrapper in ``CALLS``: the mean start and end of each of its
    kernels in µs from the start of the call's first, which shows how far
    a programmatic dependent overlaps the kernel before it."""
    sums = {}
    for label, group in _calls(prof):
        n, acc = sums.get(label, (0, [[0.0, 0.0] for _ in group]))
        t0 = group[0].time_range.start
        for a, e in zip(acc, group):
            a[0] += e.time_range.start - t0
            a[1] += e.time_range.end - t0
        sums[label] = (n + 1, acc)
    return {label: {fn: [a[0] / n, a[1] / n]
                    for fn, a in zip(CALLS[label], acc)}
            for label, (n, acc) in sorted(sums.items())}


def profile_config(label: str, variant: str, overrides: dict, params,
                   audio, draft=None, max_new_tokens: int = 128,
                   eager: bool = False) -> dict:
    """One traced run of the workload; ``draft``: (params, dims) of a draft
    model, and then the run decodes speculatively with draft_k 4;
    ``overrides`` may name another ``model_id`` (``params`` None: random
    weights from seed 0); ``eager``: the greedy loop without its graphs."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from whisper_tpu_torch.headline import make_session, run_once

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # x6's precedence note
        session = make_session("cuda", params, variant, **overrides)
    session.eager_decode = eager
    decode = {"max_new_tokens": max_new_tokens}
    if draft is not None:
        session.set_draft_model(*draft, share_encoder=True)
        decode = dict(speculative=True, draft_k=4)
    run_once(session, audio, **decode)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_once(session, audio, **decode)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = summarize(prof)
    busy_ms = out["device_busy_ms"]
    return {"config": label, "traced_wall_s": wall,
            "device_ops": out["device_ops"],
            "device_ops_per_decode_step_upper":
                out["device_ops"] / (max_new_tokens - 1),
            "device_busy_ms": busy_ms,
            "device_busy_share_of_traced_wall": busy_ms / 1e3 / wall,
            **{k: out[k] for k in ("kernels", "calls", "largest_other")}}


def profile_fused_step(params, dims, device: str = "cuda") -> dict:
    """127 steps of ``decoder_step_fused``, one traced run after a warm-up
    (see the module's docstring).  ``device`` "cpu" rehearses it with the
    kernels' plain versions, and then ``summarize`` raises: no device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from whisper_tpu_torch.headline import make_session
    from whisper_tpu_torch.models import whisper
    from whisper_tpu_torch.ops import decoder_kernels as dk

    p = make_session(device, params)._decoder_params
    g = torch.Generator(device=device).manual_seed(0)
    enc = torch.randn(FUSED_BUCKET, dims.max_source_positions, dims.d_model,
                      generator=g, device=device).to(
                          p["decoder"]["tok_emb"].dtype)
    prompt = torch.tensor([[50258, 50259, 50359, 50363]] * FUSED_BUCKET,
                          device=device)
    n_p = prompt.shape[1]
    sw = dk.build_step_weights(p, dims)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)

    def steps():
        """A prefill, then the 127 steps as a function to run."""
        logits, cache = whisper.decoder_prefill(p, dims, prompt, enc,
                                                n_p + DECODE_STEPS + 1)
        k_tm = dk.cache_to_time_major(cache.self_k)
        v_tm = dk.cache_to_time_major(cache.self_v)
        first = logits[:, -1].argmax(-1)
        sync()

        def run():
            tok = first
            for i in range(DECODE_STEPS):
                tok = dk.decoder_step_fused(
                    p, sw, dims, tok, n_p + i, k_tm, v_tm, cache.cross_k,
                    cache.cross_v)[0].argmax(-1)
            sync()

        return run

    steps()()
    run = steps()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    wall = time.perf_counter() - t0
    out = summarize(prof)
    return {"config": "decoder_step_fused", "steps": DECODE_STEPS,
            "traced_wall_s": wall, "device_ops": out["device_ops"],
            "device_ops_per_step": out["device_ops"] / DECODE_STEPS,
            "device_busy_ms": out["device_busy_ms"],
            "device_ms_per_step": out["device_busy_ms"] / DECODE_STEPS,
            "call_timelines_us": call_timelines(prof),
            **{k: out[k] for k in ("kernels", "calls", "largest_other")}}


def _median_ms(fn, runs: int = 5, calls: int = 20) -> float:
    """One call of ``fn``: CUDA events around ``calls`` calls back to back,
    the median over ``runs`` runs."""
    import statistics

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


def call_profile(fn, calls: int = 20) -> dict:
    """``calls`` calls of ``fn`` back to back, traced in one profiler
    session: device operations and busy µs a call, the in-situ means of the
    hand-written kernels and, for a wrapper that ``CALLS`` names, the mean
    span of its call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = summarize(prof)
    return {"device_ops_per_call": out["device_ops"] / calls,
            "busy_us_per_call": out["device_busy_ms"] * 1e3 / calls,
            "kernels": out["kernels"], "calls": out["calls"],
            "largest_other": out["largest_other"]}


_MEL_CONSTANTS: dict = {}  # (device, n_mels) -> (window, fb) on the card


def mel_composition(wire, valid: int, n_mels: int, n_frames: int):
    """B5's function as a composition of PyTorch calls, the yardstick beside
    it (no one call computes it): the decode, ``torch.stft`` (cuFFT), the
    power, the fp32 mel product with TF32 off, log10 and the masked
    normalization."""
    import torch

    from whisper_tpu_torch.frontend import golden
    from whisper_tpu_torch.frontend.mel import (
        _constants,
        decode_transfer,
        normalize,
    )
    from whisper_tpu_torch.ops.common import disable_tf32

    disable_tf32()
    key = (str(wire.device), n_mels)
    if key not in _MEL_CONSTANTS:
        _MEL_CONSTANTS[key] = tuple(
            torch.from_numpy(np.ascontiguousarray(c)).to(wire.device)
            for c in (golden.hann_window_periodic(golden.WIN),
                      _constants(n_mels)[2].T))
    window, fb = _MEL_CONSTANTS[key]
    need = (n_frames - 1) * golden.HOP + golden.WIN
    x = decode_transfer(wire)
    x = torch.nn.functional.pad(x, (0, max(0, need - x.numel())))[:need]
    spec = torch.stft(x, golden.N_FFT, hop_length=golden.HOP,
                      win_length=golden.WIN, window=window, center=False,
                      return_complex=True)                 # [201, n_frames]
    power = spec.real.square() + spec.imag.square()
    ls = torch.log10(torch.clamp_min(torch.matmul(fb, power), 1e-10))
    return normalize(ls, ls[:, :valid].amax(), valid)


def profile_x7_one_shot(params):
    """The ``--x7-one-shot`` lines, one at a time (see the module's
    docstring)."""
    import torch

    from whisper_tpu_torch.frontend import golden
    from whisper_tpu_torch.headline import (
        AUDIO_SECONDS,
        make_session,
        run_once,
        synth_audio,
    )
    from whisper_tpu_torch.ops import log_mel, self_attention
    from whisper_tpu_torch.pipeline.chunk import mel_frame_bucket

    audio = synth_audio(AUDIO_SECONDS)
    x7 = profile_config("x7", "x7", {}, params, audio)
    tokens = {}
    for variant in ("x5", "x7"):
        session = make_session("cuda", params, variant)
        run_once(session, audio)
        collector = []
        run_once(session, audio, token_collector=collector)
        tokens[variant] = np.asarray(collector[0])
        del session
    x7["tokens_equal_to_x5"] = float((tokens["x7"] == tokens["x5"]).mean())
    x7["first_tokens_equal_to_x5"] = bool(
        (tokens["x7"][:, 0] == tokens["x5"][:, 0]).all())
    yield x7
    yield profile_config(f"x5, {ONE_SHOT_SECONDS:g} s (one-shot front end)",
                         "x5", {}, params, synth_audio(ONE_SHOT_SECONDS))

    dev = torch.device("cuda")
    wave = synth_audio(B5_VALID * golden.HOP / 16000.0)
    pcm = np.round(np.clip(golden.reflect_pad(wave), -1, 1) * 32767.0)
    wire = torch.from_numpy(pcm.astype(np.int16)).to(dev)
    n_frames = mel_frame_bucket(B5_VALID)

    def composition():
        return mel_composition(wire, B5_VALID, 80, n_frames)

    def b5():
        return log_mel.log_mel(wire, B5_VALID, 80, n_frames)

    plain = log_mel.log_mel_plain(wire, B5_VALID, 80, n_frames)
    yield {"config": f"B5 alone, {B5_VALID} of {n_frames} frames, int16",
           **call_profile(b5), "wrapper_ms": _median_ms(b5),
           "composition_ms": _median_ms(composition),
           "max_abs_err": float((b5() - plain).abs().max()),
           "composition_max_abs_err": float((composition() - plain)
                                            .abs().max())}

    g = torch.Generator(device=dev).manual_seed(0)
    n_l, b, h, s = 6, 16, 8, 132
    q, kn, vn = ((torch.randn(b, h, 64, generator=g, device=dev) * sc)
                 .to(torch.bfloat16) for sc in (0.125, 1.0, 1.0))
    i8 = self_attention.quantize_self_cache(
        *(torch.randn(n_l, b, h, s, 64, generator=g, device=dev)
          .to(torch.bfloat16) for _ in "kv"))

    def b8():
        return self_attention.self_attend_step_int8(q, kn, vn, *i8, 3, 70)

    yield {"config": "B8 alone, bucket 16, pos 70 of 132",
           **call_profile(b8), "wrapper_ms": _median_ms(b8)}


ROUNDS = 7   # of the --decoding runs, each option once a round


def profile_decoding(params, audio):
    """The ``--decoding`` lines, one at a time (see the module's
    docstring)."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    from whisper_tpu_torch.frontend import golden
    from whisper_tpu_torch.headline import make_session
    from whisper_tpu_torch.pipeline.chunk import chunk_starts, mel_frame_bucket
    from whisper_tpu_torch.runtime.timestamps import TimestampCfg
    from whisper_tpu_torch.tokenizer.specials import special_tokens

    session = make_session("cuda", params)
    sp = special_tokens("en", "transcribe", None)
    nv = golden.num_frames(len(audio))
    mel = session.compute_mel(golden.reflect_pad(audio), nv,
                              mel_frame_bucket(nv))
    starts = [p // golden.HOP for p in chunk_starts(len(audio), 480_000,
                                                    400_000)]
    plain = [sp.sot, sp.lang, sp.task, sp.no_timestamps]
    options = {
        "greedy": (plain, {}),
        "greedy with scores": (plain, dict(with_scores=True)),
        "timestamp grammar": (plain[:3], dict(ts_cfg=TimestampCfg(
            sp.no_timestamps + 1, sp.eot, sp.no_timestamps))),
        "sampled T = 0.5 with scores": (plain, dict(temperature=0.5,
                                                    with_scores=True)),
        "beam search K = 4": (plain, dict(num_beams=4)),
        "beam search K = 4, eager": (plain, dict(num_beams=4)),
    }

    def run(name):
        prompt, kw = options[name]
        session.eager_decode = name.endswith("eager")
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            session.transcribe_from_mel(mel, starts, prompt, 128, sp.eot,
                                        **kw)
            torch.cuda.synchronize()
        finally:
            session.eager_decode = False
        return time.perf_counter() - t0

    names = list(options)
    for name in names:
        run(name)
    secs = {name: [] for name in names}
    for r in range(ROUNDS):
        for name in names[r % len(names):] + names[:r % len(names)]:
            secs[name].append(run(name))
    for name in names:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run(name)
        out = summarize(prof)
        q = statistics.quantiles(secs[name], n=4)
        yield {"config": f"x5 {name}, transcribe_from_mel, 12 chunks",
               "rounds": ROUNDS, "median_s": statistics.median(secs[name]),
               "quartiles_s": [q[0], q[2]], "runs_s": secs[name],
               "paired_minus_greedy_median_s": statistics.median(
                   a - b for a, b in zip(secs[name], secs["greedy"])),
               "device_ops": out["device_ops"],
               "device_ops_per_decode_step_upper":
                   out["device_ops"] / DECODE_STEPS,
               "device_busy_ms": out["device_busy_ms"],
               "kernels": out["kernels"],
               "largest_other": out["largest_other"]}


POOL_RUNS = (("openai/whisper-base", 301.574), ("openai/whisper-base", 76.0),
             ("openai/whisper-large-v3-turbo", 301.574),
             ("openai/whisper-large-v3-turbo", 76.0))


def profile_pools() -> list:
    """The ``--pools`` lines (see the module's docstring)."""
    import torch

    from whisper_tpu_torch.headline import make_session, run_once, synth_audio
    from whisper_tpu_torch.models.convert import init_params
    from whisper_tpu_torch.models.registry import get_dims
    from whisper_tpu_torch.runtime import generate
    from whisper_tpu_torch.utils import hbm

    capture, trial = generate._GraphLoop._capture, \
        generate._GraphLoop._trial_capture
    seen = {}

    def live(fn, name):
        """``fn`` that records, the first time it runs (the warm-up), its
        live peak above what was allocated before it."""
        def run():
            if name in seen:
                return fn()
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = fn()
            torch.cuda.synchronize()
            seen[name] = torch.cuda.max_memory_allocated() - before
            return out
        return run

    def capturing(self, pre, step, bound):
        capture(self, live(pre, "pre"),
                None if step is None else live(step, "step"), bound)
        seen["pre pool"] = generate._pool_bytes(self.pools[:1])
        seen["body pool"] = generate._pool_bytes(self.pools[1:])

    def trying(self, fn, stream, pool, body=False):
        out = trial(self, fn, stream, pool, body)
        seen["body pool after its trial" if body
             else "pre pool after its trial"] = generate._pool_bytes([pool])
        return out

    generate._GraphLoop._capture = capturing
    generate._GraphLoop._trial_capture = trying
    out, session = [], None
    try:
        for model_id, seconds in POOL_RUNS:
            dims = get_dims(model_id)
            if session is None or session.dims != dims:
                session = None
                torch.cuda.empty_cache()
                session = make_session("cuda", init_params(dims, seed=0),
                                       "x5", model_id)
            seen.clear()
            run_once(session, synth_audio(seconds))
            rows = next(reversed(session.graphs.kept())).rows
            gib = {k: v / 2 ** 30 for k, v in seen.items()}
            out.append({
                "config": f"{model_id} x5, {seconds} s, bucket {rows}",
                "pre_live_peak_gib": gib["pre"],
                "step_live_peak_gib": gib["step"],
                "pre_pool_after_trial_gib": gib["pre pool after its trial"],
                "body_pool_after_trial_gib": gib[
                    "body pool after its trial"],
                "pre_pool_gib": gib["pre pool"],
                "body_pool_gib": gib["body pool"],
                "pools_over_live_peak": (seen["pre pool"] + seen["body pool"])
                / seen["pre"],
                "program_pool_bytes_gib": hbm.program_pool_bytes(
                    dims, rows, 4, act_bytes=2) / 2 ** 30})
    finally:
        generate._GraphLoop._capture = capture
        generate._GraphLoop._trial_capture = trial
    return out


def profile_decode_ms(params, audio) -> dict:
    """The ``--decode-ms`` line (see the module's docstring)."""
    import statistics

    import torch

    from whisper_tpu_torch.frontend import golden
    from whisper_tpu_torch.headline import make_session, run_once
    from whisper_tpu_torch.pipeline.chunk import (
        CHUNK_FRAMES,
        chunk_starts,
        mel_frame_bucket,
    )
    from whisper_tpu_torch.runtime.genconfig import GenerationCfg
    from whisper_tpu_torch.tokenizer.specials import special_tokens

    session = make_session("cuda", params)
    sp = special_tokens("en", "transcribe", None)
    run_once(session, audio)
    e2e = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_once(session, audio)
        torch.cuda.synchronize()
        e2e.append(time.perf_counter() - t0)
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
    cfg = GenerationCfg()
    masks = session._get_masks(cfg.suppress_tokens,
                               cfg.begin_suppress_tokens)
    prompt = torch.tensor([sp.sot, sp.lang, sp.task, sp.no_timestamps],
                          device="cuda")

    def decode(states, n):
        """(device ms, host ms to queue) of one graphed decode of n
        tokens."""
        torch.cuda.synchronize()
        ev0, ev1 = torch.cuda.Event(True), torch.cuda.Event(True)
        ev0.record()
        t0 = time.perf_counter()
        session._greedy(states, prompt, *masks, n, sp.eot, early_exit=False)
        host = (time.perf_counter() - t0) * 1e3
        ev1.record()
        ev1.synchronize()
        return ev0.elapsed_time(ev1), host

    out = {"config": "x5, the 301.574 s file; the graphed decode of its "
                     "bucket, no row ending",
           "e2e_median_s": statistics.median(e2e), "e2e_runs_s": e2e}
    for b, states in ((16, enc), (1, enc[:1].contiguous())):
        for n in (1, 128, 128):
            decode(states, n)
        whole = [decode(states, 128) for _ in range(7)]
        pre = statistics.median(decode(states, 1)[0] for _ in range(7))
        ms = statistics.median(w[0] for w in whole)
        out[f"bucket{b}_decode_device_ms"] = ms
        out[f"bucket{b}_step_device_ms"] = (ms - pre) / DECODE_STEPS
        out[f"bucket{b}_queue_host_ms"] = statistics.median(
            w[1] for w in whole)
    # an iteration's device operations, read from the body graph's nodes
    # (trees since they are read), at bucket 16 without and with scores
    for label, kw in (("", {}), ("_scores", {"with_scores": True})):
        session._greedy(enc, prompt, *masks, DECODE_STEPS + 1, sp.eot,
                        early_exit=False, **kw)
        loop = next(reversed(session.graphs._loops.values()))
        out[f"bucket16_body_ops{label}"] = getattr(loop, "body_ops", None)
    return out


def profile_conditional(params, audio) -> list:
    """The ``--conditional`` lines (see the module's docstring)."""
    import contextlib
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    from whisper_tpu_torch.frontend import golden
    from whisper_tpu_torch.headline import make_session
    from whisper_tpu_torch.models.convert import init_params
    from whisper_tpu_torch.models.registry import get_dims
    from whisper_tpu_torch.ops.common import tally_launches
    from whisper_tpu_torch.pipeline.chunk import chunk_starts, mel_frame_bucket
    from whisper_tpu_torch.runtime import generate
    from whisper_tpu_torch.runtime.genconfig import GenerationCfg
    from whisper_tpu_torch.tokenizer.specials import special_tokens
    from whisper_tpu_torch.variants.quant import quantize_params

    @contextlib.contextmanager
    def flat(graph, done, trips, bound, body, pool=None, tail=False):
        info = {}
        with tally_launches() as tally:
            yield info
        info["tally"] = dict(tally)

    node, program = generate._while_node, generate._GraphLoop
    replay = torch.cuda.CUDAGraph.replay
    launches: list = []      # host ms of each graph launch
    per_launch = [1]         # replays of the graph a launch (flat: a step)

    class LoopOnly(generate._GraphLoop):
        """The forms before the program: the pre-node work (the encoders,
        the prefill) run eagerly ahead of each launch, the graph holding
        the loop alone (behind one no-op kernel in the pre-node's place)."""

        def _capture(self, pre, step, bound):
            self._pre = pre
            trips = self.state.trips()
            super()._capture(lambda: trips.add_(0), step, bound)

        def _launch(self):
            self._pre()
            super()._launch()

    def launch(graph):
        for _ in range(per_launch[0]):
            t0 = time.perf_counter()
            replay(graph)
            launches.append((time.perf_counter() - t0) * 1e3)

    dims = get_dims("openai/whisper-base")
    session = make_session("cuda", params)
    sp = special_tokens("en", "transcribe", None)
    nv = golden.num_frames(len(audio))
    mel = session.compute_mel(golden.reflect_pad(audio), nv,
                              mel_frame_bucket(nv))
    starts = [p // golden.HOP for p in chunk_starts(len(audio), 480_000,
                                                    400_000)]
    starts += [mel.shape[1]] * (16 - len(starts))
    sup = (GenerationCfg().suppress_tokens,
           GenerationCfg().begin_suppress_tokens)
    prompt = [sp.sot, sp.lang, sp.task, sp.no_timestamps]
    chunks = torch.nn.functional.pad(mel, (0, 3000)).unfold(
        1, 3000, 1).transpose(0, 1)[torch.tensor(starts, device="cuda")]
    hop = (len(audio) - 480_000) // 15
    padded = np.stack([golden.reflect_pad(audio[i * hop:i * hop + 480_000])
                       for i in range(16)])
    n_valid = np.full(16, 3000, np.int32)

    def fresh(mode, steps):
        """New graphs of the session in ``mode``: the program (the
        encoder, the prefill and the loop in one graph), the while node
        alone behind an eager encoder and prefill (the form before), or
        the step captured flat and launched ``steps`` times a call."""
        generate._while_node = flat if mode == "flat" else node
        generate._GraphLoop = program if mode == "program" else LoopOnly
        old = session.graphs
        session.graphs = generate.DecodeGraphs(
            old.params, old.step_weights, old.draft_params, old.encoder,
            old.draft_encoder)
        per_launch[0] = steps if mode == "flat" else 1

    def span_ms(fn):
        """(device ms of fn's work, host ms until fn returns)."""
        torch.cuda.synchronize()
        ev0, ev1 = torch.cuda.Event(True), torch.cuda.Event(True)
        ev0.record()
        t0 = time.perf_counter()
        fn()
        host = (time.perf_counter() - t0) * 1e3
        ev1.record()
        ev1.synchronize()
        return ev0.elapsed_time(ev1), host

    out = []
    torch.cuda.CUDAGraph.replay = launch
    try:
        enc_host = statistics.median(
            span_ms(lambda: session.encoder(chunks))[1] for _ in range(5))
        for mode in ("program", "while", "flat", "program", "while", "flat"):
            def decode(n):
                return session.transcribe_from_mel_async(
                    mel, starts, prompt, n, sp.eot, *sup)
            fresh(mode, DECODE_STEPS)
            decode(128)                   # the capture's call
            decode(128)
            decode(1)                     # no step
            runs = [span_ms(lambda: decode(128)) for _ in range(5)]
            pre = [span_ms(lambda: decode(1)) for _ in range(5)]
            launches.clear()
            decode(128)
            n_launches, launch_ms = len(launches), statistics.median(launches)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                decode(128)
                torch.cuda.synchronize()
            kernels = sum(e.count for e in prof.key_averages()
                          if e.device_type == torch.autograd.DeviceType.CUDA
                          and not e.key.startswith(("Memcpy", "Memset")))
            ms = statistics.median(r[0] for r in runs)
            pool = max(session.graphs.pools().values())
            out.append({"config": f"x5 transcribe_from_mel_async, bucket 16, "
                                  f"128 tokens, no row ending, {mode}",
                        "decode_device_ms": ms,
                        "runs_ms": [r[0] for r in runs],
                        "step_device_ms": (ms - statistics.median(
                            p[0] for p in pre)) / DECODE_STEPS,
                        "queue_host_ms": statistics.median(r[1] for r in
                                                           runs),
                        "one_token_queue_host_ms": statistics.median(
                            p[1] for p in pre),
                        "launch_host_ms": launch_ms,
                        "encoder_queue_host_ms": enc_host,
                        "graph_launches": n_launches,
                        "decode_kernels": kernels,
                        "program_pool_bytes": pool,
                        "keys": len(session.graphs.captures())})
        tiny = get_dims("openai/whisper-tiny")
        for label, draft, d_dims, share in (
                ("a random whisper-tiny draft", init_params(tiny, seed=1),
                 tiny, False),
                ("its own int8 weights", quantize_params(params), dims,
                 True)):
            session.set_draft_model(draft, d_dims, share_encoder=share)
            for mode in ("program", "while", "flat"):
                def rounds():
                    return session.transcribe_from_mel_async(
                        mel, starts, prompt, 128, sp.eot, *sup,
                        speculative=True)

                def short():
                    return session.transcribe_short_speculative_async(
                        padded, n_valid, prompt, 128, sp.eot, *sup)
                fresh(mode, 128)          # rounds 0 .. 127
                for fn in (rounds, rounds, short, short):
                    fn()
                spans = [span_ms(rounds) for _ in range(3)]
                short_spans = [span_ms(short) for _ in range(3)]
                launches.clear()
                span_ms(rounds)
                launch_ms = statistics.median(launches)
                n_launches = len(launches)
                launches.clear()
                torch.cuda.synchronize()
                torch.cuda._sleep(500_000_000)   # ~0.3 s of cycles
                rounds()
                torch.cuda.synchronize()
                waits = [i for i, ms_ in enumerate(launches) if ms_ > 2.0]
                out.append({
                    "config": f"x5 speculative, {label}, bucket 16, 128 "
                              f"tokens, {mode}",
                    "graph_launches": n_launches,
                    "launch_host_ms": launch_ms,
                    "first_waiting_launch": waits[0] if waits else None,
                    "dispatch_host_ms": statistics.median(
                        h for _, h in spans),
                    "span_device_ms": statistics.median(d for d, _ in spans),
                    "short_dispatch_host_ms": statistics.median(
                        h for _, h in short_spans),
                    "short_span_device_ms": statistics.median(
                        d for d, _ in short_spans)})
    finally:
        generate._while_node, generate._GraphLoop = node, program
        torch.cuda.CUDAGraph.replay = replay
    return out


def main() -> None:
    import argparse

    import torch

    parser = argparse.ArgumentParser(prog="whisper_tpu_torch.profile_ladder")
    parser.add_argument("--fused-step", action="store_true",
                        help="run only the fully fused decode step")
    parser.add_argument("--fused-block", action="store_true",
                        help="run only the fused encoder block's two runs")
    parser.add_argument("--x7-one-shot", action="store_true",
                        help="run only x7, x5 on a one-shot file, B5 and B8")
    parser.add_argument("--decoding", action="store_true",
                        help="run only the decoding options, in turns")
    parser.add_argument("--graph", action="store_true",
                        help="run only x5, graphed and eager")
    parser.add_argument("--conditional", action="store_true",
                        help="run only the while node against per-step "
                             "launches of a flat capture of the same step and "
                             "round")
    parser.add_argument("--decode-ms", action="store_true",
                        help="run only x5's e2e and its graphed decode's "
                             "device ms, no row ending")
    parser.add_argument("--pools", action="store_true",
                        help="run only the bucket programs' memory pools "
                             "beside their live peaks, whisper-base and "
                             "whisper-large-v3-turbo")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("whisper_tpu_torch.profile_ladder needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile

    from whisper_tpu_torch.headline import (
        AUDIO_SECONDS,
        MODEL_ID,
        card_info,
        synth_audio,
    )
    from whisper_tpu_torch.models.convert import init_params
    from whisper_tpu_torch.models.registry import get_dims
    from whisper_tpu_torch.variants.quant import quantize_params

    card = card_info()
    # The first profiler session of a process sets up the tracing (seconds
    # of host time): spend it here, not inside the first configuration.
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
    if args.pools:
        for out in profile_pools():
            out["device"] = card
            print(json.dumps(out), flush=True)
        return
    dims = get_dims(MODEL_ID)
    params = init_params(dims, seed=0)
    if args.fused_step:
        out = profile_fused_step(params, dims)
        out["device"] = card
        print(json.dumps(out), flush=True)
        return
    if args.x7_one_shot:
        for out in profile_x7_one_shot(params):
            out["device"] = card
            print(json.dumps(out), flush=True)
        return
    audio = synth_audio(AUDIO_SECONDS)
    if args.conditional:
        for out in profile_conditional(params, audio):
            out["device"] = card
            print(json.dumps(out), flush=True)
        return
    if args.decode_ms:
        out = profile_decode_ms(params, audio)
        out["device"] = card
        print(json.dumps(out), flush=True)
        return
    if args.decoding:
        for out in profile_decoding(params, audio):
            out["device"] = card
            print(json.dumps(out), flush=True)
        return
    if args.graph:
        for eager in (False, True):
            label = "x5, greedy loop " + ("eager" if eager else "graphed")
            out = profile_config(label, "x5", {}, params, audio, eager=eager)
            out["device"] = card
            print(json.dumps(out), flush=True)
        return
    if args.fused_block:
        label, model_id, seconds, tokens = MEDIUM
        for out in (profile_config(*FUSED_BLOCK, params, audio),
                    profile_config(label, "x5",
                                   dict(model_id=model_id,
                                        fused_encoder_block=True),
                                   None, synth_audio(seconds),
                                   max_new_tokens=tokens)):
            out["device"] = card
            print(json.dumps(out), flush=True)
        return
    runs = [(*config, None) for config in CONFIGS]
    draft = (quantize_params(params), dims)
    runs += [(label, variant, {}, draft) for label, variant in SPECULATIVE]
    for label, variant, overrides, draft in runs:
        out = profile_config(label, variant, overrides, params, audio, draft)
        out["device"] = card
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
