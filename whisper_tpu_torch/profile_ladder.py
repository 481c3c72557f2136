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
its three kernels, whose means add up to one call), the mean span of a
call of the wrappers that launch several kernels on one another's heels
(B10c's FC1 and FC2, which overlap; B10a, B10b), and the five largest other
device operations.  It needs a CUDA card and raises without one.
"""

from __future__ import annotations

import json
import time
import warnings

# kernel function name in csrc/ -> the kernel's number
KERNELS = {"attn_kernel": "B1", "out_mlp_kernel": "B9b",
           "mlp_ln_kernel": "B2 (LayerNorm)", "BiasGelu": "B2 (FC1 product)",
           "BiasResidual": "B2 (FC2 product)",
           "self_step_int8_kernel": "B8", "self_step_kernel": "B3",
           "cross_step_kernel": "B4", "cross_dequant_kernel": "B6",
           "cross_multi_int8_kernel": "B7-i8",
           "cross_multi_dequant_kernel": "B7-dq",
           "log_mel_kernel": "B5", "ln_qkv_kernel": "B9a",
           "fc1_kernel": "B10c (FC1)", "fc2_kernel": "B10c (FC2)",
           "ln_gemm_kernel": "B10a/B10b (LN and product)",
           "self_attn_kernel": "B10a (attention)",
           "cross_attn_kernel": "B10b (attention)",
           "out_proj_kernel": "B10a/B10b (O product)"}
# A wrapper that launches several kernels, as they follow each other on the
# stream: a call's in-situ time is the span from its first kernel's start to
# its last one's end (B10c's FC2 starts before FC1 ends, so the two kernels'
# own times overlap and do not add up to a call).
CALLS = {"B10a": ("ln_gemm_kernel", "self_attn_kernel", "out_proj_kernel"),
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


def _kernel_of(name: str):
    for fn, label in KERNELS.items():
        # a kernel's name, or for gemm_kernel<BN, Epilogue> its epilogue's
        if any(fn + end in name for end in "<(>") or name.endswith(fn):
            return label
    return None


def _is(fn: str, name: str) -> bool:
    return any(fn + end in name for end in "<(")


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


def call_spans(prof) -> dict:
    """Mean in-situ time of each call of the wrappers in ``CALLS`` found in
    the trace, each call the span of its kernels (see ``CALLS``)."""
    from torch.autograd import DeviceType

    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    spans, i = {}, 0
    while i < len(events):
        for label, seq in CALLS.items():
            group = events[i:i + len(seq)]
            if len(group) == len(seq) and all(
                    _is(fn, e.name) for fn, e in zip(seq, group)):
                n, total = spans.get(label, (0, 0.0))
                spans[label] = (n + 1, total + group[-1].time_range.end
                                - group[0].time_range.start)
                i += len(seq)
                break
        else:
            i += 1
    return {k: {"calls": n, "mean_ms": total / n / 1e3}
            for k, (n, total) in sorted(spans.items())}


def profile_config(label: str, variant: str, overrides: dict, params,
                   audio, draft=None) -> dict:
    """One traced run of the workload; ``draft``: (params, dims) of a draft
    model, and then the run decodes speculatively with draft_k 4."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from whisper_tpu_torch.headline import make_session, run_once

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # x6's precedence note
        session = make_session("cuda", params, variant, **overrides)
    decode = {}
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
                out["device_ops"] / DECODE_STEPS,
            "device_busy_ms": busy_ms,
            "device_busy_share_of_traced_wall": busy_ms / 1e3 / wall,
            **{k: out[k] for k in ("kernels", "calls", "largest_other")}}


def main() -> None:
    import torch

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
    dims = get_dims(MODEL_ID)
    params = init_params(dims, seed=0)
    audio = synth_audio(AUDIO_SECONDS)
    runs = [(*config, None) for config in CONFIGS]
    draft = (quantize_params(params), dims)
    runs += [(label, variant, {}, draft) for label, variant in SPECULATIVE]
    for label, variant, overrides, draft in runs:
        out = profile_config(label, variant, overrides, params, audio, draft)
        out["device"] = card
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
