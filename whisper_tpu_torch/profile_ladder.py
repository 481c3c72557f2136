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
its three kernels, whose means add up to one call), and the five largest
other device operations.  It needs a CUDA card and raises without one.
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
           "fc1_kernel": "B10c (FC1 phase)", "fc2_kernel": "B10c (FC2 phase)"}
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


def profile_config(label: str, variant: str, overrides: dict, params,
                   audio, draft=None) -> dict:
    """One traced run of the workload; ``draft``: (params, dims) of a draft
    model, and then the run decodes speculatively with draft_k 4."""
    import torch
    from torch.autograd import DeviceType
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
        "config": label, "traced_wall_s": wall, "device_ops": ops,
        "device_ops_per_decode_step_upper": ops / DECODE_STEPS,
        "device_busy_ms": busy_us / 1e3,
        "device_busy_share_of_traced_wall": busy_us / 1e6 / wall,
        "kernels": {k: {"launches": n, "mean_ms": total / n / 1e3,
                        "total_ms": total / 1e3}
                    for k, (n, total) in sorted(mine.items())},
        "largest_other": [{"name": name, "count": n, "total_ms": us / 1e3}
                          for us, n, name in other[:5]],
    }


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
