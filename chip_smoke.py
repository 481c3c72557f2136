"""Smoke run of the PyTorch/CUDA port on one NVIDIA card: ``python3 chip_smoke.py``.

What it does, in order (any failure raises and exits non-zero):

1. Requires CUDA; prints the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
   them.
2. Builds the four CUDA kernels of ``whisper_tpu_torch/csrc`` with nvcc
   (sm_90a) and prints the build time and each kernel's register use.
3. Runs each kernel (B1-B4) against its plain PyTorch version on the card
   at the shapes the main path gives it (whisper-base, rung x5, batch
   bucket 16), prints the largest difference and the time of one call of
   each (median of five runs of 20 calls).
4. Holds the port on the card against the port on the CPU (the kernels'
   plain versions) on a small input: an 80 s clip through the front end,
   the encoder and twelve teacher-forced decode steps.
5. Drives the main path, ``whisper_tpu_torch.headline``'s workload
   (whisper-base, random weights from seed 0, rung x5, the 301.574 s
   synthetic file), once to warm up and then three timed times, with every
   kernel's launch count set to 0 just before each run and read just after;
   asserts the token shape, identical tokens across runs, finite encoder
   states and logits, and that every kernel of the path was launched.
6. Prints one JSON line with the kernels, then, as the last line,
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import sys
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


def _bf16_steps(got, want) -> float:
    """Largest |got - want| in bf16 spacings (2^-7 relative) of the larger
    magnitude, the mean magnitude of ``want`` as the floor near zero."""
    import torch

    got, want = got.float(), want.float()
    scale = torch.maximum(torch.maximum(got.abs(), want.abs()),
                          want.abs().mean())
    return float(((got - want).abs() / (scale * 2.0 ** -7)).max())


def check_kernels(card: str) -> list:
    """Each kernel against its plain version at the main path's shapes."""
    import torch

    from whisper_tpu_torch.ops import attention, cross_attention, encoder_mlp
    from whisper_tpu_torch.ops import self_attention

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def randn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

    b, h, t, dh, d, f = 16, 8, 1500, 64, 512, 2048
    n_l, s_max, layer, pos = 6, 132, 3, 70
    rows = []

    # B1: q pre-scaled, as the encoder passes it.
    q, k, v = randn(b, h, t, dh, scale=dh ** -0.5), randn(b, h, t, dh), \
        randn(b, h, t, dh)
    rows.append(("fused_attention", attention, "attention.cu",
                 "whisper_tpu/ops/attention.py:75",
                 lambda: attention.fused_attention(q, k, v),
                 lambda: attention.fused_attention_plain(q, k, v), 2.0))

    # B2: dequantized int8 weights, as the encoder passes them.
    x = randn(b, t, d)
    ln_s, ln_b = 1.0 + randn(d, scale=0.1), randn(d, scale=0.1)
    w1 = (torch.randint(-127, 128, (d, f), generator=g, device=dev).to(bf)
          * torch.tensor(3e-4, dtype=bf))
    w2 = (torch.randint(-127, 128, (f, d), generator=g, device=dev).to(bf)
          * torch.tensor(3e-4, dtype=bf))
    b1, b2 = randn(f, scale=0.1), randn(d, scale=0.1)
    mlp_args = (x, ln_s, ln_b, w1, b1, w2, b2)
    rows.append(("fused_encoder_mlp", encoder_mlp, "encoder_mlp.cu",
                 "whisper_tpu/ops/encoder_mlp.py:224",
                 lambda: encoder_mlp.fused_encoder_mlp(*mlp_args),
                 lambda: encoder_mlp.fused_encoder_mlp_plain(*mlp_args), 2.0))

    # B3: the kernel writes row `pos` of the cache in place, so the kernel
    # and the plain version each get their own copy.
    qs, kn, vn = randn(b, h, dh, scale=dh ** -0.5), randn(b, h, dh), \
        randn(b, h, dh)
    kc, vc = randn(n_l, b, h, s_max, dh), randn(n_l, b, h, s_max, dh)
    kc2, vc2 = kc.clone(), vc.clone()
    pads = torch.zeros(b, dtype=torch.int32, device=dev)
    rows.append(("self_attend_step", self_attention, "self_attention.cu",
                 "whisper_tpu/ops/self_attention.py:470",
                 lambda: self_attention.self_attend_step(
                     qs, kn, vn, kc, vc, layer, pos, pads),
                 lambda: self_attention.self_attend_step_plain(
                     qs, kn, vn, kc2, vc2, layer, pos, pads), 2.0))

    # B4: the int8 cross cache as quantize_cross_kv leaves it.
    qx = randn(b, h, dh, scale=dh ** -0.5)
    k8 = torch.randint(-127, 128, (n_l, b, h, t, dh), generator=g,
                       device=dev, dtype=torch.int8)
    v8 = torch.randint(-127, 128, (n_l, b, h, t, dh), generator=g,
                       device=dev, dtype=torch.int8)
    ks = torch.rand(n_l, b, h, generator=g, device=dev) * 0.02 + 1e-3
    vs = torch.rand(n_l, b, h, generator=g, device=dev) * 0.02 + 1e-3
    rows.append(("cross_attend_step", cross_attention, "cross_attention.cu",
                 "whisper_tpu/ops/cross_attention.py:533",
                 lambda: cross_attention.cross_attend_step(
                     qx, k8, v8, ks, vs, 2, s_valid=t),
                 lambda: cross_attention.cross_attend_step_plain(
                     qx, k8, v8, ks, vs, 2, s_valid=t), 2.0))

    out = []
    for name, mod, src, replaces, kern, plain, tol in rows:
        got = kern()
        torch.cuda.synchronize()
        want = plain()
        torch.cuda.synchronize()
        steps = _bf16_steps(got, want)
        err = float((got.float() - want.float()).abs().max())
        if not torch.isfinite(got.float()).all():
            raise AssertionError(f"{name}: non-finite kernel output")
        if steps > tol:
            raise AssertionError(f"{name}: {steps:.2f} bf16 steps from the "
                                 f"plain version (tolerance {tol})")
        if name == "self_attend_step":
            # the in-place insert must leave both caches bitwise equal
            if not (torch.equal(kc, kc2) and torch.equal(vc, vc2)):
                raise AssertionError("self_attend_step: cache differs from "
                                     "the plain version's after the insert")
        ms, plain_ms = _median_ms(kern), _median_ms(plain)
        print(f"[kernel] {name}: max_abs_err {err:.3g} ({steps:.2f} bf16 "
              f"steps, tolerance {tol}); {ms:.4f} ms vs plain "
              f"{plain_ms:.4f} ms on {card}", flush=True)
        out.append({"name": name, "route": "cuda",
                    "source": f"whisper_tpu_torch/csrc/{src}",
                    "replaces": replaces, "module": mod,
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    return out


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


def check_main_path_finite(session, audio, dims) -> None:
    """The main path's encoder states and prefill logits for the file's
    chunk bucket (16 rows, the padding rows slicing zeros) are finite."""
    import torch

    from whisper_tpu_torch.frontend import golden
    from whisper_tpu_torch.models import whisper
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
    logits, _ = whisper.decoder_prefill(session._decoder_params, dims, prompt,
                                        enc, 4 + 128, int8_cross_kv=True)
    if not (torch.isfinite(enc).all() and torch.isfinite(logits).all()):
        raise AssertionError("non-finite encoder states or logits on the "
                             "main path")


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
        run_once,
        synth_audio,
    )
    from whisper_tpu_torch.models.convert import init_params
    from whisper_tpu_torch.models.registry import get_dims
    from whisper_tpu_torch.ops import kernels
    from whisper_tpu_torch.pipeline.chunk import chunk_starts

    card = card_info()
    print(card, flush=True)

    t0 = time.perf_counter()
    lib = kernels.build(extra_flags=("-Xptxas", "-v"))
    print(f"[build] {lib.parent.name}: {time.perf_counter() - t0:.1f} s "
          f"(nvcc: {kernels.build_seconds if kernels.build_seconds else 0:.1f}"
          " s, 0 = already built)", flush=True)
    log = lib.parent / "nvcc.log"
    if log.is_file():
        for line in log.read_text().splitlines():
            if "Used" in line or "spill" in line:
                print(f"[ptxas] {line.strip()}", flush=True)

    results = check_kernels(card)

    dims = get_dims(MODEL_ID)
    params = init_params(dims, seed=0)
    check_against_cpu(params, dims)

    session = make_session("cuda", params)
    audio = synth_audio(AUDIO_SECONDS)
    run_once(session, audio)  # warm-up
    runs, chains, counts = [], [], []
    for _ in range(3):
        for r in results:
            r["module"].launches = 0
        collector = []
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, timing = run_once(session, audio, token_collector=collector)
        runs.append((time.perf_counter() - t1, timing))
        counts.append({r["name"]: r["module"].launches for r in results})
        chains.append(collector[0])
    for c in counts:
        idle = [n for n, v in c.items() if v == 0]
        if idle:
            raise AssertionError(f"kernels not launched on the main path: "
                                 f"{idle}")
    toks = chains[0]
    n_chunks = len(chunk_starts(len(audio), 480_000, 400_000))  # 12
    if toks.shape != (n_chunks, 128):
        raise AssertionError(f"tokens {toks.shape}, expected "
                             f"({n_chunks}, 128)")
    if not ((toks >= 0) & (toks < dims.vocab_size)).all():
        raise AssertionError("token ids outside the vocabulary")
    for other in chains[1:]:
        if not (other == toks).all():
            raise AssertionError("two runs gave different tokens")
    check_main_path_finite(session, audio, dims)
    e2e, timing = sorted(runs, key=lambda r: r[0])[len(runs) // 2]
    print(f"[main path] whisper-base x5, {AUDIO_SECONDS} s, on {card}: "
          f"e2e {e2e:.4f} s, preprocess {timing.preprocess_s:.4f} s, model "
          f"{timing.model_only_s:.4f} s, decode {timing.decode_s:.4f} s, "
          f"{AUDIO_SECONDS / e2e:.2f}x real time (median of 3); launches "
          f"per run {counts[0]}", flush=True)

    for r in results:
        r["launches"] = counts[0][r["name"]]
        del r["module"]
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
