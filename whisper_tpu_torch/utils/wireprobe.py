"""The upload wire probe (port of ``whisper_tpu.utils.wireprobe``): time
each candidate wire on this process's link to the card, then pick one.

The candidates of ``--audio-transfer auto`` are int16 and the two delta
codings, all three bit-exact (``frontend.mel.decode_transfer``):

  int16   PCM, half the float32 bytes;
  dint16  first differences mod 2^16: as many bytes, but a link that
          compresses its payload finds their high bytes nearly constant
          on speech-like audio;
  dint16p the same differences zig-zagged, their high and low bytes in
          two contiguous planes, for a block compressor.

``--audio-transfer auto-pcm`` races pcm12 as well (a quarter fewer bytes on
any link; lossy, ``utils.pcmpack``).  A PCIe link to the card compresses
nothing, so there the race is mostly between bytes shipped and the host's
encode: what it picks is measured, not assumed.

A rate is the seconds one upload takes, host encode, the ``.to(device)``
copy and the device decode together: ``reps_big`` uploads less
``reps_small`` uploads, each batch between CUDA events on the card (a host
clock on the CPU), over the difference in count, so that what a batch
costs once (the first launch, the final synchronize) cancels.  The
selection rules are the JAX package's (``choose_audio_transfer``).
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["choose_audio_transfer", "probe_rates", "synth_speechlike"]


def synth_speechlike(seconds: float = 60.0, sr: int = 16_000) -> np.ndarray:
    """Deterministic chirp-and-noise signal whose delta-compressibility is
    in the regime of speech (mostly low-frequency energy, a small wideband
    floor)."""
    n = int(seconds * sr)
    rng = np.random.default_rng(42)
    t = np.arange(n, dtype=np.float64) / sr
    x = (
        0.3 * np.sin(2 * np.pi * (180 + 60 * np.sin(2 * np.pi * 0.7 * t)) * t)
        + 0.15 * np.sin(2 * np.pi * 920 * t)
        + 0.04 * rng.standard_normal(n)
    )
    return (0.5 * x).astype(np.float32)


def _seconds(device, work) -> float:
    """Seconds ``work()`` takes to its end on ``device``: CUDA events
    around it on the device's stream, a host clock on the CPU."""
    import torch

    if device.type != "cuda":
        t0 = time.perf_counter()
        work()
        return time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    work()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / 1e3


def probe_rates(
    audio: Optional[np.ndarray] = None,
    candidates: Tuple[str, ...] = ("int16", "dint16", "dint16p"),
    sample_s: float = 60.0,
    reps_big: int = 8,
    reps_small: int = 2,
    device=None,
) -> Dict[str, float]:
    """Seconds one upload of (a ``sample_s`` slice of) ``audio`` takes in
    each candidate wire on ``device`` (the card unless the caller asks for
    another): {mode: seconds}, ``inf`` where two tries both measured a
    difference of no more than 0."""
    import torch

    from whisper_tpu_torch.frontend.mel import decode_transfer, transfer_tag
    from whisper_tpu_torch.utils.device import resolve_device
    from whisper_tpu_torch.utils.pcmpack import encode_wire

    dev = resolve_device(device)
    if audio is None:
        audio = synth_speechlike(sample_s)
    n = min(len(audio), int(sample_s * 16_000))
    if audio.dtype == np.int16:
        # already PCM: clipping it to [-1, 1] would flatten it to +-1
        pcm = np.asarray(audio[:n])
    else:
        pcm = encode_wire(np.asarray(audio[:n], dtype=np.float32), "int16")

    def run(mode: str, reps: int) -> float:
        tag = transfer_tag(mode)
        sums = []

        def uploads():
            for _ in range(reps):
                wire = torch.from_numpy(encode_wire(pcm, mode)).to(dev)
                sums.append(decode_transfer(wire, tag).sum())

        return _seconds(dev, uploads)

    out: Dict[str, float] = {}
    for mode in candidates:
        run(mode, 1)          # warm: the decode's first launches, one upload
        delta = None
        for _attempt in range(2):
            t_small = run(mode, reps_small)
            t_big = run(mode, reps_big)
            delta = (t_big - t_small) / (reps_big - reps_small)
            if delta > 0:
                break
        # a mode measured twice as free is unmeasurable: it never wins on a
        # fluke (with auto-pcm a fluke could pick a lossy wire)
        out[mode] = delta if delta is not None and delta > 0 else float("inf")
    return out


_BYTES_PER_SAMPLE = {"int16": 2.0, "dint16": 2.0, "dint16p": 2.0,
                     "pcm12": 1.5, "pcm14": 1.75}


def choose_audio_transfer(
    audio: Optional[np.ndarray] = None,
    candidates: Tuple[str, ...] = ("int16", "dint16", "dint16p"),
    margin: float = 1.15,
    allow_pcm: bool = False,
    device=None,
) -> Tuple[str, Dict[str, float]]:
    """The fastest upload wire of ``candidates`` on this link: (mode,
    {mode: MB/s of audio bytes in that wire}).

    The first candidate (int16, no extra work) stays unless a later one is
    faster than it by more than ``margin``; among those that are, the
    fastest wins (the margin is taken against the first candidate, not a
    running best).  ``allow_pcm`` races pcm12 too (lossy, so opted into);
    pcm14 is not raced: its 12.5% fewer bytes sit under the 15% margin, so
    it could never win, and it stays an explicit ``--audio-transfer``."""
    if allow_pcm:
        candidates = tuple(candidates) + ("pcm12",)
    rates = probe_rates(audio, candidates, device=device)
    n_samples = min(
        len(audio) if audio is not None else int(60.0 * 16_000),
        int(60.0 * 16_000),
    )
    mbps = {m: n_samples * _BYTES_PER_SAMPLE.get(m, 2.0) / s / 1e6
            for m, s in rates.items()}
    first = candidates[0]
    qualifiers = [m for m in candidates[1:]
                  if rates[m] * margin < rates[first]]
    best = min(qualifiers, key=lambda m: rates[m], default=first)
    return best, mbps
