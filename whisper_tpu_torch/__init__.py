"""whisper_tpu_torch — the PyTorch and CUDA port of ``whisper_tpu``.

It runs the chunked long-form path (log-mel, encoder, greedy, sampled,
speculative or beam decoding, the timestamp grammar, language detection,
the temperature-fallback ladder, stitching) at rungs x0-x7 and ``int8``,
and the reference-compatible benchmark CLI over it (``python -m
whisper_tpu_torch.bench``; any audio libav reads through the native
decoder, ``native/``), on one NVIDIA H100 or a mesh of processes, one a
card (``parallel/``: data and tensor parallelism over
``torch.distributed``), through hand-written CUDA kernels for Hopper
(``csrc/``, built with nvcc at first use), among them:

- B1 ``ops.attention.fused_attention``: encoder self-attention
- B2 ``ops.encoder_mlp.fused_encoder_mlp``: encoder LN + MLP + residual,
  at every width (the TPU's chunked variant B2c included)
- B3 ``ops.self_attention.self_attend_step``: decode self-attention with
  an in-place cache insert
- B4 ``ops.cross_attention.cross_attend_step``: int8 x int8 decode
  cross-attention (x5)
- B5 ``ops.log_mel.log_mel``: the one-shot log-mel front end (x3+)
- B6 ``ops.cross_attention.cross_attend_step_dequant``: decode
  cross-attention with the int8 cache dequantized in the kernel (x4)

The layout mirrors ``whisper_tpu``, which stays the reference: each module
here is the counterpart of the module of the same path there.  This
package imports torch and never jax, and nothing of ``whisper_tpu``.  On a
CPU tensor each kernel wrapper runs its plain PyTorch version (what the
CPU tests hold against the JAX package); on a CUDA tensor it launches the
kernel or raises.
"""

__version__ = "0.1.0"
