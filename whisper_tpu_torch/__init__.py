"""whisper_tpu_torch — the PyTorch and CUDA port of ``whisper_tpu``.

It runs the long-form main path (rung x5: streamed log-mel, encoder,
greedy decoding, stitching) on an NVIDIA H100 through four hand-written
CUDA kernels for Hopper (``csrc/``, built with nvcc at first use):

- B1 ``ops.attention.fused_attention``: encoder self-attention
- B2 ``ops.encoder_mlp.fused_encoder_mlp``: encoder LN + MLP + residual
- B3 ``ops.self_attention.self_attend_step``: decode self-attention with
  an in-place cache insert
- B4 ``ops.cross_attention.cross_attend_step``: int8 x int8 decode
  cross-attention

The layout mirrors ``whisper_tpu``, which stays the reference: each module
here is the counterpart of the module of the same path there.  This
package imports torch and never jax, and nothing of ``whisper_tpu``.  On a
CPU tensor each kernel wrapper runs its plain PyTorch version (what the
CPU tests hold against the JAX package); on a CUDA tensor it launches the
kernel or raises.
"""

__version__ = "0.1.0"
