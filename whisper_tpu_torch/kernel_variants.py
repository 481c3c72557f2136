"""What holds the kernels redesigned for Hopper, by timed variants:
``python -m whisper_tpu_torch.kernel_variants``.

**B1** (encoder attention).  Builds ``csrc/attention.cu`` as it is and in
variants cut from its text, each into its own library under
``build/kernel_variants/``, and times one call of each at whisper-base
bucket 16 (B*H = 128, T = 1500, CUDA events over 20 calls, median of 5,
twice in alternation):

- ``no_ex2``: every ``ex2`` replaced by a multiplication (the special-
  function units idle);
- ``no_mma``: every ``wgmma`` replaced by one addition (the tensor cores
  idle);
- ``neither``: both, which leaves the loads, the barriers and the fp32
  arithmetic of the softmax;
- ``no_load``: the producer signals each tile full without copying it;
- ``two_consumers``: two consumer warpgroups of 240 registers a thread (128
  query rows a block) in place of three of 152.

Only the first variant's output means anything: the others exist to be
timed.  It also says how far the kernel as built and its plain version
each stand from the contract computed exactly (scores, softmax and P.V in
fp64, p and the output rounded to bf16 once), in bf16 steps of each of the
12.3 M outputs, with q at the encoder's scale (64^-0.5) and at 0.5, where
rows are sharply peaked: the largest distance and the share of outputs
more than one step away.

**B4** (the int8 decode cross-attention step).  Builds
``csrc/cross_attention.cu`` as it is and cut short, and times one call of
each at bucket 16 over a six-layer cache (148 MB, so no layer is found in
the 50 MB L2; 600 calls back to back, the layer rotating, median of 5):

- ``loads_only``: every block waits for its K and V segment and leaves;
- ``loads_and_barriers``: the same and the kernel's three cluster barriers;
- ``no_pv``: the whole kernel but the p8 . V8 product;
- ``max_carveout``: launched with the largest shared-memory carveout.

**B2** (the encoder MLP: LayerNorm, then two tiled wgmma products).  Builds
``csrc/encoder_mlp.cu`` with ``csrc/gemm_sm90.cuh`` written into it, as it
is and in variants, and times one call of each (all three kernels) at
whisper-base bucket 16 (24,000 rows, d = 512) and at whisper-medium's one
chunk (1,500 rows, d = 1,024):

- ``no_mma``: every ``wgmma`` replaced by one addition;
- ``no_load``: the producer signals each slot full without copying into it;
- ``no_epilogue``: the accumulators stored as they are, without bias, GELU
  or residual;
- ``one_block`` and ``two_blocks``: both products with one block an SM and a
  ring of 6 slots, or with two and rings of 3, whatever the grid (as built,
  the size of each product's grid chooses).

**B3** (the decode self-attention step).  Builds ``csrc/self_attention.cu``
as it is and cut short, and times one call of each at bucket 16 with
``pos`` 70 and 131 over a six-layer cache, the layer rotating: 600 calls
back to back from the host, where the host's launch rate is the limit, and
the same 600 launches captured in one CUDA graph and replayed, where the
card's is (median of 5 each):

- ``copies_only``: every block waits for its rows of K and V and leaves;
- ``no_pv``: the whole kernel but the P.V sum.

**B8** (the int8 decode self-attention step: B3's bulk copies, per-row
scales).  Builds ``csrc/self_attention_int8.cu`` as it is and cut short and
times it as B3 (``pos`` 70 and 131, an int; 600 calls from the host and in
one CUDA graph):

- ``copies_only``: every block quantizes, waits for its rows of K8 and V8
  and leaves;
- ``no_pv``: the whole kernel but the p8 . V8 product.

**B5** (the one-shot front end: a spectrum kernel, the normalization
kernel as its programmatic dependent).  Builds ``csrc/log_mel.cu`` as it is
and cut short and times one call at the one-shot limit (7,680 valid frames
of a 12,000-frame bucket, int16 PCM), eagerly and as 20 calls in one CUDA
graph:

- ``transform_only``: the spectrum kernel alone (the entry's ``normalize``
  0, as ``ops.log_mel.log_spec`` calls it);
- ``normalization_only``: the entry launches the normalization kernel
  alone (over what the buffer holds).

**B6 and B7-dq** (the dequantizing decode cross-attention step and its
speculative verify pass, one cluster of 192-thread blocks a (b, h), a block
a 192-row segment).  Builds ``csrc/cross_attention_dequant.cu`` and
``csrc/cross_attention_multi.cu``, ``csrc/cross_attention.cuh`` written into
each, as they are and cut short, and times one call of each as for B4 (B7-dq
with five queries a row, as the verify pass at draft_k = 4 gives it):

- ``copies_only``: every block waits for its K and V segments and leaves;
- ``no_pv``: the whole kernel but the p . V products of each segment;
- ``no_exchange``: every cluster barrier a block barrier and every write
  into another block's shared memory a write into the block's own (the
  blocks of a cluster no longer meet).

**B7-i8** (the int8 verify pass: B4's cluster, the queries in chunks of
eight).  Builds ``csrc/cross_attention_multi.cu`` with the shared header
written into it and times it at five queries a row as for B7-dq:

- ``copies_only``: every block waits for its K and V segments and leaves;
- ``copies_and_barriers``: the same and a chunk's two cluster barriers;
- ``phase1_only``: the copies, the first pass (scores and maxima) and its
  cluster barrier;
- ``phase1_and_v``: the same, each block waiting for its V too;
- ``no_phase2_groups``: the second pass without its work on the groups
  (scores, e, p8, the group sums, P.V), its exchanges and the finisher
  kept;
- ``no_exp``: e = s - max in place of exp(s - max);
- ``no_pv``: the whole kernel but the p8 . V8 products;
- ``local_adds``: every block adds its contexts into its own shared memory,
  not into the finisher's (wrong outputs: the cost of the remote adds);
- ``max_carveout``: launched with the largest shared-memory carveout (as
  built, the CUDA driver splits the SM's memory between L1 and shared
  memory).

**B10c** (the decode step's MLP block: FC1 over 16-column blocks, FC2 a
cluster of four launched as FC1's programmatic dependent).  Builds
``csrc/decoder_mlp.cu`` as it is and cut short, and times one call at
bucket 16 at d = 512 and 1,280, six layers' weights in rotation:

- ``fc1_only``: the wrapper launches FC1 and not FC2;
- ``no_pdl``: FC2 launched as a plain dependent (it starts when FC1 ends);
- ``copies_only``: each kernel waits for its weight copies (and FC2 for
  h) and leaves;
- ``fc1_only+no_ln`` and ``fc1_only+no_mma``: FC1 alone without its
  LayerNorm or without its product.

Each also as 600 calls captured in one CUDA graph and replayed, where the
card's rate is the limit and not the host's.

**B10a and B10b** (the fused decode step's self- and cross-attention
blocks: the LN-and-product kernel of ``decoder_block.cuh``, an attention
kernel launched as its programmatic dependent, the O product).  Builds
``csrc/decoder_self_block.cu`` and ``csrc/decoder_cross_block.cu``, the
shared header written into each, as they are and cut short, and times one
call at whisper-base bucket 16 (B10a with ``pos`` 70 of a 132-row cache,
B10b against 1,500 encoder positions), six layers in rotation (B10b's
cross K/V 295 MB, so no layer is found in L2), eagerly and as 600 calls in
one CUDA graph:

- ``ln_product_only``: the wrapper launches the LN-and-product kernel
  alone;
- ``copies_only``: each of the three kernels waits for its copies and
  leaves (the LN-and-product kernel: x, the LN parameters, its W slice; the
  attention: its K and V rows; the O product: its W slice and ctx);
- ``no_pv``: the attention without its P.V sums;
- ``no_pdl``: the attention kernel launched as a plain dependent;
- ``no_scores``: the attention without the q . k products (every score 0);
- ``late_v``: the attention asks for its first V block (B10b) or its cache
  rows (B10a) only once q is written, not while the product runs;
- ``other_trigger``: the LN-and-product kernel lets the attention start at
  the other of its two points (B10a's at its entry, not once its own
  copies have landed; B10b's the other way round);
- ``ln_product_only`` with ``no_stats`` (the LN statistics' sums skipped),
  ``no_mma`` (the fp64 product skipped) or ``no_exchange`` (each partial
  column written into the block's own shared memory, not its owner's):
  what the LN-and-product kernel's parts cost.

**B9a and B9b** (the fused encoder block: B9a a LayerNorm kernel and the
QKV product, B9b the O product into an fp32 residual, a LayerNorm kernel
and the two FFN products, all on ``csrc/gemm_sm90.cuh``).  Builds
``csrc/encoder_block.cu`` as it is and cut short, and times one call of B9a
at whisper-base bucket 16 and at whisper-medium's one chunk, and of B9b at
bucket 16, eagerly and in a CUDA graph of 20 calls:

- ``products_only``: the wrappers launch their products and not their
  LayerNorm kernels;
- ``ln_only``: the LayerNorm kernels alone;
- ``no_oproj``: B9b without its O product.

**The sampled pick** (each row split across the card; no Pallas
counterpart).  Builds ``csrc/gumbel_pick.cu`` as it is and in variants,
and times one call at bucket 16 and at bucket 1 over whisper-base's 51,865
ids, in a CUDA graph of 128 calls (in turns, forward and back):

- ``unroll_2``: the loop over a thread's groups unrolled twice, two
  groups' chains side by side;
- ``threads_256``: blocks of 256 threads, half as many an SM;
- ``one_group_a_thread``: twice the threads, so that each walks one group
  at bucket 16;
- ``no_merge``: every block writes its best as the row's id (no slot, no
  ticket; the id is then wrong);
- ``no_draw``: the loads, the reductions and the merge, each group's four
  logits compared as they are in place of the draw (what the launch, the
  loads and the merge cost).

``--pick-earlier FILE`` times, beside them and in the same turns, an
earlier pick kernel: a source with the C interface of the one-block-a-row
kernel, ``wt_gumbel_pick`` without the workspace (as ``git show
<commit>:whisper_tpu_torch/csrc/gumbel_pick.cu`` prints it for the commits
before the split), as ``earlier``.

Prints one JSON line for each kernel with the card's name and power limit.
It needs a CUDA card and nvcc and raises without them.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

B1_VARIANTS = ("as_built", "no_ex2", "no_mma", "neither", "no_load",
            "two_consumers")
_MMA_QK = "wgmma_m64n128k16_ss(s, dq + 2 * kk, dk + 2 * kk, kk > 0);"
_MMA_PV = ("wgmma_m64n64k16_rs(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],\n"
           "                           p[4 * kk + 3], "
           "dv + kk * (16 * DH * 2 / 16), 1);")
_LOAD = ("        tma_load_3d(s_ring + slot * TILE_BYTES, map, full(slot), 0, "
         "tile * BK,\n                    head);\n")


def _swap(text: str, old: str, new: str) -> str:
    if old not in text:
        raise RuntimeError(f"the source no longer holds {old!r}: bring "
                           "this script up to date")
    return text.replace(old, new)


def b1_source(text: str, name: str) -> str:
    """``attention.cu``'s text cut into the named variant."""
    if name in ("no_ex2", "neither"):
        text = _swap(text, "namespace {\n", "namespace {\nWT_DEV float "
                     "cheap(float x) { return x * 0.5f; }\n")
        text = _swap(text, "fast_exp2(", "cheap(")
    if name in ("no_mma", "neither"):
        text = _swap(text, _MMA_QK, "s[kk] += (float)(dq + dk);")
        text = _swap(text, _MMA_PV,
                     "o[kk] += __uint_as_float(p[4 * kk]) + (float)dv;")
    if name == "no_load":
        text = _swap(text, "mbar_arrive_expect_tx(full(slot), TILE_BYTES);",
                     "mbar_arrive(full(slot));")
        text = _swap(text, _LOAD, "")
    if name == "two_consumers":
        text = _swap(text, "constexpr int CONSUMERS = 3;",
                     "constexpr int CONSUMERS = 2;")
        text = _swap(text, "constexpr int PRODUCER_REGS = 56;",
                     "constexpr int PRODUCER_REGS = 24;")
        text = _swap(text, "constexpr int CONSUMER_REGS = 152;",
                     "constexpr int CONSUMER_REGS = 240;")
    return text


B4_VARIANTS = ("as_built", "loads_only", "loads_and_barriers", "no_pv",
               "max_carveout")
_B4_CFG = "  cudaLaunchConfig_t cfg = {};"
_CARVEOUT = """  cudaFuncSetAttribute((const void*)%s,
                       cudaFuncAttributePreferredSharedMemoryCarveout,
                       (int)cudaSharedmemCarveoutMaxShared);
"""
_B4_READY = "  __syncthreads();  // the barriers and q8 are visible\n"
_B4_LEAVE = """  mbar_wait(bar_k, 0);
  mbar_wait(bar_v, 0);
  %s
  if (tid < CROSS_DH && rank == 0)
    out[(size_t)head * CROSS_DH + tid] =
        __float2bfloat16_rn((float)(sK[tid] + sV[tid]));
  return;
"""


def b4_source(text: str, name: str) -> str:
    """``cross_attention.cu``'s text cut into the named variant."""
    if name == "loads_only":
        text = _swap(text, _B4_READY, _B4_READY + _B4_LEAVE % "")
    if name == "loads_and_barriers":
        text = _swap(text, _B4_READY, _B4_READY + _B4_LEAVE
                     % "cluster.sync(); cluster.sync(); cluster.sync();")
    if name == "no_pv":
        text = _swap(text, "    ctx += cross_pv<NT>(sP8, sV, rows, part);\n",
                     "")
    if name == "max_carveout":
        text = _swap(text, _B4_CFG, _CARVEOUT % "cross_step_kernel" + _B4_CFG)
    return text


B2_VARIANTS = ("as_built", "no_mma", "no_load", "no_epilogue", "one_block",
               "two_blocks")
_B2_CHOICE = "if (tiles(M, N) > SMS)"
_B2_MMA = ("        wgmma_m64n128k16_ss<1>(acc, da + 2 * kk, "
           "db + kk * (16 * 128 / 16), 1);\n")
_B2_LOADS = """        tma_load_2d(dst, &map_a, full(slot), s * BK, m0);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load_2d(dst + A_BYTES + j * B_BOX_BYTES, &map_b, full(slot),
                      n0 + 64 * j, s * BK);
"""


def b2_source(text: str, name: str) -> str:
    """``encoder_mlp.cu``'s text, the product's header written into it, cut
    into the named variant."""
    from whisper_tpu_torch.ops import kernels

    text = _swap(text, '#include "gemm_sm90.cuh"\n',
                 (kernels.CSRC / "gemm_sm90.cuh").read_text())
    if name == "no_mma":
        text = _swap(text, _B2_MMA, "        acc[kk] += (float)(da + db);\n")
    if name == "no_load":
        text = _swap(text, "mbar_arrive_expect_tx(full(slot), STAGE_BYTES);",
                     "mbar_arrive(full(slot));")
        text = _swap(text, _B2_LOADS, "        (void)dst;\n")
    if name in ("one_block", "two_blocks"):
        text = _swap(text, _B2_CHOICE,
                     "if (true)" if name == "two_blocks" else "if (false)")
    if name == "no_epilogue":
        text = _swap(text, "ffn::gelu_tanh(__fadd_rn(v0, __low2float(b)))",
                     "v0")
        text = _swap(text, "ffn::gelu_tanh(__fadd_rn(v1, __high2float(b)))",
                     "v1")
        text = _swap(
            text, "__fadd_rn(__low2float(xr), __fadd_rn(v0, __low2float(b)))",
            "v0")
        text = _swap(
            text,
            "__fadd_rn(__high2float(xr), __fadd_rn(v1, __high2float(b)))",
            "v1")
    return text


B9_VARIANTS = ("as_built", "products_only", "ln_only", "no_oproj")
_B9_SKIP = "namespace {\n\ntemplate <class... A>\nint skip(A...) { return 0; }\n"


def b9_source(text: str, name: str) -> str:
    """``encoder_block.cu``'s text cut into the named variant: the entry
    points skip their LayerNorm kernels (``products_only``), their products
    (``ln_only``) or B9b's O product (``no_oproj``)."""
    if name != "as_built":
        text = _swap(text, "namespace {\n", _B9_SKIP)
    if name == "products_only":
        text = _swap(text, "launch_ln(qkv_ln_of(d),", "skip(qkv_ln_of(d),")
        text = _swap(text, "launch_ln(out_ln_of(d),", "skip(out_ln_of(d),")
    if name == "ln_only":
        text = _swap(text, "gemm::run(", "skip(")
    if name == "no_oproj":
        text = _swap(text, "int rc = gemm::run(ctx, ow,",
                     "int rc = skip(ctx, ow,")
    return text


B3_VARIANTS = ("as_built", "copies_only", "no_pv")
_B3_WAIT = "  mbar_wait(bar, 0);\n"
_B3_LEAVE = """  if (tid < DH)
    out[row * DH + tid] = __float2bfloat16_rn(
        __bfloat162float(sK[tid]) + __bfloat162float(sV[tid]));
  return;
"""


def b3_source(text: str, name: str) -> str:
    """``self_attention.cu``'s text cut into the named variant."""
    if name == "copies_only":
        text = _swap(text, _B3_WAIT, _B3_WAIT + _B3_LEAVE)
    if name == "no_pv":
        text = _swap(text, "  for (int s = warp; s < n; s += NW) {",
                     "  for (int s = warp; s < 0; s += NW) {")
    return text


DQ_VARIANTS = ("as_built", "copies_only", "no_pv", "no_exchange")
_DQ_READY = ("  __syncthreads();  // the barriers are initialised\n"
             "  mbar_wait(bar_k, 0);\n")
_DQ_LEAVE = """  mbar_wait(bar_v, 0);
  if (rank == 0 && tid < CROSS_DH)
    out[(size_t)head * CROSS_DH + tid] =
        __float2bfloat16_rn((float)(sK[tid] + sV[tid]));
  return;
"""
_DQ_PV = """            dq_segment_pv(sS + (i * qmax + t) * CROSS_SEG, denom,
                          sV + (size_t)i * DQ_SEG_BYTES, seg_rows(i), col);
"""
_DQ_CLUSTER = ("template <int QC>\n__device__ __forceinline__ void "
               "cross_dequant_cluster(")


B8_VARIANTS = ("as_built", "copies_only", "no_pv")
_B8_LEAVE = """  if (tid < DH)
    out[row * DH + tid] = __float2bfloat16_rn((float)(sK[tid] + sV[tid]));
  return;
"""


def b8_source(text: str, name: str) -> str:
    """``self_attention_int8.cu``'s text cut into the named variant."""
    if name == "copies_only":
        text = _swap(text, _B3_WAIT, _B3_WAIT + _B8_LEAVE)
    if name == "no_pv":
        text = _swap(text, "  const int ctx = cross_pv<NT>(sP8, sV, n, part);",
                     "  const int ctx = sP8[0];")
    return text


B5_VARIANTS = ("as_built", "normalization_only")  # transform_only: a flag


def b5_source(text: str, name: str) -> str:
    """``log_mel.cu``'s text cut into the named variant."""
    if name == "normalization_only":
        text = _swap(text, "  if (is_int16)\n    mel_spectrum_kernel<",
                     "  if (false)\n    mel_spectrum_kernel<")
        text = _swap(text, "  else\n    mel_spectrum_kernel<",
                     "  else if (false)\n    mel_spectrum_kernel<")
    return text


def dq_source(text: str, name: str) -> str:
    """``cross_attention_dequant.cu``'s or ``cross_attention_multi.cu``'s
    text, the shared header written into it, cut into the named variant."""
    from whisper_tpu_torch.ops import kernels

    text = _swap(text, '#include "cross_attention.cuh"\n',
                 (kernels.CSRC / "cross_attention.cuh").read_text())
    # cut cross_dequant_cluster and what follows it, not the int8 kernel's
    # function before it
    head, text = text.split(_DQ_CLUSTER, 1)
    text = _DQ_CLUSTER + text
    if name == "copies_only":
        text = _swap(text, _DQ_READY, _DQ_READY + _DQ_LEAVE)
    if name == "no_pv":
        text = _swap(text, _DQ_PV, "            make_float2(denom, "
                     "(float)(col = 2 * (tid % 32)));\n")
    if name == "no_exchange":
        text = _swap(text, _DQ_CLUSTER, "template <class T>\n__device__ T* "
                     "own_shared(T* p, int) { return p; }\n" + _DQ_CLUSTER)
        text = _swap(text, "cluster_arrive_relaxed();", "")
        text = _swap(text, "if (t0 == 0) cluster_wait();", "")
        text = _swap(text, "cluster_arrive();\n    cluster_wait();",
                     "__syncthreads();")
        text = _swap(text, "cluster.map_shared_rank(", "own_shared(")
    return head + text


I8_VARIANTS = ("as_built", "copies_only", "copies_and_barriers",
               "phase1_only", "phase1_and_v", "no_phase2_groups", "no_exp",
               "no_pv", "local_adds", "max_carveout")
_I8_GROUP2 = "        if (rows > 0) {\n          int d[2][4];"
_I8_PHASE2 = ("    // ---- 2: e, p8, the sums of e, p8 . V8 into the query's "
              "finisher")
_I8_CFG = ("  cudaLaunchConfig_t cfg = {};\n"
           "  cfg.gridDim = dim3((unsigned)(B * H * n_rank));\n"
           "  cfg.blockDim = dim3(I8_NT);")
_I8_EXP = "ev[mt][e] = r < rows ? expf(__fsub_rn("
_I8_CLUSTER = "__device__ __forceinline__ void cross_int8_cluster("
_I8_READY = "    mbar_wait(bar_k, 0);\n\n    // ---- 1: scores"
_I8_LEAVE = """    mbar_wait(bar_k, 0);
    mbar_wait(bar_v, 0);
    %s
    if (rank == 0 && tid < CROSS_DH)
      out[((size_t)b * T * H + h) * CROSS_DH + tid] =
          __float2bfloat16_rn((float)(sK[tid] + sV[tid]));
    return;

    // ---- 1: scores"""
_I8_PV = ("            mma_m16n8k32_s8(ctx[mt], a[0], a[1], a[2], a[3], "
          "pw[c], pw[4 + c]);")
_I8_ADD = "dsmem_map(smem_u32(cctx + (n / n_rank) * CROSS_DH), n % n_rank)"


def i8_source(text: str, name: str) -> str:
    """``cross_attention_multi.cu``'s text, the shared header written into
    it, B7-i8 (``cross_int8_cluster``) cut into the named variant."""
    from whisper_tpu_torch.ops import kernels

    text = _swap(text, '#include "cross_attention.cuh"\n',
                 (kernels.CSRC / "cross_attention.cuh").read_text())
    head, text = text.split(_I8_CLUSTER, 1)
    body, tail = text.split(_DQ_CLUSTER, 1)
    if name == "copies_only":
        body = _swap(body, _I8_READY, _I8_LEAVE % "cluster_wait();")
    if name == "copies_and_barriers":
        body = _swap(body, _I8_READY, _I8_LEAVE
                     % "cluster_wait(); cluster_arrive(); cluster_wait(); "
                       "cluster_arrive(); cluster_wait();")
    if name == "no_pv":
        body = _swap(body, _I8_PV,
                     "            ctx[mt][0] += (int)(a[0] ^ a[3] ^ pw[c]);")
    if name == "phase1_only":
        body = _swap(body, _I8_PHASE2, "    return;\n" + _I8_PHASE2)
    if name == "phase1_and_v":
        body = _swap(body, _I8_PHASE2,
                     "    mbar_wait(bar_v, 0);\n    return;\n" + _I8_PHASE2)
    if name == "no_phase2_groups":
        body = _swap(body, _I8_GROUP2, _I8_GROUP2.replace("rows > 0", "false"))
    if name == "no_exp":
        body = _swap(body, _I8_EXP, _I8_EXP.replace("expf(", "("))
    if name == "max_carveout":
        tail = _swap(tail, _I8_CFG,
                     _CARVEOUT % "cross_multi_int8_kernel" + _I8_CFG)
    if name == "local_adds":
        body = _swap(body, _I8_ADD, _I8_ADD.replace("n % n_rank", "rank"))
    return head + _I8_CLUSTER + body + _DQ_CLUSTER + tail


B10C_VARIANTS = ("as_built", "fc1_only", "no_pdl", "copies_only",
                 "fc1_only+no_ln", "fc1_only+no_mma")
_B10C_FC1_LN = "  // LayerNorm in place while W1 lands:"
_B10C_FC1_LEAVE = """  cp_async_wait<0>();
  __syncthreads();
  if (threadIdx.x < NC)
    h[(size_t)row0 * F + c0 + threadIdx.x] = sW[threadIdx.x];
  return;
"""
_B10C_FC2_READY = ("  cp_async_wait<0>();\n  __syncthreads();\n\n"
                   "  const int kn = FQ / NW;")
_B10C_FC2_LEAVE = """  cp_async_wait<0>();
  __syncthreads();
  if (rank == 0 && threadIdx.x < NC && row0 < B)
    out[(size_t)row0 * D + c0 + threadIdx.x] = __float2bfloat16_rn(
        __bfloat162float(sW[threadIdx.x]) + __bfloat162float(sH[threadIdx.x]));
  return;

  const int kn = FQ / NW;"""
_B10C_LN = ("  {\n    const int r = threadIdx.x / 8, j = threadIdx.x % 8, "
            "nw = D / 8;")
_B10C_MMA = "  mma_tile_16x16(sR, RLD, sW, WLD, warp * kn, kn, d);"


def b10c_source(text: str, name: str) -> str:
    """``decoder_mlp.cu``'s text cut into the named variant (cuts joined by
    "+" are applied together)."""
    for cut in name.split("+"):
        if cut == "fc1_only":
            text = _swap(text, "  cudaLaunchConfig_t cfg = {};",
                         "  return 0;\n  cudaLaunchConfig_t cfg = {};")
        if cut == "no_pdl":
            text = _swap(text, "  cfg.numAttrs = 2;", "  cfg.numAttrs = 1;")
        if cut == "copies_only":
            text = _swap(text, _B10C_FC1_LN, _B10C_FC1_LEAVE + _B10C_FC1_LN)
            text = _swap(text, _B10C_FC2_READY, _B10C_FC2_LEAVE)
        if cut == "no_ln":
            text = _swap(text, _B10C_LN, "  if (false)" + _B10C_LN[1:])
        if cut == "no_mma":
            text = _swap(text, _B10C_MMA, """  for (auto& t : d)
    for (float& v : t)
      v = __bfloat162float(sR[threadIdx.x]) +
          __bfloat162float(sW[threadIdx.x]);""")
    return text


B10_VARIANTS = ("as_built", "ln_product_only", "copies_only", "no_pv",
                "no_pdl", "no_scores", "late_v", "other_trigger",
                "ln_product_only+no_stats",
                "ln_product_only+no_mma", "ln_product_only+no_exchange")
_B10B_FIRST = """    if (kb0 + warp < kb1) {
      fetch(sK, ck, kb0 + warp, bar_k);
      fetch(sV, cv, kb0 + warp, bar_v);
    }
  }
  grid_dependency_wait();  // ln_gemm has written q
"""
_B10B_LATE_V = """    if (kb0 + warp < kb1) fetch(sK, ck, kb0 + warp, bar_k);
  }
  grid_dependency_wait();  // ln_gemm has written q
  if (lane == 0 && kb0 + warp < kb1) fetch(sV, cv, kb0 + warp, bar_v);
"""
# (B10a's text, B10b's text) of each cut
_B10_SCORES = ("    for (int j = 0; j < DH / 8; ++j) {\n"
               "      const uint4 w = kr[(j + rot) & 7];",
               "        for (int j = 0; j < DH / 8; ++j) {\n"
               "          const uint4 w = kr[(j + rot) & 7];")
_B10_STATS = "    for (int wd = half * 32 + lane; wd < nw; wd += 64) {\n"
_B10_MMA = "    for (int k = 0; k < kw; k += 8) {\n"
_B10_EXCHANGE = ("    *cluster.map_shared_rank(red + (rank * BLK_RT + r) * CR"
                 " + c % CR,\n                             c / CR) = z;\n")
_B10_LN_READY = ("  cp_async_wait<0>();\n  __syncthreads();  // x's rows, "
                 "the LN parameters and W have landed\n")
_B10_LN_LEAVE = "  cp_async_wait<0>();\n  __syncthreads();\n  return;\n"
_B10_OUT_READY = ("  cp_async_wait<0>();\n  __syncthreads();\n\n"
                  "  const int kn = KQ / BLK_GW;")
_B10_OUT_LEAVE = """  cp_async_wait<0>();
  __syncthreads();
  if (rank == 0 && tid < OUT_NC && row0 < B)
    out[(size_t)row0 * D + c0 + tid] = sH[tid];
  return;

  const int kn = KQ / BLK_GW;"""
_B10A_READY = ("  cp_async_wait<0>();\n  __syncthreads();\n\n"
               "  // a thread a row;")
_B10A_LEAVE = """  cp_async_wait<0>();
  __syncthreads();
  if (tid < DH) ctx[head + tid] = sK[pos * DH + tid];
  return;

  // a thread a row;"""
_B10B_READY = "  __syncthreads();  // the barriers and q are visible\n"
_B10B_LEAVE = """  for (int kb = kb0 + warp, it = 0; kb < kb1; kb += NW, ++it) {
    mbar_wait(bar_k, it & 1);
    mbar_wait(bar_v, it & 1);
    __syncwarp();
    if (lane == 0 && kb + NW < kb1) {
      fetch(sK, ck, kb + NW, bar_k);
      fetch(sV, cv, kb + NW, bar_v);
    }
  }
  if (rank == 0 && tid < DH) ctx[(size_t)head * DH + tid] = sK[tid];
  return;
"""
# (B10a's text, B10b's text) of each cut
_B10_ONLY = ("  if (rc != 0) return rc;\n  // shared memory for S rows",
             "  if (rc != 0) return rc;\n  // about two blocks an SM")
_B10_PV = ("  for (int s = grp; s <= pos; s += NT / DH)\n",
           "    for (int s = 0; s < n; ++s) {\n")
_B10_TRIGGER = (("(float)DH), false, s);", "(float)DH), true, s);"),
                ("(float)DH), true, s);", "(float)DH), false, s);"))
_B10_PDL = ("dim3(B * H), NT, smem, s, 1, true,",
            "(unsigned)n_rank, true,")


def b10_source(text: str, name: str) -> str:
    """``decoder_self_block.cu``'s or ``decoder_cross_block.cu``'s text, the
    shared header written into it, cut into the named variant (cuts joined
    by "+" are applied together)."""
    from whisper_tpu_torch.ops import kernels

    k = 0 if "wt_decoder_self_block" in text else 1
    text = _swap(text, '#include "decoder_block.cuh"\n',
                 (kernels.CSRC / "decoder_block.cuh").read_text())
    for cut in name.split("+"):
        if cut == "ln_product_only":
            text = _swap(text, _B10_ONLY[k], _B10_ONLY[k].replace(
                "if (rc != 0) return rc;", "return rc;"))
        if cut == "copies_only":
            text = _swap(text, _B10_LN_READY, _B10_LN_LEAVE)
            text = _swap(text, _B10_OUT_READY, _B10_OUT_LEAVE)
            text = (_swap(text, _B10A_READY, _B10A_LEAVE) if k == 0 else
                    _swap(text, _B10B_READY, _B10B_READY + _B10B_LEAVE))
        if cut == "no_pv":
            text = _swap(text, _B10_PV[k], _B10_PV[k].replace(
                "s <= pos" if k == 0 else "s < n", "s < 0"))
        if cut == "no_pdl":
            text = _swap(text, _B10_PDL[k],
                         _B10_PDL[k].replace("true", "false"))
        if cut == "no_scores":
            text = _swap(text, _B10_SCORES[k],
                         _B10_SCORES[k].replace("j < DH / 8", "j < 0"))
        if cut == "late_v" and k == 1:
            text = _swap(text, _B10B_FIRST, _B10B_LATE_V)
        if cut == "late_v" and k == 0:   # B10a: its rows [0, pos) after q
            text = _swap(text, "  // rows [0, pos) of K, then of V",
                         "  grid_dependency_wait();\n"
                         "  // rows [0, pos) of K, then of V")
        if cut == "other_trigger":
            text = _swap(text, *_B10_TRIGGER[k])
        if cut == "no_stats":
            text = _swap(text, _B10_STATS, _B10_STATS.replace("nw;", "0;"))
        if cut == "no_mma":
            text = _swap(text, _B10_MMA, _B10_MMA.replace("kw;", "0;"))
        if cut == "no_exchange":
            text = _swap(text, _B10_EXCHANGE,
                         "    red[(rank * BLK_RT + r) * CR + c % CR] = z;\n")
    return text


PICK_VARIANTS = ("as_built", "unroll_2", "threads_256", "one_group_a_thread",
                 "no_merge", "no_draw")
_PICK_LOOP = "#pragma unroll 1\n  for (; g < stop; g += kThreads) {"
_PICK_MERGE = """  fold_max(slot, pack(best, best_id));
  if (take_ticket(slot + 1) == gridDim.x - 1) {
    unsigned long long won = atomicExch(slot, 0ull);
    slot[1] = 0;   // every block has taken its ticket
    tok[r] = (int)~(unsigned)won;
  }"""


def pick_source(text: str, name: str) -> str:
    """``gumbel_pick.cu``'s text cut into the named variant."""
    if name == "unroll_2":
        text = _swap(text, _PICK_LOOP,
                     _PICK_LOOP.replace("unroll 1", "unroll 2"))
    if name == "threads_256":
        text = _swap(text, "constexpr int kThreads = 128;\n"
                     "constexpr int kBlocksPerSM = 8;",
                     "constexpr int kThreads = 256;\n"
                     "constexpr int kBlocksPerSM = 4;")
    if name == "one_group_a_thread":
        text = _swap(text, "(long long)sm_count() * kBlocksPerSM * kThreads",
                     "(long long)sm_count() * 2 * kBlocksPerSM * kThreads")
    if name == "no_merge":
        text = _swap(text, _PICK_MERGE, "  tok[r] = best_id;")
    if name == "no_draw":
        text = _swap(text, "    visit<kDraws>(x, g, 4, d, best, best_id, "
                     "u_row, s_row);\n",
                     "    if (!(x[0] + x[1] + x[2] + x[3] <= best)) {\n"
                     "      best = x[0] + x[1] + x[2] + x[3];\n"
                     "      best_id = 4 * g;\n    }\n")
    return text


def _build(source: str, cut, names, stem: str = "") -> dict:
    """Each named variant of ``csrc/<source>`` as a loaded library, its
    files named ``<stem>_<variant>`` (by default the source's stem: two
    builds of one source need two stems, or the second loads the first's
    library of the same path)."""
    from whisper_tpu_torch.ops import kernels

    out_dir = kernels.BUILD_ROOT.parent / "kernel_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    text = (kernels.CSRC / source).read_text()
    stem = stem or source.split(".")[0]
    procs = []
    for name in names:
        src = out_dir / f"{stem}_{name.replace('+', '_and_')}.cu"
        src.write_text(cut(text, name))
        procs.append(subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC),
             "-shared", "-o", str(src.with_suffix(".so")), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, proc in zip(names, procs):
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {stem} variant {name}:\n{log}")
    return {name: ctypes.CDLL(str(
        out_dir / f"{stem}_{name.replace('+', '_and_')}.so"))
        for name in names}


def _median_ms(call, runs: int = 5, calls: int = 20) -> float:
    """One call of ``call(i)``: CUDA events around ``calls`` calls."""
    import torch

    call(0)
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(calls):
            call(i)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return sorted(times)[len(times) // 2]


def b1(card: str) -> dict:
    import torch

    from whisper_tpu_torch.ops.attention import fused_attention_plain

    libs = _build("attention.cu", b1_source, B1_VARIANTS)
    g = torch.Generator(device="cuda").manual_seed(0)
    b, h, t, dh = 16, 8, 1500, 64
    q, k, v = ((torch.randn(b, h, t, dh, generator=g, device="cuda")
                * s).to(torch.bfloat16) for s in (dh ** -0.5, 1.0, 1.0))
    ptr = ctypes.c_void_p
    stream = torch.cuda.current_stream().cuda_stream
    for lib in libs.values():
        lib.wt_fused_attention.argtypes = [ptr] * 4 + [ctypes.c_int] * 2 + [ptr]

    def run(lib, q_):
        out = torch.empty_like(q_)
        rc = lib.wt_fused_attention(q_.data_ptr(), k.data_ptr(), v.data_ptr(),
                                    out.data_ptr(), b * h, t, stream)
        if rc != 0:
            raise RuntimeError(f"launch failed with CUDA error {rc}")
        return out

    ms = {name: [_median_ms(lambda i, lib=lib: run(lib, q))]
          for name, lib in libs.items()}
    for name in reversed(B1_VARIANTS):
        ms[name].append(_median_ms(lambda i: run(libs[name], q)))

    def exact(q_):
        outs = []
        for i in range(b):      # a batch row at a time: fp64 scores are large
            sc = torch.matmul(q_[i].double(), k[i].double().transpose(-1, -2))
            probs = torch.softmax(sc, -1).to(torch.bfloat16)
            outs.append(torch.matmul(probs.double(), v[i].double())
                        .to(torch.bfloat16))
        return torch.stack(outs)

    def distance(got, want):
        got, want = got.float(), want.float()
        scale = torch.maximum(torch.maximum(got.abs(), want.abs()),
                              want.abs().mean())
        steps = (got - want).abs() / (scale * 2.0 ** -7)
        return {"max_steps": float(steps.max()),
                "share_over_1_step": float((steps > 1).float().mean())}

    accuracy = {}
    for q_scale in (dh ** -0.5, 0.5):
        q_ = (torch.randn(b, h, t, dh, generator=g, device="cuda")
              * q_scale).to(torch.bfloat16)
        got = run(libs["as_built"], q_)
        torch.cuda.synchronize()
        want, plain = exact(q_), fused_attention_plain(q_, k, v)
        accuracy[f"q_scale_{q_scale:g}"] = {
            "kernel_vs_exact": distance(got, want),
            "plain_vs_exact": distance(plain, want),
            "kernel_vs_plain": distance(got, plain)}
    return {"kernel": "B1", "card": card, "shape": [b, h, t, dh],
            "ms_per_call": ms, "bf16_steps": accuracy}


def b4(card: str) -> dict:
    import torch

    libs = _build("cross_attention.cu", b4_source, B4_VARIANTS)
    g = torch.Generator(device="cuda").manual_seed(0)
    n_l, b, h, s = 6, 16, 8, 1500
    k8, v8 = (torch.randint(-127, 128, (n_l, b, h, s, 64), generator=g,
                            device="cuda", dtype=torch.int8) for _ in "kv")
    ks, vs = (torch.rand(n_l, b, h, generator=g, device="cuda") * 0.02 + 1e-3
              for _ in "kv")
    q = (torch.randn(b, h, 64, generator=g, device="cuda")
         * 0.125).to(torch.bfloat16)
    out = torch.empty_like(q)
    ptr = ctypes.c_void_p
    stream = torch.cuda.current_stream().cuda_stream
    for lib in libs.values():
        lib.wt_cross_attend_step.argtypes = ([ptr] * 6 + [ctypes.c_int] * 5
                                             + [ptr])

    def run(lib, i):
        rc = lib.wt_cross_attend_step(
            q.data_ptr(), ks.data_ptr(), vs.data_ptr(), k8.data_ptr(),
            v8.data_ptr(), out.data_ptr(), b, h, s, i % n_l, s, stream)
        if rc != 0:
            raise RuntimeError(f"launch failed with CUDA error {rc}")

    us = {name: [] for name in B4_VARIANTS}
    for names in (B4_VARIANTS, tuple(reversed(B4_VARIANTS))):
        for name in names:
            us[name].append(1e3 * _median_ms(
                lambda i: run(libs[name], i), calls=600))
    return {"kernel": "B4", "card": card, "cache": [n_l, b, h, s, 64],
            "us_per_call": us}


def b6_b7_dequant(card: str) -> list:
    """B6 and B7-dq as built and cut short (``DQ_VARIANTS``), µs a call."""
    import torch

    libs = {"B6": _build("cross_attention_dequant.cu", dq_source,
                         DQ_VARIANTS),
            "B7-dq": _build("cross_attention_multi.cu", dq_source,
                            DQ_VARIANTS)}
    g = torch.Generator(device="cuda").manual_seed(0)
    n_l, b, h, s, n_q = 6, 16, 8, 1500, 5
    k8, v8 = (torch.randint(-127, 128, (n_l, b, h, s, 64), generator=g,
                            device="cuda", dtype=torch.int8) for _ in "kv")
    ks, vs = (torch.rand(n_l, b, h, generator=g, device="cuda") * 0.02 + 1e-3
              for _ in "kv")
    queries = {"B6": (b, h, 64), "B7-dq": (b, n_q, h, 64)}
    ptr = ctypes.c_void_p
    stream = torch.cuda.current_stream().cuda_stream
    out = []
    for kernel, by_name in libs.items():
        q = (torch.randn(*queries[kernel], generator=g, device="cuda")
             * 0.125).to(torch.bfloat16)
        res = torch.empty_like(q)
        n_int = 5 if kernel == "B6" else 6
        for lib in by_name.values():
            entry = (lib.wt_cross_attend_step_dequant if kernel == "B6"
                     else lib.wt_cross_attend_multi_dequant)
            entry.argtypes = [ptr] * 6 + [ctypes.c_int] * n_int + [ptr]

        def run(lib, i, kernel=kernel, q=q, res=res):
            dims = ((b, h) if kernel == "B6" else (b, n_q, h)) + (
                s, i % n_l, s)
            entry = (lib.wt_cross_attend_step_dequant if kernel == "B6"
                     else lib.wt_cross_attend_multi_dequant)
            rc = entry(q.data_ptr(), ks.data_ptr(), vs.data_ptr(),
                       k8.data_ptr(), v8.data_ptr(), res.data_ptr(), *dims,
                       stream)
            if rc != 0:
                raise RuntimeError(f"launch failed with CUDA error {rc}")

        us = {name: [] for name in DQ_VARIANTS}
        for names in (DQ_VARIANTS, tuple(reversed(DQ_VARIANTS))):
            for name in names:
                us[name].append(1e3 * _median_ms(
                    lambda i: run(by_name[name], i), calls=600))
        out.append({"kernel": kernel, "card": card,
                    "cache": [n_l, b, h, s, 64], "queries": list(q.shape),
                    "us_per_call": us})
    return out


def b7_int8(card: str) -> dict:
    """B7-i8 as built and cut short (``I8_VARIANTS``), µs a call at bucket
    16 with five queries a row, over a six-layer cache as for B4."""
    import torch

    libs = _build("cross_attention_multi.cu", i8_source, I8_VARIANTS,
                  stem="cross_attention_multi_int8")
    g = torch.Generator(device="cuda").manual_seed(0)
    n_l, b, h, s, n_q = 6, 16, 8, 1500, 5
    k8, v8 = (torch.randint(-127, 128, (n_l, b, h, s, 64), generator=g,
                            device="cuda", dtype=torch.int8) for _ in "kv")
    ks, vs = (torch.rand(n_l, b, h, generator=g, device="cuda") * 0.02 + 1e-3
              for _ in "kv")
    q = (torch.randn(b, n_q, h, 64, generator=g, device="cuda")
         * 0.125).to(torch.bfloat16)
    res = torch.empty_like(q)
    ptr = ctypes.c_void_p
    stream = torch.cuda.current_stream().cuda_stream
    for lib in libs.values():
        lib.wt_cross_attend_multi.argtypes = ([ptr] * 6 + [ctypes.c_int] * 6
                                              + [ptr])

    def run(lib, i):
        rc = lib.wt_cross_attend_multi(
            q.data_ptr(), ks.data_ptr(), vs.data_ptr(), k8.data_ptr(),
            v8.data_ptr(), res.data_ptr(), b, n_q, h, s, i % n_l, s, stream)
        if rc != 0:
            raise RuntimeError(f"launch failed with CUDA error {rc}")

    us = {name: [] for name in I8_VARIANTS}
    for names in (I8_VARIANTS, tuple(reversed(I8_VARIANTS))):
        for name in names:
            us[name].append(1e3 * _median_ms(
                lambda i: run(libs[name], i), calls=600))
    # as built at other batches and query counts (the first rows of the
    # same cache): how its time scales with the blocks and the queries
    by_shape = {}
    for b_, t_ in ((1, 5), (4, 5), (8, 5), (16, 1), (16, 8), (16, 9)):
        q_ = (torch.randn(b_, t_, h, 64, generator=g, device="cuda")
              * 0.125).to(torch.bfloat16)
        r_ = torch.empty_like(q_)

        def run_shape(i, b_=b_, t_=t_, q_=q_, r_=r_):
            rc = libs["as_built"].wt_cross_attend_multi(
                q_.data_ptr(), ks.data_ptr(), vs.data_ptr(), k8.data_ptr(),
                v8.data_ptr(), r_.data_ptr(), b_, t_, h, s, i % n_l, s,
                stream)
            if rc != 0:
                raise RuntimeError(f"launch failed with CUDA error {rc}")

        by_shape[f"B={b_},T={t_}"] = 1e3 * _median_ms(run_shape, calls=600)
    return {"kernel": "B7-i8", "card": card, "cache": [n_l, b, h, s, 64],
            "queries": list(q.shape), "us_per_call": us,
            "as_built_us_by_shape": by_shape}


def b10c(card: str) -> dict:
    """B10c as built and cut short (``B10C_VARIANTS``), µs a call at bucket
    16 at whisper-base (d = 512) and whisper-large (d = 1,280) widths, the
    weights of six layers in rotation as the decode step takes them."""
    import torch

    libs = _build("decoder_mlp.cu", b10c_source, B10C_VARIANTS)
    g = torch.Generator(device="cuda").manual_seed(0)
    bf, ptr = torch.bfloat16, ctypes.c_void_p
    stream = torch.cuda.current_stream().cuda_stream
    for lib in libs.values():
        lib.wt_decoder_mlp.argtypes = [ptr] * 8 + [ctypes.c_int] * 3 + [ptr]
    us, graph_us = {}, {}
    n_l, b = 6, 16
    for d in (512, 1280):
        f = 4 * d
        x = torch.randn(b, d, generator=g, device="cuda").to(bf)
        ln = torch.stack([torch.ones(d), torch.zeros(d)]).to(bf).cuda()
        w1, w2 = ((torch.randn(n_l, *shape, generator=g, device="cuda")
                   * 0.04).to(bf) for shape in ((d, f), (f, d)))
        b1 = torch.full((1, f), 0.1, dtype=bf, device="cuda")
        b2 = torch.full((1, d), 0.1, dtype=bf, device="cuda")
        h_ = torch.empty(b, f, dtype=bf, device="cuda")
        out = torch.empty_like(x)

        def run(lib, i, on=stream):
            rc = lib.wt_decoder_mlp(
                x.data_ptr(), ln.data_ptr(), w1[i % n_l].data_ptr(),
                b1.data_ptr(), w2[i % n_l].data_ptr(), b2.data_ptr(),
                h_.data_ptr(), out.data_ptr(), b, d, f, on)
            if rc != 0:
                raise RuntimeError(f"launch failed with CUDA error {rc}")

        def graph_of(lib, calls=600):
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                capturing = torch.cuda.current_stream().cuda_stream
                for i in range(calls):
                    run(lib, i, capturing)
            return graph

        at = us.setdefault(f"d_{d}", {v: [] for v in B10C_VARIANTS})
        graphs = {v: graph_of(libs[v]) for v in B10C_VARIANTS}
        in_graph = graph_us.setdefault(f"d_{d}",
                                       {v: [] for v in B10C_VARIANTS})
        for names in (B10C_VARIANTS, tuple(reversed(B10C_VARIANTS))):
            for name in names:
                at[name].append(1e3 * _median_ms(
                    lambda i: run(libs[name], i), calls=600))
                in_graph[name].append(1e3 / 600 * _median_ms(
                    lambda i: graphs[name].replay(), calls=1))
    return {"kernel": "B10c", "card": card, "rows": b, "layers": n_l,
            "us_per_call": us, "us_per_call_in_a_cuda_graph": graph_us}


def b10ab(card: str) -> list:
    """B10a and B10b as built and cut short (``B10_VARIANTS``), µs a call at
    bucket 16, six layers in rotation (see the module's docstring); and
    the span of a call as built and where in it each kernel runs, traced in
    a CUDA graph of 20 calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from whisper_tpu_torch.profile_ladder import call_spans, call_timelines

    libs = {"B10a": _build("decoder_self_block.cu", b10_source,
                           B10_VARIANTS),
            "B10b": _build("decoder_cross_block.cu", b10_source,
                           B10_VARIANTS)}
    g = torch.Generator(device="cuda").manual_seed(0)
    bf, ptr, i32 = torch.bfloat16, ctypes.c_void_p, ctypes.c_int
    for lib in libs["B10a"].values():
        lib.wt_decoder_self_block.argtypes = [ptr] * 11 + [i32] * 5 + [ptr,
                                                                     ptr]
    for lib in libs["B10b"].values():
        lib.wt_decoder_cross_block.argtypes = [ptr] * 11 + [i32] * 4 + [ptr]
    n_l, b, d, h, s, pos, t = 6, 16, 512, 8, 132, 70, 1500

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device="cuda")
                * scale).to(bf)

    x = randn(b, d)
    ln = torch.stack([torch.ones(d), torch.zeros(d)]).to(bf).cuda()
    qkv_w, o_w, q_w = (randn(n_l, d, n, scale=0.04)
                       for n in (3 * d, d, d))
    qkv_b, o_b = randn(1, 3 * d, scale=0.1), randn(1, d, scale=0.1)
    ck, cv = randn(n_l, s, b, d), randn(n_l, s, b, d)
    xk, xv = randn(n_l, b, h, t, 64), randn(n_l, b, h, t, 64)
    qbuf = torch.empty(b, d, dtype=torch.float32, device="cuda")
    ctx, out = torch.empty_like(x), torch.empty_like(x)

    def run(kernel, lib, i, on):
        j = i % n_l
        if kernel == "B10a":
            rc = lib.wt_decoder_self_block(
                x.data_ptr(), ln.data_ptr(), qkv_w[j].data_ptr(),
                qkv_b.data_ptr(), o_w[j].data_ptr(), o_b.data_ptr(),
                ck[j].data_ptr(), cv[j].data_ptr(), qbuf.data_ptr(),
                ctx.data_ptr(), out.data_ptr(), b, d, h, s, pos, None, on)
        else:
            rc = lib.wt_decoder_cross_block(
                x.data_ptr(), ln.data_ptr(), q_w[j].data_ptr(),
                qkv_b.data_ptr(), o_w[j].data_ptr(), o_b.data_ptr(),
                xk[j].data_ptr(), xv[j].data_ptr(), qbuf.data_ptr(),
                ctx.data_ptr(), out.data_ptr(), b, d, h, t, on)
        if rc != 0:
            raise RuntimeError(f"launch failed with CUDA error {rc}")

    def graph_of(kernel, lib, calls=600):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            capturing = torch.cuda.current_stream().cuda_stream
            for i in range(calls):
                run(kernel, lib, i, capturing)
        return graph

    stream = torch.cuda.current_stream().cuda_stream
    lines = []
    for kernel, by_name in libs.items():
        names_of = tuple(by_name)
        us = {v: [] for v in names_of}
        graph_us = {v: [] for v in names_of}
        for lib in by_name.values():   # built and warm before a capture
            run(kernel, lib, 0, stream)
        graphs = {v: graph_of(kernel, by_name[v]) for v in names_of}
        for names in (names_of, names_of[::-1]):
            for name in names:
                us[name].append(1e3 * _median_ms(
                    lambda i: run(kernel, by_name[name], i, stream),
                    calls=600))
                graph_us[name].append(1e3 / 600 * _median_ms(
                    lambda i: graphs[name].replay(), calls=1))
        # where each kernel of a call runs, in a graph of 20 calls
        traced = graph_of(kernel, by_name["as_built"], calls=20)
        traced.replay()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            traced.replay()
            torch.cuda.synchronize()
        lines.append({"kernel": kernel, "card": card, "rows": b,
                      "layers": n_l, "cache_rows": s, "pos": pos,
                      "encoder_positions": t, "us_per_call": us,
                      "us_per_call_in_a_cuda_graph": graph_us,
                      "as_built_call_in_a_cuda_graph": {
                          "spans": call_spans(prof),
                          "timelines_us": call_timelines(prof)}})
    return lines


def b2(card: str) -> dict:
    import torch

    libs = _build("encoder_mlp.cu", b2_source, B2_VARIANTS)
    g = torch.Generator(device="cuda").manual_seed(0)
    bf, ptr = torch.bfloat16, ctypes.c_void_p
    stream = torch.cuda.current_stream().cuda_stream
    for lib in libs.values():
        lib.wt_fused_encoder_mlp.argtypes = ([ptr] * 10 + [ctypes.c_int] * 3
                                             + [ptr])
    ms = {}
    for n, d in ((24000, 512), (1500, 1024)):
        f = 4 * d
        x, w1, w2 = ((torch.randn(*shape, generator=g, device="cuda")
                      * scale).to(bf)
                     for shape, scale in (((n, d), 1.0), ((d, f), 0.04),
                                          ((f, d), 0.04)))
        ln_s, ln_b, b1, b2_ = (torch.full((k,), v, dtype=bf, device="cuda")
                               for k, v in ((d, 1.0), (d, 0.1), (f, 0.1),
                                            (d, 0.1)))
        r, out = torch.empty_like(x), torch.empty_like(x)
        h = torch.empty(n, f, dtype=bf, device="cuda")

        def run(lib):
            rc = lib.wt_fused_encoder_mlp(
                x.data_ptr(), ln_s.data_ptr(), ln_b.data_ptr(), w1.data_ptr(),
                b1.data_ptr(), w2.data_ptr(), b2_.data_ptr(), r.data_ptr(),
                h.data_ptr(), out.data_ptr(), n, d, f, stream)
            if rc != 0:
                raise RuntimeError(f"launch failed with CUDA error {rc}")

        shape = ms.setdefault(f"rows_{n}_d_{d}", {v: [] for v in B2_VARIANTS})
        for names in (B2_VARIANTS, tuple(reversed(B2_VARIANTS))):
            for name in names:
                shape[name].append(_median_ms(lambda i: run(libs[name])))
    return {"kernel": "B2", "card": card, "ms_per_call": ms}


def b9(card: str) -> list:
    """B9a and B9b as built and cut short (``B9_VARIANTS``; B9a without
    ``no_oproj``, which does not touch it), ms a call eagerly and in a
    CUDA graph of 20 calls: B9a at whisper-base bucket 16 (24,000 rows,
    d = 512) and at whisper-medium's one chunk (1,500 rows, d = 1,024),
    B9b at bucket 16."""
    import torch

    libs = _build("encoder_block.cu", b9_source, B9_VARIANTS)
    g = torch.Generator(device="cuda").manual_seed(0)
    bf, ptr, i32 = torch.bfloat16, ctypes.c_void_p, ctypes.c_int
    for lib in libs.values():
        lib.wt_fused_ln_qkv.argtypes = [ptr] * 7 + [i32] * 3 + [ptr]
        lib.wt_fused_out_mlp.argtypes = [ptr] * 14 + [i32] * 3 + [ptr]

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device="cuda")
                * scale).to(bf)

    def qkv_call(n, d):
        x, w, bias = randn(n, d), randn(d, 3 * d, scale=0.04), randn(3 * d)
        ln_s, ln_b = 1.0 + randn(d, scale=0.1), randn(d, scale=0.1)
        r, out = torch.empty_like(x), torch.empty(n, 3 * d, dtype=bf,
                                                  device="cuda")

        def run(lib, on):
            return lib.wt_fused_ln_qkv(
                x.data_ptr(), ln_s.data_ptr(), ln_b.data_ptr(), w.data_ptr(),
                bias.data_ptr(), r.data_ptr(), out.data_ptr(), n, d, 3 * d,
                on)
        return run

    def out_mlp_call(n, d):
        f = 4 * d
        x, ctx = randn(n, d), randn(n, d)
        o_w, w1, w2 = (randn(*s, scale=0.04) for s in ((d, d), (d, f),
                                                       (f, d)))
        o_b, b1, b2 = randn(d, scale=0.1), randn(f, scale=0.1), \
            randn(d, scale=0.1)
        ln_s, ln_b = 1.0 + randn(d, scale=0.1), randn(d, scale=0.1)
        y32 = torch.empty(n, d, device="cuda")
        r, out = torch.empty_like(x), torch.empty_like(x)
        h = torch.empty(n, f, dtype=bf, device="cuda")

        def run(lib, on):
            return lib.wt_fused_out_mlp(
                x.data_ptr(), ctx.data_ptr(), o_w.data_ptr(), o_b.data_ptr(),
                ln_s.data_ptr(), ln_b.data_ptr(), w1.data_ptr(),
                b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), y32.data_ptr(),
                r.data_ptr(), h.data_ptr(), out.data_ptr(), n, d, f, on)
        return run

    stream = torch.cuda.current_stream().cuda_stream
    lines = []
    for kernel, n, d, run, names in (
            ("B9a", 24000, 512, qkv_call(24000, 512), B9_VARIANTS[:3]),
            ("B9a", 1500, 1024, qkv_call(1500, 1024), B9_VARIANTS[:3]),
            ("B9b", 24000, 512, out_mlp_call(24000, 512), B9_VARIANTS)):
        def call(lib, on):
            rc = run(lib, on)
            if rc != 0:
                raise RuntimeError(f"launch failed with CUDA error {rc}")

        def graph_of(lib, calls=20):
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                capturing = torch.cuda.current_stream().cuda_stream
                for _ in range(calls):
                    call(lib, capturing)
            return graph

        for name in names:   # built and warm before a capture
            call(libs[name], stream)
        graphs = {v: graph_of(libs[v]) for v in names}
        ms = {v: [] for v in names}
        graph_ms = {v: [] for v in names}
        for order in (names, names[::-1]):
            for name in order:
                ms[name].append(_median_ms(
                    lambda i: call(libs[name], stream)))
                graph_ms[name].append(_median_ms(
                    lambda i: graphs[name].replay(), calls=1) / 20)
        lines.append({"kernel": kernel, "card": card, "rows": n, "d": d,
                      "ms_per_call": ms,
                      "ms_per_call_in_a_cuda_graph": graph_ms})
    return lines


def b3(card: str) -> dict:
    import torch

    libs = _build("self_attention.cu", b3_source, B3_VARIANTS)
    g = torch.Generator(device="cuda").manual_seed(0)
    n_l, b, h, s = 6, 16, 8, 132
    bf, ptr = torch.bfloat16, ctypes.c_void_p
    kc, vc = (torch.randn(n_l, b, h, s, 64, generator=g,
                          device="cuda").to(bf) for _ in "kv")
    q, kn, vn = ((torch.randn(b, h, 64, generator=g, device="cuda")
                  * sc).to(bf) for sc in (0.125, 1.0, 1.0))
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream
    for lib in libs.values():
        lib.wt_self_attend_step.argtypes = ([ptr] * 7 + [ctypes.c_int] * 5
                                            + [ptr, ptr])

    def run(lib, i, pos, on):
        rc = lib.wt_self_attend_step(
            q.data_ptr(), kn.data_ptr(), vn.data_ptr(), kc.data_ptr(),
            vc.data_ptr(), None, out.data_ptr(), b, h, s, i % n_l, pos, None,
            on)
        if rc != 0:
            raise RuntimeError(f"launch failed with CUDA error {rc}")

    def graph_of(lib, pos, calls=600):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            capturing = torch.cuda.current_stream().cuda_stream
            for i in range(calls):
                run(lib, i, pos, capturing)
        return graph

    us, graph_us = {}, {}
    for pos in (70, 131):
        at = us.setdefault(f"pos_{pos}", {v: [] for v in B3_VARIANTS})
        graphs = {v: graph_of(libs[v], pos) for v in B3_VARIANTS}
        in_graph = graph_us.setdefault(f"pos_{pos}",
                                       {v: [] for v in B3_VARIANTS})
        for names in (B3_VARIANTS, tuple(reversed(B3_VARIANTS))):
            for name in names:
                at[name].append(1e3 * _median_ms(
                    lambda i: run(libs[name], i, pos, stream), calls=600))
                in_graph[name].append(1e3 / 600 * _median_ms(
                    lambda i: graphs[name].replay(), calls=1))
    return {"kernel": "B3", "card": card, "cache": [n_l, b, h, s, 64],
            "us_per_call": us, "us_per_call_in_a_cuda_graph": graph_us}


def b8(card: str) -> dict:
    import torch

    from whisper_tpu_torch.ops.self_attention import quantize_self_cache

    libs = _build("self_attention_int8.cu", b8_source, B8_VARIANTS)
    g = torch.Generator(device="cuda").manual_seed(0)
    n_l, b, h, s = 6, 16, 8, 132
    bf, ptr = torch.bfloat16, ctypes.c_void_p
    bufs = quantize_self_cache(*(torch.randn(n_l, b, h, s, 64, generator=g,
                                             device="cuda").to(bf)
                                 for _ in "kv"))
    q, kn, vn = ((torch.randn(b, h, 64, generator=g, device="cuda")
                  * sc).to(bf) for sc in (0.125, 1.0, 1.0))
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream
    for lib in libs.values():
        lib.wt_self_attend_step_int8.argtypes = ([ptr] * 9
                                                 + [ctypes.c_int] * 5
                                                 + [ptr, ptr])

    def run(lib, i, pos, on):
        rc = lib.wt_self_attend_step_int8(
            q.data_ptr(), kn.data_ptr(), vn.data_ptr(),
            *(x.data_ptr() for x in bufs), None, out.data_ptr(), b, h, s,
            i % n_l, pos, None, on)
        if rc != 0:
            raise RuntimeError(f"launch failed with CUDA error {rc}")

    def graph_of(lib, pos, calls=600):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            capturing = torch.cuda.current_stream().cuda_stream
            for i in range(calls):
                run(lib, i, pos, capturing)
        return graph

    us, graph_us = {}, {}
    for pos in (70, 131):
        at = us.setdefault(f"pos_{pos}", {v: [] for v in B8_VARIANTS})
        graphs = {v: graph_of(libs[v], pos) for v in B8_VARIANTS}
        in_graph = graph_us.setdefault(f"pos_{pos}",
                                       {v: [] for v in B8_VARIANTS})
        for names in (B8_VARIANTS, tuple(reversed(B8_VARIANTS))):
            for name in names:
                at[name].append(1e3 * _median_ms(
                    lambda i: run(libs[name], i, pos, stream), calls=600))
                in_graph[name].append(1e3 / 600 * _median_ms(
                    lambda i: graphs[name].replay(), calls=1))
    return {"kernel": "B8", "card": card, "cache": [n_l, b, h, s, 64],
            "us_per_call": us, "us_per_call_in_a_cuda_graph": graph_us}


def b5(card: str) -> dict:
    import numpy as np
    import torch

    from whisper_tpu_torch.frontend import golden
    from whisper_tpu_torch.headline import synth_audio
    from whisper_tpu_torch.ops import log_mel

    libs = _build("log_mel.cu", b5_source, B5_VARIANTS)
    valid, n_frames, n_mels = 7680, 12000, 80
    pcm = np.round(np.clip(golden.reflect_pad(synth_audio(
        valid * golden.HOP / 16000.0)), -1, 1) * 32767.0)
    wire = torch.from_numpy(pcm.astype(np.int16)).cuda()
    tables = log_mel._device_tables(wire.device, n_mels)
    out = torch.empty((n_mels, n_frames), device="cuda")
    tile_max = torch.empty(n_frames // log_mel.TILE_FRAMES, device="cuda")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for lib in libs.values():
        lib.wt_log_mel.argtypes = ([ptr, i32, ctypes.c_longlong] + [ptr] * 6
                                   + [i32, i32, i32, ctypes.c_float, i32, ptr])

    # variant -> (library, the entry's normalize flag)
    calls = {"as_built": (libs["as_built"], 1),
             "transform_only": (libs["as_built"], 0),
             "normalization_only": (libs["normalization_only"], 1)}

    def run(name, on):
        lib, normalize = calls[name]
        rc = lib.wt_log_mel(wire.data_ptr(), 1, wire.shape[0],
                            *(x.data_ptr() for x in tables), out.data_ptr(),
                            tile_max.data_ptr(), n_frames, valid, n_mels,
                            log_mel.INT16_SCALE, normalize, on)
        if rc != 0:
            raise RuntimeError(f"launch failed with CUDA error {rc}")

    stream = torch.cuda.current_stream().cuda_stream
    graphs = {}
    for name in calls:
        run(name, stream)
        graphs[name] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[name]):
            capturing = torch.cuda.current_stream().cuda_stream
            for _ in range(20):
                run(name, capturing)
    ms = {v: [] for v in calls}
    graph_ms = {v: [] for v in calls}
    for names in (tuple(calls), tuple(reversed(calls))):
        for name in names:
            ms[name].append(_median_ms(lambda i: run(name, stream)))
            graph_ms[name].append(_median_ms(
                lambda i: graphs[name].replay(), calls=1) / 20)
    return {"kernel": "B5", "card": card, "frames": [valid, n_frames],
            "n_mels": n_mels, "ms_per_call": ms,
            "ms_per_call_in_a_cuda_graph": graph_ms}


def pick(card: str, earlier=None) -> dict:
    import torch

    from whisper_tpu_torch.ops import kernels, sampling

    libs = _build("gumbel_pick.cu", pick_source, PICK_VARIANTS)
    for lib in libs.values():
        lib.wt_gumbel_pick.argtypes = kernels.SIGNATURES["wt_gumbel_pick"]
    variants = PICK_VARIANTS
    if earlier:
        # an absolute path: csrc's own is not joined to it
        libs.update(_build(str(Path(earlier).resolve()), lambda text, _: text,
                           ("earlier",), stem="gumbel_pick"))
        no_ws = kernels.SIGNATURES["wt_gumbel_pick"]
        libs["earlier"].wt_gumbel_pick.argtypes = no_ws[:7] + no_ws[8:]
        variants += ("earlier",)
    g = torch.Generator(device="cuda").manual_seed(0)
    vocab = 51865
    logits = torch.randn(16, vocab, generator=g, device="cuda") * 4.0
    logits[:, ::50] = float("-inf")
    temp = torch.full((1,), 0.5, device="cuda")
    key = sampling.generator_key(
        torch.Generator(device="cuda").manual_seed(3), "cuda")
    step = torch.full((1,), 7, dtype=torch.int64, device="cuda")
    us = {}
    for rows in (16, 1):
        x = logits[:rows].contiguous()
        ws = sampling.pick_workspace(rows, "cuda")
        tok = torch.empty(rows, dtype=torch.int64, device="cuda")

        def graph_of(lib, calls=128):
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                capturing = torch.cuda.current_stream().cuda_stream
                ptrs = (x.data_ptr(), temp.data_ptr(), key.data_ptr(),
                        step.data_ptr(), tok.data_ptr(), None, None)
                ptrs += () if lib is libs.get("earlier") else (ws.data_ptr(),)
                for _ in range(calls):
                    rc = lib.wt_gumbel_pick(*ptrs, rows, vocab, 0, capturing)
                    if rc != 0:
                        raise RuntimeError(f"launch failed with CUDA error "
                                           f"{rc}")
            return graph

        want = sampling.gumbel_pick_plain(x, temp, key, step)
        graphs = {v: graph_of(libs[v]) for v in variants}
        at = us.setdefault(f"bucket_{rows}", {v: [] for v in variants})
        for names in (variants, tuple(reversed(variants))):
            for name in names:
                at[name].append(1e3 / 128 * _median_ms(
                    lambda i: graphs[name].replay(), calls=1))
                if name != "no_merge" and name != "no_draw" and \
                        not torch.equal(tok, want):
                    raise AssertionError(f"pick variant {name} at {rows} "
                                         "rows: an id differs from the plain "
                                         "version's")
    return {"kernel": "gumbel_pick", "card": card, "vocab": vocab,
            "us_per_call_in_a_cuda_graph": us}


def main() -> None:
    import torch

    runs = {"b1": b1, "b4": b4, "b6_b7_dequant": b6_b7_dequant,
            "b7_int8": b7_int8, "b10c": b10c, "b10ab": b10ab, "b2": b2,
            "b3": b3, "b9": b9, "b8": b8, "b5": b5, "pick": pick}
    parser = argparse.ArgumentParser(prog="whisper_tpu_torch.kernel_variants")
    parser.add_argument("kernels", nargs="*", metavar="KERNEL",
                        help=f"any of {', '.join(runs)} (default: all)")
    parser.add_argument("--pick-earlier", metavar="FILE",
                        help="an earlier pick kernel's source, timed beside "
                             "the pick's variants")
    args = parser.parse_args()
    names = args.kernels or list(runs)
    unknown = sorted(set(names) - set(runs))
    if unknown:
        parser.error(f"unknown kernels {unknown}")
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants needs a CUDA card")
    from whisper_tpu_torch.headline import card_info

    card = card_info()
    for name in names:
        lines = (pick(card, args.pick_earlier) if name == "pick"
                 else runs[name](card))
        for line in lines if isinstance(lines, list) else [lines]:
            print(json.dumps(line), flush=True)

if __name__ == "__main__":
    main()
