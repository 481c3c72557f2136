"""B9a and B9b: the fused encoder block's two kernels (port of
``whisper_tpu.ops.encoder_block``).

One encoder layer through ``cfg.fused_encoder_block`` is three kernels:
``fused_ln_qkv`` (B9a: LN1 -> one [d, 3d] product for Q, K and V), the
encoder attention kernel B1, and ``fused_out_mlp`` (B9b: O-projection +
residual + LN2 + FC1 + tanh GELU + FC2 + residual).

``fused_ln_qkv`` replaces the JAX package's Pallas ``fused_ln_qkv``
(``_ln_qkv_kernel``), whole and column-chunked (``c_block``) alike: the
output columns are independent, so both give the same values and the port
has one kernel.  ``fused_out_mlp`` replaces ``fused_out_mlp``
(``_out_mlp_kernel``): LN2 reads the UNROUNDED fp32 residual y32, the
final residual adds the bf16-ROUNDED y, as there.

On a CUDA tensor each launches its hand-written Hopper kernels in
``csrc/encoder_block.cu``, B2's pieces under names of their own: B9a a
LayerNorm kernel into a bf16 scratch r, then the tiled ``wgmma`` product
of ``csrc/gemm_sm90.cuh`` with the bias in its epilogue (two device
operations a call); B9b that product for the O-projection with its
residual written in fp32 into a scratch y32, the LayerNorm kernel over
y32, and the two FFN products, FC1 with bias and GELU into a scratch h,
FC2 with bias and the residual on the rounded y32 (four device operations
a call).  The scratch belongs to the call (``torch.empty``): 172 MB for
B9b at whisper-base bucket 16.  On a CPU tensor each takes its
``*_plain`` version.  Any other device raises.

``fits_vmem`` and ``qkv_chunk_plan`` are copies of the JAX package's VMEM
predicates (and ``mlp_fits_vmem``/``mlp_chunk_plan`` of
``whisper_tpu.ops.encoder_mlp``'s).  The H100 has no such budget; the port
keeps them as a selector of NUMERICS only: ``fused_block_mode`` picks, as
``encoder_apply`` does in JAX, between the "whole" composition (B9a, B1,
B9b) and the "chunked" one (B9a, B1, a plain O-projection whose residual
is rounded to the activation dtype, then B2), which round differently, so
that the port gives the JAX package's values at every model size.
"""

from __future__ import annotations

from typing import Optional

import torch

from whisper_tpu_torch.ops import kernels
from whisper_tpu_torch.ops.common import (
    COUNT_LOCK,
    check_operand,
    gelu_tanh,
    route,
)
from whisper_tpu_torch.ops.encoder_mlp import F_CHUNK, KERNEL_WIDTHS, LN_EPS

QKV_WIDTHS = KERNEL_WIDTHS              # B9a d_model instantiations (B2's)
OUT_MLP_WIDTHS = (128, 384, 512, 768)   # B9b d_model instantiations
QKV_COL_TILE = 128  # the product's column tile: 3d must be a multiple

ln_qkv_launches = 0   # B9a kernel launches since the last reset
out_mlp_launches = 0  # B9b kernel launches since the last reset

_VMEM_WEIGHT_BUDGET = 12 * 2 ** 20
_QKV_CHUNK_BUDGET = 6 * 2 ** 20
_F_CHUNK_BUDGET = 6 * 2 ** 20


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def fits_vmem(d: int, f: int, dtype: torch.dtype) -> bool:
    """The JAX package's ``encoder_block.fits_vmem``: O [d,d] + FC1 [d,f] +
    FC2 [f,d], double-buffered, inside 12 MiB."""
    return 2 * (d * d + 2 * d * f) * _itemsize(dtype) <= _VMEM_WEIGHT_BUDGET


def qkv_chunk_plan(d: int, dtype: torch.dtype) -> Optional[int]:
    """The JAX package's ``encoder_block.qkv_chunk_plan``: the largest
    multiple of 128 that divides 3d inside the chunk budget, or None."""
    best = None
    blk = 128
    while blk <= 3 * d:
        if (3 * d) % blk == 0 and 4 * d * blk * _itemsize(dtype) \
                <= _QKV_CHUNK_BUDGET:
            best = blk
        blk += 128
    return best


def mlp_fits_vmem(d: int, f: int, dtype: torch.dtype) -> bool:
    """The JAX package's ``encoder_mlp.fits_vmem``."""
    return 2 * (2 * d * f * _itemsize(dtype)) <= _VMEM_WEIGHT_BUDGET


def mlp_chunk_plan(d: int, f: int, dtype: torch.dtype) -> Optional[int]:
    """The JAX package's ``encoder_mlp.chunk_plan``: the largest multiple
    of 128 that divides f inside the chunk budget, or None."""
    best = None
    blk = 128
    while blk <= f:
        if f % blk == 0 and 4 * d * blk * _itemsize(dtype) <= _F_CHUNK_BUDGET:
            best = blk
        blk += 128
    return best


def fused_block_mode(d: int, f: int, dtype: torch.dtype) -> Optional[str]:
    """Which composition ``encoder_apply(fused_block=True)`` runs, chosen
    as the JAX package chooses it: "whole", "chunked", or None where JAX
    falls back to the unfused block.  A selector of numerics, not of
    memory: the three round differently (see the module docstring)."""
    if fits_vmem(d, f, dtype):
        return "whole"
    if qkv_chunk_plan(d, dtype) is None:
        return None
    if not mlp_fits_vmem(d, f, dtype) and mlp_chunk_plan(d, f, dtype) is None:
        return None
    return "chunked"


def _ln32(x32, ln_s, ln_b):
    mean = x32.mean(dim=-1, keepdim=True)
    var = torch.square(x32 - mean).mean(dim=-1, keepdim=True)
    r = (x32 - mean) * torch.rsqrt(var + LN_EPS)
    return r * ln_s.float() + ln_b.float()


def fused_ln_qkv_plain(x, ln_s, ln_b, w_qkv, b_qkv) -> torch.Tensor:
    """Reference version of B9a: the JAX kernel's math in plain PyTorch."""
    r = _ln32(x.float(), ln_s, ln_b).to(x.dtype)
    y = torch.matmul(r.float(), w_qkv.float()) + b_qkv.float()
    return y.to(x.dtype)


def fused_ln_qkv(x: torch.Tensor, ln_s: torch.Tensor, ln_b: torch.Tensor,
                 w_qkv: torch.Tensor, b_qkv: torch.Tensor) -> torch.Tensor:
    """x [B, T, d] -> LN(x) @ w_qkv + b_qkv as [B, T, 3d]; ``w_qkv`` is
    [q_w | k_w | v_w] along the output axis, ``b_qkv`` carries zeros for
    K."""
    if route(x) == "plain":
        return fused_ln_qkv_plain(x, ln_s, ln_b, w_qkv, b_qkv)
    global ln_qkv_launches
    b, t, d = x.shape
    c = w_qkv.shape[1]
    if d not in QKV_WIDTHS or c % QKV_COL_TILE:
        raise ValueError(f"fused_ln_qkv kernel: d={d} not in {QKV_WIDTHS} or "
                         f"{c} output columns not a multiple of "
                         f"{QKV_COL_TILE}")
    bf = torch.bfloat16
    check_operand("x", x, bf, (b, t, d), x.device)
    for name, a, shape in (("ln_s", ln_s, (d,)), ("ln_b", ln_b, (d,)),
                           ("w_qkv", w_qkv, (d, c)), ("b_qkv", b_qkv, (c,))):
        check_operand(name, a, bf, shape, x.device)
    out = torch.empty((b, t, c), dtype=bf, device=x.device)
    r = torch.empty_like(x)  # LN1(x): scratch of this call
    lib = kernels.library()
    kernels.check(lib.wt_fused_ln_qkv(
        x.data_ptr(), ln_s.data_ptr(), ln_b.data_ptr(), w_qkv.data_ptr(),
        b_qkv.data_ptr(), r.data_ptr(), out.data_ptr(), b * t, d, c,
        kernels.stream_ptr(x.device)), "fused_ln_qkv")
    with COUNT_LOCK:
        ln_qkv_launches += 1
    return out


def fused_out_mlp_plain(x, ctx, o_w, o_b, ln_s, ln_b, w1, b1, w2,
                        b2) -> torch.Tensor:
    """Reference version of B9b: the JAX kernel's math in plain PyTorch."""
    o = torch.matmul(ctx.float(), o_w.float()) + o_b.float()
    y32 = x.float() + o
    y = y32.to(x.dtype)
    r = _ln32(y32, ln_s, ln_b).to(x.dtype)
    h = torch.matmul(r.float(), w1.float()) + b1.float()
    h = gelu_tanh(h).to(x.dtype)
    z = torch.matmul(h.float(), w2.float()) + b2.float()
    return (y.float() + z).to(x.dtype)


def fused_out_mlp(x: torch.Tensor, ctx: torch.Tensor, o_w: torch.Tensor,
                  o_b: torch.Tensor, ln_s: torch.Tensor, ln_b: torch.Tensor,
                  w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                  b2: torch.Tensor) -> torch.Tensor:
    """y = x + ctx @ o_w + o_b; returns y + FC2(GELU_tanh(FC1(LN(y)))).
    x: the pre-attention residual stream [B, T, d]; ctx: the merged
    attention context [B, T, d]; w1 [d, f], w2 [f, d]."""
    if route(x) == "plain":
        return fused_out_mlp_plain(x, ctx, o_w, o_b, ln_s, ln_b, w1, b1, w2,
                                   b2)
    global out_mlp_launches
    b, t, d = x.shape
    f = w1.shape[1]
    if d not in OUT_MLP_WIDTHS or f % F_CHUNK:
        raise ValueError(f"fused_out_mlp kernel: d={d} not in "
                         f"{OUT_MLP_WIDTHS} or f={f} not a multiple of "
                         f"{F_CHUNK}")
    bf = torch.bfloat16
    for name, a, shape in (("x", x, (b, t, d)), ("ctx", ctx, (b, t, d)),
                           ("o_w", o_w, (d, d)), ("o_b", o_b, (d,)),
                           ("ln_s", ln_s, (d,)), ("ln_b", ln_b, (d,)),
                           ("w1", w1, (d, f)), ("b1", b1, (f,)),
                           ("w2", w2, (f, d)), ("b2", b2, (d,))):
        check_operand(name, a, bf, shape, x.device)
    out = torch.empty_like(x)
    # scratch of this call: the fp32 residual, LN2 of it, the FFN's hidden
    y32 = torch.empty((b * t, d), dtype=torch.float32, device=x.device)
    r = torch.empty_like(x)
    h = torch.empty((b * t, f), dtype=bf, device=x.device)
    lib = kernels.library()
    kernels.check(lib.wt_fused_out_mlp(
        x.data_ptr(), ctx.data_ptr(), o_w.data_ptr(), o_b.data_ptr(),
        ln_s.data_ptr(), ln_b.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), y32.data_ptr(), r.data_ptr(),
        h.data_ptr(), out.data_ptr(), b * t, d, f,
        kernels.stream_ptr(x.device)), "fused_out_mlp")
    with COUNT_LOCK:
        out_mlp_launches += 1
    return out
