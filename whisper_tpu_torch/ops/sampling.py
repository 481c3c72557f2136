"""The sampled token pick of a decode step: a Gumbel-max draw whose random
bits are a counter-based Philox keyed by the loop's state.

``gumbel_pick(logits, temperature, key, step, row0)`` returns, for each row
r of the fp32 logits [B, V], the id of the largest

    logits[r, v] / T - log(E),   E = max(-log(u), FLT_MIN),

with ``u`` the Philox4x32-10 uniform of (``step``, global row ``row0 + r``,
``v``) under ``key``: the distribution ``jax.random.categorical`` draws
from.  The JAX package draws on the TPU inside its ``lax.while_loop``, the
key in the loop's carry and split once a step
(``whisper_tpu/runtime/generate.py:97-111, 158-159, 195``); here the key is
a [2] int64 tensor of the loop's state, (seed, offset) of the caller's
``torch.Generator`` (``generator_key``), and the step the loop's [1] int64
step counter, both read on the card with T, so a CUDA graph of the step
draws anew at every iteration of its while node.  Philox4x32-10 (Salmon et
al., SC'11, as Random123 defines it) under key (seed low word, seed high
word ^ offset high word) and counter (v // 4, row0 + r, step, offset low
word) gives four words, one for each id 4g .. 4g + 3; a word x becomes u =
((x >> 9) + 0.5) / 2^23, exact in fp32, never 0 or 1.  The floor on E keeps
a suppressed id (-inf) from ever being drawn.  A tie goes to the lowest
id, NaN counting as the largest (``torch.argmax``'s rule).  A data rank
passes its first row's place in the batch as ``row0``: it draws its own
rows, those of the one-process decode, without the others'.

On a CUDA tensor ``gumbel_pick`` launches the hand-written kernel
``csrc/gumbel_pick.cu`` (each row split across the card's SMs, the blocks'
bests met in the same launch through a [B, 2] int64 ``workspace`` that
every launch leaves zero; it replaces no Pallas kernel: see its header);
on a CPU tensor it takes ``gumbel_pick_plain``, which
does the same arithmetic in PyTorch (Philox in int64 tensor arithmetic
masked to 32 bits, no product above 2^49; the division a true division by
a tensor; ``torch.log``), bitwise the kernel on the card.  Any other
device raises.
"""

from __future__ import annotations

import sys

import torch

from whisper_tpu_torch.ops import kernels
from whisper_tpu_torch.ops.common import count_launch, route

launches = 0  # kernel launches since the last reset (plain calls excluded)

_M0, _M1 = 0xD2511F53, 0xCD9E8D57     # Philox4x32's multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85     # its key increments (Weyl)
_MASK = 0xFFFFFFFF


def _signed(x: int) -> int:
    """A 64-bit word as the int64 that holds its bits."""
    x &= (1 << 64) - 1
    return x - (1 << 64) if x >> 63 else x


def generator_key(generator: torch.Generator, device) -> torch.Tensor:
    """The [2] int64 key (seed, offset) of ``generator`` on ``device``:
    its initial seed and, for a generator on a card, its Philox offset (a
    CPU generator has none: 0).  A generator on another kind of device
    than ``device`` raises.  Filled on the card, no copy from the host."""
    device = torch.device(device)
    if generator.device.type != device.type:
        raise RuntimeError(f"generator on {generator.device}, the draws on "
                           f"{device}")
    offset = generator.get_offset() if device.type == "cuda" else 0
    key = torch.full((2,), _signed(generator.initial_seed()),
                     dtype=torch.int64, device=device)
    key[1:].fill_(_signed(offset))
    return key


def _mulhilo(a: torch.Tensor, m: int):
    """(high, low) 32-bit words of a * m, for int64 ``a`` holding 32-bit
    values and a 32-bit constant ``m``, through two products of under 49
    bits."""
    p_lo = a * (m & 0xFFFF)
    p_hi = a * (m >> 16)
    hi = (p_hi + (p_lo >> 16)) >> 16
    lo = (((p_hi & 0xFFFF) << 16) + p_lo) & _MASK
    return hi, lo


def philox4x32_10(counter, key):
    """Philox4x32-10 of ``counter`` (four int64 tensors of 32-bit words,
    broadcast together) under ``key`` (two such tensors or ints): the four
    output words, int64 tensors."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for i in range(10):
        if i:
            k0 = (k0 + _W0) & _MASK
            k1 = (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def uniforms_plain(rows: int, vocab: int, key: torch.Tensor,
                   step: torch.Tensor, row0: int = 0) -> torch.Tensor:
    """The uniforms u [rows, vocab] fp32 of ``step`` (a [1] int64 tensor)
    for global rows row0 .. row0 + rows - 1 under ``key`` ([2] int64), on
    the key's device, read nowhere on the host."""
    dev = key.device
    seed, offset = key[0:1, None], key[1:2, None]
    k = (seed & _MASK, ((seed >> 32) ^ (offset >> 32)) & _MASK)
    groups = -(-vocab // 4)
    c = (torch.arange(groups, dtype=torch.int64, device=dev)[None, :],
         torch.arange(row0, row0 + rows, dtype=torch.int64,
                      device=dev)[:, None],
         step.reshape(1, 1) & _MASK, offset & _MASK)
    words = torch.stack(philox4x32_10(c, k), dim=-1)       # [rows, G, 4]
    x = words.reshape(rows, 4 * groups)[:, :vocab]
    return ((x >> 9).float() + 0.5) * 2.0 ** -23


def gumbel_scores_plain(logits: torch.Tensor, temperature: torch.Tensor,
                        key: torch.Tensor, step: torch.Tensor,
                        row0: int = 0):
    """(u, scores): the uniforms and logits / T - log(E), [B, V] fp32."""
    u = uniforms_plain(logits.shape[0], logits.shape[1], key, step, row0)
    e = (-torch.log(u)).clamp_min(torch.finfo(torch.float32).tiny)
    return u, logits / temperature - torch.log(e)


def gumbel_pick_plain(logits, temperature, key, step, row0: int = 0):
    """Reference version: the ids [B] int64 of the largest scores."""
    return torch.argmax(
        gumbel_scores_plain(logits, temperature, key, step, row0)[1], -1)


def pick_workspace(rows: int, device) -> torch.Tensor:
    """The pick kernel's workspace for ``rows`` rows: [rows, 2] int64
    zeros on ``device`` (each row's best and ticket), which every launch
    leaves zero.  One a decode loop's state: two launches that may run at
    once (two streams, two graphs) must not share one."""
    return torch.zeros(rows, 2, dtype=torch.int64, device=device)


def gumbel_pick(logits: torch.Tensor, temperature: torch.Tensor,
                key: torch.Tensor, step: torch.Tensor, row0: int = 0, *,
                with_draws: bool = False, workspace=None):
    """logits [B, V] fp32, contiguous; temperature [1] fp32 (T > 0); key
    [2] int64; step [1] int64, all on the logits' device -> the ids [B]
    int64; with_draws also (u, scores) [B, V] fp32, which the kernel then
    writes (checks only: the decode does not ask for them).  workspace:
    a ``pick_workspace(B, device)`` for the kernel (None: a zeroed one is
    made for the call; the plain version needs none)."""
    if route(logits) == "plain":
        if with_draws:
            u, s = gumbel_scores_plain(logits, temperature, key, step, row0)
            return torch.argmax(s, -1), u, s
        return gumbel_pick_plain(logits, temperature, key, step, row0)
    for name, t, dtype, shape in (
            ("logits", logits, torch.float32, None),
            ("temperature", temperature, torch.float32, (1,)),
            ("key", key, torch.int64, (2,)),
            ("step", step, torch.int64, (1,))):
        if t.device != logits.device or t.dtype != dtype:
            raise ValueError(f"gumbel_pick: {name} must be {dtype} on "
                             f"{logits.device}, got {t.dtype} on {t.device}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"gumbel_pick: {name} of shape "
                             f"{tuple(t.shape)}, expected {shape}")
    if logits.dim() != 2 or not logits.is_contiguous():
        raise ValueError("gumbel_pick: logits must be contiguous [B, V]")
    b, v = logits.shape
    if workspace is None:
        workspace = pick_workspace(b, logits.device)
    elif (workspace.device != logits.device
          or workspace.dtype != torch.int64
          or tuple(workspace.shape) != (b, 2)
          or not workspace.is_contiguous()):
        raise ValueError(f"gumbel_pick: the workspace must be contiguous "
                         f"[{b}, 2] int64 on {logits.device}")
    tok = torch.empty(b, dtype=torch.int64, device=logits.device)
    u = s = None
    if with_draws:
        u, s = torch.empty_like(logits), torch.empty_like(logits)
    lib = kernels.library()
    kernels.check(lib.wt_gumbel_pick(
        logits.data_ptr(), temperature.data_ptr(), key.data_ptr(),
        step.data_ptr(), tok.data_ptr(), 0 if u is None else u.data_ptr(),
        0 if s is None else s.data_ptr(), workspace.data_ptr(), b, v, row0,
        kernels.stream_ptr(logits.device)), "gumbel_pick")
    count_launch(sys.modules[__name__], launches=1)
    return (tok, u, s) if with_draws else tok
