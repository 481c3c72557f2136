"""The greedy decode step's tail: the loop state's update after the pick
and, in the body of a CUDA-graph while node, the node's condition, in one
kernel.

``loop_tail(nxt, lp, done, buf, last, pos, step, sum_lp, n_tok,
eot_id=...)`` updates the greedy loop's state in place
(``runtime.generate.LoopState``) as the JAX loop's body does after its
pick (``whisper_tpu/runtime/generate.py:197-205``): a row done before the
step emits ``eot_id`` in place of its pick ``nxt``, which is written to
column ``step`` of ``buf`` and to ``last``; with scores (``lp``,
``sum_lp``, ``n_tok``) a row undone before the step adds its pick's
log-probability and one token; a row that emits ``eot_id`` is done; then
``pos`` and ``step`` advance by one.  It replaces no Pallas kernel: XLA
fuses this bookkeeping and the loop's condition
(``whisper_tpu/runtime/generate.py:170-173``) into the ``while_loop``'s
program, where the port ran seven PyTorch operations (twelve with scores)
and the while node's condition kernel (C, ``csrc/graph_cond.cu``) a step.

On a CUDA tensor ``loop_tail`` launches the hand-written kernel
``wt_loop_tail`` (``csrc/graph_cond.cu``: one block, rows in turn, the
rows' OR one ``__syncthreads_or``; its bound is bytes, ~40 a row, so what
it saves is launches).  While this thread captures the body of a while
node whose body ends in the tail (``runtime.generate._while_node`` with
``tail=True``, through ``offer_condition``), the kernel also sets the
node's condition, "some row undone and step < bound", from the state it
has just written, and the node queues no C after the body; elsewhere (an
eager step, a warm-up, a trial capture) it sets nothing.  On a CPU tensor
it takes ``loop_tail_plain``, the PyTorch sequence it replaces, which the
kernel equals bit for bit.  Any other device raises.  Nothing on a card
falls back to the plain version.

``launches`` counts the tail kernel's launches; ``condition_launches`` C's,
which ``runtime.generate._while_node`` queues: once a graph launch ahead
of the node, and once an iteration at the end of a body with no tail (the
beam and speculative loops).  ``condition_plain`` is C's function in
PyTorch.
"""

from __future__ import annotations

import contextlib
import sys
import threading
from typing import Optional

import torch

from whisper_tpu_torch.ops import kernels
from whisper_tpu_torch.ops.common import count_launch, route

launches = 0            # tail kernel launches (plain calls excluded)
condition_launches = 0  # the while node's condition kernel (C)

_BODY = threading.local()  # the while node whose body this thread captures


class ConditionOffer:
    """A while node's handle offered to the body being captured, with the
    done flags, counter and bound of its condition; ``taken``: the tail
    kernels that set it."""

    def __init__(self, handle: int, done: torch.Tensor, trips: torch.Tensor,
                 bound: int):
        self.handle, self.done, self.trips = handle, done, trips
        self.bound = bound
        self.taken = 0


@contextlib.contextmanager
def offer_condition(handle: int, done: torch.Tensor, trips: torch.Tensor,
                    bound: int):
    """Within the block (the capture of a while node's body on this
    thread) a tail kernel launched over ``done`` and the counter ``trips``
    sets the node's condition through ``handle``.  Yields the
    ``ConditionOffer``."""
    offer = ConditionOffer(handle, done, trips, bound)
    outer = getattr(_BODY, "offer", None)
    _BODY.offer = offer
    try:
        yield offer
    finally:
        _BODY.offer = outer


def condition_plain(done: torch.Tensor, trips: torch.Tensor,
                    bound: int) -> torch.Tensor:
    """The while node's condition (C's function) as PyTorch computes it:
    [1] bool, "``trips`` < ``bound`` and some flag of ``done`` is
    false"."""
    return torch.logical_and(trips < bound, ~done.all())


def loop_tail_plain(nxt, lp, done, buf, last, pos, step, sum_lp=None,
                    n_tok=None, *, eot_id: int) -> None:
    """Reference version: the PyTorch sequence, in place."""
    nxt = torch.where(done, eot_id, nxt)
    if sum_lp is not None:
        # rows done before this step add nothing
        sum_lp.add_(torch.where(done, 0.0, lp))
        n_tok.add_((~done).long())
    buf.index_copy_(1, step, nxt[:, None])
    done.logical_or_(nxt == eot_id)
    last.copy_(nxt)
    pos.add_(1)
    step.add_(1)


def _check(name: str, t: Optional[torch.Tensor], dtype, shape, device):
    if t is None or t.device != device or t.dtype != dtype \
            or tuple(t.shape) != shape or not t.is_contiguous():
        got = None if t is None else (t.dtype, tuple(t.shape), t.device)
        raise ValueError(f"loop_tail: {name} must be contiguous {dtype} of "
                         f"shape {shape} on {device}, got {got}")


def loop_tail(nxt: torch.Tensor, lp: Optional[torch.Tensor],
              done: torch.Tensor, buf: torch.Tensor, last: torch.Tensor,
              pos: torch.Tensor, step: torch.Tensor,
              sum_lp: Optional[torch.Tensor] = None,
              n_tok: Optional[torch.Tensor] = None, *, eot_id: int) -> None:
    """nxt [B] int64, the pick's ids; lp [B] fp32 or None; done [B] bool;
    buf [B, cols] int64; last [B] int64; pos [1] int32; step [1] int64;
    sum_lp [B] fp32 and n_tok [B] int64, with lp, or all three None; all
    on one device, contiguous.  Updates the state in place (see the
    module's docstring)."""
    if route(done) == "plain":
        loop_tail_plain(nxt, lp, done, buf, last, pos, step, sum_lp, n_tok,
                        eot_id=eot_id)
        return
    b, dev = done.shape[0], done.device
    scores = sum_lp is not None
    if (lp is not None) != scores or (n_tok is not None) != scores:
        raise ValueError("loop_tail: lp, sum_lp and n_tok go together")
    cols = buf.shape[-1]
    for name, t, dtype, shape in (
            ("nxt", nxt, torch.int64, (b,)), ("done", done, torch.bool, (b,)),
            ("buf", buf, torch.int64, (b, cols)),
            ("last", last, torch.int64, (b,)),
            ("pos", pos, torch.int32, (1,)), ("step", step, torch.int64, (1,))
    ) + ((("lp", lp, torch.float32, (b,)),
          ("sum_lp", sum_lp, torch.float32, (b,)),
          ("n_tok", n_tok, torch.int64, (b,))) if scores else ()):
        _check(name, t, dtype, shape, dev)
    handle, bound = 0, cols
    offer = getattr(_BODY, "offer", None)
    if offer is not None:
        if done.data_ptr() != offer.done.data_ptr() \
                or step.data_ptr() != offer.trips.data_ptr():
            raise ValueError("loop_tail: the while node being captured "
                             "reads other done flags or another counter")
        handle, bound = offer.handle, offer.bound
        offer.taken += 1
    lp_p, sum_p, n_p = ((lp.data_ptr(), sum_lp.data_ptr(), n_tok.data_ptr())
                        if scores else (0, 0, 0))
    kernels.check(kernels.library().wt_loop_tail(
        nxt.data_ptr(), lp_p, done.data_ptr(), buf.data_ptr(),
        last.data_ptr(), sum_p, n_p, pos.data_ptr(), step.data_ptr(), b,
        cols, eot_id, handle, int(offer is not None), bound,
        kernels.stream_ptr(dev)), "loop_tail")
    count_launch(sys.modules[__name__], launches=1)
