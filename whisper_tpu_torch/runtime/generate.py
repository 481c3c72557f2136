"""Greedy generation with a static-shape KV cache (port of
``whisper_tpu.runtime.generate``).

Semantics are the JAX package's (and the reference's, src/main.rs:753-829):

- the prefill over the full prompt gives the first token, with
  suppression = base + begin_suppress;
- each later step uses the base suppression only;
- generation stops at EOT or after ``max_new_tokens``; rows that finish
  early keep emitting EOT, and the loop exits once every row is done;
- suppression is an additive ``-inf`` mask before argmax; ``torch.argmax``
  picks the first index on ties, like ``jnp.argmax``.

Options, with the JAX semantics: ``ts_cfg`` applies the timestamp grammar
(``runtime.timestamps``) after the suppression mask at every step;
``temperature > 0`` samples ``argmax(logits / T + Gumbel)``, the
distribution ``jax.random.categorical`` draws from: the key is part of the
loop's state, as in the JAX carry (``LoopState.key``: the seed and offset
of the caller's ``torch.Generator``), and step s draws its noise from a
counter-based Philox of (key, s, row, id) on the card
(``ops.sampling.gumbel_pick``, a hand-written kernel); ``return_logprobs``
also returns each row's summed log-probability (``log_softmax`` of the
masked logits, before the division by T) and its token count.

The JAX ``lax.while_loop`` becomes a step function that updates the
loop's state in place (``LoopState``: the last token, the cache slot
``pos`` and the step counter as one-element device tensors, ``done``, the
token buffer, the scores, the grammar's state and the cache), so that no
host value changes from one step to the next.  What the JAX session jits
ahead of the loop into the same program, a bucket's one, is a ``Front``:
the chunk normalisation and the encoder (the short path: the wire decode,
the mel and the encoder; a draft's encoder too), then the loop's
``prepare``: the prefill writing the cache, the int8 cross cache and the
first pick, the state before step ``first``.  Every value that changes
from call to call (the audio or the chunks, the prompt, ``pad_count``, the
masks, the temperature, the sampling key) is an input tensor.

On a card one ``torch.cuda.CUDAGraph`` per key (``DecodeGraphs``: the
batch rows, the prompt length, max_new_tokens, the step's route and rung,
the grammar, whether it samples, the scores, ``pad_count``, a data rank's
first row, the front's kind and its inputs' shapes) holds the whole
program: the front and
``prepare`` on a capture stream (the pre-node program), then the step as
the body of a CUDA-graph conditional (while) node (``_while_node``,
``csrc/graph_cond.cu``) whose condition, "trips < n and some row undone",
a kernel ahead of the node sets, and at the end of each iteration the
step's last kernel (``ops.loop_tail``: the state's update after the pick
and the condition in one launch), so one launch runs the whole bucket on
the card, from its input to its tokens, and stops where the JAX loop
stops.  A call copies its
inputs into the key's static tensors (a bucket's windows by one indexed
read, ``Gather``; the short path's upload as shipped) and queues that one
launch; it reads nothing and returns before the decode ends.  The
pre-node program's launches count once a launch, the body's once a step
that ran: ``ops.common.defer_launches`` of the step counter's advance,
settled where the results are copied to the host (``settle_launches``).
A capture that fails raises, and so does work that would draw from a
torch generator (its draws would repeat in every iteration); nothing falls
back to an eager encoder, prefill or step, or to reads.  A key's first
call runs the program's work once for real, the warm-up before the
capture, then launches the graph, whose ``prepare`` overwrites what the
warm-up left (a step past all-done returns what the loop would have: a
done row emits EOT and adds nothing).  A key keeps its static inputs, its
state (one cache of its rows) and its graph's memory pools (the front's
and the prefill's temporaries) for later calls; the keys of one
``DecodeGraphs`` keep at most a quarter of the card's memory in all, the
least recently used dropped first.  The same machinery (``InPlaceState``,
``_GraphLoop``, ``DecodeGraphs``, ``run_loop``) runs the beam loop
(``runtime.beam``) and the speculative rounds (``runtime.speculative``),
each with a key of its own, under one budget.

The eager loop (the CPU, ``eager=True``: the card checks compare the two,
and a mesh whose collectives cannot be captured) runs the front and
``prepare`` into a new state, then calls the step function as it is and
reads ``done`` on the host: with ``early_exit=False`` never (every step
runs; a row past EOT emits EOT and adds nothing to its scores, so the
tokens, sums and counts are those of a loop that stopped), else once a
step, so that it stops where ``lax.while_loop`` stops, except under a mesh
on a card: there once a block of ``EXIT_BLOCK`` steps, from a non-blocking
copy read only after the next block is queued, so the card never waits on
the host.

Under a mesh (``parallel.mesh``) every rank runs the loop on its own rows
and heads (``mesh=`` reaches the model's collectives), where the JAX
session runs the mesh's whole decode in one program and GSPMD puts the
collectives inside it.  ``graphed`` holds the rule: a rank's bucket is one
launch of its program, as without a mesh, wherever every collective on
the loop's path can be captured (``Mesh.capturable``: a model axis of one
rank makes no call, and NCCL queues its all-reduces on the card, so the
capture holds them between the step's kernels, in the while node's body);
a data rank's tokens are gathered over "data" after the launch.  A model
axis over gloo, whose collectives carry CUDA tensors through the host,
runs eagerly: the rule picks that before any capture, and a capture that
fails raises.  A collective replayed from a graph has no work item the
group's watchdog could time out, so the model ranks of a program must
take the same trips through it: they hold the same rows, their logits
follow the same all-reduce, and their picks share the key and the first
row (``row0``), so their ``done`` agrees and they run the same steps (and
read it alike, eagerly); a data rank stops when its own rows end.  The
model ranks meet their keys in the same order (SPMD: the same calls, the
same warm-ups, whose eager collectives run in lockstep), so each captures
and drops the same programs.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import threading
import time
import weakref
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from whisper_tpu_torch.models import whisper
from whisper_tpu_torch.models.registry import WhisperDims
from whisper_tpu_torch.ops import loop_tail, sampling
from whisper_tpu_torch.ops.decoder_kernels import decoder_step_hybrid


def build_suppress_mask(vocab_size: int, ids: Sequence[int] | None) -> np.ndarray:
    """Additive float32 mask [V]: 0 everywhere, -inf at suppressed ids."""
    mask = np.zeros(vocab_size, dtype=np.float32)
    if ids:
        idx = np.asarray([i for i in ids if 0 <= i < vocab_size], dtype=np.int64)
        mask[idx] = -np.inf
    return mask


def pick(logits: torch.Tensor, temperature, key, step, want_lp: bool,
         row0: int = 0, workspace=None):
    """(token [B], its log-probability [B] or None) from masked fp32 logits
    [B, V].  T > 0: argmax(logits / T - log E), E = -log u of a Philox
    uniform u of (``key``, ``step``, row, id) (a Gumbel-max draw,
    ``ops.sampling.gumbel_pick``); E is floored at the smallest normal
    float, so a suppressed id (-inf) can never be drawn.  The
    log-probability is that of the masked distribution at T = 1, as the
    JAX ``pick`` takes it.  temperature: a float (0: argmax), or a
    one-element fp32 tensor holding T > 0 (the loop's step); key: [2] int64
    (seed, offset) on the logits' device; step: an int or a [1] int64
    tensor (the loop's step counter).

    row0: the logits' first row is row row0 of the batch (a data rank's
    share): each row draws as it does in the one-process decode.
    workspace: the pick kernel's (``ops.sampling.pick_workspace``), which
    the loop's state carries; None: one made for the call."""
    if torch.is_tensor(temperature) or temperature > 0:
        dev = logits.device
        if not torch.is_tensor(temperature):
            temperature = torch.full((1,), temperature, dtype=torch.float32,
                                     device=dev)
        if not torch.is_tensor(step):
            step = torch.full((1,), step, dtype=torch.int64, device=dev)
        tok = sampling.gumbel_pick(logits, temperature, key, step, row0,
                                   workspace=workspace)
    else:
        tok = torch.argmax(logits, dim=-1)
    if not want_lp:
        return tok, None
    lp = torch.log_softmax(logits, dim=-1).gather(-1, tok[:, None])[:, 0]
    return tok, lp


EXIT_BLOCK = 16  # steps between two reads of done under a mesh on a card


class InPlaceState:
    """What ``_GraphLoop`` needs of a decode loop's state (``LoopState``
    here, ``beam.BeamState``, ``speculative.SpecState``): ``tensors()``,
    every tensor one step updates in place or reads, in one fixed order;
    ``done``, the tensor whose ``all()`` ends the loop; ``trips()``, the
    one-element int64 counter that a step (a round) whose body runs
    advances by one, ``first`` before the loop's first step, which the
    while node holds under the loop's bound; ``outputs()``, copies of the
    results, so that the next run may reuse the state;
    ``sets_condition``, whether the step's last kernel sets the while
    node's condition itself (the greedy step's ``ops.loop_tail``), so that
    the node queues no condition kernel after the body."""

    done: torch.Tensor
    sets_condition = False

    def tensors(self) -> list:
        raise NotImplementedError

    def trips(self) -> torch.Tensor:
        raise NotImplementedError

    def outputs(self):
        raise NotImplementedError

    def nbytes(self) -> int:
        """Device bytes the state's tensors hold (whole storages, once)."""
        return _storage_bytes(self.tensors())

    def copy_(self, other: "InPlaceState") -> "InPlaceState":
        """Write ``other``'s values into this state's tensors, skipping
        those the two share (a cache the prefill wrote in place)."""
        for mine, theirs in zip(self.tensors(), other.tensors()):
            if mine is not theirs:
                mine.copy_(theirs)
        return self


def _storage_bytes(tensors) -> int:
    """Device bytes of the storages of ``tensors``, each counted once."""
    storages = {t.untyped_storage().data_ptr():
                t.untyped_storage().nbytes() for t in tensors}
    return sum(storages.values())


@dataclasses.dataclass
class LoopState(InPlaceState):
    """The greedy loop's carried state: every field a tensor on the device
    that one step updates in place (``_step_fn``), whose tail kernel sets
    the while node's condition."""

    sets_condition = True

    last: torch.Tensor            # [B] int64, the token the step feeds
    pos: torch.Tensor             # [1] int32, its cache slot
    step: torch.Tensor            # [1] int64, the column the step writes
    done: torch.Tensor            # [B] bool
    buf: torch.Tensor             # [B, max_new_tokens] int64
    suppress: torch.Tensor        # [V] fp32 additive mask of every step
    cache: whisper.KVCache
    sum_lp: Optional[torch.Tensor] = None   # [B] fp32 (return_logprobs)
    n_tok: Optional[torch.Tensor] = None    # [B] int64
    ts: Optional[object] = None             # timestamps.TimestampState
    pad_count: Optional[torch.Tensor] = None  # [B] int32
    temperature: Optional[torch.Tensor] = None  # [1] fp32, T > 0 (sampling)
    key: Optional[torch.Tensor] = None      # [2] int64 (seed, offset)
    # [B, 2] int64, the pick kernel's (``sampling.pick_workspace``): zeroed
    # once, when the state is made, and left zero by every launch
    pick_ws: Optional[torch.Tensor] = None

    def tensors(self) -> list:
        """Every tensor of the state, in one fixed order."""
        out = [self.last, self.pos, self.step, self.done, self.buf,
               self.suppress, *self.cache, self.sum_lp, self.n_tok,
               *(self.ts or ()), self.pad_count, self.temperature, self.key,
               self.pick_ws]
        return [t for t in out if t is not None]

    def trips(self) -> torch.Tensor:
        return self.step

    def outputs(self):
        """buf, or with scores (buf, sum_lp, n_tok)."""
        if self.sum_lp is not None:
            return self.buf.clone(), self.sum_lp.clone(), self.n_tok.clone()
        return self.buf.clone()


def _step_fn(st: LoopState, params, dims: WhisperDims, *, eot_id: int,
             kernel_step: bool, cross_len: int, int8_mxu: bool,
             step_weights, ts_cfg, return_logprobs: bool, mesh, row0: int):
    """One decode step over ``st``, in place: nothing is read on the host
    and no host value changes between steps (the draw's key and step are
    tensors of the state), so the body of a CUDA graph's while node runs
    every step.  The state's update after the pick is one call of
    ``ops.loop_tail``, which in a while node's body also sets its
    condition; the grammar's state follows it, from ``st.last`` (the
    step's ids with done rows' EOT), and changes neither ``done`` nor the
    step."""
    from whisper_tpu_torch.runtime import timestamps as ts

    def step() -> None:
        # `last` was generated as token index pos of the full sequence.
        if step_weights is not None:
            logits, _ = decoder_step_hybrid(params, step_weights, dims,
                                            st.last, st.pos, st.cache,
                                            mesh=mesh)
        else:
            logits, _ = whisper.decoder_step(
                params, dims, st.last, st.pos, st.cache,
                kernel_step=kernel_step,
                cross_len=cross_len if kernel_step else None,
                int8_mxu=int8_mxu, pad_count=st.pad_count, mesh=mesh)
        logits = logits.float() + st.suppress
        if ts_cfg is not None:
            logits = ts.apply_rules(logits, st.ts, st.step, ts_cfg)
        temperature = 0.0 if st.temperature is None else st.temperature
        nxt, lp = pick(logits, temperature, st.key, st.step, return_logprobs,
                       row0, st.pick_ws)
        loop_tail.loop_tail(nxt, lp, st.done, st.buf, st.last, st.pos,
                            st.step, st.sum_lp, st.n_tok, eot_id=eot_id)
        if ts_cfg is not None:
            ts.update_state_(st.ts, st.last, ts_cfg)

    return step


def _done_flag(done: torch.Tensor):
    """(flag, event): whether every row is done, copied to the host without
    a wait on a card (read it with ``_read``)."""
    if done.device.type != "cuda":
        return done.all(), None
    flag = torch.empty((), dtype=torch.bool, pin_memory=True)
    flag.copy_(done.all(), non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return flag, event


def _read(flag_event) -> bool:
    flag, event = flag_event
    if event is not None:
        event.synchronize()
    return bool(flag)


def _drive(step, first: int, n: int, done: torch.Tensor,
           exit_every: Optional[int]) -> None:
    """The eager loop: steps first .. n-1.  exit_every None: no read.  Else
    ``done`` is copied once a block of exit_every steps and, for blocks of
    more than one step, read only after the next block is queued."""
    lag = 0 if exit_every == 1 else 1
    flags: collections.deque = collections.deque()
    i = first
    while i < n:
        if exit_every is not None:
            flags.append(_done_flag(done))
            if len(flags) > lag and _read(flags.popleft()):
                return
        hi = n if exit_every is None else min(i + exit_every, n)
        for _ in range(i, hi):
            step()
        i = hi


_CAPTURE_LOCK = threading.Lock()  # one capture at a time in the process
_CAPTURE_STREAMS: dict = {}       # device -> (body stream, capture stream)

GRAPH_MEMORY_SHARE = 0.25  # of the card's memory, for one DecodeGraphs


def _budget(device) -> int:
    """The bytes of loop state one ``DecodeGraphs`` keeps on ``device``."""
    card = torch.cuda.get_device_properties(device)
    return int(GRAPH_MEMORY_SHARE * card.total_memory)


def graphed(device, mesh, eager: bool) -> bool:
    """Whether a decode loop runs from a graph: on a card, unless
    ``eager``, wherever every collective on the loop's path can be captured
    (no mesh, or ``mesh.capturable``: a model axis of one rank, or one over
    NCCL; a data axis over any backend, its gather coming after the
    launch).  A model axis over gloo runs eagerly (see the module's
    docstring)."""
    return (device.type == "cuda" and not eager
            and (mesh is None or mesh.capturable))


_THREAD_LOCAL = 1   # cudaStreamCaptureModeThreadLocal


@contextlib.contextmanager
def _while_node(graph, done: torch.Tensor, trips: torch.Tensor, bound: int,
                body, pool=None, tail: bool = False):
    """Within a capture of ``graph`` on the current stream: the work the
    block queues on the ``body`` stream (made current) becomes the body of
    a conditional (while) node on "``trips`` < ``bound`` and some flag of
    ``done`` is false" (a [1] int64 counter and bools on the card,
    contiguous): one launch of the graph runs the body while that holds,
    evaluated before the first iteration and after each, and the
    ``trips < bound`` term ends a loop whose rows never end.  Built through
    the CUDA runtime (``csrc/graph_cond.cu``): the card's torch has no
    ``CUDAGraph`` method for conditional nodes.  A condition kernel (C)
    ahead of the node sets the condition at every launch; after each
    iteration C at the end of the body sets it or, with ``tail``, the
    body's loop tail (``ops.loop_tail``), which takes the node's handle
    here: a ``tail`` body that launches no tail kernel, or more than one,
    raises (its body then ends in C, so no node is made whose condition
    nothing sets).  C counts in ``ops.loop_tail.condition_launches``: the
    one ahead of the node where the block's caller tallies (a graph's
    program: once a launch), those ending the body in the body's tally.
    The body's allocations go to a memory pool of its own, kept until
    ``graph`` is gone; a failure raises (``pool``: a pool id to take, else
    a new one).  A body whose capture fails leaves a node that the runtime
    cannot instantiate (the process dies in ``capture_end``):
    ``_GraphLoop._trial_capture`` raises for such a step first.  Yields a
    dict that holds, once the block has ended, "tally": the launches the
    body tallied (``ops.common.tally_launches``), an iteration's, and
    "body_ops": the device operations an iteration runs, read from the
    body graph's nodes (kernels, copies and fills; -1 where the body holds
    a conditional node).  A mesh's collectives in the block queue on their
    group's stream, which joins the body's capture and is joined back by
    the next kernel's stream."""
    from whisper_tpu_torch.ops import kernels
    from whisper_tpu_torch.ops.common import count_launch, tally_launches

    if done.dtype != torch.bool or not done.is_contiguous():
        raise ValueError("the while node reads contiguous bools")
    if trips.dtype != torch.int64 or trips.numel() != 1:
        raise ValueError("the while node's counter is one int64")
    index = done.device.index
    lib = kernels.library()
    parent = kernels.stream_ptr(done.device)
    handle = ctypes.c_ulonglong()
    body_ops = ctypes.c_longlong(0)
    args = (done.data_ptr(), done.numel(), trips.data_ptr(), bound)
    taken = False
    try:
        kernels.check(lib.wt_while_node_begin(
            *args, parent, body.cuda_stream, _THREAD_LOCAL,
            ctypes.byref(handle)), "wt_while_node_begin")
        count_launch(loop_tail, condition_launches=1)
        if pool is None:
            pool = torch.cuda.graph_pool_handle()
        taken = True
        info = {}
        offer = None
        set_by_tail = False
        with torch.cuda.stream(body):
            torch._C._cuda_beginAllocateCurrentStreamToPool(index, pool)
            try:
                with tally_launches() as tally, (
                        loop_tail.offer_condition(handle.value, done, trips,
                                                  bound)
                        if tail else contextlib.nullcontext()) as offer:
                    try:
                        yield info
                    finally:
                        set_by_tail = offer is not None and offer.taken == 1
                        if not set_by_tail:      # C ends the body
                            count_launch(loop_tail, condition_launches=1)
            finally:
                torch._C._cuda_endAllocateToPool(index, pool)
                rc = lib.wt_while_node_end(handle.value, *args,
                                           body.cuda_stream,
                                           int(not set_by_tail),
                                           ctypes.byref(body_ops))
        kernels.check(rc, "wt_while_node_end")
        if tail and not set_by_tail:
            raise RuntimeError(
                f"the while node's body launched {offer.taken} loop tail "
                "kernels that set its condition, not one: its condition "
                "would be set by none, or twice")
        info["tally"] = dict(tally)
        info["body_ops"] = body_ops.value
    except BaseException:
        if taken:
            torch._C._cuda_releasePool(index, pool)
        raise
    weakref.finalize(graph, torch._C._cuda_releasePool, index, pool)


# cudaGraphNodeType -> its name, for the types a while node's body may not
# hold (``_bad_body_node``)
_NODE_TYPES = {3: "host", 6: "event wait", 7: "event record",
               8: "external semaphore signal", 9: "external semaphore wait",
               10: "memory allocation", 11: "memory free"}


def _bad_body_node(stream) -> Optional[str]:
    """Inside a capture on ``stream``: the type of the first node captured
    so far that a while node's body may not hold (CUDA's rules for
    conditional bodies: kernel, copy, fill, empty, child-graph and
    conditional nodes only; ``csrc/graph_cond.cu``), or None."""
    from whisper_tpu_torch.ops import kernels

    bad = ctypes.c_int(-1)
    kernels.check(kernels.library().wt_capture_bad_node(
        stream.cuda_stream, ctypes.byref(bad)), "wt_capture_bad_node")
    if bad.value < 0:
        return None
    return _NODE_TYPES.get(bad.value, f"type {bad.value}")


class _NoRandomOps(TorchDispatchMode):
    """Raises at any torch operation that draws from a generator (tagged
    ``nondeterministic_seeded``): captured in a while node's body, such a
    draw takes its Philox offset from the host once a launch, so every
    iteration would repeat the same draws."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if torch.Tag.nondeterministic_seeded in func.tags:
            raise RuntimeError(
                f"{func} draws from a torch generator: in a while node's "
                "body it would repeat its draws in every iteration (the "
                "decode loops draw from the key in their state)")
        return func(*args, **(kwargs or {}))


class Gather(NamedTuple):
    """A call's input made by one indexed read on the device: rows
    ``index`` (an int64 tensor on ``src``'s device) of ``src`` along its
    first axis (``torch.index_select``), written straight into the key's
    static tensor.  A bucket's windows of a whole-file mel are gathered so,
    outside the graph: the file's length stays out of the key."""

    src: torch.Tensor
    index: torch.Tensor


def _signature(x) -> tuple:
    """(shape, dtype) of a call's input (a tensor or a ``Gather``)."""
    if isinstance(x, Gather):
        return (x.index.shape[0], *x.src.shape[1:]), x.src.dtype
    return tuple(x.shape), x.dtype


def _on_device(x, device) -> torch.Tensor:
    """A call's input as a tensor on ``device`` (the eager loop's)."""
    if isinstance(x, Gather):
        return torch.index_select(x.src, 0, x.index)
    return x.to(device)


def _copy_in(static: torch.Tensor, x) -> None:
    """A call's input into the key's static tensor of its shape."""
    if isinstance(x, Gather):
        torch.index_select(x.src, 0, x.index, out=static)
    else:
        static.copy_(x)


class Front(NamedTuple):
    """A call's work ahead of its decode loop's prefill, which the JAX
    session jits into the bucket's one program with the loop (a bucket's
    chunk normalisation and encoder; the short path's wire decode, zero
    tail, mel and encoder; with a draft, its encoder too):
    ``encode(*inputs)`` -> the encoder states [rows, length, d] (speculative
    decoding: the main model's and the draft's, of ``draft_length``
    frames).  ``inputs``: the call's tensors, on any device, or
    ``Gather``s, copied into the key's static tensors ahead of a launch (no
    copy from the host inside a graph); ``key``: what ``encode`` computes,
    besides its inputs' shapes and dtypes (``front_key``); ``weights``: the
    encoders it runs, which ``DecodeGraphs`` holds to its own."""

    encode: Callable
    inputs: tuple
    key: tuple
    rows: int
    length: int
    device: torch.device
    weights: tuple = ()
    draft_length: Optional[int] = None


def states_front(enc_states: torch.Tensor,
                 draft_states: Optional[torch.Tensor] = None) -> Front:
    """Encoder states given as they are (a loop called directly): the
    program copies them in and starts at the prefill."""
    if draft_states is None:
        return Front(lambda e: e, (enc_states,), ("states",),
                     enc_states.shape[0], enc_states.shape[1],
                     enc_states.device)
    return Front(lambda e, d: (e, d), (enc_states, draft_states),
                 ("states",), enc_states.shape[0], enc_states.shape[1],
                 enc_states.device, draft_length=draft_states.shape[1])


def front_key(front: Front) -> tuple:
    """What a loop's key holds of its front: the front's key and its
    inputs' shapes and dtypes (a bucket's rows, the short path's ship
    length and wire)."""
    return front.key + tuple(_signature(x) for x in front.inputs)


def _pool_bytes(pools) -> int:
    """Device bytes the caching allocator holds in the memory pools
    ``pools`` (a graph's pool ids): their segments, whole, from its
    snapshot."""
    wanted = {tuple(p) for p in pools if p is not None}
    if not wanted:
        return 0
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg["segment_pool_id"]) in wanted)


class _GraphLoop:
    """One key's static inputs and state, its captured program and the
    launches the capture tallied.  ``run`` holds the loop's lock from the
    copy-in to the queued copies of the results, so two threads never share
    them."""

    def __init__(self, device: torch.device, mesh=None):
        self.device = device
        self.mesh = mesh      # the rank's mesh, where its collectives run
        self.inputs: Optional[tuple] = None   # the static input tensors
        self.state: Optional[InPlaceState] = None
        self.graph = None
        self.pre_tally: dict = {}   # the pre-node program's: once a launch
        self.tally: dict = {}       # the body's: once an iteration that ran
        self.body_ops = 0   # the body graph's device operations (nodes)
        self.capture_s = 0.0
        self.pools: tuple = ()      # the graph's memory pools
        self.pool_nbytes = 0
        self.nbytes = 0     # device bytes of the state, inputs and pools
        self._lock = threading.Lock()
        self._free = None   # an event: the last run's results are copied

    def _capture(self, pre, step, bound: int) -> None:
        """Run the pre-node program ``pre`` and then ``step`` once for real
        (the warm-up, whose results the launch overwrites), then capture
        both into one graph: ``pre``, then a while node whose body is
        ``step``, run while the state's ``trips()`` is under ``bound`` and
        some row is undone (``_while_node``); step None: ``pre`` alone.
        ``pre`` is warmed and captured on a capture stream, the step on the
        device's body stream, both made once: each stream that runs a
        product keeps a cuBLAS workspace, which the warm-up makes outside
        any graph's memory, as it does a kernel's build, its library's load
        and its shared-memory limit.  A throwaway trial capture of each
        comes first (``_trial_capture``).  Unlike ``torch.cuda.graph``, no
        device-wide sync, garbage collection or emptying of the allocator's
        cache: a key met while serving holds back no other thread's work."""
        from whisper_tpu_torch.ops.common import tally_launches

        t0 = time.perf_counter()
        done, trips = self.state.done, self.state.trips()
        with _CAPTURE_LOCK:
            if self.device not in _CAPTURE_STREAMS:
                _CAPTURE_STREAMS[self.device] = (
                    torch.cuda.Stream(self.device),
                    torch.cuda.Stream(self.device))
            body_stream, own = _CAPTURE_STREAMS[self.device]
            main = torch.cuda.current_stream(self.device)
            own.wait_stream(main)
            with tally_launches(), torch.cuda.stream(own):
                pre()
            if step is not None:
                body_stream.wait_stream(own)
                with tally_launches(), torch.cuda.stream(body_stream):
                    step()
                own.wait_stream(body_stream)
            main.wait_stream(own)
            # the trials capture into the graph's own pools and live until
            # its capture has taken them: their memory is the graph's, not
            # pools of their own left behind
            pools = (torch.cuda.graph_pool_handle(),
                     torch.cuda.graph_pool_handle() if step else None)
            trials = [self._trial_capture(pre, own, pools[0])]
            if step is not None:
                trials.append(self._trial_capture(step, body_stream,
                                                  pools[1], body=True))
            graph = torch.cuda.CUDAGraph()
            body = {}
            with torch.cuda.stream(own):
                graph.capture_begin(pool=pools[0],
                                    capture_error_mode="thread_local")
                try:
                    # the node's condition kernel ahead of it counts with
                    # the pre-node program, once a launch; the body keeps
                    # its own tally, once an iteration
                    with tally_launches() as pre_tally:
                        pre()
                        if step is not None:
                            with _while_node(
                                    graph, done, trips, bound, body_stream,
                                    pools[1],
                                    self.state.sets_condition) as body:
                                step()
                finally:
                    try:
                        graph.capture_end()
                    except BaseException:
                        # the allocator may go on routing these streams'
                        # allocations to the failed capture's pool
                        del _CAPTURE_STREAMS[self.device]
                        raise
        del trials
        self.graph, self.pre_tally = graph, dict(pre_tally)
        self.tally = body.get("tally", {})
        self.body_ops = body.get("body_ops", 0)
        self.pools = pools
        self.capture_s = time.perf_counter() - t0

    def _trial_capture(self, fn, stream, pool, body: bool = False):
        """Capture ``fn`` into a graph that is never launched, in memory
        pool ``pool``, and return it: work that cannot be captured (a host
        read, a copy from pageable memory, a library that refuses) or that
        draws from a torch generator (``_NoRandomOps``) raises here, before
        it can leave a while node's body half made (``_while_node``), and
        so does a ``body`` whose capture holds a node that a while node's
        body may not (``_bad_body_node``: an event, a host callback or an
        allocation, which a mesh's collectives might leave), naming its
        type."""
        from whisper_tpu_torch.ops.common import tally_launches

        trial = torch.cuda.CUDAGraph()
        bad = None
        with tally_launches(), torch.cuda.stream(stream):
            trial.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                with _NoRandomOps():
                    fn()
                if body:
                    bad = _bad_body_node(stream)
            finally:
                try:
                    trial.capture_end()
                except BaseException:
                    # the allocator may go on routing this stream's
                    # allocations to the failed capture's pool
                    del _CAPTURE_STREAMS[self.device]
                    raise
        if bad is not None:
            where = "" if self.mesh is None else (
                f" (a rank of a {self.mesh.data} x {self.mesh.model} mesh, "
                f"its model group over {self.mesh.model_backend})")
            raise RuntimeError(
                f"the loop's step left a node of type \"{bad}\" in its "
                f"capture{where}: a while node's body holds kernel, copy, "
                "fill, empty, child-graph and conditional nodes only, so its "
                "graph could not be instantiated")
        return trial

    def _launch(self) -> None:
        self.graph.replay()

    def run(self, inputs, prepare, make_step, first: int, n: int):
        """inputs: the call's (its ``Front``'s, then the loop's own:
        tensors on any device or ``Gather``s); prepare(static inputs, state
        or None) -> the state before step ``first`` (an ``InPlaceState``
        whose ``trips()`` holds ``first``), written into the state given,
        in place, or a new one; make_step(state) -> the step function.

        The inputs are copied into the key's static tensors, then one
        launch of the key's graph runs ``prepare`` and steps first .. n-1
        while some row is undone, reading nothing.  A key's first call
        makes its static inputs and state (``prepare`` into None) and
        captures the graph (``_capture``; a capture that fails drops them
        and raises) before that launch: the launch's own ``prepare``
        overwrites every tensor of the state the warm-up left, so a first
        call's results are its launch's, as a later call's are.  Launches
        count the pre-node program's tally once (``ops.common.add_launches``)
        and the body's once an iteration that ran (``defer_launches``).
        Returns the outputs."""
        from whisper_tpu_torch.ops.common import (
            add_launches,
            defer_launches,
            tally_launches,
        )

        with self._lock:
            main = torch.cuda.current_stream(self.device)
            if self._free is not None:
                main.wait_event(self._free)
            if self.inputs is None:
                self.inputs = tuple(
                    torch.empty(shape, dtype=dtype, device=self.device)
                    for shape, dtype in map(_signature, inputs))
            for static, x in zip(self.inputs, inputs):
                _copy_in(static, x)
            if self.graph is None:
                try:
                    with tally_launches():      # their launches count nowhere
                        self.state = prepare(self.inputs, None)
                    self._capture(lambda: prepare(self.inputs, self.state),
                                  make_step(self.state) if first < n
                                  else None, n)
                except BaseException:
                    self.inputs = self.state = None
                    raise
                self.pool_nbytes = _pool_bytes(self.pools)
                self.nbytes = self.pool_nbytes + _storage_bytes(
                    self.state.tensors() + list(self.inputs))
            self._launch()
            add_launches(self.pre_tally)
            if first < n:
                defer_launches(self.tally, self.state.trips() - first)
            out = self.state.outputs()
            self._free = torch.cuda.Event()
            self._free.record(main)
            return out

    def release(self) -> None:
        """Drop the graph, the inputs and the state once the last run's
        work is done (a later run captures anew)."""
        with self._lock:
            if self._free is not None:
                self._free.synchronize()
            self.inputs, self.state, self.graph = None, None, None
            self.pre_tally, self.tally, self.pools = {}, {}, ()
            self.nbytes = self.pool_nbytes = 0


class GraphKey(NamedTuple):
    """What a captured greedy program is specialised to.  Each loop has a
    key of its own (``beam.BeamKey``, ``speculative.SpecKey``), each ending
    in its ``front`` (``front_key``: the chunks, the chunk-normalised
    chunks, the short path's audio or given encoder states, and their
    shapes) and its ``kind``, so that keys of two loops never compare
    equal."""

    rows: int
    prompt_len: int
    max_new_tokens: int
    cross_len: int
    kernel_step: bool
    int8_mxu: bool
    int8_self: bool
    int8_cross_kv: bool
    hybrid: bool           # the hybrid step (step_weights)
    ts_cfg: object
    sampled: bool          # temperature > 0 (T and the key are inputs)
    scores: bool
    pads: bool
    eot_id: int
    # a data rank's first row of the batch, which the pick kernel takes as
    # a constant: two shares never share a program
    row0: int = 0
    front: tuple = ()
    kind: str = "greedy"


class DecodeGraphs:
    """The captured decode programs of one set of weights (a session's:
    the decoder tree, for the hybrid step its step weights, its encoder,
    and for speculative decoding the draft's decoder tree and encoder, held
    here), one per key, of every kind: greedy steps, beam steps and
    speculative rounds; ``greedy_generate``, ``beam_generate`` and
    ``speculative_generate`` take it (``graphs=``) and refuse other
    weights.  The programs keep at most ``GRAPH_MEMORY_SHARE`` of the
    card's memory, every kind counted, each key by what it holds: its
    state, its static inputs and its graph's memory pools (the encoder's
    and the prefill's temporaries, the step's); after a run that passes
    it, the least recently used other keys are dropped."""

    def __init__(self, params, step_weights=None, draft_params=None,
                 encoder=None, draft_encoder=None):
        self.params = params
        self.step_weights = step_weights
        self.draft_params = draft_params
        self.encoder = encoder
        self.draft_encoder = draft_encoder
        self._loops: collections.OrderedDict = collections.OrderedDict()
        self._lock = threading.Lock()

    def loop(self, params, step_weights, key, device, draft_params=None,
             encoders=(), mesh=None) -> _GraphLoop:
        if params is not self.params or (
                step_weights is not None
                and step_weights is not self.step_weights) or (
                draft_params is not None
                and draft_params is not self.draft_params) or any(
                w is not self.encoder and w is not self.draft_encoder
                for w in encoders):
            raise ValueError("these decode graphs belong to other weights")
        with self._lock:
            if key not in self._loops:
                self._loops[key] = _GraphLoop(device, mesh)
            self._loops.move_to_end(key)
            return self._loops[key]

    def set_draft(self, draft_params, draft_encoder=None) -> None:
        """Serve speculative rounds with ``draft_params`` (and
        ``draft_encoder``, None where the draft reads the main encoder's
        states) from now on: every speculative loop, captured with the
        draft before, is dropped."""
        with self._lock:
            self.draft_params = draft_params
            self.draft_encoder = draft_encoder
            victims = [self._loops.pop(k) for k in list(self._loops)
                       if k.kind == "speculative"]
        for v in victims:
            v.release()

    def trim(self, keep) -> None:
        """Drop the least recently used loops other than ``keep`` while the
        loops' bytes (state, inputs and pools) pass the budget."""
        with self._lock:
            if keep not in self._loops:     # dropped by another thread's run
                return
            budget = _budget(self._loops[keep].device)
            total = sum(v.nbytes for v in self._loops.values())
            victims = []
            for k in list(self._loops):
                if total <= budget:
                    break
                if k != keep:
                    victims.append(self._loops.pop(k))
                    total -= victims[-1].nbytes
        for v in victims:
            v.release()

    def nbytes(self) -> int:
        """Device bytes the loops keep: state, inputs and pools."""
        with self._lock:
            return sum(v.nbytes for v in self._loops.values())

    def kept(self) -> dict:
        """{key: device bytes its loop keeps}."""
        with self._lock:
            return {k: v.nbytes for k, v in self._loops.items()}

    def pools(self) -> dict:
        """{key: device bytes of its graph's memory pools}."""
        with self._lock:
            return {k: v.pool_nbytes for k, v in self._loops.items()}

    def captures(self) -> dict:
        """{key: seconds its warm-up and capture took}, for the loops kept
        and captured."""
        with self._lock:
            return {k: v.capture_s for k, v in self._loops.items()
                    if v.graph is not None}


def exit_period(early_exit: bool, device, mesh, block: int = EXIT_BLOCK, *,
                eager: bool = False):
    """The eager loop's steps between two reads of ``done`` (``_drive``):
    None without the early exit; ``block`` for an eager mesh on a card
    (one that ``graphed`` runs eagerly: a model axis over gloo, or
    ``eager``), so its host reads keep a block behind the card; else one
    (where the ``while_loop`` stops).  A graphed loop reads nothing: its
    while node stops on the card."""
    if not early_exit:
        return None
    eager_mesh = (device.type == "cuda" and mesh is not None
                  and not graphed(device, mesh, eager))
    return block if eager_mesh else 1


def run_loop(inputs, prepare, make_step, first: int, n: int, exit_every, *,
             graphs: Optional[DecodeGraphs], key, device, params,
             step_weights=None, draft_params=None, encoders=(), mesh=None,
             eager: bool = False):
    """Steps first .. n-1 of a decode loop over the state ``prepare``
    makes from the call's ``inputs`` (``_GraphLoop.run``), while some row
    is undone, and the state's outputs.  Where ``graphed`` (a card, not
    ``eager``, and no mesh or one whose collectives can be captured): one
    launch of ``key``'s graph in ``graphs`` (None: a ``DecodeGraphs`` for
    this call alone), ``prepare`` its pre-node program, which then drops
    what passes its budget; nothing is read.  Else eagerly: ``prepare``
    into a new state, ``done`` read once ``exit_every`` steps (``_drive``;
    ``exit_period``)."""
    if not graphed(device, mesh, eager):
        st = prepare(tuple(_on_device(x, device) for x in inputs), None)
        _drive(make_step(st), first, n, st.done, exit_every)
        return st.outputs()
    if graphs is None:
        graphs = DecodeGraphs(params, step_weights, draft_params, *encoders)
    loop = graphs.loop(params, step_weights, key, device, draft_params,
                       encoders, mesh)
    out = loop.run(inputs, prepare, make_step, first, n)
    graphs.trim(key)
    return out


def greedy_generate(params, dims: WhisperDims, enc_states,
                    prompt: torch.Tensor, suppress_mask: torch.Tensor,
                    first_suppress_mask: torch.Tensor, max_new_tokens: int,
                    eot_id: int, *, ts_cfg=None, int8_cross_kv: bool = False,
                    kernel_step: bool = False,
                    int8_mxu: bool = True, int8_self: bool = False,
                    step_weights=None, temperature: float = 0.0,
                    generator: torch.Generator | None = None,
                    return_logprobs: bool = False, pad_count=None,
                    mesh=None, row0: int = 0, early_exit: bool = True,
                    eager: bool = False,
                    graphs: Optional[DecodeGraphs] = None):
    """Generated tokens [B, max_new_tokens] (prompt excluded), rows that
    finished early padded with EOT; with return_logprobs also (sum_lp [B]
    fp32, n_tok [B] int64): the log-probability summed over each row's
    tokens up to and including its first EOT, and their count.
    enc_states: [B, T, d], or a ``Front`` that computes them from the
    call's inputs (the session's bucket programs: chunk normalisation and
    encoder, the short path's mel and encoder).  prompt: [P] ids shared by
    every row (on any device); masks: [V] fp32 additive.  kernel_step runs the
    decode step through kernel B3 and, against the int8 cross cache, B4
    (int8_mxu, x5) or B6 (x4); with int8_self and int8_mxu (x7) the self
    cache is quantized after the prefill and the step runs B8, then B4.

    step_weights (``ops.decoder_kernels.build_step_weights``,
    cfg.fused_decoder_step) takes the hybrid step instead
    (``decoder_step_hybrid``: one QKV product, plain attention against the
    prefill-layout cache, kernel B10c for the MLP); the kernel step and the
    int8 self cache are then not used, at any rung, as in the JAX
    package.

    ts_cfg (``runtime.timestamps.TimestampCfg``) enforces the timestamp
    grammar.  temperature > 0 samples under the key of ``generator`` (a
    ``torch.Generator``: its seed and, on a card, its offset;
    ``ops.sampling.generator_key``), held in the loop's state: the draws
    depend on the key, the step, the row and the id, not on the generator's
    later use (it is not advanced), and the graphed loop's are the eager
    loop's.

    pad_count ([B] int32 on enc_states' device): the first pad_count[r]
    prompt slots of row r are left padding (previous-text conditioning at
    one static prompt length): masked in the prefill, and passed to every
    step (B3/B8 on the kernel step), so each row decodes as its unpadded
    shorter prompt would.

    On a card the call runs as one launch of a CUDA graph kept in
    ``graphs`` (a ``DecodeGraphs`` of these weights; None: captured for
    this call alone), unless ``eager`` or a mesh whose collectives cannot
    be captured (``graphed``): the front, the prefill and the first pick,
    then the steps under the graph's while node, on the card, nothing read
    (see the module's docstring), so the call returns before the decode
    ends.  The eager loop runs the same front and prefill, then reads
    ``done`` on the host once a step, where the JAX loop stops (an eager
    mesh on a card once ``EXIT_BLOCK`` steps), or never with early_exit
    False (every step runs).

    mesh: this rank's share of a (data, model) mesh: enc_states are its
    rows, the weights its shard (``parallel.mesh.shard_params``); the
    tokens returned are its rows.  row0: the place of its first row in the
    batch, so that sampled draws equal the one-process decode's (``pick``);
    a key of its own."""
    from whisper_tpu_torch.runtime import timestamps as ts

    if step_weights is not None and pad_count is not None:
        # decoder_step_hybrid has no pad mask: it would attend the left
        # padding and offset positions on conditioned prompts.
        raise ValueError("step_weights (fused_decoder_step) does not "
                         "support pad_count-conditioned prompts")
    if temperature > 0 and generator is None:
        raise ValueError("temperature > 0 requires a generator")
    kernel_step = kernel_step and step_weights is None
    if kernel_step and not int8_cross_kv:
        raise ValueError("kernel_step needs the int8 cross cache")
    front = (enc_states if isinstance(enc_states, Front)
             else states_front(enc_states))
    b, cross_len, dev = front.rows, front.length, front.device
    p = prompt.shape[0]
    x7 = kernel_step and int8_self and int8_mxu
    # every value that changes from call to call is an input tensor: the
    # program reads it from the key's static copy
    inputs = front.inputs + (prompt.long(), suppress_mask,
                             first_suppress_mask)
    if pad_count is not None:
        inputs += (pad_count,)
    if temperature > 0:
        inputs += (torch.full((1,), temperature, dtype=torch.float32,
                              device=dev),
                   sampling.generator_key(generator, dev))
    nf = len(front.inputs)

    def prepare(xs, out: Optional[LoopState] = None) -> LoopState:
        """The front (the encoder states), the prefill and the first
        token: the state before step 1, written into ``out`` where given
        (the prefill's cache straight into its cache; at x7 the self cache
        quantized from a bf16 buffer of the prefill's)."""
        enc = front.encode(*xs[:nf])
        prompt_t, suppress, first_mask, *rest = xs[nf:]
        pads = rest.pop(0) if pad_count is not None else None
        t, key = rest if temperature > 0 else (0.0, None)
        tokens = prompt_t[None, :].expand(b, p)
        prompt_mask = None
        if pads is not None:
            prompt_mask = (torch.arange(p, device=dev)[None, :]
                           >= pads[:, None])                   # [B, P]
        cache = None if out is None else out.cache
        if cache is not None and x7:
            bf = torch.empty(cache.self_k.shape, device=dev,
                             dtype=params["decoder"]["tok_emb"].dtype)
            cache = cache._replace(self_k=bf, self_v=torch.empty_like(bf),
                                   self_k_scale=None, self_v_scale=None)
        logits, cache = whisper.decoder_prefill(
            params, dims, tokens, enc, p + max_new_tokens,
            int8_cross_kv=int8_cross_kv, prompt_mask=prompt_mask, mesh=mesh,
            cache=cache)
        if x7:
            cache = whisper.quantize_self_kv(cache)
        first_logits = logits[:, -1, :].float() + first_mask
        ts_state = None
        if ts_cfg is not None:
            ts_state = ts.init_state(b, eot_id, dev)
            first_logits = ts.apply_rules(first_logits, ts_state, 0, ts_cfg)
        # the pick's workspace: made (zeroed) with a new state, outside any
        # capture; a graph's program reuses its state's
        ws = None
        if temperature > 0:
            ws = (sampling.pick_workspace(b, dev) if out is None
                  else out.pick_ws)
        first, sum_lp = pick(first_logits, t, key, 0, return_logprobs, row0,
                             ws)
        if ts_cfg is not None:
            ts_state = ts.update_state(ts_state, first.clone(), ts_cfg)
        buf = torch.full((b, max_new_tokens), eot_id, dtype=torch.long,
                         device=dev)
        buf[:, 0] = first
        st = LoopState(
            last=first, pos=torch.full((1,), p, dtype=torch.int32,
                                       device=dev),
            step=torch.ones(1, dtype=torch.long, device=dev),
            done=first == eot_id, buf=buf, suppress=suppress,
            cache=cache, sum_lp=sum_lp,
            n_tok=(torch.ones(b, dtype=torch.long, device=dev)
                   if return_logprobs else None),
            ts=ts_state, pad_count=pads,
            temperature=t if temperature > 0 else None, key=key, pick_ws=ws)
        return st if out is None else out.copy_(st)

    def make_step(st: LoopState):
        return _step_fn(st, params, dims, eot_id=eot_id,
                        kernel_step=kernel_step, cross_len=cross_len,
                        int8_mxu=int8_mxu, step_weights=step_weights,
                        ts_cfg=ts_cfg, return_logprobs=return_logprobs,
                        mesh=mesh, row0=row0)

    key = GraphKey(b, p, max_new_tokens, cross_len, kernel_step, int8_mxu,
                   int8_self, int8_cross_kv, step_weights is not None, ts_cfg,
                   temperature > 0, return_logprobs, pad_count is not None,
                   eot_id, row0=row0, front=front_key(front))
    return run_loop(inputs, prepare, make_step, 1, max_new_tokens,
                    exit_period(early_exit, dev, mesh, eager=eager),
                    graphs=graphs, key=key, device=dev, params=params,
                    step_weights=step_weights, encoders=front.weights,
                    mesh=mesh, eager=eager)


def strip_generated(row: np.ndarray, eot_id: int) -> list[int]:
    """Cut a generated row at the first EOT (exclusive), like the
    reference's strip of the trailing EOT (src/main.rs:926-943)."""
    out = []
    for t in row.tolist():
        if t == eot_id:
            break
        out.append(int(t))
    return out
