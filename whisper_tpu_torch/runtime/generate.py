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
distribution ``jax.random.categorical`` draws from, with the draws from an
explicit ``torch.Generator`` on the logits' device; ``return_logprobs``
also returns each row's summed log-probability (``log_softmax`` of the
masked logits, before the division by T) and its token count.

The JAX ``lax.while_loop`` becomes a step function that updates the
loop's state in place (``LoopState``: the last token, the cache slot
``pos`` and the step counter as one-element device tensors, ``done``, the
token buffer, the scores, the grammar's state and the cache), so that no
host value changes from one step to the next.  On the CPU the step
function is called as it is.  On a card it is warmed once on a side stream,
captured in a ``torch.cuda.CUDAGraph`` per key (``DecodeGraphs``: the
batch rows, the prompt length, max_new_tokens, the step's route and rung,
the grammar, whether it samples, the scores, ``pad_count``) and replayed
once a step; a capture that fails raises.  The temperature is a tensor of
the state, so every T > 0 shares one graph.  A key's loop keeps its state
(the cache of its rows) for later calls; the loops of one ``DecodeGraphs``
keep at most a quarter of the card's memory in it, the least recently
used dropped first.  ``eager=True`` runs the step
function on the card without a graph (the card checks compare the two).
A replay adds to the kernels' launch counters what its capture tallied
(``ops.common.tally_launches``).  The same machinery (``InPlaceState``,
``_GraphLoop``, ``DecodeGraphs``, ``run_loop``) runs the beam loop
(``runtime.beam``) and the speculative rounds (``runtime.speculative``),
each with a key of its own, under one budget.

The early exit: with ``early_exit=False`` the loop reads nothing on the
host and every step runs (the ``_async`` entry points; a row past EOT
emits EOT and adds nothing to its scores, so the tokens, sums and counts
are those of a loop that stopped).  Otherwise it reads whether every row
is done once a block of ``EXIT_BLOCK`` steps on a card, once a step on
the CPU: on a card from a non-blocking copy, read only after the next block
is queued, so the card never waits on the host.

Under a mesh (``parallel.mesh``) every rank runs the step function on its
own rows without a graph, since gloo's collectives go through the host
(``mesh=`` reaches the model's collectives): the model ranks of one data
rank hold the same rows, and their logits follow the same all-reduce, so
their ``done`` reads agree and they take the same number of steps, as the
collectives need; a data rank stops when its own rows end.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from whisper_tpu_torch.models import whisper
from whisper_tpu_torch.models.registry import WhisperDims
from whisper_tpu_torch.ops.decoder_kernels import decoder_step_hybrid


def build_suppress_mask(vocab_size: int, ids: Sequence[int] | None) -> np.ndarray:
    """Additive float32 mask [V]: 0 everywhere, -inf at suppressed ids."""
    mask = np.zeros(vocab_size, dtype=np.float32)
    if ids:
        idx = np.asarray([i for i in ids if 0 <= i < vocab_size], dtype=np.int64)
        mask[idx] = -np.inf
    return mask


def pick(logits: torch.Tensor, temperature, generator,
         want_lp: bool, rows=None):
    """(token [B], its log-probability [B] or None) from masked fp32 logits
    [B, V].  T > 0: argmax(logits / T - log E), E ~ Exp(1) (a Gumbel-max
    draw); E is floored at the smallest normal float, so a suppressed id
    (-inf) can never be drawn.  The log-probability is that of the masked
    distribution at T = 1, as the JAX ``pick`` takes it.  temperature: a
    float, or a one-element fp32 tensor holding T > 0 (the loop's step).

    rows (lo, hi, n): the logits are rows [lo, hi) of a batch of n (a data
    rank's share): the draws are made for all n rows, as the one-process
    decode makes them, and rows [lo, hi) taken."""
    if torch.is_tensor(temperature) or temperature > 0:
        if rows is None:
            e = torch.empty_like(logits).exponential_(generator=generator)
        else:
            lo, hi, n = rows
            e = logits.new_empty((n,) + tuple(logits.shape[1:])).exponential_(
                generator=generator)[lo:hi]
        tok = torch.argmax(
            logits / temperature
            - torch.log(e.clamp_min_(torch.finfo(torch.float32).tiny)), -1)
    else:
        tok = torch.argmax(logits, dim=-1)
    if not want_lp:
        return tok, None
    lp = torch.log_softmax(logits, dim=-1).gather(-1, tok[:, None])[:, 0]
    return tok, lp


EXIT_BLOCK = 16  # steps a synchronous caller runs between two reads of done


class InPlaceState:
    """What ``_GraphLoop`` needs of a decode loop's state (``LoopState``
    here, ``beam.BeamState``, ``speculative.SpecState``): ``tensors()``,
    every tensor one step updates in place or reads, in one fixed order;
    ``done``, the tensor whose ``all()`` ends the loop; ``owned()``, the
    state with the caller's tensors (masks, pads) cloned, so that a graph
    that adopts it reads none of them; ``outputs()``, copies of the
    results, so that the next run may reuse the state."""

    done: torch.Tensor

    def tensors(self) -> list:
        raise NotImplementedError

    def owned(self):
        raise NotImplementedError

    def outputs(self):
        raise NotImplementedError

    def nbytes(self) -> int:
        """Device bytes the state's tensors hold (whole storages, once)."""
        storages = {t.untyped_storage().data_ptr():
                    t.untyped_storage().nbytes() for t in self.tensors()}
        return sum(storages.values())

    def copy_(self, other: "InPlaceState") -> None:
        for mine, theirs in zip(self.tensors(), other.tensors()):
            mine.copy_(theirs)


@dataclasses.dataclass
class LoopState(InPlaceState):
    """The greedy loop's carried state: every field a tensor on the device
    that one step updates in place (``_step_fn``)."""

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

    def tensors(self) -> list:
        """Every tensor of the state, in one fixed order."""
        out = [self.last, self.pos, self.step, self.done, self.buf,
               self.suppress, *self.cache, self.sum_lp, self.n_tok,
               *(self.ts or ()), self.pad_count, self.temperature]
        return [t for t in out if t is not None]

    def owned(self) -> "LoopState":
        return dataclasses.replace(
            self, suppress=self.suppress.clone(),
            pad_count=None if self.pad_count is None
            else self.pad_count.clone())

    def outputs(self):
        """buf, or with scores (buf, sum_lp, n_tok)."""
        if self.sum_lp is not None:
            return self.buf.clone(), self.sum_lp.clone(), self.n_tok.clone()
        return self.buf.clone()


def _step_fn(st: LoopState, params, dims: WhisperDims, *, eot_id: int,
             kernel_step: bool, cross_len: int, int8_mxu: bool,
             step_weights, ts_cfg, generator, return_logprobs: bool, mesh,
             draw_rows):
    """One decode step over ``st``, in place: nothing is read on the host
    and no host value changes between steps, so a CUDA graph of it replays
    every step."""
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
        nxt, lp = pick(logits, temperature, generator, return_logprobs,
                       draw_rows)
        nxt = torch.where(st.done, eot_id, nxt)
        if return_logprobs:
            # rows done before this step add nothing
            st.sum_lp.add_(torch.where(st.done, 0.0, lp))
            st.n_tok.add_((~st.done).long())
        if ts_cfg is not None:
            ts.update_state_(st.ts, nxt, ts_cfg)
        st.buf.index_copy_(1, st.step, nxt[:, None])
        st.done.logical_or_(nxt == eot_id)
        st.last.copy_(nxt)
        st.pos.add_(1)
        st.step.add_(1)

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
           exit_every: Optional[int], first_step=None) -> None:
    """Steps first .. n-1.  exit_every None: no read.  Else ``done`` is
    copied once a block of exit_every steps and, for blocks of more than
    one step, read only after the next block is queued.  first_step, where
    given, runs step ``first`` in place of ``step`` (a key's capture, whose
    warm-up runs the step for real), so that the blocks and the reads fall
    where the eager loop's do."""
    lag = 0 if exit_every == 1 else 1
    flags: collections.deque = collections.deque()
    i = first
    while i < n:
        if exit_every is not None:
            flags.append(_done_flag(done))
            if len(flags) > lag and _read(flags.popleft()):
                return
        hi = n if exit_every is None else min(i + exit_every, n)
        for j in range(i, hi):
            (step if first_step is None or j != first else first_step)()
        i = hi


_CAPTURE_LOCK = threading.Lock()  # one capture at a time in the process
_CAPTURE_STREAMS: dict = {}       # device -> (warm-up stream, capture stream)

GRAPH_MEMORY_SHARE = 0.25  # of the card's memory, for one DecodeGraphs


def _budget(device) -> int:
    """The bytes of loop state one ``DecodeGraphs`` keeps on ``device``."""
    card = torch.cuda.get_device_properties(device)
    return int(GRAPH_MEMORY_SHARE * card.total_memory)


class _GraphLoop:
    """One key's static state, its captured step and the launches the
    capture tallied.  ``run`` holds the loop's lock from the copy-in to the
    queued copies of the results, so two threads never share the state."""

    def __init__(self, device: torch.device, sampled: bool):
        self.device = device
        self.generator = (torch.Generator(device=device) if sampled
                          else None)
        self.state: Optional[InPlaceState] = None
        self.graph = None
        self.tally: dict = {}
        self.capture_s = 0.0
        self.nbytes = 0     # the state's device bytes
        self._lock = threading.Lock()
        self._free = None   # an event: the last run's results are copied

    def _seeded(self, generator):
        """The loop's generator at the caller's seed and offset (the
        graph draws from its own, registered one)."""
        if generator.device.type != self.device.type:
            raise RuntimeError(f"generator on {generator.device}, the decode "
                               f"on {self.device}")
        self.generator.manual_seed(generator.initial_seed())
        offset = generator.get_offset()
        if offset:
            self.generator.set_offset(offset)
        return self.generator

    def _capture(self, step) -> None:
        """Run ``step`` once for real on a side stream (the warm-up: the
        first call's step 1), then capture it on a stream of its own; both
        streams are the device's two, made once (each stream that runs a
        product keeps a cuBLAS workspace).  Unlike ``torch.cuda.graph``, no
        device-wide sync, garbage collection or emptying of the allocator's
        cache: a key met while serving holds back no other thread's work."""
        from whisper_tpu_torch.ops.common import tally_launches

        t0 = time.perf_counter()
        with _CAPTURE_LOCK:
            if self.device not in _CAPTURE_STREAMS:
                _CAPTURE_STREAMS[self.device] = (
                    torch.cuda.Stream(self.device),
                    torch.cuda.Stream(self.device))
            side, own = _CAPTURE_STREAMS[self.device]
            main = torch.cuda.current_stream(self.device)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                step()
            main.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            if self.generator is not None:
                graph.register_generator_state(self.generator)
            with tally_launches() as tally, torch.cuda.stream(own):
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    step()
                finally:
                    try:
                        graph.capture_end()
                    except BaseException:
                        # the allocator may go on routing this stream's
                        # allocations to the failed capture's pool
                        del _CAPTURE_STREAMS[self.device]
                        raise
        self.graph, self.tally = graph, dict(tally)
        self.capture_s = time.perf_counter() - t0

    def _capturing(self, step):
        """Step ``first`` of a key's first call: ``_capture`` (its warm-up
        runs the step); a capture that fails drops the state and raises."""
        def first_step() -> None:
            try:
                self._capture(step)
            except BaseException:
                self.state = None
                raise
        return first_step

    def _replay(self) -> None:
        from whisper_tpu_torch.ops.common import add_launches

        self.graph.replay()
        add_launches(self.tally)

    def run(self, init, make_step, first: int, n: int,
            exit_every: Optional[int], generator):
        """init(generator) -> the call's state before step ``first`` (an
        ``InPlaceState``); make_step(state, generator) -> the step
        function; steps first .. n-1 (``_drive``), then the outputs."""
        with self._lock:
            main = torch.cuda.current_stream(self.device)
            if self._free is not None:
                main.wait_event(self._free)
            gen = None if self.generator is None else self._seeded(generator)
            fresh = init(gen)
            first_step = None
            if self.state is None:
                # adopt the first call's tensors as the static state; its
                # first step is the capture's warm-up, then the capture
                self.state = fresh.owned()
                first_step = self._capturing(make_step(self.state, gen))
            else:
                self.state.copy_(fresh)
            del fresh
            _drive(self._replay, first, n, self.state.done, exit_every,
                   first_step=first_step)
            out = self.state.outputs()
            if self.graph is None:      # no step ran: capture at a later call
                self.state = None
            self.nbytes = 0 if self.state is None else self.state.nbytes()
            self._free = torch.cuda.Event()
            self._free.record(main)
            return out

    def release(self) -> None:
        """Drop the graph and the state once the last run's work is done
        (a later run captures anew)."""
        with self._lock:
            if self._free is not None:
                self._free.synchronize()
            self.state, self.graph, self.tally, self.nbytes = None, None, {}, 0


class GraphKey(NamedTuple):
    """What a captured greedy step is specialised to.  Each loop has a key
    of its own (``beam.BeamKey``, ``speculative.SpecKey``), each ending in
    its ``kind``, so that keys of two loops never compare equal."""

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
    sampled: bool          # temperature > 0 (T itself is in the state)
    scores: bool
    pads: bool
    eot_id: int
    kind: str = "greedy"


class DecodeGraphs:
    """The captured decode loops of one set of weights (a session's: the
    decoder tree, for the hybrid step its step weights, and for speculative
    decoding the draft's decoder tree, held here), one per key, of every
    kind: greedy steps, beam steps and speculative rounds;
    ``greedy_generate``, ``beam_generate`` and ``speculative_generate``
    take it (``graphs=``) and refuse other weights.  The loops keep at most
    ``GRAPH_MEMORY_SHARE`` of the card's memory in state, every kind
    counted: after a run that passes it, the least recently used other
    loops are dropped.  Not counted: the temporaries of one step that each
    graph's own memory pool keeps."""

    def __init__(self, params, step_weights=None, draft_params=None):
        self.params = params
        self.step_weights = step_weights
        self.draft_params = draft_params
        self._loops: collections.OrderedDict = collections.OrderedDict()
        self._lock = threading.Lock()

    def loop(self, params, step_weights, key, device, sampled: bool,
             draft_params=None) -> _GraphLoop:
        if params is not self.params or (
                step_weights is not None
                and step_weights is not self.step_weights) or (
                draft_params is not None
                and draft_params is not self.draft_params):
            raise ValueError("these decode graphs belong to other weights")
        with self._lock:
            if key not in self._loops:
                self._loops[key] = _GraphLoop(device, sampled)
            self._loops.move_to_end(key)
            return self._loops[key]

    def set_draft(self, draft_params) -> None:
        """Serve speculative rounds with ``draft_params`` from now on: every
        speculative loop, captured with the draft before, is dropped."""
        with self._lock:
            self.draft_params = draft_params
            victims = [self._loops.pop(k) for k in list(self._loops)
                       if k.kind == "speculative"]
        for v in victims:
            v.release()

    def trim(self, keep) -> None:
        """Drop the least recently used loops other than ``keep`` while the
        loops' state passes the budget."""
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
        """Device bytes of the state the loops keep."""
        with self._lock:
            return sum(v.nbytes for v in self._loops.values())

    def kept(self) -> dict:
        """{key: device bytes its loop's state keeps}."""
        with self._lock:
            return {k: v.nbytes for k, v in self._loops.items()}

    def captures(self) -> dict:
        """{key: seconds its warm-up step and capture took}, for the loops
        kept and captured."""
        with self._lock:
            return {k: v.capture_s for k, v in self._loops.items()
                    if v.graph is not None}


def exit_period(early_exit: bool, device, block: int = EXIT_BLOCK):
    """Steps between two reads of ``done`` (``_drive``): None without the
    early exit, ``block`` on a card, one on the CPU."""
    if not early_exit:
        return None
    return block if device.type == "cuda" else 1


def run_loop(init, make_step, first: int, n: int, exit_every, *,
             graphs: Optional[DecodeGraphs], key, device, params,
             step_weights=None, draft_params=None, generator=None,
             sampled: bool = False):
    """Steps first .. n-1 of a decode loop over the state ``init`` makes:
    eagerly (``graphs`` None: the CPU, a mesh, ``eager=True``), else
    replayed from the CUDA graph of ``key`` in ``graphs``, which then drops
    what passes its budget.  Returns the state's outputs."""
    if graphs is None:
        st = init(generator)
        _drive(make_step(st, generator), first, n, st.done, exit_every)
        return st.outputs()
    loop = graphs.loop(params, step_weights, key, device, sampled,
                       draft_params)
    out = loop.run(init, make_step, first, n, exit_every, generator)
    graphs.trim(key)
    return out


def greedy_generate(params, dims: WhisperDims, enc_states: torch.Tensor,
                    prompt: torch.Tensor, suppress_mask: torch.Tensor,
                    first_suppress_mask: torch.Tensor, max_new_tokens: int,
                    eot_id: int, *, ts_cfg=None, int8_cross_kv: bool = False,
                    kernel_step: bool = False,
                    int8_mxu: bool = True, int8_self: bool = False,
                    step_weights=None, temperature: float = 0.0,
                    generator: torch.Generator | None = None,
                    return_logprobs: bool = False, pad_count=None,
                    mesh=None, draw_rows=None, early_exit: bool = True,
                    eager: bool = False,
                    graphs: Optional[DecodeGraphs] = None):
    """Generated tokens [B, max_new_tokens] (prompt excluded), rows that
    finished early padded with EOT; with return_logprobs also (sum_lp [B]
    fp32, n_tok [B] int64): the log-probability summed over each row's
    tokens up to and including its first EOT, and their count.  prompt: [P]
    ids shared by every row; masks: [V] fp32 additive.  kernel_step runs the
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
    grammar.  temperature > 0 samples with ``generator``, a
    ``torch.Generator`` on enc_states' device (a graphed loop draws from a
    generator of its own set to this one's seed and offset).

    pad_count ([B] int32 on enc_states' device): the first pad_count[r]
    prompt slots of row r are left padding (previous-text conditioning at
    one static prompt length): masked in the prefill, and passed to every
    step (B3/B8 on the kernel step), so each row decodes as its unpadded
    shorter prompt would.

    early_exit False reads nothing on the host (every step runs); else the
    loop reads ``done`` once a block of ``EXIT_BLOCK`` steps on a card,
    once a step on the CPU (see the module's docstring).  On a card
    without a mesh the steps replay from a CUDA graph, kept in ``graphs``
    (a ``DecodeGraphs`` of these weights; None: captured for this call
    alone), unless ``eager``.

    mesh: this rank's share of a (data, model) mesh: enc_states are its
    rows, the weights its shard (``parallel.mesh.shard_params``); the
    tokens returned are its rows, decoded without a graph.  draw_rows (lo,
    hi, n): those rows' place in the batch, so that sampled draws equal the
    one-process decode's (``pick``)."""
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
    b = enc_states.shape[0]
    p = prompt.shape[0]
    dev = enc_states.device
    cross_len = enc_states.shape[1]

    def init(gen) -> LoopState:
        """The prefill and the first token: the state before step 1."""
        tokens = prompt.to(device=dev, dtype=torch.long)[None, :].expand(b, p)
        prompt_mask = None
        if pad_count is not None:
            prompt_mask = (torch.arange(p, device=dev)[None, :]
                           >= pad_count[:, None])              # [B, P]
        logits, cache = whisper.decoder_prefill(
            params, dims, tokens, enc_states, p + max_new_tokens,
            int8_cross_kv=int8_cross_kv, prompt_mask=prompt_mask, mesh=mesh)
        if kernel_step and int8_self and int8_mxu:
            cache = whisper.quantize_self_kv(cache)
        first_logits = logits[:, -1, :].float() + first_suppress_mask
        ts_state = None
        if ts_cfg is not None:
            ts_state = ts.init_state(b, eot_id, dev)
            first_logits = ts.apply_rules(first_logits, ts_state, 0, ts_cfg)
        first, sum_lp = pick(first_logits, temperature, gen,
                             return_logprobs, draw_rows)
        if ts_cfg is not None:
            ts_state = ts.update_state(ts_state, first.clone(), ts_cfg)
        buf = torch.full((b, max_new_tokens), eot_id, dtype=torch.long,
                         device=dev)
        buf[:, 0] = first
        return LoopState(
            last=first, pos=torch.full((1,), p, dtype=torch.int32,
                                       device=dev),
            step=torch.ones(1, dtype=torch.long, device=dev),
            done=first == eot_id, buf=buf, suppress=suppress_mask,
            cache=cache, sum_lp=sum_lp,
            n_tok=(torch.ones(b, dtype=torch.long, device=dev)
                   if return_logprobs else None),
            ts=ts_state, pad_count=pad_count,
            temperature=(torch.full((1,), temperature, dtype=torch.float32,
                                    device=dev) if temperature > 0 else None))

    def make_step(st: LoopState, gen):
        return _step_fn(st, params, dims, eot_id=eot_id,
                        kernel_step=kernel_step, cross_len=cross_len,
                        int8_mxu=int8_mxu, step_weights=step_weights,
                        ts_cfg=ts_cfg, generator=gen, return_logprobs=return_logprobs,
                        mesh=mesh, draw_rows=draw_rows)

    graphed = dev.type == "cuda" and mesh is None and not eager
    if graphed and graphs is None:
        graphs = DecodeGraphs(params, step_weights)
    key = GraphKey(b, p, max_new_tokens, cross_len, kernel_step, int8_mxu,
                   int8_self, int8_cross_kv, step_weights is not None, ts_cfg,
                   temperature > 0, return_logprobs, pad_count is not None,
                   eot_id)
    return run_loop(init, make_step, 1, max_new_tokens,
                    exit_period(early_exit, dev),
                    graphs=graphs if graphed else None, key=key, device=dev,
                    params=params, step_weights=step_weights,
                    generator=generator, sampled=temperature > 0)


def strip_generated(row: np.ndarray, eot_id: int) -> list[int]:
    """Cut a generated row at the first EOT (exclusive), like the
    reference's strip of the trailing EOT (src/main.rs:926-943)."""
    out = []
    for t in row.tolist():
        if t == eot_id:
            break
        out.append(int(t))
    return out
