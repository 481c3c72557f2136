"""A mesh rank's decode loops as one launch of its program
(``runtime.generate.graphed``, the rule for when a rank graphs) on the CPU.

- The rule, case by case: a card, not ``eager``, and every collective on
  the loop's path capturable (no mesh; a model axis of one rank over any
  backend, data parallelism's gather coming after the launch; a model axis
  over NCCL), else eager (the CPU; ``eager``; a model axis over gloo; a
  mesh without groups whose model axis has more than one rank).
  ``make_mesh`` records its groups' backend (a gloo world of one).
- ``GraphKey``, ``BeamKey`` and ``SpecKey`` of one shape at two data
  shares (``row0``) differ, and so do the programs a ``DecodeGraphs``
  keeps for them.  ``exit_period`` gives its block only to an eager mesh
  on a card.
- A data rank (a mesh without groups whose model axis has one rank, so no
  collective on the loop's path) through the graphed schedule, with the
  rule as a card takes it and the while node's plain form in place of the
  graph (``_PlainLoop`` of tests/test_torch_device_exit.py): greedy
  sampled at T > 0, beams K = 2 and speculative rounds, each one launch,
  bitwise the same rank's eager loop and the one-process decode's rows of
  that share.
- The memory gate (``session.speculative_footprint``) of a graphed rank
  prices its own rows, shard and pools: the terms both packages have equal
  the JAX package's ``decode_footprint`` at the rank's rows (under tensor
  parallelism at the rank's heads), the weights the rank's shard, the
  pools ``program_pool_bytes`` at its rows and heads, and the budget the
  rank's own card's.
- The trial capture of a step whose capture holds a node a while node's
  body may not hold raises naming its type, through a fake library.
"""

import contextlib
import dataclasses
import socket
import types

import pytest
import torch

from test_torch_device_exit import (  # noqa: F401 (fixtures)
    DIMS,
    PROMPT,
    SUPPRESS,
    _model,
    _PlainLoop,
    landed,
)
from whisper_tpu.models.registry import WhisperDims as JaxDims
from whisper_tpu.utils import hbm as jhbm
from whisper_tpu_torch.models import convert
from whisper_tpu_torch.ops import kernels
from whisper_tpu_torch.parallel import mesh as pm
from whisper_tpu_torch.runtime import beam, generate, speculative
from whisper_tpu_torch.runtime.generate import build_suppress_mask
from whisper_tpu_torch.runtime.session import RuntimeCfg, WhisperSession
from whisper_tpu_torch.utils import hbm

torch.set_num_threads(2)

CPU, CUDA = torch.device("cpu"), torch.device("cuda")
EOT = 300                       # suppressed: no row ends, every step runs
MAX_NEW = 10
ROWS = 4                        # the batch; a data rank of two holds 2


def _mesh(data=1, model=1, data_index=0, backend=None):
    return pm.Mesh(data=data, model=model, data_index=data_index,
                   model_backend=backend)


# ---------------------------------------------------------------------------
# the rule
# ---------------------------------------------------------------------------

RULE_CASES = {
    "card, no mesh": (CUDA, None, False, True),
    "card, eager": (CUDA, None, True, False),
    "the CPU": (CPU, None, False, False),
    "DP 2 over gloo": (CUDA, _mesh(data=2, backend="gloo"), False, True),
    "DP 2 over NCCL": (CUDA, _mesh(data=2, backend="nccl"), False, True),
    "TP 2 over gloo": (CUDA, _mesh(model=2, backend="gloo"), False, False),
    "DP 2 x TP 2 over gloo": (CUDA, _mesh(2, 2, backend="gloo"), False,
                              False),
    "TP 2 over NCCL": (CUDA, _mesh(model=2, backend="nccl"), False, True),
    "TP 2 over NCCL, eager": (CUDA, _mesh(model=2, backend="nccl"), True,
                              False),
    "TP 2 over NCCL on the CPU": (CPU, _mesh(model=2, backend="nccl"), False,
                                  False),
    "a mesh without groups, TP 2": (CUDA, _mesh(model=2), False, False),
    "a mesh without groups, DP 2": (CUDA, _mesh(data=2), False, True),
}


@pytest.mark.parametrize("case", list(RULE_CASES))
def test_the_rule_graphs_a_rank_whose_collectives_can_be_captured(case):
    device, mesh, eager, want = RULE_CASES[case]
    assert generate.graphed(device, mesh, eager) is want
    if mesh is not None:
        assert mesh.capturable is (mesh.model == 1
                                   or mesh.model_backend == "nccl")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_make_mesh_records_its_groups_backend():
    """A gloo world of one in this process: the mesh records gloo, and its
    model axis of one rank is capturable."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    pm.init_distributed(f"127.0.0.1:{_free_port()}", 1, 0, backend="gloo",
                        timeout_s=60)
    try:
        mesh = pm.make_mesh(1, 1)
    finally:
        dist.destroy_process_group()
    assert (mesh.model_backend, mesh.capturable) == ("gloo", True)
    assert not dataclasses.replace(mesh, model=2).capturable


# ---------------------------------------------------------------------------
# keys and the eager loop's reads
# ---------------------------------------------------------------------------

def _keys(row0):
    kw = {} if row0 is None else {"row0": row0}
    return (generate.GraphKey(2, 4, 8, 1500, True, True, False, True, False,
                              None, False, False, False, EOT, **kw),
            beam.BeamKey(4, 2, 4, 8, 1500, True, True, True, None, False,
                         EOT, **kw),
            speculative.SpecKey(2, 4, 8, 3, 1500, 1500, True, True, True,
                                True, EOT, **kw))


@pytest.mark.parametrize("kind", [0, 1, 2], ids=["greedy", "beam",
                                                 "speculative"])
def test_keys_of_two_data_shares_differ(kind):
    first, second, default = (_keys(r)[kind] for r in (0, 2, None))
    assert first != second and hash(first) != hash(second)
    assert first == default and second.row0 == 2


EXIT_CASES = {
    "TP 2 over gloo, a card": (CUDA, _mesh(model=2, backend="gloo"), False,
                               generate.EXIT_BLOCK),
    "TP 2 over NCCL, a card, eager": (CUDA, _mesh(model=2, backend="nccl"),
                                      True, generate.EXIT_BLOCK),
    "TP 2 over NCCL, a card, graphed": (CUDA,
                                        _mesh(model=2, backend="nccl"),
                                        False, 1),
    "DP 2 over gloo, a card, graphed": (CUDA, _mesh(data=2, backend="gloo"),
                                        False, 1),
    "TP 2 over gloo, the CPU": (CPU, _mesh(model=2, backend="gloo"), False,
                                1),
    "no mesh, a card, eager": (CUDA, None, True, 1),
}


@pytest.mark.parametrize("case", list(EXIT_CASES))
def test_exit_period_blocks_only_an_eager_mesh_on_a_card(case):
    device, mesh, eager, want = EXIT_CASES[case]
    assert generate.exit_period(True, device, mesh, eager=eager) == want
    assert generate.exit_period(False, device, mesh, eager=eager) is None
    spec = speculative.EXIT_BLOCK if want != 1 else 1
    assert generate.exit_period(True, device, mesh, speculative.EXIT_BLOCK,
                                eager=eager) == spec


# ---------------------------------------------------------------------------
# a data rank through the graphed schedule
# ---------------------------------------------------------------------------

@pytest.fixture
def as_on_a_card(monkeypatch, landed):  # noqa: F811 (a fixture)
    """The graphed schedule on the CPU with the rule as a card takes it:
    ``graphed`` asked for a card, ``_PlainLoop`` for the graph, no bound
    on the state kept."""
    rule = generate.graphed
    monkeypatch.setattr(generate, "graphed",
                        lambda device, mesh, eager: rule(CUDA, mesh, eager))
    monkeypatch.setattr(generate, "_GraphLoop", _PlainLoop)
    monkeypatch.setattr(generate, "_budget", lambda device: 1 << 62)


def _launches(monkeypatch):
    """Every launch of a graph (``_PlainLoop``'s graph), in a list."""
    runs = []
    real = _PlainLoop._launch

    def launch(self):
        runs.append(1)
        real(self)

    monkeypatch.setattr(_PlainLoop, "_launch", launch)
    return runs


def _decode(loop, tp, enc, mesh, row0, graphs, draft=None, **kw):
    """One decode of ``enc`` (a tensor of rows) by ``loop``: its tokens."""
    base = torch.from_numpy(build_suppress_mask(DIMS.vocab_size, SUPPRESS))
    prompt = torch.tensor(PROMPT)
    args = (tp, DIMS, enc, prompt, base, base, MAX_NEW, EOT)
    if loop == "greedy sampled":
        return generate.greedy_generate(
            *args, temperature=0.7,
            generator=torch.Generator().manual_seed(11), mesh=mesh,
            row0=row0, graphs=graphs, **kw)
    if loop == "beam":
        return beam.beam_generate(*args, 2, mesh=mesh, row0=row0,
                                  graphs=graphs, **kw)[0]
    return speculative.speculative_generate(
        tp, DIMS, draft, DIMS, enc, enc, prompt, base, base, MAX_NEW, EOT, 3,
        mesh=mesh, row0=row0, graphs=graphs, **kw)[0]


@pytest.mark.parametrize("loop", ["greedy sampled", "beam", "speculative"])
def test_a_data_rank_graphed_equals_its_eager_loop_and_one_process(
        loop, as_on_a_card, monkeypatch):
    enc, _, tp = _model(6, b=ROWS)
    enc = torch.from_numpy(enc)
    draft = convert.params_from_numpy(convert.init_params(DIMS, 9), "cpu",
                                      torch.float32)
    graphs = generate.DecodeGraphs(tp, draft_params=draft)
    whole = _decode(loop, tp, enc, None, 0, None, draft, eager=True)
    launches = _launches(monkeypatch)
    for index in (1, 0):
        mesh = _mesh(data=2, data_index=index)
        lo, hi = pm.data_rows(ROWS, mesh)
        rows = enc[lo:hi]
        eager = _decode(loop, tp, rows, mesh, lo, graphs, draft, eager=True)
        assert not launches
        for _ in range(2):
            got = _decode(loop, tp, rows, mesh, lo, graphs, draft)
            assert torch.equal(got, eager)
        assert len(launches) == 2
        launches.clear()
        assert torch.equal(eager, whole[lo:hi])
    shares = sorted(k.row0 for k in graphs.captures())
    assert shares == [0, 2]


# ---------------------------------------------------------------------------
# the memory gate of a graphed rank
# ---------------------------------------------------------------------------

GATE_DIMS = dataclasses.replace(DIMS, vocab_size=512,
                                max_source_positions=1500)


def _jax_dims(dims, tp=1):
    """The JAX dims of one model rank's heads (head_dim kept)."""
    return JaxDims(**dict(dataclasses.asdict(dims),
                          d_model=dims.d_model // tp,
                          encoder_heads=dims.encoder_heads // tp,
                          decoder_heads=dims.decoder_heads // tp))


@pytest.mark.parametrize("dp,tp", [(2, 1), (2, 2), (1, 2)])
def test_a_graphed_rank_prices_its_own_rows_shard_and_pools(
        dp, tp, monkeypatch):
    params = convert.init_params(GATE_DIMS, seed=0)
    mesh = _mesh(dp, tp, data_index=dp - 1, backend="nccl")
    cfg = RuntimeCfg(dtype="float32", max_batch=8)
    sess = WhisperSession(params, GATE_DIMS, cfg, device="cpu", mesh=mesh)
    ddims = dataclasses.replace(GATE_DIMS, encoder_layers=1,
                                decoder_layers=1)
    rule = generate.graphed
    monkeypatch.setattr(generate, "graphed",
                        lambda device, mesh, eager: rule(CUDA, mesh, eager))
    monkeypatch.setattr(generate, "_budget", lambda device: 3 << 30)
    got = sess.speculative_footprint(ddims)
    rows = cfg.max_batch // dp
    want = jhbm.decode_footprint(
        JaxDims(**dataclasses.asdict(GATE_DIMS)), rows, 132, weight_bytes=4,
        kv_bytes=4, draft_dims=JaxDims(**dataclasses.asdict(ddims)))
    # the rank's heads of the main model's caches
    want["kv_cache"] = jhbm.kv_cache_bytes(
        _jax_dims(GATE_DIMS, tp), rows, 132, GATE_DIMS.max_source_positions,
        kv_bytes=4)
    # the rank's shard of the weights
    shard = pm.shard_params(params, mesh)
    want["params"] = 4 * sum(x.size for x in _leaves(shard))
    for term in ("params", "kv_cache", "enc_states", "draft_params",
                 "draft_kv_cache", "draft_enc_states"):
        assert got[term] == want[term], term
    assert got["graph_pool"] == hbm.program_pool_bytes(
        GATE_DIMS, rows, 4, act_bytes=4, fused_attention=False,
        draft_dims=ddims, tensor_parallel=tp)
    one = hbm.program_pool_bytes(GATE_DIMS, cfg.max_batch, 4, act_bytes=4,
                                 fused_attention=False, draft_dims=ddims)
    assert got["graph_pool"] < one
    assert got["graph_kept"] == 3 << 30
    assert got["total"] == sum(v for k, v in got.items() if k != "total")
    # the eager rule prices no pools
    sess.eager_decode = True
    eager = sess.speculative_footprint(ddims)
    assert "graph_pool" not in eager and "graph_kept" not in eager


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


# ---------------------------------------------------------------------------
# a node a while node's body may not hold
# ---------------------------------------------------------------------------

class _Trial:
    def capture_begin(self, **kw):
        pass

    def capture_end(self):
        pass


@pytest.mark.parametrize("bad,name", [(-1, None), (7, "event record"),
                                      (3, "host"), (10, "memory allocation"),
                                      (12, "type 12")])
def test_the_trial_capture_raises_for_a_node_a_body_may_not_hold(
        bad, name, monkeypatch):
    class Lib:
        def wt_capture_bad_node(self, stream, out):
            out._obj.value = bad
            return 0

    monkeypatch.setattr(kernels, "library", lambda: Lib())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Trial)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    stream = types.SimpleNamespace(cuda_stream=0)
    assert generate._bad_body_node(stream) == name
    loop = generate._GraphLoop(CPU, _mesh(model=2, backend="nccl"))
    ran = []
    # the pre-node program's trial is not walked
    assert isinstance(loop._trial_capture(lambda: ran.append(1), stream,
                                          None), _Trial)
    if name is None:
        assert isinstance(loop._trial_capture(lambda: ran.append(1), stream,
                                              None, body=True), _Trial)
        return
    with pytest.raises(RuntimeError, match=f'type "{name}" .*model group '
                       "over nccl"):
        loop._trial_capture(lambda: ran.append(1), stream, None, body=True)
    assert ran == [1, 1]
