"""Process mesh and sharding rules: the port's scale-out layer (port of
``whisper_tpu.parallel.mesh``).

The JAX package puts every device of a slice in one program and lets GSPMD
insert the collectives.  The port takes PyTorch's idiom instead: one
process a card (``torchrun``, or ``init_distributed`` over TCP), a
``torch.distributed`` process group, and a
``torch.distributed.device_mesh.DeviceMesh`` of shape (data, model) whose
axes name the two process groups.  Every process runs the same program on
its own share (SPMD, as JAX's multi-controller runs across hosts), and the
model code calls the collectives itself on plain tensors (no DTensor):

- data parallelism: each data rank takes a contiguous share of a chunk
  batch's rows, runs the encoder and its own decode loop on them, and the
  tokens are all-gathered over "data" at the end (``all_gather_rows``);
- tensor parallelism: column-parallel q/k/v/fc1 (and xq/xk/xv) weights keep
  the rank's output columns, so attention runs on the rank's heads;
  row-parallel o/xo/fc2 keep the rank's input rows, and their partial
  products are summed over "model" (``all_reduce``), the bias added once
  after the sum (Megatron's split; ``_TP_RULES`` are the JAX package's).

A rank's local rank order is JAX's ``devices.reshape(data, model)``: rank
= data_index * model + model_index.  The backend is NCCL on cards and gloo
on the CPU (gloo also carries CUDA tensors, through the host, where two
ranks share a card).  Every group has a finite timeout, so a rank that
stops answering fails its peers instead of hanging them, as long as its
collectives are called from the host; a collective captured in a CUDA
graph (``runtime.generate``: a rank's bucket program) has no work item the
group's watchdog could time out, so the ranks of a captured program must
take the same trips through it (they do: see ``runtime.generate``).

A collective over NCCL queues on the card and can be captured in a CUDA
graph, the program's collectives then replaying with it, as GSPMD puts
them inside the JAX program; over gloo it goes through the host and
cannot.  ``Mesh.capturable`` records which holds for the model axis, the
only one a decode loop reduces over.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"
DEFAULT_TIMEOUT_S = 600.0
# the timeout init_distributed gave the process group; make_mesh's groups
# take it too
_group_timeout_s = DEFAULT_TIMEOUT_S


def torchrun_hint(n: int) -> str:
    return (f"torchrun --nproc-per-node {n} -m whisper_tpu_torch.bench "
            f"... (or init_distributed over --dcn-coordinator)")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in a (data, model) grid of processes.

    ``device_mesh`` holds the process groups (None for a mesh made only
    to slice parameters, as ``shard_params`` needs no group);
    ``model_backend`` the model group's backend ("nccl", "gloo"; None
    without groups)."""

    data: int = 1
    model: int = 1
    data_index: int = 0
    model_index: int = 0
    device_mesh: object = None
    model_backend: Optional[str] = None

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph can capture the collectives of a decode
        loop on this rank: those over "model", which make no call on an
        axis of one rank and queue on the card over NCCL (gloo carries a
        CUDA tensor through the host, which no capture can hold).  The
        data axis's one collective, the tokens' gather, comes after the
        loop, outside any graph.  A mesh without groups counts as
        capturable only where its model axis has one rank."""
        return self.model == 1 or self.model_backend == "nccl"

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    def group(self, axis: str):
        if self.device_mesh is None:
            raise RuntimeError("this Mesh has no process groups "
                               "(make_mesh builds them)")
        return self.device_mesh.get_group(axis)


def init_distributed(coordinator: str = "", num_processes: int = 0,
                     process_id: int = -1, *, backend: Optional[str] = None,
                     timeout_s: Optional[float] = None) -> None:
    """Join (or form) the process group, the counterpart of
    ``jax.distributed.initialize`` over DCN.

    coordinator "host:port" is the TCP rendezvous of rank 0; "" takes
    ``MASTER_ADDR``/``MASTER_PORT`` from the environment, as ``torchrun``
    sets them.  The CLI's sentinels, num_processes 0 and process_id -1,
    mean "not given": the world size and the rank then come from
    ``WORLD_SIZE`` and ``RANK`` (JAX maps them to None and auto-detects).
    backend: NCCL where a card is in sight, else gloo (gloo also lets two
    ranks share one card).  With NCCL each rank takes the card
    ``LOCAL_RANK`` (else its rank modulo the cards in sight) as its
    current device.  timeout_s bounds every collective of the group and of
    the meshes made over it."""
    global _group_timeout_s
    import torch.distributed as dist

    def env_int(name: str) -> int:
        try:
            return int(os.environ[name])
        except (KeyError, ValueError):
            raise RuntimeError(
                f"{name} is not set: pass --dcn-num-processes and "
                "--dcn-process-id, or launch with torchrun") from None

    world = num_processes if num_processes > 0 else env_int("WORLD_SIZE")
    rank = process_id if process_id >= 0 else env_int("RANK")
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if timeout_s is not None:
        _group_timeout_s = float(timeout_s)
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}" if coordinator
        else "env://", world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=_group_timeout_s))


def world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1, *,
              timeout_s: Optional[float] = None) -> Mesh:
    """Mesh with axes ('data', 'model') over the process group's ranks.

    model_parallel must divide n_devices (the rest becomes the data axis),
    and the process group must hold exactly n_devices ranks: one process a
    card.  Raises RuntimeError naming torchrun without a process group.
    Its groups time out as the process group does (``init_distributed``'s
    timeout_s), or after ``timeout_s``.  Both groups take the process
    group's backend, which the mesh records (``Mesh.capturable``)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if n_devices is None:
        n_devices = world_size()
    if n_devices % model_parallel != 0:
        raise ValueError(
            f"model_parallel={model_parallel} must divide "
            f"n_devices={n_devices}")
    if not dist.is_initialized():
        raise RuntimeError(
            f"a mesh of {n_devices} processes needs a process group of "
            f"{n_devices}, and this process has none: launch one process a "
            f"card, {torchrun_hint(n_devices)}")
    if dist.get_world_size() != n_devices:
        raise ValueError(
            f"the process group holds {dist.get_world_size()} processes, "
            f"the mesh asks for {n_devices}")
    backend = dist.get_backend()
    if backend == "nccl":
        opts = dist.ProcessGroupNCCL.Options()
        device_type = "cuda"
    else:
        opts = dist.ProcessGroupGloo._Options()
        device_type = "cpu"
    opts._timeout = datetime.timedelta(
        seconds=_group_timeout_s if timeout_s is None else timeout_s)
    dm = init_device_mesh(
        device_type, (n_devices // model_parallel, model_parallel),
        mesh_dim_names=(DATA_AXIS, MODEL_AXIS),
        backend_override={DATA_AXIS: (backend, opts),
                          MODEL_AXIS: (backend, opts)})
    return Mesh(data=n_devices // model_parallel, model=model_parallel,
                data_index=dm.get_local_rank(DATA_AXIS),
                model_index=dm.get_local_rank(MODEL_AXIS), device_mesh=dm,
                model_backend=dist.get_backend(dm.get_group(MODEL_AXIS)))


# Tensor-parallel rules, keyed by stacked-param name ([L, ...] layouts of
# models.convert), as tuples of axis names per dimension (the JAX
# PartitionSpecs).  Column-parallel projections (q/k/v, fc1) shard the
# output dim; row-parallel (o, fc2) shard the input dim, and their outputs
# are summed over "model".
_TP_RULES: Dict[str, Tuple] = {
    "q_w": (None, None, MODEL_AXIS), "q_b": (None, MODEL_AXIS),
    "k_w": (None, None, MODEL_AXIS),
    "v_w": (None, None, MODEL_AXIS), "v_b": (None, MODEL_AXIS),
    "o_w": (None, MODEL_AXIS, None), "o_b": (None,),
    "xq_w": (None, None, MODEL_AXIS), "xq_b": (None, MODEL_AXIS),
    "xk_w": (None, None, MODEL_AXIS),
    "xv_w": (None, None, MODEL_AXIS), "xv_b": (None, MODEL_AXIS),
    "xo_w": (None, MODEL_AXIS, None), "xo_b": (None,),
    "fc1_w": (None, None, MODEL_AXIS), "fc1_b": (None, MODEL_AXIS),
    "fc2_w": (None, MODEL_AXIS, None), "fc2_b": (None,),
}


def fit_spec(spec: Tuple, shape, axis_size: int) -> Tuple:
    """The rule fitted to a leaf's shape (the JAX ``fit``): the model axis
    is dropped on a dim of size 1 or one it does not divide (an int8
    QTensor's [L, 1, out] scale under a row-parallel rule), trailing
    Nones trimmed."""
    names = list(spec) + [None] * (len(shape) - len(spec))
    fitted = [n if n is None or (shape[d] > 1 and shape[d] % axis_size == 0)
              else None for d, n in enumerate(names[:len(shape)])]
    while fitted and fitted[-1] is None:
        fitted.pop()
    return tuple(fitted)


def shard_params(params, mesh: Mesh, whole=()):
    """This rank's local slice of every leaf of a parameter tree (numpy or
    torch leaves, ``QTensor`` pairs alike): the counterpart of
    ``param_shardings`` followed by the device_put, for one process.
    Block weights under ``/blocks/`` follow ``_TP_RULES`` over "model",
    fitted to each leaf's shape; everything else (convs, embeddings,
    norms) is whole on every rank.

    whole: paths ("encoder/blocks/fc1_w") kept whole, for the fused
    kernels whose fusion crosses the row-parallel sum (B2, B9b, B10c: the
    residual and the bias inside the kernel); every model rank then runs
    them on the whole weights."""
    tp, mi = mesh.model, mesh.model_index

    def slice_leaf(x, spec):
        for d, name in enumerate(spec):
            if name == MODEL_AXIS:
                n = x.shape[d] // tp
                x = x[(slice(None),) * d + (slice(mi * n, (mi + 1) * n),)]
        return (x.contiguous() if isinstance(x, torch.Tensor)
                else np.ascontiguousarray(x))

    def walk(node, prefix=""):
        if isinstance(node, dict):
            return {k: walk(v, f"{prefix}/{k}" if prefix else k)
                    for k, v in node.items()}
        leaf = prefix.rsplit("/", 1)[-1]
        rule = (_TP_RULES.get(leaf, ()) if "/blocks/" in prefix
                and prefix not in whole else ())
        if hasattr(node, "q") and hasattr(node, "s"):   # QTensor
            return type(node)(
                q=slice_leaf(node.q, fit_spec(rule, node.q.shape, tp)),
                s=slice_leaf(node.s, fit_spec(rule, node.s.shape, tp)))
        return slice_leaf(node, fit_spec(rule, getattr(node, "shape", ()),
                                         tp))

    return walk(params)


def check_heads(heads: int, local: int, mesh: Optional[Mesh],
                what: str) -> None:
    """Raise unless ``local`` heads are this rank's share of ``heads``."""
    tp = 1 if mesh is None else mesh.model
    if heads % tp or local != heads // tp:
        raise ValueError(f"{what}: {local} heads on this rank, expected "
                         f"{heads} / {tp} model ranks")


# ---------------------------------------------------------------------------
# Collectives (plain tensors, explicit calls)
# ---------------------------------------------------------------------------

def all_reduce(t: torch.Tensor, mesh: Mesh, axis: str = MODEL_AXIS,
               op: str = "sum") -> torch.Tensor:
    """The sum (or max) of ``t`` over ``axis``.  A floating-point sum is
    taken in fp32 and rounded to t's dtype once (bf16 partial products
    summed as fp32); integers are summed exactly.  Over an axis of one
    rank it is ``t`` itself, with no call: a data-parallel rank pays
    nothing for its model axis.

    Sound under a CUDA graph's capture (``Mesh.capturable``): the fp32
    copy is made on the current stream, so inside a capture it comes from
    the capture's memory pool; the call reads nothing on the host, and
    over NCCL it queues on the group's own stream behind the current
    stream's work, which waits for it before its next kernel (the
    synchronous form's ``wait``), so a capture holds the collective
    between the kernels around it.  Over gloo the call waits on the host
    for the card, as it always has."""
    import torch.distributed as dist

    if mesh.shape[axis] == 1:
        return t

    buf = t.float() if t.is_floating_point() else t
    if buf is t:
        buf = t.clone()
    dist.all_reduce(buf, op=dist.ReduceOp.MAX if op == "max"
                    else dist.ReduceOp.SUM, group=mesh.group(axis))
    return buf.to(t.dtype)


def all_gather(t: torch.Tensor, mesh: Mesh, axis: str, dim: int
               ) -> torch.Tensor:
    """The ranks' ``t`` of ``axis`` concatenated along ``dim`` in rank
    order.  Built on all_reduce over a zero buffer (exact: every element
    is one rank's value plus zeros), which gloo also runs on CUDA tensors;
    the results are small (tokens) or per-layer activations.  Sound under
    capture as ``all_reduce`` is: the zero buffer is made on the current
    stream."""
    import torch.distributed as dist

    n = mesh.shape[axis]
    if n == 1:
        return t
    index = mesh.data_index if axis == DATA_AXIS else mesh.model_index
    shape = list(t.shape)
    size = shape[dim]
    shape[dim] = size * n
    buf = torch.zeros(shape, dtype=t.dtype, device=t.device)
    buf.narrow(dim, index * size, size).copy_(t)
    dist.all_reduce(buf, group=mesh.group(axis))
    return buf


def all_gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Rows of every data rank, in rank order (dim 0 over "data")."""
    return all_gather(t, mesh, DATA_AXIS, 0)


def data_rows(n: int, mesh: Optional[Mesh]) -> Optional[Tuple[int, int]]:
    """(lo, hi): this data rank's contiguous rows of a batch of n, or None
    when n does not divide the data axis (the batch then runs replicated
    on every rank)."""
    if mesh is None:
        return 0, n
    if n % mesh.data:
        return None
    per = n // mesh.data
    return mesh.data_index * per, (mesh.data_index + 1) * per
