"""The port's multi-device layer: one process a card, a
``torch.distributed`` process group and a (data, model) ``DeviceMesh``,
with explicit collectives in the model code where the JAX package lets
GSPMD insert them (``parallel.mesh``)."""

from whisper_tpu_torch.parallel.mesh import (
    Mesh,
    init_distributed,
    make_mesh,
    shard_params,
)

__all__ = ["Mesh", "init_distributed", "make_mesh", "shard_params"]
