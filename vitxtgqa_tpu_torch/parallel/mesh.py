"""The sequence-parallel process group.

Counterpart of vitxtgqa_tpu/parallel/mesh.py's ``build_mesh`` for its
``sp`` axis.  The JAX package shards one program over a device mesh; the
port runs one process per rank (PyTorch's idiom), each holding the whole
model and the whole batch, as JAX replicates activations outside its
shard_map, and the sequence-parallel attention splits only the query rows
(parallel/sequence_parallel.py).  Data, tensor and pipeline parallelism
are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch.distributed as dist


@dataclasses.dataclass(frozen=True, eq=False)
class SPGroup:
    """group: the torch.distributed process group of the sequence-parallel
    ranks; rank: this process's rank in it (its query rows are rank * L /
    size .. (rank + 1) * L / size); size: the number of ranks."""

    group: Any
    rank: int
    size: int


def build_sp_group(sp: int, data: int = 1, model: int = 1, pp: int = 1) -> SPGroup:
    """The ``sp`` ranks of an initialised torch.distributed world as one
    sequence-parallel group (``Options.sp``).  The world must hold exactly
    ``sp`` processes; a ``data``, ``model`` or ``pp`` axis above 1 raises."""
    if max(data, model, pp) > 1:
        raise NotImplementedError(
            f"data={data}, model={model}, pp={pp}: only sequence parallelism is ported; data, "
            "tensor and pipeline parallelism are ROADMAP.md queue 1, \"Multi-GPU\"")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("build_sp_group: initialise torch.distributed first "
                           "(init_process_group with this rank and the world size)")
    world = dist.get_world_size()
    if sp != world:
        raise ValueError(f"sp={sp} must equal the world size {world}")
    return SPGroup(group=dist.group.WORLD, rank=dist.get_rank(), size=sp)
