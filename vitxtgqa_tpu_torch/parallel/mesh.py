"""The process groups of the port: the data axis and the sequence-parallel
group of an initialised torch.distributed world.

Counterpart of vitxtgqa_tpu/parallel/mesh.py's ``build_mesh``.  The JAX
package shards one program over a device mesh; the port runs one process
per rank (PyTorch's idiom), each holding the whole model.

- The ``data`` axis (``build_data_group``): each rank takes its rows of the
  global batch (data/loader.py), and the losses and gradients are summed
  over the ranks (losses.py, training/optim.py), so a step on N ranks is
  the one-process step on the global batch.  ``-1`` is the world size;
  the global batch must divide by the axis, as in the JAX trainer's
  multi-host branch (vitxtgqa_tpu/training/trainer.py:131-135): no rank
  sits idle.
- The ``sp`` axis (``build_sp_group``): each rank holds the whole model and
  the whole batch, as JAX replicates activations outside its shard_map, and
  the sequence-parallel attention splits only the query rows
  (parallel/sequence_parallel.py).

``init_world`` joins the world that ``torchrun`` describes.  Tensor
parallelism (the ``model`` axis), pipeline parallelism (``pp``) and the data
axis together with ``sp`` are not ported (ROADMAP.md queue 1 item 5).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from vitxtgqa_tpu_torch.parallel.collectives import process_count

# the JAX mesh's axes that the port does not run, and where they stand
NOT_PORTED = {
    "model": "tensor parallelism (the mesh's model axis) is not ported "
             "(ROADMAP.md queue 1 item 5)",
    "pp": "pipeline parallelism (the mesh's pp axis, parallel/pipeline.py) is not ported "
          "(ROADMAP.md queue 1 item 5)",
    "data_sp": "the data axis together with sequence parallelism is not ported "
               "(ROADMAP.md queue 1 item 5)",
}
# torchrun's description of the world
WORLD_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


@dataclasses.dataclass(frozen=True, eq=False)
class SPGroup:
    """group: the torch.distributed process group of the sequence-parallel
    ranks; rank: this process's rank in it (its query rows are rank * L /
    size .. (rank + 1) * L / size); size: the number of ranks."""

    group: Any
    rank: int
    size: int


@dataclasses.dataclass(frozen=True, eq=False)
class DataGroup:
    """group: the torch.distributed process group of the data axis; rank:
    this process's rank in it (its rows of a global batch are rank, rank +
    size, ...); size: the number of ranks."""

    group: Any
    rank: int
    size: int


def _refuse_unported(model: int, pp: int) -> None:
    if model > 1:
        raise NotImplementedError(f"mesh model={model}: " + NOT_PORTED["model"])
    if pp > 1:
        raise NotImplementedError(f"mesh pp={pp}: " + NOT_PORTED["pp"])


def build_sp_group(sp: int, data: int = 1, model: int = 1, pp: int = 1) -> SPGroup:
    """The ``sp`` ranks of an initialised torch.distributed world as one
    sequence-parallel group (``Options.sp``).  The world must hold exactly
    ``sp`` processes; a ``data``, ``model`` or ``pp`` axis above 1 raises."""
    _refuse_unported(model, pp)
    if data > 1:
        raise NotImplementedError(f"mesh data={data}, sp={sp}: " + NOT_PORTED["data_sp"])
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("build_sp_group: initialise torch.distributed first "
                           "(init_process_group with this rank and the world size)")
    world = dist.get_world_size()
    if sp != world:
        raise ValueError(f"sp={sp} must equal the world size {world}")
    return SPGroup(group=dist.group.WORLD, rank=dist.get_rank(), size=sp)


def data_axis(data: int = -1, model: int = 1, sp: int = 1, pp: int = 1,
              batch_size: Optional[int] = None, world: Optional[int] = None) -> int:
    """The size of the mesh's data axis in a world of ``world`` processes
    (default: this one's).  ``-1`` is the world size; another value must
    equal it; ``batch_size`` (the global batch), where given, must divide
    by it.  ``model > 1``, ``pp > 1`` and ``sp > 1`` beside a data axis
    above 1 raise."""
    _refuse_unported(model, pp)
    world = process_count() if world is None else int(world)
    if sp > 1:
        if data > 1 or (data == -1 and world > sp):
            raise NotImplementedError(f"mesh data={data}, sp={sp}: " + NOT_PORTED["data_sp"])
        return 1
    size = world if data == -1 else data
    if size != world:
        raise ValueError(f"mesh data={data}: the data axis spans the world of {world} "
                         "processes (-1 takes the world size)")
    if batch_size is not None and int(batch_size) % size:
        raise ValueError(f"batch_size {batch_size} (the global batch) is not divisible by the "
                         f"data axis of {size} ranks")
    return size


def build_data_group(data: int = -1, model: int = 1, sp: int = 1, pp: int = 1,
                     batch_size: Optional[int] = None) -> Optional[DataGroup]:
    """The data axis of the initialised world as a DataGroup, or None where
    it has one rank (one process: nothing is reduced); raises as
    ``data_axis``."""
    size = data_axis(data, model, sp, pp, batch_size)
    if size == 1:
        return None
    return DataGroup(group=dist.group.WORLD, rank=dist.get_rank(), size=size)


def rank_device(local_rank: int, local_world: int, cuda: bool,
                cards: Optional[int] = None) -> Tuple[str, torch.device]:
    """The backend and device of local rank ``local_rank`` of the
    ``local_world`` ranks on this machine.  On the card: card ``local_rank``
    where there is a card for every local rank (NCCL), else card
    ``local_rank`` mod the card count, shared (gloo: NCCL refuses two ranks
    on one device); it is made the current device before anything touches
    the card, since the kernels launch on the current device.  On the CPU,
    gloo.  ``cards``: the cards the ranks may use (default: the machine's
    count)."""
    if not cuda:
        return "gloo", torch.device("cpu")
    cards = torch.cuda.device_count() if cards is None else int(cards)
    device = torch.device("cuda", local_rank % cards)
    torch.cuda.set_device(device)
    return ("nccl" if cards >= local_world else "gloo"), device


def init_world(cuda: bool) -> str:
    """Join the world that ``torchrun`` describes (RANK, WORLD_SIZE,
    LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT) on the backend
    and device of ``rank_device``, and return the backend.  Without a
    torchrun environment it raises: a multi-process run never falls back to
    one process."""
    missing = [k for k in WORLD_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"a multi-process run needs the torchrun environment ({', '.join(missing)} unset): "
            "start it as python -m torch.distributed.run --nproc_per_node N -m "
            "vitxtgqa_tpu_torch.run ... training_parameters.distributed_init=True")
    backend, _ = rank_device(int(os.environ.get("LOCAL_RANK", 0)),
                             int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"])),
                             cuda)
    dist.init_process_group(backend, init_method="env://")
    return backend


def close_world() -> None:
    """Leave the world (no-op where none was joined)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
