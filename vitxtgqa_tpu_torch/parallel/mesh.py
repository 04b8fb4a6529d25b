"""The device mesh of the port: the data, tensor-parallel (model),
sequence-parallel and pipeline groups of an initialised torch.distributed
world.

Counterpart of vitxtgqa_tpu/parallel/mesh.py's ``build_mesh``.  The JAX
package shards one program over a device mesh; the port runs one process
per rank (PyTorch's idiom), each holding the whole model.  ``build_mesh``
lays the world's ranks out as JAX lays out its devices: row-major over
``[data, model, sp, pp]``, so world rank ((d * model + m) * sp + s) * pp + p
is the JAX mesh's device of coordinates (d, m, s, p).

- The ``data`` axis (``Mesh.data``, a DataGroup): each data row takes its
  rows of the global batch (data/loader.py), and the losses and gradients
  are summed over the data group (losses.py, training/optim.py), so a step
  on N rows equals the one-process step on the global batch.  The global
  batch must divide by the axis, as in the JAX trainer's multi-host branch
  (vitxtgqa_tpu/training/trainer.py:131-135): no rank sits idle (JAX's
  ``build_mesh(batch_size=)`` shrinks the axis instead).
- The ``model`` axis (``Mesh.model``, a ModelGroup): the ranks that
  split each transformer layer's heads and FFN width and the
  vocabulary-sized weights, each holding only its shards of those weights
  (parallel/tensor_parallel.py, Megatron's layout of JAX's
  DEFAULT_PARAM_RULES); the other parameters and every activation between
  the layers are replicated.  A model group is the ranks that share (d, s,
  p); the ranks that hold the same shards share m (ModelGroup.replicas).
- The ``sp`` axis (``Mesh.sp``, an SPGroup): the ranks (sharing d, m, p)
  that hold a data row's whole batch and split the query rows of each
  full-sequence attention (parallel/sequence_parallel.py), over a model
  rank's heads on a model mesh.
- The ``pp`` axis (``Mesh.pp``, a PPGroup): the stages (sharing d, m, s)
  of the GPipe schedule over a transformer stack's layers
  (parallel/pipeline.py), a model rank's shards of them on a model mesh.
  A pipelined pass leaves every stage with the whole stack's gradients
  (all-gathered over the group in its backward), so the pp ranks hold a
  data row's gradients as replicas.

Every model, sp and pp rank of one data row computes what that row's rank
would compute alone: the same rows, the same dropout and gumbel draws
(training/step.py folds in the data coordinate only).  ``-1`` for the data
axis takes the world over model x sp x pp; the product of the axes must
equal the world size.  Every combination of the four axes runs, as the
JAX trainer's meshes do.

``init_world`` joins the world that ``torchrun`` describes.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from vitxtgqa_tpu_torch.parallel.collectives import process_count

AXES = ("data", "model", "sp", "pp")
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


@dataclasses.dataclass(frozen=True, eq=False)
class ModelGroup:
    """group: the torch.distributed process group of the tensor-parallel
    ranks; rank: this process's rank in it (its heads are rank * H / size
    .. (rank + 1) * H / size, its FFN columns and vocabulary rows alike);
    size: the number of ranks; replicas: the process group of the ranks
    that hold the same shards (data x sp x pp through this rank's model
    coordinate), None where this rank is alone in it."""

    group: Any
    rank: int
    size: int
    replicas: Any = None


@dataclasses.dataclass(frozen=True, eq=False)
class PPGroup:
    """group: the torch.distributed process group of the pipeline stages;
    rank: this process's stage; size: the number of stages; peers: the
    world rank of each stage (a broadcast's source names a world rank)."""

    group: Any
    rank: int
    size: int
    peers: Tuple[int, ...] = ()


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """The mesh of this rank: ``shape`` the size of each axis of AXES,
    ``coords`` this rank's coordinate on each; ``data``, ``model``, ``sp``
    and ``pp`` its groups, None where the axis has one rank (nothing to
    reduce)."""

    shape: Dict[str, int]
    coords: Dict[str, int]
    data: Optional[DataGroup] = None
    model: Optional[ModelGroup] = None
    sp: Optional[SPGroup] = None
    pp: Optional[PPGroup] = None


def mesh_shape(data: int = -1, model: int = 1, sp: int = 1, pp: int = 1,
               batch_size: Optional[int] = None, world: Optional[int] = None) -> Dict[str, int]:
    """The size of each axis of the mesh over a world of ``world``
    processes (default: this one's).  ``data=-1`` takes world / (model *
    sp * pp), as JAX's build_mesh does; the product must equal the world;
    ``batch_size`` (the global batch), where given, must divide by the data
    axis.  A shape the world cannot hold raises ValueError."""
    world = process_count() if world is None else int(world)
    if min(sp, pp, model) < 1 or data == 0 or data < -1:
        raise ValueError(f"mesh data={data}, model={model}, sp={sp}, pp={pp}: sizes are >= 1 "
                         "(data -1 takes the rest of the world)")
    rest = model * sp * pp
    if data == -1:
        if world % rest:
            raise ValueError(f"mesh {'model=' + str(model) + ' x ' if model > 1 else ''}"
                             f"sp={sp} x pp={pp} needs a multiple of {rest} processes; "
                             f"the world has {world}")
        data = world // rest
    if data * rest != world:
        raise ValueError(f"mesh data={data}: the data axis times model x sp x pp = {rest} spans "
                         f"the world of {world} processes (-1 takes the world size over them); "
                         f"data x model x sp x pp needs {data * rest} processes")
    if batch_size is not None and int(batch_size) % data:
        raise ValueError(f"batch_size {batch_size} (the global batch) is not divisible by the "
                         f"data axis of {data} ranks")
    return {"data": data, "model": model, "sp": sp, "pp": pp}


def rank_coords(rank: int, shape: Dict[str, int]) -> Dict[str, int]:
    """The mesh coordinates of world rank ``rank``: the JAX mesh's device
    order, row-major over AXES."""
    idx = np.unravel_index(int(rank), tuple(shape[a] for a in AXES))
    return {a: int(i) for a, i in zip(AXES, idx)}


def _line_ranks(shape: Dict[str, int], axes: Tuple[str, ...],
                fixed: Dict[str, int]) -> Tuple[int, ...]:
    """The world ranks whose coordinates off ``axes`` are ``fixed``, in
    world order (along one axis: its order)."""
    sizes = tuple(shape[a] for a in AXES)
    return tuple(int(np.ravel_multi_index(tuple({**fixed, **dict(zip(axes, idx))}[a]
                                                for a in AXES), sizes))
                 for idx in np.ndindex(*(shape[a] for a in axes)))


def _axes_group(shape: Dict[str, int], axes: Tuple[str, ...], coords: Dict[str, int]):
    """(this rank's process group over ``axes``: the ranks that differ
    from it only there, and their world ranks).  Every rank creates every
    group of those axes in the same order (``new_group`` is collective);
    a group that spans the world is the world's group."""
    others = [a for a in AXES if a not in axes]
    mine = _line_ranks(shape, axes, {a: coords[a] for a in others})
    if len(mine) == dist.get_world_size():
        return dist.group.WORLD, mine
    group = None
    for line in np.ndindex(*(shape[a] for a in others)):
        ranks = _line_ranks(shape, axes, dict(zip(others, line)))
        g = dist.new_group(list(ranks))
        if ranks == mine:
            group = g
    return group, mine


def build_mesh(data: int = -1, model: int = 1, sp: int = 1, pp: int = 1,
               batch_size: Optional[int] = None) -> Mesh:
    """The mesh of the initialised world (mesh_shape's sizes; one process
    without an initialised world: every axis 1).  Every rank must call it
    with the same sizes."""
    shape = mesh_shape(data, model, sp, pp, batch_size)
    initialized = dist.is_available() and dist.is_initialized()
    if not initialized and process_count() > 1:
        raise RuntimeError("build_mesh: initialise torch.distributed first "
                           "(init_process_group with this rank and the world size)")
    rank = dist.get_rank() if initialized else 0
    coords = rank_coords(rank, shape)
    groups: Dict[str, Any] = {}
    for axis, cls in (("data", DataGroup), ("model", ModelGroup), ("sp", SPGroup),
                      ("pp", PPGroup)):
        if shape[axis] == 1:
            continue
        group, ranks = _axes_group(shape, (axis,), coords)
        extra = {"peers": ranks} if cls is PPGroup else {}
        if cls is ModelGroup and shape["data"] * shape["sp"] * shape["pp"] > 1:
            extra["replicas"] = _axes_group(shape, ("data", "sp", "pp"), coords)[0]
        groups[axis] = cls(group=group, rank=coords[axis], size=shape[axis], **extra)
    return Mesh(shape=shape, coords=coords, **groups)


def build_sp_group(sp: int, data: int = 1, model: int = 1, pp: int = 1) -> SPGroup:
    """This rank's sequence-parallel group of build_mesh(data, model, sp,
    pp) (``Options.sp``); the world must hold the mesh."""
    if sp < 2:
        raise ValueError(f"sp={sp}: a sequence-parallel group has at least 2 ranks")
    return build_mesh(data, model, sp, pp).sp


def build_model_group(model: int, data: int = -1) -> ModelGroup:
    """This rank's tensor-parallel group of build_mesh(data, model)
    (``Options.tp``); the world must hold the mesh."""
    if model < 2:
        raise ValueError(f"model={model}: a tensor-parallel group has at least 2 ranks")
    return build_mesh(data, model).model


def build_data_group(data: int = -1, model: int = 1, sp: int = 1, pp: int = 1,
                     batch_size: Optional[int] = None) -> Optional[DataGroup]:
    """This rank's data group of build_mesh(...), or None where the axis
    has one rank (nothing is reduced); raises as mesh_shape."""
    return build_mesh(data, model, sp, pp, batch_size).data


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
