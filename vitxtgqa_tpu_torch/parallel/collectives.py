"""Cross-process communication helpers on torch.distributed.

Counterpart of vitxtgqa_tpu/parallel/collectives.py (reference:
pythia/utils/distributed_utils.py): the host-level helpers keep their
names, and the tensor collectives that sequence and data parallelism need
sit beside them (in the JAX package XLA emits those inside its sharded
jit and shard_map).  Each helper is a no-op, or returns its input, when
torch.distributed is not initialised or runs one process.

Backends: NCCL runs one rank per card (a multi-card machine, launched with
``torchrun``).  Two ranks on one card, as on a machine with one H100, need
gloo: NCCL refuses two ranks on one device.  Gloo takes the CUDA tensors of
all_gather and all_reduce as they are (torch 2.11), so the helpers have one
path for every backend.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if _initialized() else 1


def is_main_process() -> bool:
    return not _initialized() or dist.get_rank() == 0


def synchronize(name: str = "sync") -> None:
    """Barrier across all processes (no-op in one process); ``name`` is
    kept for the JAX helper's signature."""
    if process_count() > 1:
        dist.barrier()


def broadcast_scalar(value, source: int = 0):
    """Rank ``source``'s value on every rank (the early-stop decision)."""
    if process_count() <= 1:
        return value
    box = [value]
    dist.broadcast_object_list(box, src=source)
    return box[0]


def gather_objects(obj: Any, group: Optional[Any] = None) -> List[Any]:
    """Every process's ``obj`` (picklable), in rank order: of the world,
    or of ``group``'s ranks."""
    if process_count() <= 1:
        return [obj]
    out: List[Any] = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def host_mean_dict(values: Dict[str, float]) -> Dict[str, float]:
    """Each metric averaged over the processes (eval-time, on the host)."""
    if process_count() <= 1:
        return values
    gathered = gather_objects({k: float(v) for k, v in values.items()})
    return {k: sum(g[k] for g in gathered) / len(gathered) for k in sorted(values)}


def all_gather(t: torch.Tensor, group: Optional[Any] = None, dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim`` in rank order (each rank
    holds the same shape)."""
    if dist.get_world_size(group) == 1:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def all_reduce(t: torch.Tensor, group: Optional[Any] = None) -> torch.Tensor:
    """The sum of the ranks' ``t``, a new tensor."""
    if dist.get_world_size(group) == 1:
        return t
    out = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def all_reduce_flat_(tensors: List[torch.Tensor], group: Optional[Any] = None) -> None:
    """Sum each of ``tensors`` (one dtype) over the ranks, in place, through
    one flat buffer: one collective for the lot (the data axis's gradients
    and the step's losses)."""
    if not tensors or dist.get_world_size(group) == 1:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def assert_replicas_equal(tensors: List[torch.Tensor], what: str,
                          group: Optional[Any] = None) -> None:
    """Raise unless every rank holds the same ``tensors`` (bit for bit, as
    far as a float64 sum and an index-weighted sum of squares of each can
    tell): one small gather, e.g. of the parameters at load."""
    if dist.get_world_size(group) == 1:
        return
    sums = [[float(t.detach().double().sum()),
             float(t.detach().double().square().sum()) * (i + 1)]
            for i, t in enumerate(tensors)]
    every: List[Any] = [None] * dist.get_world_size(group)
    dist.all_gather_object(every, sums, group=group)
    for rank, other in enumerate(every):
        if other != every[0]:
            raise RuntimeError(f"{what} differ between rank 0 and rank {rank}")
