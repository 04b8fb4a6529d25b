"""Tensor parallelism: the mesh's ``model`` axis in Megatron's layout.

Counterpart of vitxtgqa_tpu/parallel/mesh.py's DEFAULT_PARAM_RULES and
param_shardings, and of the collectives that GSPMD inserts for them.  The
JAX trainer shards the ``query``, ``key``, ``value`` and ``ffn_in``
kernels over their output features (column-parallel) and the
``attn_out`` and ``ffn_out`` kernels over their input features
(row-parallel), and GSPMD computes the one-device function.  The port runs
one process per rank that holds only its shards (Options.tp, a ModelGroup):

- a transformer layer's Q/K/V are the rank's heads (num_attention_heads /
  model of them, from head rank * H / model on), its attention output
  product reads their context, its FFN holds intermediate_size / model of
  the FFN width; so a rank's attention and FFN-in run on its shards alone;
- the attention-output and FFN-out products are partial sums over the
  ranks: their two all-reduces a layer (``reduce_from_model``, or the
  post-attention block kernels' split forms, ops/fused_block.py and
  ops/block_train.py), after which the biases of those products are added
  once and every rank holds the whole 768-wide rows again;
- in the backward the input gradient of the column-parallel products is a
  partial sum too: ``copy_to_model`` at the attention's input all-reduces
  it (the block's FFN-in input gradient is summed inside the block's split
  backward), so each partial is summed exactly once.

The vocabulary-sized weights and the OCR pointer network's query and key
(which JAX's query/key rule also catches) follow JAX's other rules, each
where the group divides its dimension (``divides``, JAX's param_shardings
condition), else whole on every rank:

- the text BERT's word embeddings hold a rank's rows of the vocabulary:
  ``vocab_lookup`` gives a zero row for an id outside them, then one
  all-reduce (Megatron's VocabParallelEmbedding); its backward keeps each
  rank's rows;
- the fixed-vocabulary classifier holds a rank's answer rows: its input
  comes through copy_to_model, its score columns are all-gathered along
  the vocabulary (``gather_from_model``, whose backward keeps the rank's
  columns), and its table's LayerNormed rows feed the decoder slots
  through ``vocab_lookup``;
- the pointer network's query and key are column-parallel over
  query_key_size, so its scores are a partial sum, all-reduced in f32.

The biases of the column-parallel products go with their columns (JAX's
rules name the kernels only and keep the biases whole; GSPMD computes the
same function).

``PARAM_RULES`` is the port's rule table over its parameter names;
``shard_state`` / ``gather_state`` map a whole state dict to a rank's
shards and back (the seeded init, the checkpoints); ``drive`` runs the
split forms' steps of one rank or of every rank's shards in one process.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from vitxtgqa_tpu_torch.parallel import collectives as C

# parameter name -> the dimension it shards (nn.Linear layout [out, in]):
# column-parallel weights and biases over their output features (dim 0),
# row-parallel weights over their input features (dim 1), the vocabulary
# tables over their rows (dim 0); a transformer layer's FFN output is
# "output.dense", its attention output "attention.output.dense"
PARAM_RULES: Tuple[Tuple[str, int], ...] = (
    (r"(?:^|\.)attention\.self\.(?:query|key|value)\.(?:weight|bias)$", 0),
    (r"(?:^|\.)attention\.output\.dense\.weight$", 1),
    (r"(?:^|\.)intermediate\.dense\.(?:weight|bias)$", 0),
    (r"(?:^|(?<!attention)\.)output\.dense\.weight$", 1),
    (r"(?:^|\.)classifier\.module\.(?:weight|bias)$", 0),
    (r"(?:^|\.)word_embeddings\.weight$", 0),
    (r"(?:^|\.)ocr_ptr_net\.(?:query|key)\.(?:weight|bias)$", 0),
)


def rule_dim(name: str) -> Optional[int]:
    """The dimension PARAM_RULES shard ``name`` over, or None (whole)."""
    for pattern, dim in PARAM_RULES:
        if re.search(pattern, name):
            return dim
    return None


def layer_splits(num_heads: int, intermediate: int, size: int) -> bool:
    """Whether a layer of ``num_heads`` heads and FFN ``intermediate`` is
    split over ``size`` ranks: both divide (JAX's rule applies where the
    axis divides the dimension; a head is not split here).  Another layer
    stays whole on every rank."""
    return size > 1 and num_heads % size == 0 and intermediate % size == 0


def divides(tp, dim: int) -> bool:
    """Whether ``tp`` (a ModelGroup, or None) splits a dimension of
    ``dim``: JAX's rule applies where the axis divides the dimension."""
    return tp is not None and tp.size > 1 and dim % tp.size == 0


def mark(param: nn.Parameter, dim: int) -> None:
    """Mark ``param`` as a shard along ``dim`` (read by sharded_dims, the
    optimizer and the checkpoints)."""
    param.tp_dim = dim


def sharded_dims(model: nn.Module) -> Dict[str, int]:
    """{parameter name: shard dim} of the parameters a model holds as
    tensor-parallel shards (Options.tp: its split layers' and vocabulary
    tables'); the others are whole."""
    return {n: p.tp_dim for n, p in model.named_parameters() if hasattr(p, "tp_dim")}


def is_sharded(param: torch.Tensor) -> bool:
    return hasattr(param, "tp_dim")


def shard(t: torch.Tensor, dim: int, rank: int, size: int) -> torch.Tensor:
    """Rank ``rank``'s 1 / size of ``t`` along ``dim`` (a copy)."""
    if t.shape[dim] % size:
        raise ValueError(f"a dim of {t.shape[dim]} does not split over {size} ranks")
    return t.chunk(size, dim=dim)[rank].clone()


def shard_state(state: Dict[str, torch.Tensor], dims: Dict[str, int], rank: int,
                size: int) -> Dict[str, torch.Tensor]:
    """A whole state dict's entries as rank ``rank`` of ``size`` holds them:
    the names in ``dims`` (sharded_dims of the rank's model) sharded, the
    rest as they are."""
    return {k: shard(v, dims[k], rank, size) if k in dims else v for k, v in state.items()}


def local_state(model: nn.Module, state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A whole state dict as ``model`` holds it: its tensor-parallel
    rank's shards (sharded_dims; Options.tp), else the dict as it is
    (a checkpoint of any mesh loads on any other)."""
    tp = getattr(getattr(model, "opts", None), "tp", None)
    dims = sharded_dims(model)
    if tp is None or not dims:
        return state
    return shard_state(state, dims, tp.rank, tp.size)


def whole_state(model: nn.Module, state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``model``'s state dict ``state`` made whole over its model group (a
    collective under Options.tp; else the dict as it is)."""
    tp = getattr(getattr(model, "opts", None), "tp", None)
    dims = sharded_dims(model)
    if tp is None or not dims:
        return state
    return gather_state(state, dims, tp.group)


def check_replicas(params: Sequence[torch.Tensor], what: str, tp=None) -> None:
    """Raise unless the ranks that should hold the same ``params`` do: the
    whole ones on every rank of the world, the shards on the ranks of one
    model coordinate (``tp.replicas``: data x sp x pp)."""
    whole = [p for p in params if not is_sharded(p)]
    shards = [p for p in params if is_sharded(p)]
    C.assert_replicas_equal(whole, what)
    if shards and tp is not None and tp.replicas is not None:
        C.assert_replicas_equal(shards, what + " (the tensor-parallel shards)", tp.replicas)


def gather_state(state: Dict[str, torch.Tensor], dims: Dict[str, int],
                 group) -> Dict[str, torch.Tensor]:
    """A rank's state dict made whole: the names in ``dims`` all-gathered
    over the model group (a collective: every rank calls it)."""
    return {k: C.all_gather(v, group, dim=dims[k]) if k in dims else v for k, v in state.items()}


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the input gradient's partials
    over the model group (at the input of column-parallel products)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return C.all_reduce(g.contiguous(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """The sum of the ranks' partials forward; identity backward (the
    output of a row-parallel product outside a block kernel)."""

    @staticmethod
    def forward(ctx, x, group):
        return C.all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    """The ranks' ``x`` concatenated along the last dimension forward; the
    backward keeps this rank's columns of the (replicated) cotangent."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return C.all_gather(x, tp.group, dim=-1)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.tp.size, dim=-1)[ctx.tp.rank].contiguous(), None


def copy_to_model(x: torch.Tensor, tp) -> torch.Tensor:
    """x, whose gradient is summed over ``tp``'s ranks in the backward."""
    return _CopyToModel.apply(x, tp.group) if torch.is_grad_enabled() else x


def reduce_from_model(x: torch.Tensor, tp) -> torch.Tensor:
    """The sum of the ranks' ``x`` over ``tp`` (gradient passed through)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _ReduceFromModel.apply(x, tp.group)
    return C.all_reduce(x, tp.group)


def gather_from_model(x: torch.Tensor, tp) -> torch.Tensor:
    """The ranks' ``x`` concatenated along its last dimension in rank
    order (a vocabulary-parallel product's columns), on every rank."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _GatherFromModel.apply(x, tp)
    return C.all_gather(x, tp.group, dim=-1)


def vocab_lookup(table: torch.Tensor, ids: torch.Tensor, tp) -> torch.Tensor:
    """``whole_table[ids]`` from this rank's rows of it (``table``, rows
    tp.rank * V / size on): a zero row for an id outside them, then the
    sum over ``tp`` (one all-reduce in float32, where a row and zeros add
    exactly; the table's dtype after it).  The backward reaches each
    rank's rows only."""
    rows = table.shape[0]
    local = ids - tp.rank * rows
    hit = (local >= 0) & (local < rows)
    got = table[local.clamp(0, rows - 1)]
    own = torch.where(hit[..., None], got, torch.zeros_like(got)).float()
    return reduce_from_model(own, tp).to(table.dtype)


# ---- the split forms' steps ------------------------------------------------

Reduce = Callable[[List[torch.Tensor]], torch.Tensor]


def group_sum(tp) -> Reduce:
    """The reduction of one rank's steps: its one partial summed over the
    model group in place (every rank gets the same bits)."""

    def reduce(parts: List[torch.Tensor]) -> torch.Tensor:
        (part,) = parts
        if tp is not None and tp.size > 1:
            torch.distributed.all_reduce(part, group=tp.group)
        return part

    return reduce


def shard_sum(parts: List[torch.Tensor]) -> torch.Tensor:
    """The reduction of every rank's shards run in one process: the
    partials' sum in rank order (one partial: itself)."""
    if len(parts) == 1:
        return parts[0]
    total = parts[0].clone()
    for p in parts[1:]:
        total += p
    return total


def drive(steps: Sequence[Any], reduce: Reduce) -> List[Any]:
    """Run split-form step generators side by side: each yields its f32
    partial before every all-reduce and receives the sum; ``reduce`` forms
    the sum from the list of partials (group_sum for one rank's one
    generator, shard_sum for every rank's in one process).  Returns each
    generator's return value."""
    outs: List[Any] = [None] * len(steps)
    sent = None
    while True:
        parts, done = [], 0
        for i, g in enumerate(steps):
            try:
                parts.append(g.send(sent))
            except StopIteration as stop:
                outs[i] = stop.value
                done += 1
        if done:
            if done != len(steps):
                raise RuntimeError("split-form steps out of step: some ended before the rest")
            return outs
        sent = reduce(parts)


def run_split(steps: Any, tp) -> Any:
    """One rank's split form: ``steps`` (a generator) with its partials
    summed over ``tp``."""
    return drive([steps], group_sum(tp))[0]
