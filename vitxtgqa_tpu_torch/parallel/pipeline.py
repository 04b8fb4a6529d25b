"""Pipeline parallelism over a transformer stack's layers: the GPipe
schedule over the mesh's ``pp`` group.

Counterpart of vitxtgqa_tpu/parallel/pipeline.py.  Stage s of S owns a
contiguous slice of the stack's layers (the layer count divides by S).
The rows split into M microbatches, and the schedule runs M + S - 1 ticks:
at tick t stage s computes microbatch t - s, and then every stage hands
its output to the next stage (the ring shift).  The JAX package runs the
schedule as one SPMD program, so its warm-up and drain ticks compute on
zeros; here each rank is its own program and a stage with no microbatch
at a tick computes nothing, but it still joins the tick's shift.

The payload carries each microbatch's mask with its activations: a
MaskSpec's key mask as it is (its decoder length beside it), or an
additive bias's rows.  So each stage's layers take the routes the
unpipelined layer takes: the flash kernel for a MaskSpec at >= 256 keys,
the eval block kernels where the microbatch's rows reach their gate, the
training block kernels.  (JAX materialises the bias because its pipeline
runs XLA.)  The result is on every pp rank, as the JAX version's closing
``psum`` leaves it: the last stage broadcasts it.

Gradients: the whole schedule is one autograd node (GPipeFn) over the
stack's input and every stage's parameters.  Its forward keeps each
microbatch's graph on the stage that computed it; its backward runs the
ticks in reverse, each stage back-propagating the gradient it received
from the next stage and handing the input gradient to the previous one
(the reverse shift); stage 0 broadcasts the gradient of the stack's input,
which every rank's replicated upstream needs.  The stages' layer
gradients are then all-gathered (``stage_grads``: the stages' layers are
alike, so each stage sends as many numbers), so every pp rank leaves the
pass with the whole stack's gradients, as it holds every other gradient
of the step: the optimizer treats the pp ranks as replicas
(training/optim.py).

The ring shift all-gathers the stages' outputs and takes the previous
stage's: one code path on every backend, since gloo's send / recv take
CPU tensors only while its all_gather, like NCCL's, takes CUDA tensors as
they are.  A point-to-point form (``batch_isend_irecv``) for NCCL with a
card a rank waits for a run that can measure it against this one.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from vitxtgqa_tpu_torch.ops.masks import MaskSpec

Payload = Dict[str, torch.Tensor]


def microbatches(rows: int, stages: int, num_microbatches: int = 0) -> Tuple[int, int]:
    """(microbatches, rows a microbatch) of ``rows`` over ``stages``
    stages: ``num_microbatches`` (0: one a stage), which must divide the
    rows (the JAX assert at pipeline.py:57)."""
    m = int(num_microbatches) or int(stages)
    if rows % m:
        raise ValueError(f"pipeline: {rows} rows do not divide into {m} microbatches "
                         f"(pp_microbatches={num_microbatches}, {stages} stages)")
    return m, rows // m


def shift(x: torch.Tensor, pp, step: int) -> torch.Tensor:
    """Stage s's copy of stage (s - step)'s ``x``, zeros where there is no
    such stage: ``step`` +1 is the forward ring, -1 the backward one.
    Every stage calls it at the same ticks with tensors of one shape."""
    src, n = pp.rank - step, pp.size
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=pp.group)
    return parts[src] if 0 <= src < n else torch.zeros_like(x)


def broadcast_from(x: torch.Tensor, pp, stage: int) -> torch.Tensor:
    """Stage ``stage``'s ``x`` on every stage (in place on the others'
    buffers of the same shape)."""
    x = x.contiguous()
    dist.broadcast(x, src=pp.peers[stage], group=pp.group)
    return x


def stage_grads(own: Sequence[torch.Tensor], pp) -> List[torch.Tensor]:
    """Every stage's ``own`` (the float32 gradients of its layers'
    parameters, in order; as many numbers on every stage), in stage order,
    on every stage: one all-gather."""
    flat = torch.cat([g.reshape(-1) for g in own])
    parts = [torch.empty_like(flat) for _ in range(pp.size)]
    dist.all_gather(parts, flat, group=pp.group)
    out = []
    for part in parts:
        offset = 0
        for g in own:
            out.append(part[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
    return out


class _Schedule:
    """One pipelined pass of a stack (``layers``: every stage's, in order):
    ``stage_fn(own, payload_mb, i)`` returns this stage's output
    activations for microbatch i (shaped as ``payload_mb["h"]``), ``own``
    the stage's contiguous share of the layers; ``rest`` the payload's
    other tensors, [B, ...]."""

    def __init__(self, stage_fn, layers: Sequence[nn.Module], rest: Payload, pp,
                 m: int, mb: int):
        n = len(layers)
        if n % pp.size:
            raise ValueError(f"pipeline: {n} layers do not divide over {pp.size} stages")
        per = n // pp.size
        self.stage_fn, self.rest, self.pp, self.m, self.mb = stage_fn, rest, pp, m, mb
        self.layers = list(layers)[pp.rank * per:(pp.rank + 1) * per]
        shares = [[tuple(p.shape) for layer in list(layers)[i * per:(i + 1) * per]
                   for p in layer.parameters() if p.requires_grad] for i in range(pp.size)]
        if any(share != shares[0] for share in shares):
            raise ValueError("pipeline: the stages' layers must hold parameters of the same "
                             "shapes (their gradients are all-gathered)")
        self.params = [p for layer in layers for p in layer.parameters() if p.requires_grad]
        self.own = [p for layer in self.layers for p in layer.parameters() if p.requires_grad]

    def _rows(self, t: torch.Tensor, i: int) -> torch.Tensor:
        return t[i * self.mb:(i + 1) * self.mb]

    def forward(self, h: torch.Tensor, keep_graph: bool):
        """(the stack's output on every stage, the saved (input, output)
        of each microbatch this stage computed, with their graphs where
        ``keep_graph``)."""
        pp, m = self.pp, self.m
        s, n = pp.rank, pp.size
        payload = {**self.rest, "h": h}
        blank = {k: torch.zeros_like(self._rows(v, 0)) for k, v in payload.items()}
        recv, outs, saved = blank, [], []
        for t in range(m + n - 1):
            i, send = t - s, blank
            if 0 <= i < m:
                inp = {k: self._rows(v, i) for k, v in payload.items()} if s == 0 else recv
                if keep_graph:
                    h_in = inp["h"].detach().requires_grad_()
                    with torch.enable_grad():
                        y = self.stage_fn(self.layers, {**inp, "h": h_in}, i)
                    saved.append((h_in, y))
                    y = y.detach()
                else:
                    y = self.stage_fn(self.layers, inp, i)
                if y.shape != inp["h"].shape or y.dtype != h.dtype:
                    raise ValueError(f"pipeline: a stage maps {tuple(inp['h'].shape)} "
                                     f"{h.dtype} to {tuple(y.shape)} {y.dtype}; it must keep "
                                     "the payload's shape and dtype")
                if s == n - 1:
                    outs.append(y)
                send = {**inp, "h": y}
            if n > 1 and t < m + n - 2:
                recv = {k: shift(v, pp, +1) for k, v in send.items()}
        out = torch.cat(outs) if s == n - 1 else torch.empty_like(h)
        return broadcast_from(out, pp, n - 1), saved

    def backward(self, saved, g: torch.Tensor):
        """(the gradient of the stack's input, and the gradients of every
        stage's parameters (``self.params``), on every stage: each summed
        over its stage's microbatches in float32 and rounded once to its
        parameter's dtype)."""
        pp, m = self.pp, self.m
        s, n = pp.rank, pp.size
        blank = torch.zeros_like(self._rows(g, 0))
        own: List[Optional[torch.Tensor]] = [None] * len(self.own)
        dxs, recv = [], blank
        for t in reversed(range(m + n - 1)):
            i, send = t - s, blank
            if 0 <= i < m:
                gy = self._rows(g, i) if s == n - 1 else recv
                h_in, y = saved[i]
                got = torch.autograd.grad(y, [h_in] + self.own, gy, allow_unused=True)
                send = got[0]
                for j, gp in enumerate(got[1:]):
                    if gp is not None:
                        own[j] = gp.float() if own[j] is None else own[j] + gp
                if s == 0:
                    dxs.append(send)
            if n > 1 and t > 0:
                recv = shift(send, pp, -1)
        dx = torch.cat(dxs[::-1]) if s == 0 else torch.empty_like(g)
        own = [torch.zeros_like(p, dtype=torch.float32) if gp is None else gp
               for gp, p in zip(own, self.own)]
        grads = stage_grads(own, pp)
        return (broadcast_from(dx.to(g.dtype), pp, 0),
                [gp.to(p.dtype) for gp, p in zip(grads, self.params)])


class GPipeFn(torch.autograd.Function):
    """A pipelined pass as one autograd node over the stack's input and
    every stage's parameters (module docstring)."""

    @staticmethod
    def forward(ctx, sched: _Schedule, h: torch.Tensor, *params):
        out, ctx.saved = sched.forward(h, keep_graph=True)
        ctx.sched = sched
        return out

    @staticmethod
    def backward(ctx, g):
        dx, grads = ctx.sched.backward(ctx.saved, g.contiguous())
        ctx.saved = None
        return (None, dx, *grads)


def gpipe(stage_fn: Callable[[Sequence[nn.Module], Payload, int], torch.Tensor],
          layers: Sequence[nn.Module], payload: Payload, group,
          num_microbatches: int = 0) -> torch.Tensor:
    """stage_{S-1}(... stage_0(payload)) over the stages of ``group`` (a
    PPGroup), on every stage.  ``layers``: the whole stack, whose count
    divides by the stages; stage s runs its contiguous share.
    ``payload``: [B, ...] tensors, ``"h"`` the activations (the one
    differentiable entry), every other entry riding along with its
    microbatch; ``stage_fn(stage_layers, payload_mb, i)`` maps microbatch
    i's payload to its output activations, of h's shape and dtype.  The
    rows must divide into the microbatches (0: one a stage).  A backward
    leaves every stage with the gradients of every layer."""
    h = payload["h"]
    m, mb = microbatches(h.shape[0], group.size, num_microbatches)
    rest = {k: v for k, v in payload.items() if k != "h"}
    sched = _Schedule(stage_fn, layers, rest, group, m, mb)
    if torch.is_grad_enabled() and (h.requires_grad or sched.params):
        return GPipeFn.apply(sched, h, *sched.params)
    return sched.forward(h, keep_graph=False)[0]


def pipeline_encoder_apply(layers: Sequence[nn.Module], x: torch.Tensor, bias, group,
                           num_microbatches: int = 0, tanh_residual_base=None, *,
                           train: bool = False, gen=None) -> torch.Tensor:
    """A TransformerEncoder's layer stack (``layers``, models/common.py)
    over ``group``'s stages, equal to the stack run whole: each stage runs
    its contiguous layers with the layer's own routes (``train``/``gen``
    as TransformerLayer.forward takes them).  ``bias``: a MaskSpec, whose
    key mask rides with its microbatch, or an additive bias with a
    leading dimension of 1 or B.  With ``tanh_residual_base`` the result is
    ``base + tanh(stack(x))``: in a pass without gradients inside the last
    stage's last layer (the eval block's tanh form where its gate holds),
    else after the pipeline."""
    stages = group.size
    b = x.shape[0]
    _, mb = microbatches(b, stages, num_microbatches)
    if isinstance(bias, MaskSpec):
        mask, dec_len = bias.key_mask, bias.dec_len
    else:
        mask, dec_len = bias.expand((b,) + tuple(bias.shape[1:])), None
    grad = torch.is_grad_enabled() and (x.requires_grad or any(
        p.requires_grad for layer in layers for p in layer.parameters()))
    base = tanh_residual_base
    tanh_inside = base is not None and not grad

    def stage_fn(stage_layers, inp, i):
        spec = MaskSpec(key_mask=inp["mask"], dec_len=dec_len) if dec_len is not None \
            else inp["mask"]
        h = inp["h"]
        for j, layer in enumerate(stage_layers):
            last = tanh_inside and group.rank == stages - 1 and j == len(stage_layers) - 1
            h = layer(h, spec, tanh_residual_base=base[i * mb:(i + 1) * mb] if last else None,
                      train=train, gen=gen)
        return h

    out = gpipe(stage_fn, layers, {"h": x, "mask": mask.contiguous()}, group, num_microbatches)
    return base + torch.tanh(out) if base is not None and not tanh_inside else out
