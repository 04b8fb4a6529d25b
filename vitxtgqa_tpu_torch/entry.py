"""The port's entry points: the counterparts of ``__graft_entry__.entry()``
and of ``__graft_entry__.dryrun_multichip`` on the data, model, sp and pp
axes.

    fn, args = entry()
    out = fn(*args)   # the serving forward on the card

    dryrun_multichip(4)                        # data x model = 2 x 2 on the card(s)
    dryrun_multichip(2, device="cpu")          # model 2 on two gloo ranks on the CPU
    dryrun_multichip(2, device="cpu", model=1) # data 2
    dryrun_multichip(4, device="cpu", sp=2)    # model x sp = 2 x 2
    dryrun_multichip(4, device="cpu", pp=2)    # model x pp = 2 x 2
    dryrun_multichip(4, device="cpu", model=1, sp=2)  # data x sp = 2 x 2
    dryrun_multichip(2, device="cpu", pp=2)    # a pipeline of two stages

``entry()`` builds T2S at production dims (configs/t2s_abinet.yml's model,
``models/t2s.t2s_production_config``; 5050 answers + 960 OCR copy slots,
BOS 2) with random weights from seed 0, and a synthetic batch of 2 videos
on the device.  ``fn`` is the serving forward (the pos greedy decode and
the grounding), its gumbel draws fixed by a seed.

``dryrun_multichip(n, model=, sp=, pp=)`` spawns ``n`` ranks
(``torch.multiprocessing``, a ``file://`` rendezvous in a temporary
directory): gloo on the CPU or where ranks share a card, NCCL with a card a
rank.  They form the mesh data x model x sp x pp (parallel/mesh.build_mesh,
data = n / (model sp pp); ``model`` defaults to JAX's dry run's, 2 where
the world holds it beside sp x pp (n a multiple of 2 sp pp), else 1; every
combination of the axes runs), and each takes
one full T2S training step (forward, the losses, backward with the
pipelined stacks' gradients all-gathered over the stages, the split
layers' partials summed over the model group, the gradients' all-reduce
over the mesh and their mean over the model x sp x pp replicas, clipping,
Adam) on its data
row's rows of a global batch of ``2 data``, every dropout at 0 and the
gumbel draws from the shared generator; this process takes the same step
on the global batch alone, from the same seeded weights.  The loss, the
gradient norm, every parameter's gradient and (on the CPU) update,
relative L2 differences, a key projection's bias left out (softmax
ignores it), must agree within ``DRYRUN_LIMITS`` (a split layer's
gradients and updates gathered over the model group), and every rank
must hold the same parameters after the update (the shards: the ranks
of one model coordinate; ``data_parallel_step``, which chip_smoke.py's
slices o, r and s run too).  The batch's rows carry
unequal loss-mask counts, so a mean of the ranks' ratios would not pass.
On the CPU the model is the tiny T2S in float32; on the card the
production T2S in bf16 through the kernels (at 3 / 2 / 3 layers: pp 3
pipelines the text BERT and the MMT, pp 2 the QTV).
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from vitxtgqa_tpu_torch import Options
from vitxtgqa_tpu_torch.models.t2s import PRODUCTION_NUM_FINAL_OUTPUTS, T2S, t2s_production_config
from vitxtgqa_tpu_torch.serving.engine import group_generator, to_device
from vitxtgqa_tpu_torch.utils.synthetic import synthetic_batch

# (loss, gradient norm, per-parameter gradient, per-parameter update)
# relative limits of the data-parallel step against the one-process step:
# float32 on the CPU (another summation order); bf16 through the kernels
# on the card (chip_smoke.py slice e's limits), where the update is printed
# and not held: Adam's first step is about the gradient's sign, which
# bf16 rounding flips on the entries near zero
DRYRUN_LIMITS = {"cpu": (1e-5, 1e-4, 1e-3, 1e-3), "cuda": (5e-4, 1e-3, 5e-2, None)}
DRYRUN_SEED, DRYRUN_ROWS = 7, 2   # the step's seed; a rank's rows
LOSSES = [{"type": "pos_bce_loss", "weight": 1.0}, {"type": "InfoNCE", "weight": 1000}]


def entry(device: Any = "cuda") -> Tuple[Callable[..., Dict[str, Any]], tuple]:
    """(fn, args): ``fn(*args)`` is the serving forward of the production
    T2S on ``device`` (the card by default) at batch 2."""
    opts = Options(device=device)
    model = T2S(t2s_production_config(), PRODUCTION_NUM_FINAL_OUTPUTS, bos_idx=2, opts=opts,
                inference_only=True).init_weights(0)
    batch = to_device(synthetic_batch(batch=2, num_final_outputs=PRODUCTION_NUM_FINAL_OUTPUTS),
                      opts.device)

    def fn(tensors):
        return model(tensors, group_generator(3, 0, opts.device))

    return fn, (batch,)


def dryrun_model_and_batch(device: torch.device, rows: int, dropout: bool = False):
    """(model config, final outputs, the global batch of ``rows`` as numpy)
    of the dry run: the tiny T2S on the CPU, the production T2S on the
    card, every dropout 0 unless ``dropout``; odd rows keep one active
    decode step of three."""
    from vitxtgqa_tpu_torch.utils.synthetic import tiny_model_config

    if device.type == "cuda":
        cfg, nf = t2s_production_config(), PRODUCTION_NUM_FINAL_OUTPUTS
        batch = synthetic_batch(batch=rows, num_final_outputs=nf, seed=DRYRUN_SEED)
    else:
        frames, opf = 8, 3
        cfg = tiny_model_config(hidden=64, frames=frames, ocr_per_frame=opf)
        nf = 32 + frames * opf
        batch = synthetic_batch(batch=rows, frames=frames, ocr_per_frame=opf, dec_steps=4,
                                text_len=10, video_feat_dim=32, fasttext_dim=16, phoc_dim=24,
                                num_final_outputs=nf, text_vocab=128, seed=DRYRUN_SEED)
    cfg = {k: (dict(v) if hasattr(v, "items") else v) for k, v in cfg.items()}
    if not dropout:
        for sect in ("text_bert", "translayers", "mmt", "encoder"):
            if sect in cfg:
                cfg[sect].update(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
        cfg["obj"]["dropout_prob"] = cfg["ocr"]["dropout_prob"] = 0.0
    batch["train_loss_mask"][1::2, 1:] = 0.0
    return cfg, nf, batch


def data_parallel_step(model, cfg, tensors: Dict[str, torch.Tensor], group=None,
                       check_replicas: bool = True) -> Dict[str, Any]:
    """One training step of ``model`` (the config's losses, the production
    optimizer, the model's sp and pp groups) on ``tensors`` (this data
    row's rows on a data axis ``group``, else the global batch), the
    gumbel draws from step_generators(DRYRUN_SEED, 0): the global loss and
    gradient norm, each parameter's applied (reduced, clipped) float32
    gradient and float32 update, flattened.  On a mesh (a data group, or
    the model's sp or pp group) every rank of the world must hold the same
    parameters after the update (``check_replicas``); under tensor
    parallelism a split layer's gradients and updates are gathered over
    the model group (every rank returns whole ones)."""
    from vitxtgqa_tpu_torch.losses import Losses
    from vitxtgqa_tpu_torch.parallel import tensor_parallel as TP
    from vitxtgqa_tpu_torch.parallel.collectives import all_gather
    from vitxtgqa_tpu_torch.training.optim import build_optimizer
    from vitxtgqa_tpu_torch.training.step import step_generators, train_step

    opt = build_optimizer(model, model_config=cfg, group=group)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    before = [m.detach().float().clone() for _, m in opt.pairs]
    tp = model.opts.tp
    whole = lambda t, p: (all_gather(t, tp.group, dim=p.tp_dim)
                          if tp is not None and TP.is_sharded(p) else t).flatten()
    grads = {}
    apply = opt.apply

    def keep_and_apply():
        grads.update({n: whole(m.grad.detach().float().clone(), p)
                      for n, (p, m) in zip(names, opt.pairs)})
        apply()

    opt.apply = keep_and_apply
    r = train_step(model, Losses(cfg["losses"], group=group), opt, tensors,
                   step_generators(DRYRUN_SEED, 0, tensors["text"].device, group))
    if not r["applied"]:
        raise RuntimeError(f"a data-parallel step was skipped (loss {float(r['loss'])})")
    o = model.opts
    on_mesh = group is not None or o.sp is not None or o.pp is not None or o.tp is not None
    if on_mesh and check_replicas:
        for p, m in opt.pairs:
            if TP.is_sharded(p):
                TP.mark(m, p.tp_dim)
        TP.check_replicas([m for _, m in opt.pairs], "the parameters after the update", tp)
    return {"loss": float(r["loss"]), "norm": float(r["grad_norm"]), "grads": grads,
            "update": {n: whole(m.detach().float() - b, p)
                       for n, (p, m), b in zip(names, opt.pairs, before)}}


def largest_gap(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]) -> Tuple[float, str]:
    """The largest per-parameter relative L2 difference of ``got`` from
    ``want`` and its parameter, a key projection's bias (whose gradient is
    rounding: softmax ignores it) left out; a NaN is the largest."""
    worst, name = 0.0, ""
    for k, w in want.items():
        nw = float(w.norm())
        if nw > 0 and not k.endswith(("attention.self.key.bias", "k_lin.bias")):
            rel = float((got[k] - w).norm()) / nw
            if not rel <= worst:
                worst, name = rel, k
    return worst, name


def step_gaps(got: Dict[str, Any], ref: Dict[str, Any]) -> Dict[str, Any]:
    """How far the step ``got`` lies from the step ``ref`` (each
    data_parallel_step's result): the relative differences of the loss and
    of the gradient norm, and (largest_gap) of the applied gradients and of
    the updates."""
    return {"loss_rel": abs(got["loss"] - ref["loss"]) / abs(ref["loss"]),
            "norm_rel": abs(got["norm"] - ref["norm"]) / ref["norm"],
            "grad_rel": largest_gap(got["grads"], ref["grads"]),
            "update_rel": largest_gap(got["update"], ref["update"])}


def within(gaps: Dict[str, Any], limits) -> bool:
    """Whether step_gaps' ``gaps`` lie within ``limits`` (loss, gradient
    norm, gradient, update; an update limit of None holds nothing)."""
    loss_tol, norm_tol, grad_tol, update_tol = limits
    return (gaps["loss_rel"] <= loss_tol and gaps["norm_rel"] <= norm_tol
            and gaps["grad_rel"][0] <= grad_tol
            and (update_tol is None or gaps["update_rel"][0] <= update_tol))


def _dryrun_step(device: torch.device, batch: Dict[str, np.ndarray], mesh=None):
    """data_parallel_step of the dry run's model (seed-0 weights) on
    ``mesh`` (None: one process), on the CPU for the parent's
    comparison."""
    cfg, nf, _ = dryrun_model_and_batch(device, 1)
    opts = Options(device=device, sp=mesh.sp if mesh else None, pp=mesh.pp if mesh else None,
                   tp=mesh.model if mesh else None)
    model = T2S(cfg, nf, bos_idx=2, opts=opts).init_weights(0)
    out = data_parallel_step(model, cfg, to_device(batch, device), mesh.data if mesh else None)
    return {k: ({n: t.cpu() for n, t in v.items()} if isinstance(v, dict) else v)
            for k, v in out.items()}


def _dryrun_rank(rank: int, n: int, device_type: str, directory: str, model: int = 1,
                 sp: int = 1, pp: int = 1) -> None:
    """One rank of dryrun_multichip (torch.multiprocessing.spawn's target)."""
    import torch.distributed as dist

    from vitxtgqa_tpu_torch.parallel.mesh import build_mesh, rank_device

    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    backend, device = rank_device(rank, n, device_type == "cuda")
    dist.init_process_group(backend, init_method=f"file://{directory}/rendezvous", rank=rank,
                            world_size=n)
    try:
        mesh = build_mesh(-1, model, sp, pp)
        d, data = mesh.coords["data"], mesh.shape["data"]
        _, _, batch = dryrun_model_and_batch(device, DRYRUN_ROWS * data)
        out = _dryrun_step(device, {k: v[d::data] for k, v in batch.items()}, mesh)
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(directory, f"rank{rank}.pt"))


def dryrun_multichip(n_devices: int, device: str = "cuda", model: Optional[int] = None,
                     sp: int = 1, pp: int = 1) -> Dict[str, Any]:
    """The step on the mesh data x model x sp x pp of ``n_devices`` ranks
    against the one-process step on the same global batch (module
    docstring), on the card unless ``device="cpu"``; raises where they
    disagree (a mesh the ranks cannot hold raises first), and returns the
    readings.  ``model`` None: JAX's default (module docstring)."""
    import torch.multiprocessing as mp

    from vitxtgqa_tpu_torch.parallel.mesh import mesh_shape

    if model is None:
        model = 2 if n_devices % (2 * sp * pp) == 0 else 1
    data = mesh_shape(-1, model, sp, pp, world=n_devices)["data"]
    dev = torch.device(device)
    with tempfile.TemporaryDirectory() as directory:
        mp.spawn(_dryrun_rank, args=(n_devices, dev.type, directory, model, sp, pp),
                 nprocs=n_devices, join=True)
        ranks = [torch.load(os.path.join(directory, f"rank{r}.pt")) for r in range(n_devices)]
    _, _, batch = dryrun_model_and_batch(dev, DRYRUN_ROWS * data)
    ref = _dryrun_step(dev, batch)
    limits = DRYRUN_LIMITS[dev.type]
    loss_tol, norm_tol, tol, update_tol = limits
    got = ranks[0]
    out = {"ranks": n_devices, "mesh": {"data": data, "model": model, "sp": sp, "pp": pp},
           "device": dev.type,
           "loss": [got["loss"], ref["loss"]], **step_gaps(got, ref)}
    print(f"dryrun_multichip: {n_devices} ranks on {dev.type}, mesh data {data} x model {model} "
          f"x sp {sp} x pp {pp}, a step at global batch {DRYRUN_ROWS * data}: loss "
          f"{got['loss']:.6f} vs one "
          f"process {ref['loss']:.6f} "
          f"(rel {out['loss_rel']:.3e}), gradient norm rel {out['norm_rel']:.3e}, per-parameter "
          f"gradient rel max {out['grad_rel'][0]:.3e} ({out['grad_rel'][1]}), update rel max "
          f"{out['update_rel'][0]:.3e} ({out['update_rel'][1]}); limits {loss_tol}, {norm_tol}, "
          f"{tol}, {update_tol}", flush=True)
    if not within(out, limits):
        raise RuntimeError(f"dryrun_multichip: the step on the mesh disagrees with the "
                           f"one-process step: {out}")
    return out
