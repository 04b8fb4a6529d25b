"""Runs of the port on the mesh's data, sp and pp axes on gloo ranks on the
CPU, for the port's tests (tests/test_torch_mesh.py).

As tests/torch_dp_ranks.py: a test module starts one world with
``start(cases, directory, world)`` and collects it with
``Ranks.results()``; each rank (``python -m tests.torch_mesh_ranks DIR
RANK WORLD``) imports torch and the port only, no JAX, joins a gloo group
(a ``file://`` rendezvous in DIR), runs every case in order and pickles its
results.

Case kinds (the ``kind`` key):
- "layout": build_mesh for each of ``meshes`` ((data, sp, pp) sizes): the
  rank's coordinates, and the world ranks that all-gather over each of its
  groups;
- "encoder": a TransformerEncoder of ``cfg`` (``state``'s weights) over a
  pp group of each ``pp`` size (build_mesh's at the world's size over it,
  else a group of the first ``pp`` ranks, which the other ranks sit out)
  for each number of microbatches: a training pass (the output, the
  gradients of the input and of every parameter for the cotangent ``g``)
  and an eval pass with the tanh residual;
- "step": one T2S training step (the config's losses, Adam of ``oa`` /
  ``tp``) on the mesh ``mesh`` ((data, sp, pp)), the data row's rows of
  the global batch, the gumbel noise global numpy arrays (ops/gumbel.
  RankRows over the data axis): the loss, its parts, the gradient norm,
  the parameters after, and how many passes ran pipelined;
- "run": ``run(argv)`` (the CLI in-process): the prediction reports (rank
  0), the meter's series, the number of questions a split and ckpt/final's
  parameters;
- "launches": for each of ``runs`` (a full-eval forward with the int8
  cache, or a training step, on a mesh or a pp group of the first ranks),
  the calls of the plain versions ((module, function, kernel) in
  ``plain_of``) on CPU tensors, where each kernel wrapper runs its plain
  version, and the rank's stage and data coordinate.
"""

from __future__ import annotations

import importlib
import os
import sys

import torch
import torch.distributed as dist

from tests.torch_dp_ranks import Ranks, _reports, _series, _tensors  # noqa: F401
from tests.torch_dp_ranks import start as _start


def run_layout(case, rank, world):
    from vitxtgqa_tpu_torch.parallel.collectives import gather_objects
    from vitxtgqa_tpu_torch.parallel.mesh import build_mesh

    out = []
    for data, sp, pp in case["meshes"]:
        mesh = build_mesh(data, 1, sp, pp)
        groups = {}
        for axis in ("data", "sp", "pp"):
            g = getattr(mesh, axis)
            groups[axis] = None if g is None else (g.rank, gather_objects(rank, g.group))
        out.append({"coords": mesh.coords, "groups": groups,
                    "peers": list(mesh.pp.peers) if mesh.pp else None})
    return out


def _pp_group(pp, world):
    """A PPGroup of ``pp`` stages: build_mesh's where the world divides by
    it, else the first ``pp`` ranks' (every rank creates the group; the
    others get None)."""
    from vitxtgqa_tpu_torch.parallel.mesh import PPGroup, build_mesh

    if world % pp == 0:
        return build_mesh(-1, 1, 1, pp).pp
    ranks = list(range(pp))
    group = dist.new_group(ranks)
    rank = dist.get_rank()
    return PPGroup(group=group, rank=rank, size=pp, peers=tuple(ranks)) if rank < pp else None


def run_encoder(case, rank, world):
    from vitxtgqa_tpu_torch import Options
    from vitxtgqa_tpu_torch.models.common import TransformerConfig, TransformerEncoder
    from vitxtgqa_tpu_torch.ops.masks import MaskSpec

    cfg = TransformerConfig(**case["cfg"])
    x, g, km = (torch.from_numpy(case[k]) for k in ("x", "g", "key_mask"))
    out = {}
    for pp in case["pp"]:
        group = _pp_group(pp, world)
        if group is None:
            continue
        for m in (0, pp, 2 * pp):
            enc = TransformerEncoder(cfg, Options(device="cpu", pp=group, pp_microbatches=m))
            enc.load_state_dict({k: torch.from_numpy(v) for k, v in case["state"].items()})
            spec = MaskSpec(key_mask=km, dec_len=case["dec_len"])
            xg = x.clone().requires_grad_()
            y = enc(xg, spec, train=True, gen=torch.Generator().manual_seed(0))
            y.backward(g)
            with torch.no_grad():
                y_eval = enc(x, spec, tanh_residual_base=x)
            out[(pp, m)] = {
                "y": y.detach().numpy(), "dx": xg.grad.numpy(), "y_eval": y_eval.numpy(),
                "grads": {k: None if p.grad is None else p.grad.numpy()
                          for k, p in enc.named_parameters()}}
    return out


def run_step(case, rank, world):
    from vitxtgqa_tpu_torch import Options
    from vitxtgqa_tpu_torch.losses import Losses
    from vitxtgqa_tpu_torch.models.t2s import T2S
    from vitxtgqa_tpu_torch.ops.gumbel import RankRows
    from vitxtgqa_tpu_torch.parallel import pipeline as P
    from vitxtgqa_tpu_torch.parallel.collectives import assert_replicas_equal
    from vitxtgqa_tpu_torch.parallel.mesh import build_mesh
    from vitxtgqa_tpu_torch.training.optim import build_optimizer
    from vitxtgqa_tpu_torch.training.step import train_step

    data, sp, pp = case["mesh"]
    mesh = build_mesh(data, 1, sp, pp, batch_size=case["batch"]["text"].shape[0])
    model = T2S(case["cfg"], case["nf"], bos_idx=2,
                opts=Options(device="cpu", sp=mesh.sp, pp=mesh.pp))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in case["state"].items()})
    opt = build_optimizer(model, case["oa"], case["tp"], case["cfg"], group=mesh.data)
    d, n = mesh.coords["data"], mesh.shape["data"]
    batch = _tensors({k: v[d::n] for k, v in case["batch"].items()})
    noise = RankRows(lambda shape, kind: case["noise"][shape], d, n)
    runs = []
    real = P.pipeline_encoder_apply

    def counted(*a, **kw):
        runs.append(len(a[0]))
        return real(*a, **kw)

    P.pipeline_encoder_apply = counted
    try:
        r = train_step(model, Losses(case["losses"], group=mesh.data), opt, batch,
                       (torch.Generator().manual_seed(0), noise))
    finally:
        P.pipeline_encoder_apply = real
    assert_replicas_equal(list(model.parameters()), "the parameters after the step")
    return {"loss": float(r["loss"]), "norm": float(r["grad_norm"]), "applied": r["applied"],
            "parts": {k: float(v) for k, v in r["losses"].items()}, "pipelined": runs,
            "coords": mesh.coords,
            "state": {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}}


def run_cli(case, rank, world):
    from vitxtgqa_tpu_torch.run import run

    trainer = run(case["argv"])
    final = os.path.join(trainer.logger.save_dir, "ckpt", "final", "state.pt")
    return {"reports": _reports(trainer.logger.save_dir) if rank == 0 else {},
            "series": _series(trainer.meter), "iteration": trainer.iteration,
            "mesh": trainer.mesh.shape,
            "questions": {s: len(ds) for s, ds in trainer.datasets.items()},
            "final": ({k: v.numpy() for k, v in torch.load(final)["model"].items()}
                      if rank == 0 and os.path.exists(final) else None)}


def run_launches(case, rank, world):
    from vitxtgqa_tpu_torch import Options
    from vitxtgqa_tpu_torch.losses import Losses
    from vitxtgqa_tpu_torch.models.t2s import T2S
    from vitxtgqa_tpu_torch.ops.gumbel import RankRows
    from vitxtgqa_tpu_torch.parallel.mesh import build_mesh
    from vitxtgqa_tpu_torch.training.optim import build_optimizer
    from vitxtgqa_tpu_torch.training.step import train_step

    counts = {}

    def counting(fn, kernel):
        def call(*a, **kw):
            counts[kernel] = counts.get(kernel, 0) + 1
            return fn(*a, **kw)
        return call

    out = {}
    for name, (how, axes, train) in case["runs"].items():
        if how == "first":
            data, d, sp, pp = None, 0, None, _pp_group(axes, world)
            n = 1
            if pp is None:
                continue
        else:
            mesh = build_mesh(axes[0], 1, axes[1], axes[2])
            data, sp, pp = mesh.data, mesh.sp, mesh.pp
            d, n = mesh.coords["data"], mesh.shape["data"]
        model = T2S(case["cfg"], case["nf"], bos_idx=2, inference_only=False,
                    opts=Options(device="cpu", kv_cache_int8=not train, sp=sp, pp=pp))
        model.load_state_dict({k: torch.from_numpy(v) for k, v in case["state"].items()})
        batch = _tensors({k: v[d::n] for k, v in case["batch"].items()})
        noise = RankRows(lambda shape, kind: case["noise"][shape], d, n)
        originals = []
        counts.clear()
        for mod_name, fn_name, kernel in case["plain_of"]:
            mod = importlib.import_module(mod_name)
            originals.append((mod, fn_name, getattr(mod, fn_name)))
            setattr(mod, fn_name, counting(getattr(mod, fn_name), kernel))
        try:
            if train:
                opt = build_optimizer(model, model_config=case["cfg"], group=data)
                train_step(model, Losses(case["losses"], group=data), opt, batch,
                           (torch.Generator().manual_seed(0), noise))
            else:
                with torch.no_grad():
                    model(batch, noise)
        finally:
            for mod, fn_name, fn in originals:
                setattr(mod, fn_name, fn)
        out[name] = {"stage": pp.rank if pp else 0, "rows": batch["text"].shape[0],
                     "counts": dict(counts)}
    return out


RUNNERS = {"layout": run_layout, "encoder": run_encoder, "step": run_step, "run": run_cli,
           "launches": run_launches}


def main(argv) -> int:
    import pickle

    directory, rank, world = argv[0], int(argv[1]), int(argv[2])
    torch.set_num_threads(1)
    with open(os.path.join(directory, "cases.pkl"), "rb") as f:
        cases = pickle.load(f)
    dist.init_process_group("gloo", init_method=f"file://{directory}/rendezvous", rank=rank,
                            world_size=world)
    try:
        out = {name: RUNNERS[case["kind"]](case, rank, world) for name, case in cases.items()}
    finally:
        dist.destroy_process_group()
    with open(os.path.join(directory, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    return 0


def start(cases, directory, world: int, timeout: float = 600.0) -> Ranks:
    """Start ``cases`` on ``world`` gloo ranks in the background."""
    return _start(cases, directory, world=world, timeout=timeout, module="tests.torch_mesh_ranks")


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
