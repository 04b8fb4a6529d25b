"""Runs of the port under data parallelism on gloo ranks on the CPU, for the
port's tests (tests/test_torch_dp.py).

A test module starts one set of ranks with ``start(cases, directory)`` and
collects them with ``Ranks.results()``: the cases are pickled into the
directory, and each rank (``python -m tests.torch_dp_ranks DIR RANK WORLD``)
imports torch and the port only, no JAX, joins a gloo group (a ``file://``
rendezvous in DIR), runs every case in order and pickles its results,
which ``results`` returns in rank order.  A failing rank fails the
collection with its error output.

Case kinds (the ``kind`` key):
- "steps": ``training/step.train_step`` on the rank's rows of a global
  batch for ``steps`` Adam steps, the gumbel noise a global numpy array of
  which the rank takes its rows (ops/gumbel.RankRows): each step's loss,
  parts, gradient norm and whether it applied, the parameters after;
- "generators": one step with ``step_generators(..., group)``, the
  gumbel draws from the step's generator (a rank's NaN rows where
  ``nan_rank`` names the rank);
- "dropout": one training forward of the same rows on every rank with the
  rank's dropout generator: the pos scores;
- "trainer": a loaded trainer (``training/trainer.BaseTrainer``) of the
  case's CLI arguments, its gumbel draws the case's noise and its data
  generators reseeded, trained: the meter's series, the parameters (those
  of ckpt/best, which the trainer restores at its end) and ckpt/final's,
  the checkpoint writes of the rank;
- "run": ``run(argv)`` (the CLI in-process): the prediction report's rows,
  the checkpoint writes of the rank and whether it ran the int8 cache;
- "launches": one data-parallel training step whose plain kernel
  versions ((module, function, kernel) in case["plain_of"]) are counted,
  by the kernel each stands for.
"""

from __future__ import annotations

import json
import os
import pickle
import random
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tensors(batch):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}


def _rows(batch, rank, world):
    return {k: v[rank::world] for k, v in batch.items()}


def _model(case):
    from vitxtgqa_tpu_torch import Options
    from vitxtgqa_tpu_torch.models.t2s import T2S

    model = T2S(case["cfg"], case["nf"], bos_idx=2, opts=Options(device="cpu"))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in case["state"].items()})
    return model


def _group(case, world):
    from vitxtgqa_tpu_torch.parallel.mesh import build_data_group

    return build_data_group(world, batch_size=case["batch"]["text"].shape[0])


def run_steps(case, rank, world):
    from vitxtgqa_tpu_torch.losses import Losses
    from vitxtgqa_tpu_torch.ops.gumbel import RankRows
    from vitxtgqa_tpu_torch.training.optim import build_optimizer
    from vitxtgqa_tpu_torch.training.step import train_step

    group = _group(case, world)
    model = _model(case)
    opt = build_optimizer(model, case["oa"], case["tp"], case["cfg"], group=group)
    losses = Losses(case["losses"], group=group)
    batch = _tensors(_rows(case["batch"], rank, world))
    noise = RankRows(lambda shape, kind: case["noise"][shape], rank, world)
    steps = []
    for _ in range(case["steps"]):
        r = train_step(model, losses, opt, batch, (torch.Generator().manual_seed(0), noise))
        steps.append({"loss": float(r["loss"]), "norm": float(r["grad_norm"]),
                      "parts": {k: float(v) for k, v in r["losses"].items()},
                      "applied": r["applied"]})
    return {"steps": steps, "count": opt.count,
            "state": {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}}


def run_generators(case, rank, world):
    from vitxtgqa_tpu_torch.losses import Losses
    from vitxtgqa_tpu_torch.training.optim import build_optimizer
    from vitxtgqa_tpu_torch.training.step import step_generators, train_step

    group = _group(case, world)
    model = _model(case)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    opt = build_optimizer(model, model_config=case["cfg"], group=group)
    rows = _rows(case["batch"], rank, world)
    if case.get("nan_rank") == rank:
        rows["video_feat"] = rows["video_feat"] * np.float32("nan")
    r = train_step(model, Losses(case["losses"], group=group), opt, _tensors(rows),
                   step_generators(case["seed"], 0, "cpu", group))
    unchanged = all(torch.equal(before[k], v) for k, v in model.state_dict().items())
    return {"loss": float(r["loss"]), "norm": float(r["grad_norm"]), "applied": r["applied"],
            "count": opt.count, "unchanged": unchanged,
            "grads_dropped": all(p.grad is None for p in model.parameters())}


def run_dropout(case, rank, world):
    from vitxtgqa_tpu_torch.training.step import step_generators

    group = _group(case, world)
    model = _model(case)
    dropout_gen, gumbel = step_generators(case["seed"], 0, "cpu", group)
    out = model(_tensors(case["rows"]), gumbel, train=True, dropout_gen=dropout_gen)
    return {"pos_scores": out["pos_scores"].detach().numpy()}


class Writes:
    """Count Checkpoint._write's calls in this process."""

    def __init__(self):
        from vitxtgqa_tpu_torch.training import checkpoint as C

        self.n, self.mod, self.write = 0, C, C.Checkpoint._write

        def counted(ckpt, *a, **kw):
            self.n += 1
            return self.write(ckpt, *a, **kw)

        C.Checkpoint._write = counted

    def close(self):
        self.mod.Checkpoint._write = self.write


def _reports(save_dir):
    d = os.path.join(save_dir, "reports")
    out = {}
    for name in sorted(os.listdir(d)) if os.path.isdir(d) else ():
        with open(os.path.join(d, name)) as f:
            out[name] = json.load(f)
    return out


def _series(meter):
    return {k: list(m.series) for k, m in meter.meters.items()}


def run_trainer(case, rank, world):
    from vitxtgqa_tpu_torch.core.config import build_config
    from vitxtgqa_tpu_torch.core.flags import get_parser
    from vitxtgqa_tpu_torch.core.registry import registry
    from vitxtgqa_tpu_torch.run import setup_imports
    from vitxtgqa_tpu_torch.training import trainer as T

    setup_imports()
    noise = case.get("noise")
    real = T.step_generators
    if noise is not None:
        def gens(seed, step, device, group=None):
            drop, _ = real(seed, step, device, group)
            return drop, tuple(torch.from_numpy(n[rank::world]) for n in noise)
        T.step_generators = gens
    writes = Writes()
    try:
        args = get_parser().parse_args(case["argv"])
        trainer = registry.get_trainer_class("base_trainer")(
            build_config(args.config, opts=args.opts, args=args))
        trainer.load()
        if case.get("reseed"):
            for ds in trainer.datasets.values():
                ds.rng = random.Random(13)
                ds.answer_processor.processor.rng = np.random.default_rng(7)
        try:
            trainer.train()
        finally:
            trainer.close()
    finally:
        T.step_generators = real
        writes.close()
    final = os.path.join(trainer.logger.save_dir, "ckpt", "final", "state.pt")
    return {"series": _series(trainer.meter), "writes": writes.n,
            "final": ({k: v.numpy() for k, v in torch.load(final)["model"].items()}
                      if os.path.exists(final) else None),
            "iteration": trainer.iteration,
            "state": {k: v.detach().numpy().copy() for k, v in trainer.model.state_dict().items()}}


def run_cli(case, rank, world):
    from vitxtgqa_tpu_torch.run import run

    writes = Writes()
    try:
        trainer = run(case["argv"])
    finally:
        writes.close()
    return {"writes": writes.n, "reports": _reports(trainer.logger.save_dir) if rank == 0 else {},
            "rows": len(trainer.datasets["test"]) if "test" in trainer.datasets else 0,
            "kv_cache_int8": trainer.opts.kv_cache_int8}


def run_launches(case, rank, world):
    import importlib

    counts = {}

    def counting(fn, kernel):
        def call(*a, **kw):
            counts[kernel] = counts.get(kernel, 0) + 1
            return fn(*a, **kw)
        return call

    originals = []
    for mod_name, fn_name, kernel in case["plain_of"]:
        mod = importlib.import_module(mod_name)
        originals.append((mod, fn_name, getattr(mod, fn_name)))
        setattr(mod, fn_name, counting(getattr(mod, fn_name), kernel))
    try:
        run_generators(case, rank, world)
    finally:
        for mod, fn_name, fn in originals:
            setattr(mod, fn_name, fn)
    return counts


RUNNERS = {"launches": run_launches, "steps": run_steps, "generators": run_generators,
           "dropout": run_dropout, "trainer": run_trainer, "run": run_cli}


def main(argv) -> int:
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


class Ranks:
    """Ranks started by ``start``; ``results()`` waits for them."""

    def __init__(self, procs, logs, directory, timeout):
        self.procs, self.logs, self.directory = procs, logs, directory
        self.deadline = time.monotonic() + timeout
        self._results = None

    def results(self):
        if self._results is not None:
            return self._results
        procs = self.procs
        while any(p.poll() is None for p in procs):
            if any(p.poll() for p in procs) or time.monotonic() > self.deadline:
                for p in procs:
                    p.kill()
                break
            time.sleep(0.05)
        for p in procs:
            p.wait()
        if any(p.returncode for p in procs):
            text = "\n".join(f"rank {r} (exit {p.returncode}):\n"
                             + open(self.logs[r]).read()[-6000:] for r, p in enumerate(procs))
            raise RuntimeError(f"data-parallel ranks failed:\n{text}")
        out = []
        for r in range(len(procs)):
            with open(os.path.join(self.directory, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        self._results = out
        return out


def start(cases, directory, world: int = 2, timeout: float = 600.0,
          module: str = "tests.torch_dp_ranks") -> Ranks:
    """Start ``cases`` on ``world`` gloo ranks of ``module`` (its ``main``
    takes DIR RANK WORLD) in the background."""
    directory = str(directory)
    with open(os.path.join(directory, "cases.pkl"), "wb") as f:
        pickle.dump(cases, f)
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    logs = [os.path.join(directory, f"rank{r}.log") for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", module, directory, str(r), str(world)],
                cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT))
    return Ranks(procs, logs, directory, timeout)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
