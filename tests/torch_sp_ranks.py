"""Runs of the port under sequence parallelism on gloo ranks on the CPU,
for the port's tests (tests/test_torch_sp.py, tests/test_torch_chip_smoke.py).

A test module starts one set of ranks with ``launch(cases, directory)``:
the cases are pickled into the directory, and each rank (``python -m
tests.torch_sp_ranks DIR RANK WORLD``) imports torch and the port only, no
JAX, joins a gloo group (a ``file://`` rendezvous in DIR), runs every case
under ``Options(sp=build_sp_group(WORLD))`` and pickles its results, which
``launch`` returns in rank order.  A failing rank fails the launch with its
error output.

Case kinds (the ``kind`` key):
- "attention": ``sp_attention`` of q / k / v with a bias form, and its
  gradients for the cotangent ``g`` (the loss sum(out * g));
- "t2s": a T2S forward (``inference_only`` or full-eval) with injected
  gumbel noise;
- "train": a training forward, the losses and every parameter's gradient;
- "launches": a T2S forward (or training step) whose plain kernel versions
  are counted, by the kernel each stands for.
"""

from __future__ import annotations

import importlib
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tensors(batch):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}


def _model(case, sp):
    from vitxtgqa_tpu_torch import Options
    from vitxtgqa_tpu_torch.models.t2s import T2S

    opts = Options(device="cpu", sp=sp, **case["opts"])
    model = T2S(case["cfg"], case["nf"], bos_idx=2, opts=opts,
                inference_only=case.get("inference_only", True))
    model.load_state_dict(case["state"])
    return model


def _bias(spec):
    from vitxtgqa_tpu_torch.ops.masks import MaskSpec

    if spec is None:
        return None
    if spec["form"] == "mask_spec":
        return MaskSpec(key_mask=torch.from_numpy(spec["key_mask"]), dec_len=spec["dec_len"])
    return torch.from_numpy(spec["bias"])


def run_attention(case, sp):
    from vitxtgqa_tpu_torch.parallel.sequence_parallel import sp_attention

    q, k, v = (torch.from_numpy(case[n]).requires_grad_() for n in ("q", "k", "v"))
    out = sp_attention(q, k, v, _bias(case["bias"]), sp)
    (out * torch.from_numpy(case["g"])).sum().backward()
    return {"out": out.detach().numpy(), "dq": q.grad.numpy(), "dk": k.grad.numpy(),
            "dv": v.grad.numpy()}


def _noise(case):
    return tuple(torch.from_numpy(n) for n in case["noise"])


def run_t2s(case, sp):
    model = _model(case, sp)
    with torch.inference_mode():
        out = model(_tensors(case["batch"]), _noise(case))
    return {k: v.float().numpy() for k, v in out.items() if torch.is_tensor(v)}


def run_train(case, sp):
    from vitxtgqa_tpu_torch.losses import Losses

    model = _model(case, sp)
    batch = _tensors(case["batch"])
    out = model(batch, _noise(case), train=True)
    total, parts = Losses(case["losses"]).total(batch, out)
    total.backward()
    return {"total": float(total.detach()),
            "parts": {k: float(v.detach()) for k, v in parts.items()},
            "scores": {k: out[k].detach().numpy()
                       for k in ("ref_scores", "pos_scores", "neg_scores")},
            "grads": {k: p.grad.numpy() for k, p in model.named_parameters()
                      if p.grad is not None}}


def run_launches(case, sp):
    """Calls of the plain versions ((module, function, kernel) in
    case["plain_of"]) in one forward, or one training step, on CPU tensors,
    where each kernel wrapper runs its plain version."""
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
        if case.get("train"):
            from vitxtgqa_tpu_torch.losses import Losses

            model = _model(case, sp)
            batch = _tensors(case["batch"])
            out = model(batch, _noise(case), train=True,
                        dropout_gen=torch.Generator().manual_seed(1))
            Losses(case["losses"]).total(batch, out)[0].backward()
        else:
            run_t2s(case, sp)
    finally:
        for mod, fn_name, fn in originals:
            setattr(mod, fn_name, fn)
    return counts


RUNNERS = {"attention": run_attention, "t2s": run_t2s, "train": run_train,
           "launches": run_launches}


def main(argv) -> int:
    from vitxtgqa_tpu_torch.parallel.mesh import build_sp_group

    directory, rank, world = argv[0], int(argv[1]), int(argv[2])
    torch.set_num_threads(1)
    with open(os.path.join(directory, "cases.pkl"), "rb") as f:
        cases = pickle.load(f)
    dist.init_process_group("gloo", init_method=f"file://{directory}/rendezvous", rank=rank,
                            world_size=world)
    try:
        sp = build_sp_group(world)
        out = {name: RUNNERS[case["kind"]](case, sp) for name, case in cases.items()}
    finally:
        dist.destroy_process_group()
    with open(os.path.join(directory, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    return 0


def launch(cases, directory, world: int = 2, timeout: float = 600.0):
    """Run ``cases`` on ``world`` gloo ranks; returns each rank's results.
    A rank that fails (or a run past ``timeout`` seconds) stops the others
    and raises with the ranks' output."""
    directory = str(directory)
    with open(os.path.join(directory, "cases.pkl"), "wb") as f:
        pickle.dump(cases, f)
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    logs = [os.path.join(directory, f"rank{r}.log") for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "tests.torch_sp_ranks", directory, str(r), str(world)],
                cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    while any(p.poll() is None for p in procs):
        if any(p.poll() for p in procs) or time.monotonic() > deadline:
            for p in procs:
                p.kill()
            break
        time.sleep(0.05)
    for p in procs:
        p.wait()
    if any(p.returncode for p in procs):
        text = "\n".join(f"rank {r} (exit {p.returncode}):\n" + open(logs[r]).read()[-6000:]
                         for r, p in enumerate(procs))
        raise RuntimeError(f"sequence-parallel ranks failed:\n{text}")
    results = []
    for r in range(world):
        with open(os.path.join(directory, f"rank{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
