"""Runs of the port under tensor parallelism (the mesh's model axis) on gloo
ranks on the CPU, for the port's tests (tests/test_torch_tp.py).

As tests/torch_mesh_ranks.py: a test module starts one world with
``start(cases, directory, world)`` and collects it with
``Ranks.results()``; each rank (``python -m tests.torch_tp_ranks DIR RANK
WORLD``) imports torch and the port only, no JAX, joins a gloo group (a
``file://`` rendezvous in DIR), runs every case in order and pickles its
results.

Case kinds (the ``kind`` key); ``mesh``, where a case names one, is
(data, model[, sp, pp]) (default: the model axis of the whole world):
- "encoder": a TransformerEncoder of ``cfg`` (``state``'s whole weights,
  each rank taking its shards) on the mesh: a training pass with the
  dropout generator of ``drop_seed`` (None: none; the pipeline then
  takes the stack) (the output, the input's gradient, every parameter's
  gradient made whole) and an eval pass with the tanh residual;
- "step": one T2S training step (the config's losses, Adam of ``oa`` /
  ``tp``) on the mesh, the data row's rows of the global batch, the
  gumbel noise global numpy arrays, the dropout generator of
  ``drop_seed``: the loss, the gradient norm, each parameter's applied
  gradient and the parameters after (both made whole), the rank's own
  parameters and coordinates; with ``ckpt`` (a directory) the model and
  optimizer state made whole and written there by rank 0
  (training/checkpoint.Checkpoint.finalize);
- "eval": the full-eval forward of T2S on the whole batch on the mesh:
  the scores;
- "vocab": for each model axis of ``sizes`` (the data axis the rest of
  the world) the vocabulary-parallel modules of ``vocab_modules``;
- "run": ``run(argv)`` (the CLI in-process): the meter's series, the
  reports (rank 0), ckpt/final's state as saved (rank 0), and the rank's
  own parameters and optimizer moments as they were when it was saved;
- "launches": a full-eval forward (the bf16 cache) and a training step
  on the mesh, the calls of the plain versions and split forms ((module,
  function, kernel) in ``plain_of``) counted by the kernel each stands
  for, with the rank's coordinates.
"""

from __future__ import annotations

import os
import sys

import torch
import torch.distributed as dist

from tests.torch_dp_ranks import Ranks, _reports, _series, _tensors  # noqa: F401
from tests.torch_dp_ranks import start as _start


def _whole(model, grads):
    from vitxtgqa_tpu_torch.parallel import tensor_parallel as TP

    return {k: v.numpy() for k, v in TP.whole_state(model, grads).items()}


def _mesh(case, world, batch_size=None):
    """build_mesh of the case's (data, model[, sp, pp]), or the model axis
    of the world; and the Options of its groups on the CPU, with the
    case's further Options fields (``opts``, where it has them)."""
    from vitxtgqa_tpu_torch import Options
    from vitxtgqa_tpu_torch.parallel.mesh import build_mesh

    axes = (tuple(case.get("mesh", (1, world))) + (1, 1))[:4]
    mesh = build_mesh(*axes, batch_size=batch_size)
    return mesh, Options(device="cpu", tp=mesh.model, sp=mesh.sp, pp=mesh.pp,
                         **case.get("opts", {}))


def run_encoder(case, rank, world):
    from vitxtgqa_tpu_torch.models.common import TransformerConfig, TransformerEncoder
    from vitxtgqa_tpu_torch.ops.masks import MaskSpec
    from vitxtgqa_tpu_torch.parallel import tensor_parallel as TP

    mesh, opts = _mesh(case, world)
    enc = TransformerEncoder(TransformerConfig(**case["cfg"]), opts)
    enc.load_state_dict(TP.local_state(enc, {k: torch.from_numpy(v)
                                             for k, v in case["state"].items()}))
    x, g, km = (torch.from_numpy(case[k]) for k in ("x", "g", "key_mask"))
    spec = MaskSpec(key_mask=km, dec_len=case["dec_len"])
    xg = x.clone().requires_grad_()
    seed = case["drop_seed"]
    y = enc(xg, spec, train=True, gen=None if seed is None else torch.Generator().manual_seed(seed))
    y.backward(g)
    with torch.no_grad():
        y_eval = enc(x, spec, tanh_residual_base=x)
    grads = {k: p.grad for k, p in enc.named_parameters()}
    return {"y": y.detach().numpy(), "dx": xg.grad.numpy(), "y_eval": y_eval.numpy(),
            "grads": _whole(enc, grads), "sharded": TP.sharded_dims(enc),
            "coords": mesh.coords, "pipelined": enc.pipelined(deterministic=seed is None)}


def run_step(case, rank, world):
    from vitxtgqa_tpu_torch.losses import Losses
    from vitxtgqa_tpu_torch.models.t2s import T2S
    from vitxtgqa_tpu_torch.ops.gumbel import RankRows
    from vitxtgqa_tpu_torch.parallel import tensor_parallel as TP
    from vitxtgqa_tpu_torch.training.checkpoint import Checkpoint
    from vitxtgqa_tpu_torch.training.optim import build_optimizer
    from vitxtgqa_tpu_torch.training.step import step_generators, train_step

    mesh, opts = _mesh(case, world, case["batch"]["text"].shape[0])
    model = T2S(case["cfg"], case["nf"], bos_idx=2, opts=opts)
    model.load_state_dict(TP.local_state(model, {k: torch.from_numpy(v)
                                                 for k, v in case["state"].items()}))
    opt = build_optimizer(model, case["oa"], case["tp"], case["cfg"], group=mesh.data)
    d, n = mesh.coords["data"], mesh.shape["data"]
    batch = _tensors({k: v[d::n] for k, v in case["batch"].items()})
    noise = RankRows(lambda shape, kind: case["noise"][shape], d, n)
    names = [k for k, _ in model.named_parameters()]
    applied = {}
    apply = opt.apply

    def keep_and_apply():
        applied.update({k: m.grad.detach().clone() for k, (_, m) in zip(names, opt.pairs)})
        apply()

    opt.apply = keep_and_apply
    drop = step_generators(case["drop_seed"], 1, torch.device("cpu"), mesh.data)[0]
    r = train_step(model, Losses(case["losses"], group=mesh.data), opt, batch, (drop, noise))
    TP.check_replicas(list(model.parameters()), "the parameters after the step", mesh.model)
    own = {k: v.detach().clone() for k, v in model.state_dict().items()}
    if case.get("ckpt"):
        state = {"model": TP.whole_state(model, own), "optimizer": opt.state_dict()}
        Checkpoint(case["ckpt"]).finalize(state if rank == 0 else None, 1)
    return {"loss": float(r["loss"]), "norm": float(r["grad_norm"]), "applied": r["applied"],
            "grads": _whole(model, applied), "coords": mesh.coords,
            "own": {k: v.numpy() for k, v in own.items()}, "state": _whole(model, own)}


def run_eval(case, rank, world):
    from vitxtgqa_tpu_torch.models.t2s import T2S
    from vitxtgqa_tpu_torch.parallel import tensor_parallel as TP

    _, opts = _mesh(case, world)
    model = T2S(case["cfg"], case["nf"], bos_idx=2, inference_only=False, opts=opts)
    model.load_state_dict(TP.local_state(model, {k: torch.from_numpy(v)
                                                 for k, v in case["state"].items()}))
    noise = tuple(torch.from_numpy(n) for n in case["noise"])
    with torch.no_grad():
        out = model(_tensors(case["batch"]), noise)
    return {k: out[k].numpy() for k in ("pos_scores", "ref_scores", "neg_scores")}


def run_cli(case, rank, world):
    from vitxtgqa_tpu_torch.run import run
    from vitxtgqa_tpu_torch.training.trainer import BaseTrainer

    own = {}
    state = BaseTrainer._state

    def spy(self):
        """The rank's own shards each time a snapshot's state is taken (the
        last: ckpt/final's)."""
        own["model"] = {k: v.detach().numpy().copy() for k, v in self.model.state_dict().items()}
        own["moments"] = {i: {k: v.numpy().copy() for k, v in st.items() if v.dim() > 0}
                          for i, st in self.optimizer.inner.state_dict()["state"].items()}
        return state(self)

    BaseTrainer._state = spy
    try:
        trainer = run(case["argv"])
    finally:
        BaseTrainer._state = state
    final = os.path.join(trainer.logger.save_dir, "ckpt", "final", "state.pt")
    saved = torch.load(final) if rank == 0 and os.path.exists(final) else None
    return {"series": _series(trainer.meter),
            "reports": _reports(trainer.logger.save_dir) if rank == 0 else {},
            "mesh": trainer.mesh.shape, "kv_cache_int8": trainer.opts.kv_cache_int8,
            "saved": None if saved is None else {
                "model": {k: v.numpy() for k, v in saved["model"].items()},
                "moments": {i: {k: v.numpy() for k, v in st.items() if v.dim() > 0}
                            for i, st in saved["optimizer"]["adam"]["state"].items()}},
            "own": own["model"], "own_moments": own["moments"],
            "sharded": {i: getattr(p, "tp_dim", None)
                        for i, (p, _) in enumerate(trainer.optimizer.pairs)}}


def run_launches(case, rank, world):
    import importlib

    from vitxtgqa_tpu_torch.losses import Losses
    from vitxtgqa_tpu_torch.models.t2s import T2S
    from vitxtgqa_tpu_torch.parallel import tensor_parallel as TP
    from vitxtgqa_tpu_torch.training.optim import build_optimizer
    from vitxtgqa_tpu_torch.training.step import train_step

    mesh, opts = _mesh(case, world)
    counts = {}

    def counting(fn, kernel):
        def call(*a, **kw):
            counts[kernel] = counts.get(kernel, 0) + 1
            return fn(*a, **kw)
        return call

    out = {}
    for train in (False, True):
        model = T2S(case["cfg"], case["nf"], bos_idx=2, inference_only=False, opts=opts)
        model.load_state_dict(TP.local_state(model, {k: torch.from_numpy(v)
                                                     for k, v in case["state"].items()}))
        batch = _tensors(case["batch"])
        noise = lambda shape, kind: case["noise"][shape]
        originals = []
        counts.clear()
        for mod_name, fn_name, kernel in case["plain_of"]:
            mod = importlib.import_module(mod_name)
            originals.append((mod, fn_name, getattr(mod, fn_name)))
            setattr(mod, fn_name, counting(getattr(mod, fn_name), kernel))
        try:
            if train:
                opt = build_optimizer(model, model_config=case["cfg"])
                train_step(model, Losses(case["losses"]), opt, batch,
                           (torch.Generator().manual_seed(0), noise))
            else:
                with torch.no_grad():
                    model(batch, noise)
        finally:
            for mod, fn_name, fn in originals:
                setattr(mod, fn_name, fn)
        out["train" if train else "eval"] = {"rows": batch["text"].shape[0],
                                             "counts": dict(counts), "coords": mesh.coords}
    return out


def vocab_modules(case, tp):
    """The word embeddings (BertEmbeddings), the classifier with its table
    feeding the decoder slots (FixedVocabClassifier, PrevPredEmbeddings)
    and the OCR pointer (OcrPtrNet) of ``case``'s whole weights, each
    holding ``tp``'s shards where the group divides it (None: whole), one
    pass and its backward with the case's cotangents: the outputs, the
    inputs' gradients, every parameter's gradient made whole, the names
    held as shards, and the pointer's scores again through the cached
    decode (the keys once, a step a row)."""
    from torch import nn

    from vitxtgqa_tpu_torch.models.common import (BertEmbeddings, FixedVocabClassifier,
                                                  OcrPtrNet, PrevPredEmbeddings,
                                                  TransformerConfig)
    from vitxtgqa_tpu_torch.parallel import collectives as C
    from vitxtgqa_tpu_torch.parallel import tensor_parallel as TP

    cfg = TransformerConfig(**case["cfg"])
    heads = nn.ModuleDict({"emb": BertEmbeddings(cfg, tp),
                           "cls": FixedVocabClassifier(case["answers"], cfg.hidden_size, tp=tp),
                           "ptr": OcrPtrNet(cfg.hidden_size, case["qk"], tp=tp)})
    heads["ppe"] = PrevPredEmbeddings(cfg, heads["cls"].vocab)
    dims = TP.sharded_dims(heads)
    state = {k: torch.from_numpy(v) for k, v in case["state"].items()}
    heads.load_state_dict(state if tp is None else TP.shard_state(state, dims, tp.rank, tp.size))
    t = {k: torch.from_numpy(case[k]) for k in ("x", "ocr", "keys", "ocr_mask")}
    leaves = {k: t[k].clone().requires_grad_() for k in ("x", "ocr", "keys")}
    ids, prev = torch.from_numpy(case["ids"]), torch.from_numpy(case["prev"])
    out = {"emb": heads["emb"](ids), "cls": heads["cls"](leaves["x"]),
           "ptr": heads["ptr"](leaves["x"], leaves["keys"], t["ocr_mask"])}
    ans, ocr = heads["ppe"].tables(heads["cls"].table(), leaves["ocr"], float32_answers=True)
    out["ppe"] = heads["ppe"].embed(ans, ocr, prev)
    total = sum((o * torch.from_numpy(case["g_" + k])).sum() for k, o in out.items())
    total.backward()
    with torch.no_grad():
        k = heads["ptr"].keys(t["keys"])
        cached = torch.cat([heads["ptr"].scores_from_keys(t["x"][:, i:i + 1], k, t["ocr_mask"])
                            for i in range(t["x"].shape[1])], dim=1)
    grads = {}
    for name, p in heads.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        grads[name] = (C.all_gather(g, tp.group, dim=dims[name]) if name in dims else g).numpy()
    return {"out": {k: v.detach().numpy() for k, v in out.items()}, "cached": cached.numpy(),
            "dx": {k: v.grad.numpy() for k, v in leaves.items()}, "grads": grads,
            "sharded": dims}


def run_vocab(case, rank, world):
    from vitxtgqa_tpu_torch.parallel.mesh import build_mesh

    return {n: vocab_modules(case, build_mesh(world // n, n).model) for n in case["sizes"]}


RUNNERS = {"encoder": run_encoder, "step": run_step, "eval": run_eval, "run": run_cli,
           "launches": run_launches, "vocab": run_vocab}


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
    return _start(cases, directory, world=world, timeout=timeout, module="tests.torch_tp_ranks")


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
