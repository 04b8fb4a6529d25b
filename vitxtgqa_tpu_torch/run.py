"""CLI entry point of the port (the counterpart of tools/run.py; reference:
tools/run.py:67-88).

    python -m vitxtgqa_tpu_torch.run --config configs/t2s_abinet.yml --model t2s \
        --datasets vtextgqa --run_type train [opts...]
    python -m vitxtgqa_tpu_torch.run --config configs/pythia_vqa2.yml --model pythia \
        --datasets vqa2 [opts...]
    python -m vitxtgqa_tpu_torch.run --config configs/lorra_textvqa.yml --model lorra \
        --datasets textvqa [opts...]

It runs on the CUDA card unless the config says
``training_parameters.device=cpu`` (then the plain versions run on the
CPU); a machine without CUDA and no such option raises.

Data parallelism: ``VITXTGQA_DISTRIBUTED=1`` or
``training_parameters.distributed_init: true`` joins the world that
``torchrun`` describes (parallel/mesh.init_world: NCCL where every rank has
its own card, gloo where ranks share one or run on the CPU) and leaves it
at the end; the trainer then runs the config's mesh ``data`` axis over the
ranks (training/trainer.py).  Without a torchrun environment the switch
raises; it never falls back to one process:

    python -m torch.distributed.run --nproc_per_node N -m vitxtgqa_tpu_torch.run \
        --config ... training_parameters.distributed_init=True
"""

from __future__ import annotations

import importlib
import os

import torch
import torch.distributed as dist

from vitxtgqa_tpu_torch.core.config import build_config
from vitxtgqa_tpu_torch.core.flags import get_parser
from vitxtgqa_tpu_torch.core.registry import registry
from vitxtgqa_tpu_torch.parallel.mesh import close_world, init_world

# every module that registers a processor, builder, metric, model or trainer
MANIFEST = (
    "vitxtgqa_tpu_torch.data.processors",
    "vitxtgqa_tpu_torch.data.builders",
    "vitxtgqa_tpu_torch.metrics.metrics",
    "vitxtgqa_tpu_torch.models.t2s",
    "vitxtgqa_tpu_torch.models.t2s_ablations",
    "vitxtgqa_tpu_torch.models.m4c",
    "vitxtgqa_tpu_torch.models.t5vitevqa",
    "vitxtgqa_tpu_torch.models.gt_box",
    "vitxtgqa_tpu_torch.models.transtr",
    "vitxtgqa_tpu_torch.models.mist",
    "vitxtgqa_tpu_torch.models.legacy_vqa",
    "vitxtgqa_tpu_torch.training.trainer",
)


def setup_imports() -> None:
    """Import the registering modules (the JAX package's explicit manifest,
    vitxtgqa_tpu.setup_imports, for the port's registry)."""
    for mod in MANIFEST:
        importlib.import_module(mod)


def run(argv=None):
    setup_imports()
    args = get_parser().parse_args(argv)
    if not args.config:
        raise SystemExit("--config is required")
    cfg = build_config(args.config, opts=args.opts, args=args,
                       config_override=args.config_override)
    registry.register("config", cfg)

    tp = cfg.training_parameters
    joined = False
    if os.environ.get("VITXTGQA_DISTRIBUTED", "") == "1" or bool(
            getattr(tp, "distributed_init", False)):
        if not dist.is_initialized():
            cuda = str(getattr(tp, "device", "auto") or "auto") != "cpu"
            init_world(cuda and torch.cuda.is_available())
            joined = True
    try:
        trainer_cls = registry.get_trainer_class(getattr(tp, "trainer", "base_trainer"))
        trainer = trainer_cls(cfg)
        trainer.load()
        try:
            trainer.train()
        except Exception:
            # log the traceback to the run's log file before re-raising
            # (reference: tools/run.py:75-84)
            import traceback

            trainer.logger.write(traceback.format_exc(), "error")
            raise
        finally:
            trainer.close()
    finally:
        if joined:
            close_world()
    return trainer


if __name__ == "__main__":
    run()
