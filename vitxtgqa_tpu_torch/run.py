"""CLI entry point of the port (the counterpart of tools/run.py; reference:
tools/run.py:67-88).

    python -m vitxtgqa_tpu_torch.run --config configs/t2s_abinet.yml --model t2s \
        --datasets vtextgqa --run_type train [opts...]

It runs on the CUDA card unless the config says
``training_parameters.device=cpu`` (then the plain versions run on the
CPU); a machine without CUDA and no such option raises.  One process, one
device: multi-process runs (``VITXTGQA_DISTRIBUTED=1``,
``training_parameters.distributed_init: true``) raise here, a mesh axis
above 1 in the trainer (``options_from_config``; ROADMAP.md queue 1 item 5).
"""

from __future__ import annotations

import importlib
import os

from vitxtgqa_tpu_torch.core.config import build_config
from vitxtgqa_tpu_torch.core.flags import get_parser
from vitxtgqa_tpu_torch.core.registry import registry

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
    if os.environ.get("VITXTGQA_DISTRIBUTED", "") == "1" or bool(
            getattr(tp, "distributed_init", False)):
        raise NotImplementedError(
            "multi-process runs (VITXTGQA_DISTRIBUTED=1 / training_parameters."
            "distributed_init) are ROADMAP.md queue 1 item 5; the port runs one process")

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
    return trainer


if __name__ == "__main__":
    run()
