"""CLI argument parser of the port (a copy of vitxtgqa_tpu/core/flags.py;
reference: pythia/utils/flags.py:14-244).

Same public surface: --config --model --datasets --run_type --seed
--resume_file --batch_size ... plus trailing dotted `opts` overrides.
"""

from __future__ import annotations

import argparse


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="vitxtgqa_tpu_torch: grounded TextVideoQA on PyTorch and CUDA"
    )
    parser.add_argument("--config", type=str, default=None, help="experiment yaml")
    parser.add_argument("--tasks", type=str, default=None, help="task list (compat)")
    parser.add_argument("--datasets", type=str, default=None, help="comma list")
    parser.add_argument("--model", type=str, default=None, help="registered model key")
    parser.add_argument("--run_type", type=str, default=None, help="train/val/test/+inference")
    parser.add_argument("--seed", type=int, default=None, help="-1 for random")
    parser.add_argument("--experiment_name", type=str, default=None)
    parser.add_argument("--max_iterations", type=int, default=None)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--num_workers", type=int, default=None)
    parser.add_argument("--log_interval", type=int, default=None)
    parser.add_argument("--snapshot_interval", type=int, default=None)
    parser.add_argument("--save_dir", type=str, default=None)
    parser.add_argument("--log_dir", type=str, default=None)
    parser.add_argument("--logger_level", type=str, default=None)
    parser.add_argument("--resume", type=bool, default=None)
    parser.add_argument("--resume_file", type=str, default=None)
    parser.add_argument("--evalai_inference", type=bool, default=None)
    parser.add_argument("--data_root_dir", type=str, default=None)
    parser.add_argument("--config_override", type=str, default=None, help="JSON blob")
    parser.add_argument(
        "opts",
        nargs=argparse.REMAINDER,
        action=_OptsAction,
        help="dotted-path overrides: key value [key value ...]",
    )
    return parser


class _OptsAction(argparse.Action):
    """REMAINDER swallows EVERYTHING after the first dotted token — a
    `--resume_file` placed after an override is silently eaten and the
    trainer starts fresh (this bit twice: the round-4 mode-diff harness
    and the round-5 dryrun ckpt section, whose resume arm trained from
    scratch while its iteration assert passed vacuously).  Fail loudly
    instead: flag-looking tokens are never valid dotted overrides."""

    def __call__(self, parser, namespace, values, option_string=None):
        bad = [v for v in values if v.startswith("--")]
        if bad:
            parser.error(
                f"flags must precede dotted opts; found {bad} inside the "
                "opts remainder (argparse swallows flags after the first "
                "override token)"
            )
        setattr(namespace, self.dest, values)
