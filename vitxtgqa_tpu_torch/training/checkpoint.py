"""Checkpointing: model, optimizer and data-generator state as torch files,
with run metadata in JSON.

Counterpart of vitxtgqa_tpu/training/checkpoint.py (reference:
pythia/utils/checkpoint.py:15-251 — periodic snapshots, a metric-keyed best,
the final model, git provenance, resume with the optimizer state).  Layout:

  ckpt/models/model_<it>/   periodic snapshots
  ckpt/best/                the best monitored-metric snapshot
  ckpt/final/               the end-of-training snapshot

Each snapshot directory holds ``state.pt`` ({"model": state_dict,
"optimizer": Optimizer.state_dict(), "generator": the train dataset's host
generator state or None}) and ``meta.json`` (iteration, epoch, the batch
index in the epoch, the early-stopping fields, the world size, git fields
and the config).  On a data axis every rank's generators hold the one
state that ``generator`` keeps: with no worker processes each rank draws
the whole global batch in order (data/loader.py), with them the draws are
seeded by position, so a snapshot resumes at any world size.
A snapshot is written into a sibling directory and renamed into place, so
a reader never sees half of one; ``best`` hard-links the files of the
snapshot it copies where the file system allows.  Saving is synchronous.

On the ranks of a data axis rank 0 alone writes (the others pass no state)
and every rank waits at a barrier after a save, so that each can then
restore the same files.  Under tensor parallelism the state is whole:
the trainer gathers the shards (the split layers', the vocabulary-parallel
tables') and their optimizer moments over the model group before rank 0
writes, and a load takes each rank's
shards of it (parallel/tensor_parallel.local_state,
training/optim.Optimizer.load_state_dict), so a checkpoint of a model-2
run loads in one process and the reverse.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
from typing import Any, Dict, Optional

import torch

from vitxtgqa_tpu_torch.parallel.collectives import is_main_process, process_count, synchronize

STATE, META = "state.pt", "meta.json"


def _git_metadata() -> Dict[str, str]:
    """Best-effort VCS provenance of the working directory (reference:
    checkpoint.py:184-204)."""
    def run(*args):
        try:
            return subprocess.run(
                ["git", *args], capture_output=True, text=True, timeout=10,
            ).stdout.strip()
        except Exception:
            return ""

    return {
        "git/branch": run("rev-parse", "--abbrev-ref", "HEAD"),
        "git/commit_hash": run("rev-parse", "HEAD"),
        "git/commit_author": run("log", "-1", "--format=%an"),
        "git/commit_message": run("log", "-1", "--format=%s"),
        "git/diff": run("diff", "--no-prefix"),
    }


def unwrap_state_dict(blob: Any) -> Dict[str, torch.Tensor]:
    """A model state dict from a torch checkpoint blob: unwraps the
    reference's {"model": state_dict, ...} and DataParallel ``module.``
    prefixes (as vitxtgqa_tpu/utils/torch_convert.load_state_dict does)."""
    if isinstance(blob, dict) and isinstance(blob.get("model"), dict):
        blob = blob["model"]
    return {(k[len("module."):] if k.startswith("module.") else k): v for k, v in blob.items()}


class Checkpoint:
    """Save and restore training state under save_dir/ckpt/."""

    def __init__(self, save_dir: str, config: Any = None):
        self.root = os.path.join(save_dir, "ckpt")
        if is_main_process():
            os.makedirs(os.path.join(self.root, "models"), exist_ok=True)
        self.config = config

    # -- paths -------------------------------------------------------------
    def _model_path(self, iteration: int) -> str:
        return os.path.join(self.root, "models", f"model_{iteration}")

    @property
    def best_path(self) -> str:
        return os.path.join(self.root, "best")

    @property
    def final_path(self) -> str:
        return os.path.join(self.root, "final")

    # -- save --------------------------------------------------------------
    def _meta(self, iteration: int, best_iteration: int, best_metric_value: Optional[float],
              epoch: int, epoch_batch: int) -> Dict[str, Any]:
        meta = {
            "iteration": iteration,
            "epoch": epoch,
            "epoch_batch": epoch_batch,
            "best_iteration": best_iteration,
            "best_metric_value": best_metric_value,
            "world_size": process_count(),
            **_git_metadata(),
        }
        if self.config is not None:
            meta["config"] = self.config.to_dict()
        return meta

    def _write(self, path: str, state: Optional[Dict[str, Any]], meta: Dict[str, Any],
               link_from: Optional[str] = None) -> None:
        """Write ``state`` (or hard-link ``link_from``'s state file) and
        ``meta`` into ``path``."""
        tmp = path.rstrip("/") + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        if link_from is not None:
            src = os.path.join(link_from, STATE)
            try:
                os.link(src, os.path.join(tmp, STATE))
            except OSError:
                shutil.copyfile(src, os.path.join(tmp, STATE))
        else:
            torch.save(state, os.path.join(tmp, STATE))
        with open(os.path.join(tmp, META), "w") as f:
            json.dump(meta, f, indent=1, default=str)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.replace(tmp, path)

    def save(self, state: Optional[Dict[str, Any]], iteration: int, update_best: bool = False,
             best_iteration: int = 0, best_metric_value: Optional[float] = None,
             epoch: int = 0, epoch_batch: int = 0) -> None:
        """Write the snapshot of ``iteration`` (and ``best``) on rank 0, then
        wait for every rank."""
        if is_main_process():
            path = self._model_path(iteration)
            meta = self._meta(iteration, best_iteration, best_metric_value, epoch, epoch_batch)
            self._write(path, state, meta)
            if update_best:
                self._write(self.best_path, None, meta, link_from=path)
        synchronize("checkpoint")

    def finalize(self, state: Optional[Dict[str, Any]], iteration: int, epoch: int = 0,
                 epoch_batch: int = 0) -> None:
        if is_main_process():
            self._write(self.final_path, state,
                        self._meta(iteration, iteration, None, epoch, epoch_batch))
        synchronize("checkpoint")

    # -- restore -----------------------------------------------------------
    def load(self, path: Optional[str] = None, map_location: Any = "cpu") -> Dict[str, Any]:
        """A snapshot directory (default: best/) as written by ``save``, or
        a torch file holding a model state dict, bare or in the reference's
        {"model": ...} blob with ``module.`` prefixes: {"model": state_dict,
        "optimizer": ... or absent, "generator": ... or absent}."""
        path = path or self.best_path
        if os.path.isdir(path):
            return torch.load(os.path.join(path, STATE), map_location=map_location)
        return {"model": unwrap_state_dict(torch.load(path, map_location=map_location))}

    def load_meta(self, path: Optional[str] = None) -> Dict[str, Any]:
        with open(os.path.join(path or self.best_path, META)) as f:
            return json.load(f)
