"""Multi-dataset training: proportional or equal sampling across datasets.

The port's copy of vitxtgqa_tpu/data/multi_dataset.py (reference:
pythia/datasets/multi_dataset.py:19-305).  The reference has rank 0 choose
the next dataset and broadcast the choice; here, as in the JAX package, the
schedule is a function of (seed, step) alone, the same on every rank with
no collective: on a data axis each rank's loaders yield its rows of every
global batch (data/loader.py), so at each step every rank draws the same
dataset and takes its own rows of that dataset's global batch.

``iter_from(step)`` resumes exactly: each dataset's stream starts at the
epoch and batch that the schedule's earlier steps consumed of it (the JAX
``iter_from`` restarts every dataset's stream at its first batch).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List

import numpy as np

from vitxtgqa_tpu_torch.data.loader import DataLoader, infinite_batches


class MultiDataset:
    def __init__(self, loaders: Dict[str, DataLoader], proportional: bool = True,
                 seed: int = 0):
        if not loaders:
            raise ValueError("MultiDataset needs at least one loader")
        self.names: List[str] = sorted(loaders)
        self.loaders = loaders
        sizes = np.array([len(loaders[n].dataset) for n in self.names], dtype=np.float64)
        if proportional:
            self.probs = sizes / sizes.sum()
        else:
            self.probs = np.full(len(self.names), 1.0 / len(self.names))
        self.seed = seed

    def dataset_for_step(self, step: int) -> str:
        """The dataset of a global step, the same on every rank."""
        rng = np.random.default_rng(self.seed * 1_000_003 + step)
        return self.names[rng.choice(len(self.names), p=self.probs)]

    def iter_from(self, step: int) -> Iterator[Dict[str, Any]]:
        """Endless batches from global step ``step`` on, each dataset's
        stream started where steps 0 .. step - 1 left it."""
        taken = {n: 0 for n in self.names}
        for s in range(step):
            taken[self.dataset_for_step(s)] += 1
        streams = {}
        for n in self.names:
            per_epoch = len(self.loaders[n])
            if per_epoch == 0:
                raise ValueError(f"dataset {n!r} has no full batch")
            streams[n] = infinite_batches(self.loaders[n], start_epoch=taken[n] // per_epoch,
                                          start_batch=taken[n] % per_epoch)
        while True:
            yield next(streams[self.dataset_for_step(step)])
            step += 1

    def __iter__(self):
        return self.iter_from(0)
