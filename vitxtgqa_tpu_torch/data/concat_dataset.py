"""Concatenation of datasets with attribute and method fan-out.

The port's copy of vitxtgqa_tpu/data/concat_dataset.py (reference:
pythia/datasets/concat_dataset.py:8-46): indexes span the child datasets
in order; an attribute lookup falls through to the first child; a method
call fans out to every child, the first non-None return winning (the
reference's early return).  A legacy builder returns one when a split has
several imdb files.
"""

from __future__ import annotations

import bisect
import types
from typing import Any, List, Sequence


class ConcatDataset:
    def __init__(self, datasets: Sequence[Any]):
        assert len(datasets) > 0, "datasets should not be empty"
        object.__setattr__(self, "datasets", list(datasets))
        sizes: List[int] = []
        total = 0
        for d in self.datasets:
            total += len(d)
            sizes.append(total)
        object.__setattr__(self, "cumulative_sizes", sizes)

    def __len__(self) -> int:
        return self.cumulative_sizes[-1]

    def _locate(self, idx: int):
        if idx < 0:
            idx += len(self)
        if idx < 0 or idx >= len(self):
            raise IndexError(idx)
        ds_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        prev = self.cumulative_sizes[ds_idx - 1] if ds_idx > 0 else 0
        return ds_idx, idx - prev

    def __getitem__(self, idx: int):
        ds_idx, local = self._locate(idx)
        return self.datasets[ds_idx][local]

    def get_item(self, idx: int):
        ds_idx, local = self._locate(idx)
        return self.datasets[ds_idx].get_item(local)

    def __getattr__(self, name: str):
        # only called when normal lookup fails -> fan out to the children;
        # dunder and own-field lookups (pickle's, before the fields are
        # restored) fail plainly
        if name.startswith("__") or name in ("datasets", "cumulative_sizes"):
            raise AttributeError(name)
        first = self.datasets[0]
        if hasattr(first, name):
            attr = getattr(first, name)
            if isinstance(attr, types.MethodType):
                def fan_out(*args, **kwargs):
                    for dataset in self.datasets:
                        value = getattr(dataset, name)(*args, **kwargs)
                        if value is not None:
                            # reference quirk: the first non-None return
                            # short-circuits (concat_dataset.py:33-38)
                            return value
                    return None

                return fan_out
            return attr
        raise AttributeError(name)
