"""Dataset builders (registry-keyed, config-driven).

The port's copy of the vtextgqa builder of vitxtgqa_tpu/data/builders.py
(reference: pythia/datasets/base_dataset_builder.py:41-122,
videoqa/vtextgqa/builder.py:7-12); the gt_box and legacy image-VQA
builders come with their models (ROADMAP.md queue 1 item 4).
"""

from __future__ import annotations

import random
from typing import Any, Optional

from vitxtgqa_tpu_torch.core.registry import registry
from vitxtgqa_tpu_torch.data.dataset import VTextGQADataset


@registry.register_builder("vtextgqa")
class VTextGQABuilder:
    dataset_name = "vtextgqa"
    dataset_class = VTextGQADataset

    def build(self, dataset_type: str, config: Any) -> None:
        """One-time data preparation; nothing to download in this framework."""

    def load(
        self, dataset_type: str, config: Any, seed: Optional[int] = None
    ) -> VTextGQADataset:
        rng = random.Random(seed)
        return self.dataset_class(dataset_type, config, rng=rng)
