"""Dataset builders (registry-keyed, config-driven).

The port's copy of the vtextgqa and gt_box builders of
vitxtgqa_tpu/data/builders.py (reference:
pythia/datasets/base_dataset_builder.py:41-122,
videoqa/vtextgqa/builder.py:7-12, videoqa/gt_box_clipocr/builder.py:7); the
legacy image-VQA builders come with their models (ROADMAP.md queue 1 item
4).  ``load`` takes ``reference_compat`` (training_parameters.
reference_compat), which only the GT-box dataset reads.
"""

from __future__ import annotations

import random
from typing import Any, Optional

from vitxtgqa_tpu_torch.core.registry import registry
from vitxtgqa_tpu_torch.data.dataset import VTextGQADataset
from vitxtgqa_tpu_torch.data.gt_box_dataset import GTBoxDataset


@registry.register_builder("vtextgqa")
class VTextGQABuilder:
    dataset_name = "vtextgqa"
    dataset_class = VTextGQADataset

    def build(self, dataset_type: str, config: Any) -> None:
        """One-time data preparation; nothing to download in this framework."""

    def load(
        self, dataset_type: str, config: Any, seed: Optional[int] = None,
        reference_compat: bool = False,
    ) -> VTextGQADataset:
        rng = random.Random(seed)
        return self.dataset_class(dataset_type, config, rng=rng)


@registry.register_builder("gt_box")
@registry.register_builder("gt_box_clipocr")
class GTBoxBuilder(VTextGQABuilder):
    """Oracle variant: exposes GT grounding annotations to the model
    (reference: pythia/datasets/videoqa/gt_box_clipocr/)."""

    dataset_name = "gt_box_clipocr"

    def load(self, dataset_type, config, seed=None, reference_compat=False):
        return GTBoxDataset(dataset_type, config, reference_compat=reference_compat,
                            rng=random.Random(seed))
