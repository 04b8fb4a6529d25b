"""Dataset builders (registry-keyed, config-driven).

The port's copy of vitxtgqa_tpu/data/builders.py (reference:
pythia/datasets/base_dataset_builder.py:41-122,
videoqa/vtextgqa/builder.py:7-12, videoqa/gt_box_clipocr/builder.py:7,
vqa/vqa2/builder.py:18-89, vizwiz/builder.py:7-16, textvqa/builder.py:7-12,
vqa2/ocr_builder.py:7-12): vtextgqa, gt_box / gt_box_clipocr, and the
legacy image-VQA builders vqa2, vizwiz, textvqa and vqa2_ocr, which load
one dataset per imdb file of the split and a ConcatDataset of them where
there are several.  ``load`` takes ``reference_compat``
(training_parameters.reference_compat), which only the GT-box dataset
reads.
"""

from __future__ import annotations

import random
from typing import Any, Optional

from vitxtgqa_tpu_torch.core.registry import registry
from vitxtgqa_tpu_torch.data.dataset import VTextGQADataset
from vitxtgqa_tpu_torch.data.concat_dataset import ConcatDataset
from vitxtgqa_tpu_torch.data.gt_box_dataset import GTBoxDataset
from vitxtgqa_tpu_torch.data.legacy_vqa_datasets import (
    TextVQADataset,
    VizWizDataset,
    VQA2Dataset,
    VQA2OCRDataset,
)


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


class _LegacyVQABuilderBase:
    """The legacy image-VQA builders' lifecycle (reference:
    vqa2/builder.py:18-89): one dataset per imdb file, concatenated when
    several; ``update_registry_for_model`` rides on the dataset
    (vqa2/builder.py:40-48: the trainer calls it there)."""

    dataset_name = "vqa2"
    dataset_class = VQA2Dataset

    def build(self, dataset_type: str, config: Any) -> None:
        """reference vqa2/builder.py:36-38: nothing to download."""

    def load(self, dataset_type: str, config: Any, seed: Optional[int] = None,
             reference_compat: bool = False):
        imdb_files = config.imdb_files
        if dataset_type not in imdb_files:
            raise ValueError(f"no imdb for split {dataset_type}")
        rng = random.Random(seed)
        datasets = [self.dataset_class(dataset_type, config, imdb_file_index=i, rng=rng)
                    for i in range(len(imdb_files[dataset_type]))]
        return datasets[0] if len(datasets) == 1 else ConcatDataset(datasets)


@registry.register_builder("vqa2")
class VQA2Builder(_LegacyVQABuilderBase):
    dataset_name = "vqa2"
    dataset_class = VQA2Dataset


@registry.register_builder("vizwiz")
class VizWizBuilder(_LegacyVQABuilderBase):
    """reference vizwiz/builder.py:7-16."""

    dataset_name = "vizwiz"
    dataset_class = VizWizDataset


@registry.register_builder("textvqa")
class TextVQABuilder(_LegacyVQABuilderBase):
    """reference textvqa/builder.py:7-12."""

    dataset_name = "textvqa"
    dataset_class = TextVQADataset


@registry.register_builder("vqa2_ocr")
class VQA2OCRBuilder(_LegacyVQABuilderBase):
    """reference vqa2/ocr_builder.py:7-12."""

    dataset_name = "vqa2_ocr"
    dataset_class = VQA2OCRDataset
