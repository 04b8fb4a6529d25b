"""The port's deterministic mode, ``training_parameters.deterministic``:
run()'s scope of PyTorch's deterministic algorithms, and the flash
backward's ordered form that the mode selects on the card
(ops/flash_attention.py bwd_ordered / bwd_parts and the scratch of
csrc/flash_bwd.cuh: dq summed over the key blocks in a fixed order).  CPU;
the ordered kernel itself is held to its plain version on the card
(chip_smoke.py check_ordered_bwd)."""

import os

import pytest
import torch

from tests.test_torch_runtime import TRAIN3, _cli, fixroot, tiny_opts  # noqa: F401
from vitxtgqa_tpu_torch.ops import flash_attention as FA
from vitxtgqa_tpu_torch.run import deterministic_algorithms, run

CUBLAS = "CUBLAS_WORKSPACE_CONFIG"


@pytest.mark.parametrize("preset", [None, ":16:8"])
def test_the_mode_is_scoped_to_its_block(monkeypatch, preset):
    """On: the deterministic algorithms and a fixed cuBLAS workspace (the
    environment's own kept), both as before after the block; off: nothing
    changes."""
    if preset is None:
        monkeypatch.delenv(CUBLAS, raising=False)
    else:
        monkeypatch.setenv(CUBLAS, preset)
    assert not torch.are_deterministic_algorithms_enabled()
    with deterministic_algorithms(False):
        assert not torch.are_deterministic_algorithms_enabled()
        assert os.environ.get(CUBLAS) == preset
    with deterministic_algorithms(True):
        assert torch.are_deterministic_algorithms_enabled() and FA.bwd_ordered()
        assert os.environ[CUBLAS] == (preset or ":4096:8")
    assert not torch.are_deterministic_algorithms_enabled() and not FA.bwd_ordered()
    assert os.environ.get(CUBLAS) == preset


@pytest.mark.parametrize("lk, ordered, parts", [
    (1152, False, 1), (1152, True, 18), (576, True, 9), (100, True, 2), (64, True, 1)])
def test_the_ordered_form_takes_a_slice_a_key_block(lk, ordered, parts):
    """One dq slice of the scratch a block of 64 keys in the ordered form,
    else one; the scratch: per (batch, head) and query row padded to 64,
    64 floats a slice, D_i and the base-2 lse."""
    assert FA.bwd_parts(lk, ordered) == parts
    b, h, lq = 2, 3, 100
    scratch = FA._bwd_scratch(b, h, lq, lk, ordered, "cpu")
    assert scratch.dtype == torch.float32
    assert scratch.numel() == b * h * 128 * (64 * parts + 2)


def test_run_takes_the_mode_from_its_config(repo_root, fixroot, tmp_path, monkeypatch):
    """``training_parameters.deterministic=True``: the trainer trains under
    the deterministic algorithms, and run() leaves them as it found them;
    two such runs give the same losses."""
    from vitxtgqa_tpu_torch.training.trainer import BaseTrainer

    seen = []
    train = BaseTrainer.train

    def spy(self):
        seen.append(torch.are_deterministic_algorithms_enabled())
        return train(self)

    monkeypatch.setattr(BaseTrainer, "train", spy)
    losses = []
    for i in range(2):
        trainer = run(_cli(repo_root) + tiny_opts(fixroot, tmp_path / f"run{i}", dropout=False,
                                                  deterministic=True, **TRAIN3))
        losses.append(list(trainer.meter["train/total_loss"].series))
        assert not torch.are_deterministic_algorithms_enabled()
    trainer = run(_cli(repo_root) + tiny_opts(fixroot, tmp_path / "off", dropout=False, **TRAIN3))
    assert seen == [True, True, False]
    assert len(losses[0]) == TRAIN3["max_iterations"] and losses[0] == losses[1]
