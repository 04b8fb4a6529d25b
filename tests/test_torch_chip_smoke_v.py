"""chip_smoke.py's slice v (every head width the attention kernels take,
#5's long caches, T2S at MiniLM-L12-H384's widths, ViT-H/14) rehearsed on
the CPU: its launch derivation against the calls of a tiny forward and
training step at 12 heads of 32, the ViT's at 16 heads of 80, and its
kernel checks' dry run with every planted fault outside the kernels'
tolerances.

On CPU tensors each wrapper runs its plain version, so a call of one
(counted here) stands for a launch on the card, and a planted fault is held
against the twin the kernel is held against there.
"""

import types

import numpy as np
import pytest
import torch

import chip_smoke as CS
from tests.test_torch_chip_smoke import FRAMES, OCR_PF
from tests.test_torch_chip_smoke_u import CASES, _batch, _counting
from tests.torch_helpers import cpu_options, one_torch_thread  # noqa: F401
from vitxtgqa_tpu.utils.synthetic import tiny_model_config
from vitxtgqa_tpu_torch.losses import Losses
from vitxtgqa_tpu_torch.models import common as TC
from vitxtgqa_tpu_torch.models.t2s import T2S, t2s_minilm_config

# MiniLM's heads: 12 of 32 at hidden 384 (FFN 768 in the tiny config)
HIDDEN, HEADS = 384, 12


def _config():
    return tiny_model_config(hidden=HIDDEN, heads=HEADS, frames=FRAMES, ocr_per_frame=OCR_PF)


@pytest.mark.parametrize("case", sorted(CASES))
def test_slice_v_launches_count_a_forward_at_heads_of_32(case, monkeypatch):
    """chip_smoke.expected_launches (slice v(ii)'s serving and full-eval
    counts) against the calls of a forward at 12 heads of 32, the
    fused-decode gate opened as on a CUDA tensor: the gates read no head
    width, so every kernel of slice a-h's paths is reached at D 32."""
    b, opts, full_eval = CASES[case]
    cfg, nf = _config(), 32 + FRAMES * OCR_PF
    model = T2S(cfg, nf, opts=cpu_options(**opts), inference_only=not full_eval).init_weights(0)
    gate = TC.TransformerEncoder.fused_decode_ok
    monkeypatch.setattr(TC.TransformerEncoder, "fused_decode_ok",
                        lambda self, x: gate(self, types.SimpleNamespace(is_cuda=True,
                                                                         shape=x.shape)))
    counts = _counting(monkeypatch)
    with torch.no_grad():
        model({k: torch.as_tensor(np.asarray(v)) for k, v in _batch(b, nf).items()},
              torch.Generator().manual_seed(0))
    want = CS.expected_launches(cfg, b, model.opts, full_eval=full_eval, text_len=10, dec_len=4)
    assert counts == want
    assert any(counts.values())


def test_slice_v_launches_count_a_training_step_at_heads_of_32(monkeypatch):
    """chip_smoke.expected_train_launches (slice v(ii)'s step) against the
    calls of a training step at 12 heads of 32 with dropout: the flash
    pair (#1 / #1b) at D 32 on the QTV and MMT layers."""
    cfg, nf = _config(), 32 + FRAMES * OCR_PF
    model = T2S(cfg, nf, opts=cpu_options()).init_weights(0)
    counts = _counting(monkeypatch)
    tb = {k: torch.as_tensor(np.asarray(v)) for k, v in _batch(2, nf).items()}
    out = model(tb, torch.Generator().manual_seed(0), train=True,
                dropout_gen=torch.Generator().manual_seed(1))
    Losses(cfg["losses"]).total(tb, out)[0].backward()
    assert counts == CS.expected_train_launches(cfg, model.opts)
    assert counts["flash_attention_merged"] and counts["flash_attention_merged_bwd"]


def test_slice_v_drives_minilm_widths_and_vit_h14():
    """The configurations slice v drives: T2S with MiniLM's 12 heads of 32
    at the production sequence, and ViT-H/14, whose 257 tokens take #14
    and whose 64 frames' 16,448 rows take #13 in all 32 layers."""
    from vitxtgqa_tpu_torch.models.vit import VIT_H_14

    cfg = t2s_minilm_config()
    assert CS.joint_lengths(cfg) == (CS.L_JOINT, CS.L_COMPACT)
    assert cfg["mmt"]["hidden_size"] // cfg["mmt"]["num_attention_heads"] == 32
    want = {name: 0 for name in CS.REPLACES}
    want.update(fused_ffn=32, fused_attention=32)
    assert CS.expected_vit_launches(VIT_H_14, CS.VIT_FRAMES) == want


def _dry_run_geometry(monkeypatch):
    """slice v(i) on the CPU: a serving mask of 140 keys (its last 12 the
    decoder slots), #14 over 70 keys, #5 at hidden 256 (8 heads of 32, 2
    of 128) and over 2,048 slots at 256 / 512, the timers stubbed."""
    mask, ocr = CS.serving_masks("cpu")
    small = torch.cat([mask[:, :128], torch.zeros(CS.BATCH, CS.DEC_LEN)], 1).contiguous()
    monkeypatch.setattr(CS, "serving_masks", lambda dev: (small, ocr))
    monkeypatch.setattr(CS, "HEAD_BIAS_KEYS", 70)
    monkeypatch.setattr(CS, "STEP_HEAD_TIMED", ((256, 512, 8), (256, 512, 2)))
    monkeypatch.setattr(CS, "STEP_HEAD_CASES", ((256, 512, 8),))
    monkeypatch.setattr(CS, "STEP_LONG_CACHES", (2048,))
    monkeypatch.setattr(CS, "STEP_LONG_WIDTHS", (256, 512))
    monkeypatch.setattr(CS, "cuda_time_ms", lambda fn, reps=20, warmup=3: (fn(), 0.0)[1])
    monkeypatch.setattr(CS, "cuda_time_cold_ms", lambda fn, sets, reps=20: 0.0)
    monkeypatch.setattr(CS, "products_ms", lambda pairs: 0.0)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)


def test_check_head_kernels_dry_run(monkeypatch):
    """v(i) on the CPU at every head width of HEAD_WIDTHS: each kernel's
    check runs against its twin, each planted fault (a head row's last
    chunk dropped) falls outside its tolerance (the run fails otherwise),
    the timed widths' numbers land in the kernels' records under
    head_D<d>, #5's long caches under slots_<n>."""
    _dry_run_geometry(monkeypatch)
    record = {}
    out = CS.check_head_kernels(torch.device("cpu"), record)
    faults = {k: v for k, v in out.items() if k.endswith("fault")}
    for d in CS.HEAD_WIDTHS:
        for name in ("flash_attention_merged", "flash_attention_merged_q8", "flash_attention",
                     "flash_attention_bwd", "fused_attention", "decode_attention_int8",
                     "decode_attention"):
            assert f"{name} D{d} fault" in faults, (name, d)
    for key, rec in faults.items():
        name = key.split(" D")[0]
        assert rec["max_abs_diff"] > CS.TOL[name], key
    for name in ("flash_attention_merged", "flash_attention_merged_bwd", "fused_attention",
                 "decode_attention_int8", "decode_attention"):
        for d in CS.HEAD_TIMED:
            assert record[name][f"head_D{d}"]["bound_ms"] > 0, (name, d)
    assert record["fused_decode_step"]["head_D32"]["bound_ms"] > 0
    assert record["fused_decode_step"]["head_D128"]["bound_ms"] > 0
    assert record["fused_decode_step"]["slots_2048"]["bound_ms"] > 0
    assert record["fused_decode_step"]["max_abs_err"] == 0.0


def test_a_fault_within_the_tolerance_fails_slice_v(monkeypatch):
    """With nothing dropped the planted fault is the twin itself: the check
    fails, as planted_rejected lets nothing inside a tolerance pass."""
    _dry_run_geometry(monkeypatch)
    monkeypatch.setattr(CS, "HEAD_WIDTHS", (32,))
    monkeypatch.setattr(CS, "drop_chunk", lambda x, d: x)
    with pytest.raises(SystemExit, match="planted fault"):
        CS.check_head_kernels(torch.device("cpu"), {})
