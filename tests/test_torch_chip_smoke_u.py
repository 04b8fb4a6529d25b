"""chip_smoke.py's slice u (the kernels at other widths than the main
path's, T2S at bert-large-uncased's widths) rehearsed on the CPU: its
launch derivation against the calls of a tiny forward and training step
at a hidden width other than 768, and its planted faults outside the
kernels' tolerances.

On CPU tensors each wrapper runs its plain version, so a call of one (counted
here) stands for a launch on the card, and a planted fault is held against
the twin the kernel is held against there.
"""

import importlib
import types

import numpy as np
import pytest
import torch

import chip_smoke as CS
from tests.test_torch_chip_smoke import FRAMES, OCR_PF, SP_PLAIN_OF
from tests.torch_helpers import cpu_options, one_torch_thread  # noqa: F401
from vitxtgqa_tpu.utils.synthetic import tiny_model_config
from vitxtgqa_tpu_torch.losses import Losses
from vitxtgqa_tpu_torch.models import common as TC
from vitxtgqa_tpu_torch.models.t2s import T2S, t2s_bert_large_config
from vitxtgqa_tpu_torch.utils.synthetic import synthetic_batch

PLAIN_OF = SP_PLAIN_OF + [
    ("vitxtgqa_tpu_torch.ops.decode_step", "fused_decode_step_plain", "fused_decode_step"),
    ("vitxtgqa_tpu_torch.ops.decode_step", "fused_epilogue_plain", "fused_epilogue"),
]
# hidden 256 (4 heads of 64), FFN 512: no width the kernels took before
# slice u; the wide geometry of tests/test_torch_chip_smoke.py (a 384-row
# joint sequence: flash; 6 x 384 rows: the fused block's gate)
HIDDEN = 256
CASES = {
    # name: (batch, Options fields, full-eval)
    "int8_b6": (6, dict(kv_cache_int8=True), False),
    "fused_b2": (2, dict(kv_cache_int8=True), False),
    "bf16_b6": (6, dict(kv_cache_int8=False), False),
    "preset_b2": (2, dict(kv_cache_int8=True, compact_serving=True), False),
    "w8a8_b6": (6, dict(kv_cache_int8=True, w8a8=True), False),
    "full_eval_b6": (6, dict(kv_cache_int8=True), True),
}


def _config():
    return tiny_model_config(hidden=HIDDEN, frames=FRAMES, ocr_per_frame=OCR_PF)


def _batch(b, nf):
    return synthetic_batch(batch=b, frames=FRAMES, ocr_per_frame=OCR_PF, dec_steps=4,
                           text_len=10, video_feat_dim=32, fasttext_dim=16, phoc_dim=24,
                           num_final_outputs=nf, text_vocab=128, seed=0)


def _counting(monkeypatch):
    """Count each plain version's calls by the kernel it stands for."""
    counts = {name: 0 for name in CS.REPLACES}

    def counting(fn, kernel):
        def call(*a, **kw):
            counts[kernel] += 1
            return fn(*a, **kw)
        return call

    for mod_name, fn_name, kernel in PLAIN_OF:
        mod = importlib.import_module(mod_name)
        monkeypatch.setattr(mod, fn_name, counting(getattr(mod, fn_name), kernel))
    return counts


@pytest.mark.parametrize("case", sorted(CASES))
def test_slice_u_launches_count_a_forward_at_another_width(case, monkeypatch):
    """chip_smoke.expected_launches (slice u's serving and full-eval
    counts) against the calls of a forward at hidden 256, the fused-decode
    gate opened as on a CUDA tensor."""
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


def test_slice_u_launches_count_a_training_step_at_another_width(monkeypatch):
    """chip_smoke.expected_train_launches (slice u's step) against the calls
    of a training step at hidden 256 with dropout: the flash pair on the
    QTV and MMT layers, the block pair (its forward twice under remat
    "attn") on every layer."""
    cfg, nf = _config(), 32 + FRAMES * OCR_PF
    model = T2S(cfg, nf, opts=cpu_options()).init_weights(0)
    counts = _counting(monkeypatch)
    tb = {k: torch.as_tensor(np.asarray(v)) for k, v in _batch(2, nf).items()}
    out = model(tb, torch.Generator().manual_seed(0), train=True,
                dropout_gen=torch.Generator().manual_seed(1))
    Losses(cfg["losses"]).total(tb, out)[0].backward()
    assert counts == CS.expected_train_launches(cfg, model.opts)
    assert counts["block_train_fwd"] and counts["flash_attention_merged_bwd"]


def test_slice_u_drives_bert_large_widths():
    """The configuration slice u drives: every stack at bert-large-uncased's
    widths, the production depths and sequence."""
    from vitxtgqa_tpu_torch.models.common import TransformerConfig

    cfg = t2s_bert_large_config()
    for stack, layers in (("text_bert", 3), ("translayers", 2), ("mmt", 3)):
        tc = TransformerConfig.from_config(cfg[stack])
        assert (tc.hidden_size, tc.num_attention_heads, tc.intermediate_size,
                tc.num_hidden_layers, tc.layer_norm_eps) == (1024, 16, 4096, layers, 1e-12)
    ptr = cfg["classifier"]["ocr_ptr_net"]
    assert cfg["grounding"]["hidden_size"] == ptr["hidden_size"] == ptr["query_key_size"] == 1024
    assert CS.joint_lengths(cfg) == (CS.L_JOINT, CS.L_COMPACT)


@pytest.mark.parametrize("d, m", [(256, 512), (1024, 2048)])
def test_the_planted_width_faults_fall_outside_the_tolerances(d, m):
    """width_faults at a narrower and a wider row than 768: every planted
    fault (the row passes' sums over another width, the masks keyed to
    768-wide rows) lies outside its kernel's tolerance of the twin."""
    out = CS.width_faults(torch.device("cpu"), d, m, rows=48)
    assert sorted(out) == ["block_train_bwd", "block_train_fwd", "fused_block",
                           "fused_block_tanh", "fused_block_w8a8"]
    for name, rec in out.items():
        assert rec["max_abs_diff"] > CS.TOL[name], name


def test_a_fault_within_the_tolerance_fails_slice_u(monkeypatch):
    """With no fault planted (the row passes' own width) the check fails:
    planted_rejected lets nothing inside a tolerance pass."""
    monkeypatch.setattr(CS, "fault_width", lambda d: d)
    with pytest.raises(SystemExit, match="planted fault"):
        CS.width_faults(torch.device("cpu"), 256, 512, rows=48)


def test_check_width_kernels_dry_run(monkeypatch):
    """u(i) on the CPU at narrow widths (hidden 256 / 384, 64 rows; #5 at
    256; #6, #12 and the split forms at their own widths), the timer
    stubbed: every check runs against its twin and each planted fault
    falls outside its tolerance (the run fails otherwise); the errors and
    the timed calls' numbers land in the kernels' records."""
    monkeypatch.setattr(CS, "WIDTH_CASES", ((256, 512), (384, 768)))
    monkeypatch.setattr(CS, "WIDTH_TIMED", (256, 512))
    monkeypatch.setattr(CS, "SPILL_TIMED", (384, 768))
    monkeypatch.setattr(CS, "WIDTH_ROWS", 64)
    monkeypatch.setattr(CS, "STEP_WIDTH_CASES", ((256, 512),))
    monkeypatch.setattr(CS, "cuda_time_ms", lambda fn, reps=20, warmup=3: (fn(), 0.0)[1])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    record = {}
    details = CS.check_width_kernels(torch.device("cpu"), record)
    assert sorted(details["spilling"]) == ["block_train_bwd", "block_train_fwd",
                                           "ptr_scores_int8"]
    for name in ("fused_block", "fused_block_w8a8", "block_train_bwd", "fused_decode_step",
                 "fused_epilogue", "ptr_scores_int8", "block_train_bwd_tp"):
        assert record[name]["width_1024"]["bound_ms"] > 0, name
    assert details["ptr_scores 1280"]["fault"]["max_abs_diff"] > CS.TOL["ptr_scores_int8"]
