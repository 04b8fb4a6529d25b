"""chip_smoke.py's slice x (the fused decode above 8 batch rows, T2S served
through it at the serving bucket, the CLIP towers and MIST's text modules)
rehearsed on the CPU: the launch derivation of the grouped launches, the
kernel checks' dry runs with every planted group fault rejected, the
serving check on a tiny T2S and the towers at tiny widths.

On CPU tensors each wrapper runs its plain version, so a call of one
stands for its launches on the card: ceil(B / 8) for #5 and #6, one a
group of ops/decode_step.row_groups.
"""

import numpy as np
import pytest
import torch

import chip_smoke as CS
from tests.test_torch_chip_smoke import FRAMES, OCR_PF
from tests.torch_helpers import one_torch_thread  # noqa: F401
from vitxtgqa_tpu.utils.synthetic import tiny_model_config
from vitxtgqa_tpu_torch import Options
from vitxtgqa_tpu_torch.models import clip as TCLIP
from vitxtgqa_tpu_torch.models import common as TC
from vitxtgqa_tpu_torch.models import mist_text as TM
from vitxtgqa_tpu_torch.models.t2s import t2s_production_config
from vitxtgqa_tpu_torch.ops import _build
from vitxtgqa_tpu_torch.ops import decode_step as TDS
from vitxtgqa_tpu_torch.utils.synthetic import synthetic_batch

CPU = torch.device("cpu")


@pytest.fixture
def no_card(monkeypatch):
    """The card's timers, synchronize and memory calls stubbed."""
    monkeypatch.setattr(CS, "cuda_time_ms", lambda fn, reps=20, warmup=3: (fn(), 1.0)[1])
    monkeypatch.setattr(CS, "products_ms", lambda pairs: 1.0)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)


@pytest.mark.parametrize("batch,cap,compact,step,epilogue,per_layer", [
    (9, 192, False, 24, 24, 0), (48, 192, False, 72, 72, 0), (48, 192, True, 72, 0, 0),
    (192, 192, False, 288, 288, 0), (8, 192, False, 12, 12, 0), (2, 2, False, 12, 12, 0),
    (48, 2, False, 0, 0, 36)])
def test_expected_launches_count_a_launch_a_group(batch, cap, compact, step, epilogue, per_layer):
    """The fused decode at batch B launches #5 and #6 ceil(B / 8) times a
    step (12 steps); above the cap the per-layer int8 decode runs."""
    opts = Options(device="cpu", kv_cache_int8=True, compact_serving=compact,
                   fused_decode_max_batch=cap)
    got = CS.expected_launches(t2s_production_config(), batch, opts)
    assert (got["fused_decode_step"], got["fused_epilogue"], got["decode_attention_int8"]) == (
        step, epilogue, per_layer)


def test_group_mask_gives_every_row_its_own_planted_and_trapped_slots():
    mask = CS.group_mask(CPU, 48)
    first = [int(torch.nonzero(mask[r] > 0)[0, 0]) for r in range(48)]
    assert first == list(range(48))
    assert len({tuple(mask[r].tolist()) for r in range(48)}) == 48


@pytest.mark.parametrize("fault", [None, *CS.GROUP_FAULTS])
def test_check_step_groups_dry_run_rejects_a_grouped_launch_fault(fault, no_card, monkeypatch):
    """x(i) on the CPU at batch 9 and 16 (FFN width 256): the twin passes
    with every planted group fault outside the tolerance; a "kernel" that
    reads the first group's cache rows, or strides the cache by the group,
    fails the check."""
    monkeypatch.setattr(CS, "STEP_GROUP_BATCHES", (16, 9))
    monkeypatch.setattr(CS, "GROUP_TIMED", (9,))
    record = {}
    if fault is None:
        out = CS.check_step_groups(CPU, record, "cpu", m=256)
        assert record["fused_decode_step"]["max_abs_err"] == 0.0
        assert sorted(out["faults"]) == sorted(f"{f} {b}" for f in CS.GROUP_FAULTS
                                               for b in (16, 9))
        assert all(r["max_abs_diff"] > CS.TOL["fused_decode_step"]
                   for r in out["faults"].values())
        t = out["timed"][9]
        assert t["launches"] == 2 and t["bound_ms"] > 0 and t["max_abs_err"] == 0.0
        return
    monkeypatch.setattr(TDS, "fused_decode_step", CS.step_group_fault(fault))
    with pytest.raises(SystemExit, match="fused_decode_step"):
        CS.check_step_groups(CPU, record, "cpu", timed=False, m=256)


def test_a_group_fault_is_the_twin_within_one_group():
    """At 8 rows or fewer (one launch) the planted faults are the twin."""
    gen = torch.Generator().manual_seed(1)
    x, stacks = CS.decode_step_weights(CPU, gen, m=256, rows=8)
    mask = CS.group_mask(CPU, 8)
    kv8, kvs = CS.decode_step_cache(x, stacks, mask, 3, gen, 12, CS.WRITE_OFFSET)
    args = (x, stacks, kv8, kvs, mask, 3, CS.WRITE_OFFSET, 12)
    want = TDS.fused_decode_step_plain(*args)
    for fault in CS.GROUP_FAULTS:
        assert all(torch.equal(a, b) for a, b in zip(CS.step_group_fault(fault)(*args), want))


def _epilogue_dropping_the_offset(*args, buffers=None):
    return CS.epilogue_group_fault(args)


@pytest.mark.parametrize("faulty", [False, True])
def test_check_epilogue_groups_dry_run(faulty, no_card, monkeypatch):
    """x(ii) on the CPU: the batch order across the groups, batch 9, 11 and
    48 with the OCR row planted in the last group's last row and the tie
    in every row, the group fault outside the tolerance; an epilogue that
    drops the row offset fails."""
    monkeypatch.setattr(CS, "GROUP_TIMED", (9,))
    record = {}
    if not faulty:
        out = CS.check_epilogue_groups(CPU, record, "cpu")
        assert record["fused_epilogue"]["max_abs_err"] == 0.0
        assert sorted(out["faults"]) == sorted(CS.EPI_GROUP_BATCHES)
        assert out["timed"][9]["launches"] == 2
        return
    monkeypatch.setattr(TDS, "fused_epilogue", _epilogue_dropping_the_offset)
    with pytest.raises(SystemExit, match="fused_epilogue"):
        CS.check_epilogue_groups(CPU, record, "cpu", timed=False)


class _TinySlices(CS.Slices):
    def __init__(self):
        cfg = tiny_model_config(hidden=64, frames=FRAMES, ocr_per_frame=OCR_PF)
        super().__init__(CPU, quiet=True, cfg=cfg, nf=32 + FRAMES * OCR_PF,
                         dtype=torch.float32)

    def batch(self, b, seed):
        return synthetic_batch(batch=b, frames=FRAMES, ocr_per_frame=OCR_PF, dec_steps=4,
                               text_len=10, video_feat_dim=32, fasttext_dim=16, phoc_dim=24,
                               num_final_outputs=self.nf, text_vocab=128, seed=seed)


def test_fused_serving_slice_dry_run(no_card, monkeypatch):
    """x(iii) on a tiny T2S with the fused gate open on the CPU: served at
    bucket 9 under the lifted cap, exact and compact, each plain call of
    #5 / #6 counted as its ceil(9 / 8) = 2 launches; the launches match
    the derivation, the kernels' forward equals plain (the same
    arithmetic), the per-layer decode's tokens within the printed
    agreement."""
    monkeypatch.setattr(TC.TransformerEncoder, "fused_decode_ok",
                        lambda self, x: self.opts.kv_cache_int8 and self.opts.fused_decode
                        and x.shape[0] <= self.opts.fused_decode_max_batch)
    # the decode's kernels: the step's wrapper, and the epilogue's plain
    # version, which the forward calls in the wrapper's place on the CPU
    for name, kernel in (("fused_decode_step", "fused_decode_step"),
                         ("fused_epilogue_plain", "fused_epilogue")):
        real = getattr(TDS, name)

        def call(*a, _r=real, _k=kernel, **kw):
            _build.LAUNCHES[_k] += len(TDS.row_groups(a[0].shape[0]))
            return _r(*a, **kw)
        monkeypatch.setattr(TDS, name, call)
    monkeypatch.setattr(CS, "SERVE_BUCKET", 9)
    monkeypatch.setattr(CS, "NEAR_TIE_ROWS", {9: 9})
    monkeypatch.setattr(CS, "FUSED_FORWARD_BATCHES", (2, 9))
    decode = ("fused_decode_step", "fused_epilogue", "decode_attention_int8")
    monkeypatch.setattr(CS, "expected_launches",
                        lambda cfg, n, opts, model="t2s", _f=CS.expected_launches: {
                            k: v for k, v in _f(cfg, n, opts, text_len=10, dec_len=4,
                                                model=model).items() if k in decode})
    monkeypatch.setattr(CS, "check_outputs", lambda outs, nf, shapes=None: None)
    record = {}
    out = CS.fused_serving_slice(_TinySlices(), record, "cpu")
    assert record["fused_decode_step"]["launches"] == 2 * 4 * 2  # two slices, 4 steps, 2 groups
    assert record["fused_epilogue"]["launches"] == 4 * 2          # the exact geometry's only
    for key in ("int8_fused_b48", "preset_fused_b48"):
        assert out[key]["groups"][0]["step0_max_abs_diff"] == 0.0
    assert 0.0 <= out["int8_fused_b48"]["per_layer_token_agreement"] <= 1.0
    assert sorted(out["forward_latency"]) == [2, 9]
    _build.reset_launch_counts()


def test_towers_slice_dry_run(no_card):
    """x(iv) at tiny widths on the CPU (both "devices" the CPU: every
    distance 0), the ResNet's BatchNorm statistics drawn, AModel through
    the plain TextEncoder."""
    vit = TCLIP.CLIPConfig(embed_dim=16, image_resolution=32, vision_layers=2, vision_width=64,
                           vision_patch_size=16, context_length=12, vocab_size=50,
                           transformer_width=64, transformer_heads=1, transformer_layers=1)
    rn = TCLIP.CLIPConfig(embed_dim=32, image_resolution=64, vision_layers=(1, 1, 1, 1),
                          vision_width=16, vision_patch_size=0, context_length=10,
                          vocab_size=40, transformer_width=64, transformer_heads=1,
                          transformer_layers=1)
    bert = TC.TransformerConfig(hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
                                intermediate_size=64, vocab_size=50, hidden_dropout_prob=0.0,
                                attention_probs_dropout_prob=0.0)
    distil = TM.DistilConfig(dim=64, n_heads=4, n_layers=2, hidden_dim=128, dropout=0.0,
                             attention_dropout=0.0)
    out = CS.towers_slice(CPU, {}, "cpu", clip_cfgs=(("vit", vit), ("rn", rn)), distil=distil,
                          bert=bert, batch=3, rate_batch=2)
    assert sorted(out["rel_l2"]) == sorted(["vit", "rn", "distil_transformer 64 x 2",
                                            "amodel bert 32 x 1"])
    assert all(v == 0.0 for r in out["rel_l2"].values() for v in r.values())
    assert out["images_per_s"]["model"] == "vit"


def test_tower_agreement_fails_past_the_tolerance_or_on_a_nan():
    want = {"x": torch.ones(4)}
    CS.tower_agreement("t", {"x": torch.ones(4) * (1 + 0.5 * CS.TOWER_REL_TOL)}, want, {})
    with pytest.raises(SystemExit, match="disagrees"):
        CS.tower_agreement("t", {"x": torch.ones(4) * (1 + 2 * CS.TOWER_REL_TOL)}, want, {})
    with pytest.raises(SystemExit, match="non-finite"):
        CS.tower_agreement("t", {"x": torch.tensor([1.0, float("nan"), 1.0, 1.0])}, want, {})
