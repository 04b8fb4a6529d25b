"""chip_smoke.py's slice w (the JAX trainer's opt-in arms: compact
training, the remat modes) rehearsed on the CPU: its launch derivation
against the calls of a tiny training step under each arm, its kernel
checks' dry run with every planted fault outside the kernels' tolerances,
and its step and remat checks on a tiny T2S.

On CPU tensors each wrapper runs its plain version, so a call of one
(counted here) stands for a launch on the card, and a planted fault is held
against the twin the kernel is held against there.
"""

import numpy as np
import pytest
import torch

import chip_smoke as CS
from tests.test_torch_chip_smoke import FRAMES, OCR_PF
from tests.test_torch_chip_smoke_u import _counting
from tests.torch_helpers import cpu_options, one_torch_thread  # noqa: F401
from vitxtgqa_tpu.utils.synthetic import tiny_model_config
from vitxtgqa_tpu_torch.losses import Losses
from vitxtgqa_tpu_torch.models.t2s import T2S, t2s_production_config
from vitxtgqa_tpu_torch.ops import _build
from vitxtgqa_tpu_torch.ops.attention import MIN_KV
from vitxtgqa_tpu_torch.utils.synthetic import synthetic_batch

# each arm of slice w's steps: the Options fields of one training step
ARMS = {**{f"remat_{m}": dict(remat=m) for m in CS.REMAT_MODES},
        "compact_train": dict(compact_train=True), "compact_train_live": dict(compact_train="live")}
TEXT_LEN, DEC_STEPS = 10, 4


def _config(layers=2):
    return tiny_model_config(hidden=128, layers=layers, frames=FRAMES, ocr_per_frame=OCR_PF)


def _batch(b, nf, seed=0):
    return synthetic_batch(batch=b, frames=FRAMES, ocr_per_frame=OCR_PF, dec_steps=DEC_STEPS,
                           text_len=TEXT_LEN, video_feat_dim=32, fasttext_dim=16, phoc_dim=24,
                           num_final_outputs=nf, text_vocab=128, seed=seed)


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_slice_w_launches_count_a_training_step(arm, monkeypatch):
    """chip_smoke.expected_train_launches under each arm against the calls
    of a tiny training step with dropout (the wide geometry: QTV and MMT at
    384 keys on the flash route, compact training's pos / neg passes at 128
    on the plain one): #1 relaunched in the backward under dots and full,
    #9a under attn, attn_qkv and full."""
    cfg, nf = _config(layers=1), 32 + FRAMES * OCR_PF
    model = T2S(cfg, nf, opts=cpu_options(**ARMS[arm])).init_weights(0)
    counts = _counting(monkeypatch)
    tb = {k: torch.as_tensor(np.asarray(v)) for k, v in _batch(2, nf).items()}
    out = model(tb, torch.Generator().manual_seed(0), train=True,
                dropout_gen=torch.Generator().manual_seed(1))
    Losses(cfg["losses"]).total(tb, out)[0].backward()
    assert counts == CS.expected_train_launches(cfg, model.opts, text_len=TEXT_LEN,
                                                dec_len=DEC_STEPS)
    assert counts["flash_attention_merged_bwd"] and counts["block_train_bwd"]


def test_compact_training_keeps_the_flash_route_at_production_widths():
    """The compact passes' 384 rows reach MIN_KV at production width, so on
    the card pos and neg run #1 / #1b there, and the derivation counts
    them as the full passes'."""
    from vitxtgqa_tpu_torch import Options

    cfg = t2s_production_config()
    assert CS.joint_lengths(cfg)[1] == CS.L_COMPACT >= MIN_KV
    full = CS.expected_train_launches(cfg, Options(device="cpu"))
    assert CS.expected_train_launches(cfg, Options(device="cpu", compact_train=True)) == full
    assert full["flash_attention_merged"] == 2 + 3 * 3


def _dry_run_geometry(monkeypatch):
    """w(i) on the CPU: the compact key mask cut to 128 keys (its last 12
    the decoder slots) at a training batch of 2, the timers stubbed."""
    mask = CS.compact_mask("cpu")[:, :128].clone()
    mask[:, 128 - CS.DEC_LEN:] = 0.0
    monkeypatch.setattr(CS, "compact_mask", lambda dev: mask.contiguous())
    monkeypatch.setattr(CS, "TRAIN_BATCH", 2)
    monkeypatch.setattr(CS, "cuda_time_ms", lambda fn, reps=20, warmup=3: (fn(), 1.0)[1])
    monkeypatch.setattr(CS, "products_ms", lambda pairs: 1.0)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)


def test_check_compact_train_kernels_dry_run(monkeypatch):
    """w(i) on the CPU: #1 / #1b / #9a / #9b against their twins at the
    compact mask, each planted fault outside its tolerance (the run fails
    otherwise), every timed number under the records' "compact_train"."""
    _dry_run_geometry(monkeypatch)
    record = {}
    out = CS.check_compact_train_kernels(torch.device("cpu"), record)
    faults = {k: v for k, v in out.items() if k.endswith("fault")}
    assert sorted(faults) == sorted(["flash_attention_merged fault",
                                     "flash_attention_merged_bwd atomic fault",
                                     "flash_attention_merged_bwd ordered fault",
                                     "block_train_fwd fault", "block_train_bwd fault"])
    for key, rec in faults.items():
        assert rec["max_abs_diff"] > CS.TOL[key.split(" ")[0]], key
    for name in ("flash_attention_merged", "flash_attention_merged_bwd", "block_train_fwd",
                 "block_train_bwd"):
        t = record[name]["compact_train"]
        assert t["bound_ms"] > 0 and t["ms"] == 1.0, name
        assert record[name]["max_abs_err"] <= CS.TOL[name]
    assert record["flash_attention_merged_bwd"]["compact_train"]["ordered_ms"] == 1.0
    assert record["block_train_bwd"]["compact_train"]["gemm_ms"] == 1.0


def test_a_fault_within_the_tolerance_fails_slice_w(monkeypatch):
    """With nothing dropped the planted fault is the twin itself: the check
    fails, as planted_rejected lets nothing inside a tolerance pass."""
    _dry_run_geometry(monkeypatch)
    monkeypatch.setattr(CS, "drop_chunk", lambda x, d: x)
    with pytest.raises(SystemExit, match="planted fault"):
        CS.check_compact_train_kernels(torch.device("cpu"), {})


class _TinySlices(CS.Slices):
    """chip_smoke.Slices over a tiny float32 T2S on the CPU (``layers`` a
    stack; three where the planted block faults run: they name MMT layer
    2 and text-BERT layer 0), its batches at the tiny dims."""

    def __init__(self, layers):
        super().__init__(torch.device("cpu"), quiet=True, cfg=_config(layers=layers),
                         nf=32 + FRAMES * OCR_PF, dtype=torch.float32)

    def batch(self, b, seed):
        return _batch(b, self.nf, seed)


# the wrappers the models call, by kernel: on a CPU tensor each runs its
# plain version; counted here as the card's wrappers count their launches
WRAPPERS = (("vitxtgqa_tpu_torch.ops.attention", "flash_attention_merged"),
            ("vitxtgqa_tpu_torch.ops.attention", "flash_attention_merged_bwd"),
            ("vitxtgqa_tpu_torch.ops.attention", "decode_attention_int8"),
            ("vitxtgqa_tpu_torch.ops.attention", "decode_attention"),
            ("vitxtgqa_tpu_torch.ops.block_train", "block_train_fwd"),
            ("vitxtgqa_tpu_torch.ops.block_train", "block_train_bwd"))


@pytest.fixture
def wrapper_launches(monkeypatch):
    """_build.LAUNCHES counted by the wrappers on the CPU, the card's
    synchronize and memory counters stubbed."""
    import importlib

    for mod_name, name in WRAPPERS:
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, name)

        def call(*a, _fn=fn, _name=name, **kw):
            _build.LAUNCHES[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(mod, name, call)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(CS, "TRAIN_BATCH", 2)
    monkeypatch.setattr(CS, "TRAIN_STEPS", 2)
    monkeypatch.setattr(CS, "expected_train_launches",
                        lambda cfg, opts, model="t2s", text_len=TEXT_LEN, dec_len=DEC_STEPS,
                        _f=CS.expected_train_launches: _f(cfg, opts, model, TEXT_LEN, DEC_STEPS))
    yield
    _build.reset_launch_counts()


def _tiny(layers):
    sl = _TinySlices(layers)
    tb = {k: torch.as_tensor(np.asarray(v)) for k, v in sl.batch(2, 2).items()}
    return sl, tb, Losses(sl.cfg["losses"])


@pytest.fixture(scope="module")
def tiny():
    return _tiny(1)


@pytest.fixture(scope="module")
def tiny3():
    return _tiny(3)


def test_compact_step_against_plain_dry_run(tiny3, wrapper_launches):
    """w(ii) on the CPU ("live"; True runs the same code): the compact step
    through the wrappers against the plain versions within slice e's
    limits (the same arithmetic here: 0), its launches derived, both
    planted block faults outside the limits."""
    sl, tb, losses = tiny3
    record = {}
    out = CS.step_vs_plain(sl, record, tb, losses, "w compact_train=live", compact_train="live")
    assert out["check"]["loss_rel"] == 0.0 and out["check"]["max_grad_rel"] == 0.0
    assert sorted(out["planted"]) == sorted(CS.PLANTED_FAULTS)
    assert record["block_train_fwd"]["launches"] > 0


def test_compact_scores_check_dry_run(tiny, wrapper_launches):
    """w(ii) at dropout 0 on the CPU: the ref scores equal the full pass's,
    the kept slots within STEP0_TOL (float32: ~1e-6), the fill exact."""
    sl, tb, _ = tiny
    res = CS.compact_scores_check(sl, tb)
    assert res["ref_equal"] and res["pos_fill_equal"] and res["neg_fill_equal"]
    assert max(v for k, v in res.items() if k.endswith("diff")) < 1e-4


def _fake_timed(peaks):
    def timed(sl, record, name, card, steps=None, **opts):
        return {"step_ms_all": [1.0, 1.0, 1.0], "step_ms_median": 1.0,
                "max_memory_allocated": peaks[opts.get("remat", "attn")]}
    return timed


def test_remat_checks_dry_run(tiny, wrapper_launches, monkeypatch):
    """w(iv) on the CPU: each mode's deterministic step equals attn's bit for
    bit with its launches derived; the batch-48 timing stubbed with peaks
    that fall."""
    sl, tb, losses = tiny
    monkeypatch.setattr(CS, "timed_steps", _fake_timed(
        {"none": 5, "attn_qkv": 4, "dots": 4, "attn": 3, "full": 2}))
    record = {}
    out = CS.remat_checks(sl, record, "cpu", tb, losses)
    assert all(r["equal"] for r in out["bit_equal"].values()), out["bit_equal"]
    assert record["flash_attention_merged"]["launches"] > 0


def test_the_peak_memory_check_fails_where_it_does_not_fall():
    CS.check_peaks_fall({"none": 5, "attn_qkv": 4, "dots": 4, "attn": 3, "full": 2})
    for peaks in ({"none": 5, "attn": 3, "full": 3}, {"none": 3, "attn": 3, "full": 2}):
        with pytest.raises(SystemExit, match="peak memory"):
            CS.check_peaks_fall(peaks)


def test_timed_steps_dry_run(tiny, wrapper_launches):
    """timed_steps (slices e(ii) and w(iii)-(iv)) on the CPU under compact
    training: every step's launches derived, the update applied."""
    sl, _, _ = tiny
    out = CS.timed_steps(sl, {}, "w compact", "cpu", compact_train=True)
    assert len(out["step_ms_all"]) == 2 and all(np.isfinite(out["losses"]))
