"""chip_smoke.py's training-step check, dry-run on the CPU at a tiny width.

The check holds a step through the kernels against the same step through
the plain versions (loss, gradient norm, every parameter's gradient) and
plants two block faults in the plain step that its limits must reject.
On CPU tensors both models run the plain versions, so the two steps agree
exactly here; what this test holds is the check's own machinery: each
planted fault reaches the layer it names, moves that layer's gradients
past the limit (float32, dropout at the config's 0.1, three layers of
hidden 128), and is undone when its step ends.
"""

import copy
import os
import pathlib
import types

import numpy as np
import pytest
import torch

import chip_smoke as CS
from tests import torch_sp_ranks
from tests.test_torch_train import _no_dropout_config
from tests.torch_helpers import cpu_options, one_torch_thread  # noqa: F401
from vitxtgqa_tpu.utils.synthetic import tiny_model_config
from vitxtgqa_tpu_torch.losses import Losses
from vitxtgqa_tpu_torch.models import common as TC
from vitxtgqa_tpu_torch.models.t2s import T2S, t2s_production_config
from vitxtgqa_tpu_torch.ops import block_train as TBT
from vitxtgqa_tpu_torch.ops import decode_attention as TDA
from vitxtgqa_tpu_torch.ops import decode_step as TDS
from vitxtgqa_tpu_torch.ops import flash_attention as TFA
from vitxtgqa_tpu_torch.ops import ffn as TFF
from vitxtgqa_tpu_torch.ops import fused_attention as TFAT
from vitxtgqa_tpu_torch.ops import fused_block as TFB
from vitxtgqa_tpu_torch.ops import ptr_scores as TPS
from vitxtgqa_tpu_torch.utils.synthetic import synthetic_batch

FRAMES, OCR_PF = 8, 30


class _TinySlices:
    """chip_smoke.Slices' interface over a tiny model on the CPU."""

    dev = torch.device("cpu")

    def __init__(self):
        # three layers per stack: the planted faults name MMT layer 2 and
        # text-BERT layer 0
        self.cfg = tiny_model_config(hidden=128, layers=3, frames=FRAMES, ocr_per_frame=OCR_PF)
        self.nf = 32 + FRAMES * OCR_PF
        self.state = T2S(self.cfg, self.nf, opts=cpu_options()).init_weights(0).state_dict()

    def model(self, plain=False):
        m = T2S(self.cfg, self.nf, opts=cpu_options(plain=plain))
        m.load_state_dict(self.state)
        return m


@pytest.fixture(autouse=True, scope="module")
def no_cuda_sync():
    """The check synchronizes the card after a step; there is none here."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
        yield


@pytest.fixture(scope="module")
def steps(no_cuda_sync):
    sl = _TinySlices()
    batch = synthetic_batch(batch=2, frames=FRAMES, ocr_per_frame=OCR_PF, dec_steps=4,
                            text_len=10, video_feat_dim=32, fasttext_dim=16, phoc_dim=24,
                            num_final_outputs=sl.nf, text_vocab=128, seed=0)
    tb = {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}
    losses = Losses([{"type": "pos_bce_loss", "weight": 1.0}, {"type": "InfoNCE", "weight": 1000}])
    return sl, tb, losses, CS.train_check_step(sl, tb, losses, plain=True)


def test_train_check_step_agrees_with_itself(steps):
    sl, tb, losses, plain = steps
    kern = CS.train_check_step(sl, tb, losses, plain=False)
    loss_rel, norm_rel, (grad_rel, _), n, ok = CS.step_agreement(kern, plain)
    assert ok and loss_rel == norm_rel == grad_rel == 0.0
    assert n > 100 and not any(kern[3].values())


@pytest.mark.parametrize("fault, param", [
    ("db2_dropped", "mmt.encoder.layer.2.output.dense.bias"),
    ("keep_scale_1", "text_bert.encoder.layer.0."),
])
def test_planted_faults_break_the_step_limits(steps, fault, param):
    """Each fault moves a gradient of its own layer past GRAD_REL_TOL
    (db2 dropped: 1.0; keep scale 1 instead of 1 / 0.9: ~0.1), and the
    plain versions are restored afterwards."""
    sl, tb, losses, plain = steps
    fwd, bwd = TBT.block_train_fwd_plain, TBT.block_train_bwd_plain
    run = CS.train_check_step(sl, tb, losses, plain=True, fault=fault)
    loss_rel, norm_rel, (grad_rel, worst), _, ok = CS.step_agreement(run, plain)
    print(f"{fault}: loss {loss_rel:.3e}, norm {norm_rel:.3e}, parameter {grad_rel:.4f} ({worst})")
    assert not ok and grad_rel > 2 * CS.GRAD_REL_TOL and worst.startswith(param)
    assert TBT.block_train_fwd_plain is fwd and TBT.block_train_bwd_plain is bwd


def test_joint_lengths_of_the_production_config():
    assert CS.joint_lengths(t2s_production_config()) == (CS.L_JOINT, CS.L_COMPACT)
    assert CS.COMPACT_OFFSET == CS.L_COMPACT - CS.DEC_LEN


# each kernel and the plain version its wrapper runs on a CPU tensor
PLAIN_OF = (
    (TFA, "flash_attention_merged_plain", "flash_attention_merged"),
    (TFB, "fused_block_plain", "fused_block"),
    (TFB, "fused_block_tanh_plain", "fused_block_tanh"),
    (TFB, "fused_block_w8a8_plain", "fused_block_w8a8"),
    (TDA, "decode_attention_int8_plain", "decode_attention_int8"),
    (TDA, "decode_attention_plain", "decode_attention"),
    (TDS, "fused_decode_step_plain", "fused_decode_step"),
    (TDS, "fused_epilogue_plain", "fused_epilogue"),
)
LAUNCH_CASES = {
    # name: (batch, Options fields, full-eval).  The tiny wide geometry:
    # the full joint sequence 384 (flash), 6 x 384 rows at width 128 (the
    # block gate); the compact one 128 (neither)
    "bf16_cache_b2": (2, {}, False),
    "compact_b2": (2, dict(kv_cache_int8=True, compact_serving=True), False),
    "compact_b6": (6, dict(kv_cache_int8=True, compact_serving=True), False),
    "w8a8_b1": (1, dict(kv_cache_int8=True, w8a8=True), False),
    "w8a8_b6": (6, dict(kv_cache_int8=True, w8a8=True), False),
    "w8a8_compact_b6": (6, dict(kv_cache_int8=True, w8a8=True, compact_serving=True), False),
    "full_eval_b6": (6, dict(kv_cache_int8=True), True),
    "compact_full_eval_b6": (6, dict(kv_cache_int8=True, compact_serving=True), True),
}


@pytest.mark.parametrize("case", sorted(LAUNCH_CASES))
def test_expected_launches_count_the_kernel_calls_of_a_forward(case, monkeypatch):
    """chip_smoke.expected_launches against the calls a tiny forward makes on
    the CPU, where each wrapper runs its plain version (counted here) and
    the fused-decode gate is opened as on a CUDA tensor."""
    b, opts, full_eval = LAUNCH_CASES[case]
    cfg = tiny_model_config(hidden=128, frames=FRAMES, ocr_per_frame=OCR_PF)
    nf = 32 + FRAMES * OCR_PF
    model = T2S(cfg, nf, opts=cpu_options(**opts), inference_only=not full_eval).init_weights(0)
    gate = TC.TransformerEncoder.fused_decode_ok
    monkeypatch.setattr(TC.TransformerEncoder, "fused_decode_ok",
                        lambda self, x: gate(self, types.SimpleNamespace(is_cuda=True,
                                                                         shape=x.shape)))
    counts = {name: 0 for name in CS.REPLACES}

    def counting(fn, kernel):
        def call(*a, **kw):
            counts[kernel] += 1
            return fn(*a, **kw)
        return call

    for mod, plain, kernel in PLAIN_OF:
        monkeypatch.setattr(mod, plain, counting(getattr(mod, plain), kernel))
    batch = synthetic_batch(batch=b, frames=FRAMES, ocr_per_frame=OCR_PF, dec_steps=4,
                            text_len=10, video_feat_dim=32, fasttext_dim=16, phoc_dim=24,
                            num_final_outputs=nf, text_vocab=128, seed=0)
    model({k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()},
          torch.Generator().manual_seed(0))
    want = CS.expected_launches(cfg, b, model.opts, full_eval=full_eval, text_len=10, dec_len=4)
    assert counts == want


# slice j: (ViT config fields, frames) of a tiny forward whose kernel calls
# are counted.  Tokens (64 / 8)^2 + 1 = 65: 31 frames are 2,015 rows (below
# the fused FFN's 2,048), 32 are 2,080; at image 128, 257 tokens (>= 256:
# the bias-tensor attention)
VIT_LAUNCH_CASES = {
    "below_ffn_gate": (dict(image_size=64), 31),
    "ffn_gate": (dict(image_size=64), 32),
    "attention_gate": (dict(image_size=128), 2),
    "both": (dict(image_size=128), 8),
}


@pytest.mark.parametrize("case", sorted(VIT_LAUNCH_CASES))
def test_expected_vit_launches_count_the_kernel_calls_of_a_forward(case, monkeypatch):
    """chip_smoke.expected_vit_launches against the calls a tiny ViT forward
    makes on the CPU, where each wrapper runs its plain version (counted)."""
    from vitxtgqa_tpu_torch.models import vit as TV
    from vitxtgqa_tpu_torch.ops import ffn as TFFN
    from vitxtgqa_tpu_torch.ops import fused_attention as TFAT

    fields, frames = VIT_LAUNCH_CASES[case]
    cfg = TV.ViTConfig(patch_size=8, hidden_size=128, num_layers=2, num_heads=2, mlp_dim=256,
                       **fields)
    counts = {name: 0 for name in CS.REPLACES}
    for mod, plain, kernel in ((TFFN, "fused_ffn_plain", "fused_ffn"),
                               (TFAT, "fused_attention_plain", "fused_attention")):
        fn = getattr(mod, plain)

        def call(*a, _fn=fn, _kernel=kernel, **kw):
            counts[_kernel] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, plain, call)
    model = TV.ViT(cfg, cpu_options()).init_weights(0).eval()
    with torch.inference_mode():
        model(torch.zeros(frames, cfg.image_size, cfg.image_size, 3))
    assert counts == CS.expected_vit_launches(cfg, frames)


@pytest.mark.parametrize("frames, image_size, ffn, attention", [
    (64, 224, 24, 0), (11, 224, 24, 0), (10, 224, 0, 0), (8, 224, 0, 0), (8, 384, 24, 24),
])
def test_vit_l16_launches_of_slice_j(frames, image_size, ffn, attention):
    """ViT-L/16: the fused FFN in all 24 layers from 11 frames (2,167 rows)
    at 224 px and none below; the bias-tensor attention only at 384 px (577
    tokens); no other kernel."""
    import dataclasses

    from vitxtgqa_tpu_torch.models.vit import VIT_L_16

    cfg = dataclasses.replace(VIT_L_16, image_size=image_size)
    want = {name: 0 for name in CS.REPLACES}
    want.update(fused_ffn=ffn, fused_attention=attention)
    assert CS.expected_vit_launches(cfg, frames) == want


def test_the_kernel_record_names_fifteen_kernels(repo_root):
    """REPLACES, SOURCE and TOL name the same kernels, every one of the 17
    pallas_call sites (#10 and #10b, the split-head flash forward and
    backward, since its port) and the four split forms of tensor
    parallelism, which replace the blocks' sites (#2, #3, #9a, #9b) under
    the JAX mesh's model axis; each source is in the repo and each
    REPLACES line is the def of the Pallas kernel's wrapper (#10b: of its
    backward's _flash_bwd_impl)."""
    root = pathlib.Path(repo_root)
    assert len(CS.REPLACES) == 21 and len(set(CS.REPLACES.values())) == 17
    for name in ("fused_block", "fused_block_tanh", "block_train_fwd", "block_train_bwd"):
        assert CS.REPLACES[name + "_tp"] == CS.REPLACES[name]
        assert CS.SOURCE[name + "_tp"] == CS.SOURCE[name]
    assert set(CS.REPLACES) == set(CS.SOURCE) == set(CS.TOL)
    for name, where in CS.REPLACES.items():
        assert (root / CS.SOURCE[name]).is_file(), name
        path, line = where.split(":")
        text = (root / path).read_text().splitlines()[int(line) - 1]
        assert text.startswith("def "), (name, text)
    assert CS.REPLACES["fused_ffn"].endswith("pallas_ffn.py:74")
    assert CS.REPLACES["fused_attention"].endswith("pallas_attention.py:1162")
    assert CS.REPLACES["flash_attention"].endswith("pallas_attention.py:242")
    assert CS.REPLACES["flash_attention_bwd"].endswith("pallas_attention.py:350")


def test_vit_request_carries_the_features():
    """The request of slice j: the 64 features as video_feat, every frame
    valid, mid_img_feat the last frame's feature, OCR temporal ids over
    frames 1-64."""
    feats = np.random.default_rng(0).standard_normal((64, 1024)).astype(np.float32)
    req = CS.vit_request(feats, 5050 + 960)
    assert req["video_feat"].shape == (1, 64, 1024)
    np.testing.assert_array_equal(req["video_feat"][0], feats)
    np.testing.assert_array_equal(req["mid_img_feat"][0, 0], feats[-1])
    assert req["frame_mask"].tolist() == [[1.0] * 64]
    assert req["frame_id"].tolist() == [list(range(1, 65))]
    assert req["temporal_id"].shape == (1, 960)
    assert req["temporal_id"][0, ::15].tolist() == list(range(1, 65))
    assert int(req["frame_num"][0]) == 64


# slice k: the launches per rank of a tiny SP forward / step, counted on two
# gloo ranks on the CPU (tests/torch_sp_ranks.py), where each wrapper runs
# its plain version.  (module, plain version, kernel it stands for)
SP_PLAIN_OF = [
    ("vitxtgqa_tpu_torch.ops.flash_attention", "flash_attention_merged_plain",
     "flash_attention_merged"),
    ("vitxtgqa_tpu_torch.ops.flash_attention", "flash_attention_merged_bwd_plain",
     "flash_attention_merged_bwd"),
    ("vitxtgqa_tpu_torch.ops.flash_attention", "flash_attention_plain", "flash_attention"),
    ("vitxtgqa_tpu_torch.ops.flash_attention", "flash_attention_bwd_plain",
     "flash_attention_bwd"),
    ("vitxtgqa_tpu_torch.ops.fused_block", "fused_block_plain", "fused_block"),
    ("vitxtgqa_tpu_torch.ops.fused_block", "fused_block_tanh_plain", "fused_block_tanh"),
    ("vitxtgqa_tpu_torch.ops.fused_block", "fused_block_w8a8_plain", "fused_block_w8a8"),
    ("vitxtgqa_tpu_torch.ops.decode_attention", "decode_attention_int8_plain",
     "decode_attention_int8"),
    ("vitxtgqa_tpu_torch.ops.decode_attention", "decode_attention_plain", "decode_attention"),
    ("vitxtgqa_tpu_torch.ops.block_train", "block_train_fwd_plain", "block_train_fwd"),
    ("vitxtgqa_tpu_torch.ops.block_train", "block_train_bwd_plain", "block_train_bwd"),
]
# name: (batch, Options fields, full-eval, training step).  The tiny wide
# geometry of LAUNCH_CASES (384 joint rows: the flash route; 6 x 384 rows:
# the block gate); the step with the QTV / MMT attention dropout at 0 (the
# SP gate) and the hidden dropout at the config's 0.1, as slice k(iii)
SP_LAUNCH_CASES = {
    "sp_int8_b6": (6, dict(kv_cache_int8=True), False, False),
    "sp_full_eval_b6": (6, dict(kv_cache_int8=True), True, False),
    "sp_compact_b6": (6, dict(kv_cache_int8=True, compact_serving=True), False, False),
    "sp_train_b2": (2, {}, False, True),
}


def _sp_launch_case(name):
    b, opts, full_eval, train = SP_LAUNCH_CASES[name]
    cfg = tiny_model_config(hidden=128, frames=FRAMES, ocr_per_frame=OCR_PF)
    plain_cfg = {k: (copy.deepcopy(dict(v)) if hasattr(v, "items") else v) for k, v in cfg.items()}
    for sect in ("grounding", "classifier"):
        plain_cfg[sect] = {k: (dict(v) if hasattr(v, "items") else v)
                           for k, v in plain_cfg[sect].items()}
    if train:
        for sect in ("translayers", "mmt"):
            plain_cfg[sect]["attention_probs_dropout_prob"] = 0.0
    nf = 32 + FRAMES * OCR_PF
    batch = synthetic_batch(batch=b, frames=FRAMES, ocr_per_frame=OCR_PF, dec_steps=4,
                            text_len=10, video_feat_dim=32, fasttext_dim=16, phoc_dim=24,
                            num_final_outputs=nf, text_vocab=128, seed=0)
    rng = np.random.default_rng(1)
    state = T2S(cfg, nf, opts=cpu_options()).init_weights(0).state_dict()
    return plain_cfg, dict(
        kind="launches", cfg=plain_cfg, nf=nf, opts=opts, inference_only=not full_eval,
        train=train, state=state, plain_of=SP_PLAIN_OF,
        batch={k: np.asarray(v) for k, v in batch.items()},
        noise=(rng.gumbel(size=(b, 2, FRAMES)).astype(np.float32),
               rng.gumbel(size=(b, 2, FRAMES * OCR_PF)).astype(np.float32)),
        losses=[{"type": "pos_bce_loss", "weight": 1.0}, {"type": "InfoNCE", "weight": 1000}])


@pytest.fixture(scope="module")
def sp_launches(tmp_path_factory):
    cases = {name: _sp_launch_case(name)[1] for name in SP_LAUNCH_CASES}
    return torch_sp_ranks.launch(cases, tmp_path_factory.mktemp("sp_launch_ranks"))


@pytest.mark.parametrize("case", sorted(SP_LAUNCH_CASES))
def test_expected_sp_launches_count_the_kernel_calls_of_each_rank(case, sp_launches):
    """chip_smoke.expected_sp_launches against the calls each of two ranks
    makes in a tiny sequence-parallel forward (serving, full-eval, compact)
    or training step: the split-head flash (and its backward) where #1 (and
    #1b) ran without SP, every other kernel as before."""
    from vitxtgqa_tpu_torch import Options

    b, opts, full_eval, train = SP_LAUNCH_CASES[case]
    cfg, _ = _sp_launch_case(case)
    want = CS.expected_sp_launches(cfg, b, Options(device="cpu", **opts), full_eval=full_eval,
                                   train=train, text_len=10, dec_len=4)
    assert want["flash_attention"] > 0 and not want["flash_attention_merged"]
    if train:
        assert want["flash_attention_bwd"] == want["flash_attention"] > 0
    for rank in sp_launches:
        got = {name: rank[case].get(name, 0) for name in CS.REPLACES}
        assert got == want


@pytest.mark.parametrize("dec_len", [0, 12])
def test_edge_masks_take_the_tile_walks_two_branches(dec_len):
    """edge_masks: batch row 3 with no valid key, the rest as given; and
    every row's valid keys exactly one full 64-key tile; the decoder keys
    cleared.  The flash twin over each: the row with no key averages V over
    its 1152 keys (a multiple of 128: no padded key), the encoder rows of
    the one-tile mask attend that tile only."""
    mask, _ = CS.serving_masks(torch.device("cpu"))
    (l_none, none), (l_one, one) = CS.edge_masks(mask, dec_len)
    l = mask.shape[1]
    assert "no valid key" in l_none and "one 64-key tile" in l_one
    assert not (none[3] > 0).any() and torch.equal(none[:3, :l - dec_len], mask[:3, :l - dec_len])
    assert (one[:, 128:192] == 1).all() and one.sum().item() == 64 * one.shape[0]
    if dec_len:
        assert not none[:, l - dec_len:].any()
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((8, l, 128)).astype(np.float32))
               for _ in range(3))
    out = TFA.flash_attention_merged_plain(q, k, v, none, dec_len, 2)
    enc_rows = l - dec_len
    want = v.mean(dim=1, keepdim=True).expand(8, enc_rows, 128)[3]
    torch.testing.assert_close(out[3, :enc_rows], want, atol=1e-5, rtol=1e-5)
    out = TFA.flash_attention_merged_plain(q, k, v, one, dec_len, 2)
    split = lambda x: x.reshape(8, -1, 2, 64).transpose(1, 2)
    w = torch.softmax(split(q)[:, :, :enc_rows] @ split(k)[:, :, 128:192].transpose(-1, -2) / 8.0,
                      dim=-1)
    want = (w @ split(v)[:, :, 128:192]).transpose(1, 2).reshape(8, enc_rows, 128)
    torch.testing.assert_close(out[:, :enc_rows], want, atol=1e-5, rtol=1e-5)


def test_report_fails_on_a_nan_error():
    """report and worst_of: a NaN error fails the check and is what the
    record keeps, for the absolute and the scale-relative form alike."""
    record = {}
    CS.report(record, "flash_attention", 1e-3)
    with pytest.raises(SystemExit):
        CS.report(record, "flash_attention", float("nan"))
    assert np.isnan(record["flash_attention"]["max_abs_err"])
    with pytest.raises(SystemExit):
        CS.report(record, "flash_attention_bwd", float("nan"), scale=2.0)
    assert np.isnan(record["flash_attention_bwd"]["max_rel_err"])
    assert CS.worst_of({"a": 0.1, "b": float("nan"), "c": 0.2}) == "b"
    assert CS.worst_of({"a": 0.1, "c": 0.2}) == "c"


@pytest.mark.parametrize("padded", [True, False], ids=["twin", "unpadded_kernel"])
def test_check_padded_keys_rejects_a_kernel_without_the_padded_keys(padded, monkeypatch):
    """check_padded_keys at 130 keys (126 padded) on the CPU, where the
    wrappers run the twins: it passes, and a #1 that averages a row of mask
    fills over Lk instead of round_up(Lk, 128) keys (the port before the
    padded-key repair) is rejected."""
    monkeypatch.setattr(CS, "PAD_L", 130)
    if not padded:
        plain = TFA.flash_attention_merged_plain

        def unpadded(*args):
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(TFA, "LANE", 1)
                return plain(*args)

        monkeypatch.setattr(TFA, "flash_attention_merged", unpadded)
    record = {}
    if padded:
        CS.check_padded_keys(torch.device("cpu"), record)
        assert record["flash_attention_merged"]["max_abs_err"] == 0.0
        assert record["flash_attention"]["max_abs_err"] == 0.0
    else:
        with pytest.raises(SystemExit, match="flash_attention_merged"):
            CS.check_padded_keys(torch.device("cpu"), record)


def _without_padded_probs(plain):
    """``plain`` (a backward twin) with P = exp(S - lse) on every row: a row
    of mask fills weighs each key 1, not 1 / round_up(Lk, 128) (the port's
    backward before the padded-key repair)."""
    def call(*args):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(TFA, "_padded_probs",
                       lambda scores, lse: torch.exp(scores - lse.float()[..., None]))
            return plain(*args)
    return call


@pytest.mark.parametrize("broken", [None, "flash_attention_merged_bwd", "flash_attention_bwd"],
                         ids=["twins", "merged_bwd_unpadded", "split_bwd_unpadded"])
def test_check_padded_keys_holds_the_backward_kernels(broken, monkeypatch):
    """check_padded_keys at 130 keys on the CPU, where the wrappers run the
    twins: #1b, #10b and #14 pass with no difference, and a backward that
    weighs the keys of a row of mask fills 1 each instead of 1 / 256 is
    rejected, #1b's and #10b's alike."""
    monkeypatch.setattr(CS, "PAD_L", 130)
    if broken is not None:
        monkeypatch.setattr(TFA, broken, _without_padded_probs(getattr(TFA, broken + "_plain")))
        with pytest.raises(SystemExit, match=broken):
            CS.check_padded_keys(torch.device("cpu"), {})
        return
    record = {}
    CS.check_padded_keys(torch.device("cpu"), record)
    for name in ("flash_attention_merged_bwd", "flash_attention_bwd"):
        assert record[name]["max_abs_err"] == 0.0 and record[name]["max_rel_err"] == 0.0
    assert record["fused_attention"]["max_abs_err"] == 0.0


@pytest.mark.parametrize("padded", [True, False], ids=["twin", "unpadded_bwd"])
def test_check_split_bwd_on_the_edge_masks(padded, monkeypatch):
    """chip_smoke's #10b check on edge_masks (step 19), dry-run on the CPU
    at 256 keys, 2 heads, shards of 128 rows: the wrapper (the backward
    twin here) passes on both masks, both offsets, dec_len 0 and 12, rates
    0 and 0.1; a backward without the padded probabilities fails on the
    batch row with no valid key.  On the mask with valid keys the backward
    twin also agrees with autograd through the forward twin (the check's
    reference on the serving mask)."""
    if not padded:
        monkeypatch.setattr(TFA, "flash_attention_bwd",
                            _without_padded_probs(TFA.flash_attention_bwd_plain))
    rng = np.random.default_rng(4)
    b, h, l, rows = CS.TRAIN_CHECK_BATCH, 2, 256, 128
    q, k, v = (torch.from_numpy(rng.standard_normal((b, h, l, 64)).astype(np.float32))
               for _ in range(3))
    g = torch.from_numpy(rng.standard_normal((b, h, rows, 64)).astype(np.float32))
    mask, _ = CS.serving_masks(torch.device("cpu"))
    seed = torch.tensor([5], dtype=torch.int64)
    twin, autograd = {}, {}
    for dec_len in (0, 12):
        km = mask[:b, :l].clone()
        if dec_len:
            km[:, l - dec_len:] = 0.0
        for label, edge in CS.edge_masks(km, dec_len):
            if not padded and "no valid key" in label:
                with pytest.raises(SystemExit, match="flash_attention_bwd"):
                    CS.check_split_bwd(twin, q, k, v, g, edge, dec_len, rows, seed, label,
                                       autograd=False)
                return
            CS.check_split_bwd(twin, q, k, v, g, edge, dec_len, rows, seed, label,
                               autograd=False)
            if "no valid key" not in label:
                CS.check_split_bwd(autograd, q, k, v, g, edge, dec_len, rows, seed, label)
    assert twin["flash_attention_bwd"]["max_rel_err"] == 0.0
    assert autograd["flash_attention_bwd"]["max_rel_err"] < 1e-5


def test_ptxas_kernels_reads_the_report_of_one_source():
    """_build.ptxas_kernels, which chip_smoke.py prints the backward body's
    registers and spills with: each kernel of the named source's compile,
    none of another's."""
    from vitxtgqa_tpu_torch.ops import _build

    info = "ptxas info    : "
    log = [
        "/usr/local/cuda/bin/nvcc -O3 -c -o /b/a.1.o /r/csrc/flash_attention_bwd.cu", "# 3.1 s",
        info + "Compiling entry function '_ZN2vt5flash16flash_bwd_kernel' for 'sm_90a'",
        info + "Function properties for _ZN2vt5flash16flash_bwd_kernel",
        "    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads",
        info + "Used 207 registers, used 2 barriers",
        info + "Compiling entry function '_ZN2vt5flash20flash_bwd_pre_kernel' for 'sm_90a'",
        info + "Function properties for _ZN2vt5flash20flash_bwd_pre_kernel",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        info + "Used 22 registers, used 0 barriers",
        "/usr/local/cuda/bin/nvcc -O3 -c -o /b/b.1.o /r/csrc/fused_attention.cu", "# 3.0 s",
        info + "Compiling entry function '_ZN2vt5flash14flash_fwd_kernel' for 'sm_90a'",
        info + "Used 144 registers, used 1 barriers",
    ]
    assert _build.ptxas_kernels(log, "flash_attention_bwd.cu") == [
        ("_ZN2vt5flash16flash_bwd_kernel", 207, "8", "12"),
        ("_ZN2vt5flash20flash_bwd_pre_kernel", 22, "0", "0")]
    assert _build.ptxas_kernels(log, "fused_attention.cu") == [
        ("_ZN2vt5flash14flash_fwd_kernel", 144, "?", "?")]


@pytest.mark.parametrize("padded", [True, False], ids=["twin", "unpadded_kernel"])
def test_check_padded_bias_at_577_keys(padded, monkeypatch):
    """check_padded_bias (the #14 part of check_padded_keys) at its card
    length, 577 keys (63 padded), on the CPU: the twin passes, and a #14
    that averages a row of -1e9 biases over Lk keys instead of
    round_up(Lk, 128) (mha_reference, the port's twin before the
    padded-key repair) is rejected, although the padded keys are only 63 of
    640: V has mean 1 there, so the fault moves such a row by ~0.1."""
    from vitxtgqa_tpu_torch.ops import attention as TA
    from vitxtgqa_tpu_torch.ops import fused_attention as TFAT

    assert CS.PAD_L == 577
    record = {}
    if padded:
        CS.check_padded_bias(torch.device("cpu"), record)
        assert record["fused_attention"]["max_abs_err"] == 0.0
        return
    monkeypatch.setattr(TFAT, "fused_attention", TA.mha_reference)
    with pytest.raises(SystemExit, match="fused_attention"):
        CS.check_padded_bias(torch.device("cpu"), record)


def _without_decoder_slots(plain):
    """``plain`` (a decode twin) with no decoder slot allowed: a row's only
    keys are its valid encoder keys."""
    return lambda *args: plain(*args[:-3], -1, *args[-2:])


def _without_last_span(plain, elem_bytes):
    """``plain`` over the keys of all but the last block of each cluster
    (launch_plan): a kernel that drops its last span."""
    def call(q, *args):
        *cache, km, step, wo, h = args
        plan = TDA.launch_plan(q.shape[0], km.shape[1], h, elem_bytes)
        cut = (plan.cluster - 1) * plan.span
        return plain(q, *(t[:, :cut].contiguous() for t in cache), km[:, :cut].contiguous(),
                     step, wo, h)
    return call


@pytest.mark.parametrize("fault", [None, "int8_without_decoder_slots", "bf16_without_decoder_slots",
                                   "int8_without_last_span", "bf16_without_last_span"])
def test_check_decode_attention_rejects_a_planted_fault(fault, monkeypatch):
    """check_decode_attention (#4, #7) on the CPU, where the wrappers run
    the twins, untimed: the twins pass with no difference, and a decode
    kernel that drops the decoder slots, or the keys of a cluster's last
    block, is rejected: on the batch row with no valid encoder key both
    leave a row with no allowed key at all."""
    record = {}
    if fault is None:
        CS.check_decode_attention(torch.device("cpu"), record, timed=False)
        assert record["decode_attention_int8"]["max_abs_err"] == 0.0
        assert record["decode_attention"]["max_abs_err"] == 0.0
        return
    name = "decode_attention_int8" if fault.startswith("int8") else "decode_attention"
    plain = getattr(TDA, name + "_plain")
    broken = (_without_decoder_slots(plain) if fault.endswith("decoder_slots")
              else _without_last_span(plain, 1 if fault.startswith("int8") else 2))
    monkeypatch.setattr(TDA, name, broken)
    with pytest.raises(SystemExit, match=name):
        CS.check_decode_attention(torch.device("cpu"), record, timed=False)


def _without_last_split(bwd):
    """A block backward whose weight gradients miss the rows of the last
    split of their reduction (launch_plan's), as a kernel that dropped its
    last partial K chunk would."""
    def call(g, ctx, x1h, pre1, h, x2h, wo, w1, w2, s1, g1, s2, rate=0.0, seed=None, eps=1e-12):
        plan = TBT.launch_plan(ctx.shape[0], ctx.shape[1], w1.shape[0])
        grads = list(bwd(g, ctx, x1h, pre1, h, x2h, wo, w1, w2, s1, g1, s2, rate=rate, seed=seed,
                         eps=eps))
        cut = (plan.splits - 1) * plan.k_chunk
        rows_of = [t[:cut] for t in (g, ctx, x1h, pre1, h, x2h)]
        part = bwd(*rows_of, wo, w1, w2, s1, g1, s2, rate=rate, seed=seed, eps=eps)
        for i in (2, 6, 8):  # dWo, dW1, dW2
            grads[i] = part[i]
        return tuple(grads)
    return call


def _without_ragged_rows(fwd):
    """A block forward that leaves the rows past the last whole 128-row
    tile at zero."""
    def call(*args, **kw):
        out = list(fwd(*args, **kw))
        rows = out[0].shape[0]
        for i in range(5):
            out[i] = out[i].clone()
            out[i][rows // 128 * 128:] = 0
        return tuple(out)
    return call


def _nondeterministic(bwd):
    """A block backward whose second call moves one element of dW1 by one
    float32 ulp (a reduction whose order changes between calls)."""
    calls = [0]

    def call(*args, **kw):
        grads = list(bwd(*args, **kw))
        calls[0] += 1
        if calls[0] % 2 == 0:
            grads[6] = grads[6].clone()
            grads[6].view(-1)[0] = torch.nextafter(grads[6].view(-1)[0], torch.tensor(np.inf))
        return tuple(grads)
    return call


@pytest.mark.parametrize("fault", [None, "without_last_split", "without_ragged_rows",
                                   "nondeterministic"])
def test_check_block_kernels_rejects_a_planted_fault(fault, monkeypatch):
    """check_block_kernels (#9a, #9b) on the CPU at hidden 128, FFN 256 and
    its ragged row counts (BLOCK_RAGGED_ROWS), untimed: the twins pass with
    no difference, and each planted fault is rejected: weight gradients
    without the last split of the rows (9,000 rows: four splits), a forward
    without the rows past the last whole tile (1,000 rows: 104 of them), a
    backward whose second call differs in one bit."""
    record = {}
    small = dict(d=128, m=256)
    if fault is None:
        CS.check_block_kernels(torch.device("cpu"), record, CS.BLOCK_RAGGED_ROWS, **small)
        assert record["block_train_fwd"]["max_abs_err"] == 0.0
        assert record["block_train_bwd"]["max_rel_err"] == 0.0
        return
    assert TBT.launch_plan(9000, 128, 256).splits > 1
    if fault == "without_last_split":
        monkeypatch.setattr(TBT, "block_train_bwd", _without_last_split(TBT.block_train_bwd))
        rows, match = 9000, "block_train_bwd"
    elif fault == "without_ragged_rows":
        monkeypatch.setattr(TBT, "block_train_fwd", _without_ragged_rows(TBT.block_train_fwd))
        rows, match = 1000, "block_train_fwd"
    else:
        monkeypatch.setattr(TBT, "block_train_bwd", _nondeterministic(TBT.block_train_bwd))
        rows, match = 1000, "two calls differ in dw1"
    with pytest.raises(SystemExit, match=match):
        CS.check_block_kernels(torch.device("cpu"), record, (rows,), **small)


def _without_last_columns(ffn):
    """A fused FFN whose output misses its last 128 columns, as a GEMM that
    counted N // 256 column tiles of a width no multiple of 256 would."""
    def call(*args):
        out = ffn(*args).clone()
        out[..., -128:] = 0
        return out
    return call


@pytest.mark.parametrize("fault", [None, "without_last_columns"])
def test_check_ffn_rejects_a_planted_fault(fault, monkeypatch):
    """check_ffn (#13) on the CPU, untimed, at small widths of 128 and 384
    (one a multiple of 128 and not of 256) and ragged rows: the twin passes
    with no difference, and an FFN that leaves its last 128 output columns
    unwritten is rejected."""
    from vitxtgqa_tpu_torch.ops import ffn as TFFN

    cases = ((300, 128, 256, 128, "small"), (260, 128, 384, 384, "narrow"))
    record = {}
    if fault is None:
        CS.check_ffn(torch.device("cpu"), record, cases, timed=False)
        assert record["fused_ffn"]["max_abs_err"] == 0.0
        return
    monkeypatch.setattr(TFFN, "fused_ffn", _without_last_columns(TFFN.fused_ffn))
    with pytest.raises(SystemExit, match="fused_ffn"):
        CS.check_ffn(torch.device("cpu"), record, cases, timed=False)


def _with_bf16_residual(tanh: bool):
    """The eval block (or its tanh form) with x rounded to bf16 before the
    second residual, where the Pallas kernel keeps it in f32."""
    def block(*args, eps=1e-12):
        res, args = (args[0], args[1:]) if tanh else (None, args)
        x_q, ctx, wo, bo, s1, g1, w1, b1, w2, b2, s2, g2 = args
        dt = x_q.dtype
        mm = lambda a, w: torch.matmul(a.to(dt).float(), w.to(dt).float().t())
        x = TFB._ln(x_q.float() + (mm(ctx, wo) + bo.float()), s1.float(), g1.float(), eps)
        h = TFB.gelu_erf(mm(x, w1) + b1.float()).to(dt)
        out = TFB._ln(x.to(dt).float() + (mm(h, w2) + b2.float()), s2.float(), g2.float(), eps)
        return out.to(dt) if res is None else (res.float() + torch.tanh(out.to(dt).float())).to(dt)
    return block


@pytest.mark.parametrize("fault", [None, "fused_block", "fused_block_tanh"])
def test_check_eval_block_rejects_a_planted_fault(fault, monkeypatch):
    """check_eval_block (#2, #3) on the CPU, untimed, at its cases' row
    counts and LN1 shifts with hidden 768 and FFN widths of 384 and 256:
    the twins pass with no difference, and a block that rounds x to bf16
    before its second residual is rejected on the case whose LN1 output
    sits at 64 + O(1)."""
    cases = tuple((min(rows, 260), 384 if m % 256 else 256, shift)
                  for rows, m, shift in CS.EVAL_BLOCK_CASES)
    assert any(shift for _, _, shift in cases)
    record = {}
    if fault is None:
        CS.check_eval_block(torch.device("cpu"), record, cases, timed=False)
        assert record["fused_block"]["max_abs_err"] == 0.0
        assert record["fused_block_tanh"]["max_abs_err"] == 0.0
        return
    monkeypatch.setattr(TFB, fault, _with_bf16_residual(fault.endswith("tanh")))
    with pytest.raises(SystemExit, match=fault):
        CS.check_eval_block(torch.device("cpu"), record, cases[-1:], timed=False)


def _w8a8_with_fault(fault: str):
    """The W8A8 block's twin with one fault planted: h quantized per
    128-column tile instead of per row ("h_per_tile"), or each product's
    two scales multiplied together before the sum, acc * (xs * ws), where
    the twin takes (acc * xs) * ws ("scale_order")."""
    def dot(xq, xs, w8, ws):
        acc = torch.matmul(xq.double(), w8.double().t()).float()
        return acc * (xs * ws.float()) if fault == "scale_order" else acc * xs * ws.float()

    def block(x_q, ctx, wo8, wos, bo, s1, g1, w18, w1s, b1, w28, w2s, b2, s2, g2,
              eps=1e-12, return_quant=False):
        d, f = x_q.shape[-1], (lambda t: t.float())
        c2 = ctx.reshape(-1, d).to(x_q.dtype)
        c8, cs = TFB.quant_rows(c2)
        x = TFB._ln(x_q.reshape(-1, d).float() + (dot(c8, cs, wo8, wos) + f(bo)), f(s1), f(g1),
                    eps)
        x8, xs = TFB.quant_rows(x)
        h = TFB.gelu_as(dot(x8, xs, w18, w1s) + f(b1))
        if fault == "h_per_tile":
            tiles = [TFB.quant_rows(t) for t in h.split(128, dim=1)]
            h8 = torch.cat([q for q, _ in tiles], dim=1)
            hs = tiles[0][1]
            y = sum(dot(q, s, w, w2s) for (q, s), w in zip(tiles, w28.split(128, dim=1)))
        else:
            h8, hs = TFB.quant_rows(h)
            y = dot(h8, hs, w28, w2s)
        out = TFB._ln(x + (y + f(b2)), f(s2), f(g2), eps).to(x_q.dtype).reshape(x_q.shape)
        if not return_quant:
            return out
        return out, (c8, cs[:, 0]), (x8, xs[:, 0]), (h8, hs[:, 0])
    return block


@pytest.mark.parametrize("fault", [None, "h_per_tile", "scale_order"])
def test_check_w8a8_block_rejects_a_planted_fault(fault, monkeypatch):
    """check_w8a8_block (#8) on the CPU, untimed, at hidden 256 and FFN
    width 1,024 over 2,048 rows (two million values of h): the twin passes,
    and a block that quantizes h per 128-column tile, or applies a product's
    two scales in the other order (a last-bit difference that moves some
    values of h across an int8 step), is rejected by the h8 it forms from
    its own x8."""
    record, kw = {}, dict(cases=((2048, 1024),), d=256, timed=False, s8_cases=((130, 128, 256),))
    if fault is None:
        CS.check_w8a8_block(torch.device("cpu"), record, **kw)
        assert record["fused_block_w8a8"]["max_abs_err"] == 0.0
        return
    monkeypatch.setattr(TFB, "fused_block_w8a8", _w8a8_with_fault(fault))
    with pytest.raises(SystemExit, match="fused_block_w8a8 forms or quantizes h"):
        CS.check_w8a8_block(torch.device("cpu"), record, **kw)


def _step_without_w_cur(x_t, stacks, kv8, kvs, key_mask, step, write_offset, num_heads,
                        eps=1e-12, buffers=None):
    """fused_decode_step_plain with the current slot's term w_cur * v_cur
    dropped from the context (the slot still takes its softmax weight)."""
    n_layers, b, l_p, two_hd = kv8.shape
    hd_total = two_hd // 2
    hd = hd_total // num_heads
    pos = write_offset + int(step)
    cols = torch.arange(l_p)
    is_cur = (cols == pos)[None, None, :]
    allowed = (key_mask > 0) | ((cols >= write_offset) & (cols < pos))[None, :]
    xv, dt = x_t[:, 0], x_t.dtype
    heads = lambda t: t.reshape(t.shape[0], -1, num_heads, hd)
    rows8, rowsc = [], []
    for l in range(n_layers):
        proj = lambda w, bias: (torch.matmul(xv.float(), stacks[w][l].to(dt).float().t())
                                + stacks[bias][l].float()).to(dt)
        q, k_t, v_t = proj("wq", "bq"), proj("wk", "bk"), proj("wv", "bv")
        (k8_t, k_sc), (v8_t, v_sc) = TDS.quantize_kv(k_t), TDS.quantize_kv(v_t)
        rows8.append(torch.cat([k8_t, v8_t], dim=-1)[:, None, :])
        rowsc.append(torch.stack([k_sc, v_sc], dim=1)[:, :, None])
        kf = heads(kv8[l, :, :, :hd_total].to(dt).float())
        vf = heads(kv8[l, :, :, hd_total:].to(dt).float())
        qh = q.float().reshape(b, num_heads, hd)
        scores = torch.einsum("bhd,blhd->bhl", qh, kf) * (kvs[l, :, 0] * hd ** -0.5)[:, None, :]
        cur = torch.einsum("bhd,bhd->bh", qh, k8_t.to(dt).float().reshape(b, num_heads, hd))
        scores = scores.masked_fill(~allowed[:, None, :], TDS.NEG)
        scores = torch.where(is_cur, (cur * (k_sc * hd ** -0.5)[:, None])[:, :, None], scores)
        w = torch.softmax(scores, dim=-1)
        wv = torch.where(is_cur, 0.0, w * kvs[l, :, 1][:, None, :]).to(dt).float()
        ctx = torch.einsum("bhl,blhd->bhd", wv, vf).reshape(b, hd_total).to(dt)
        xv = TFB.fused_block_plain(xv, ctx, *(stacks[n][l] for n in TDS.STACK_NAMES[6:]),
                                   eps=eps)
    return xv[:, None, :], torch.stack(rows8), torch.stack(rowsc)


def _step_with_head_off_by_one(*args, buffers=None, **kw):
    """The twin whose quantized K rows are one int8 step off in head 0."""
    y, row8, rowsc = TDS.fused_decode_step_plain(*args, **kw)
    row8 = row8.clone()
    row8[..., :64] = (row8[..., :64].int() + 1).clamp(-127, 127).to(torch.int8)
    return y, row8, rowsc


@pytest.mark.parametrize("fault", [None, "without_w_cur", "head_off_by_one"])
def test_check_decode_step_rejects_a_planted_fault(fault, monkeypatch):
    """check_decode_step (#5) on the CPU, untimed, at the compact cache of
    384 slots, batch 1 and 2, FFN width 256: the twin passes, and a step
    that drops the current slot's weighted value, or whose quantized rows
    are one int8 step off in one head, is rejected (the first through the
    next layers' quantized rows, which it moves far past their limits; the
    second by ROW8_HEAD_MOVED, since one step alone is within ROW8_TOL)."""
    dev = torch.device("cpu")
    gen = torch.Generator(device=dev).manual_seed(7)
    x_all, stacks = CS.decode_step_weights(dev, gen, m=256)
    mask = CS.compact_mask(dev)
    kw = dict(batches=(1, 2), write_offset=CS.COMPACT_OFFSET, keep=False, timed=False)
    record = {}
    if fault is None:
        CS.check_decode_step(record, x_all, stacks, mask, gen, **kw)
        assert record["fused_decode_step"]["max_abs_err"] == 0.0
        return
    broken = _step_without_w_cur if fault == "without_w_cur" else _step_with_head_off_by_one
    monkeypatch.setattr(TDS, "fused_decode_step", broken)
    match = "fused_decode_step" if fault == "without_w_cur" else "quantized rows disagree"
    with pytest.raises(SystemExit, match=match):
        CS.check_decode_step(record, x_all, stacks, mask, gen, **kw)


def _epilogue_with_fault(fault: str):
    """fused_epilogue_plain with one planted fault: ``higher_tie`` breaks a
    tie of the top score to the higher index, ``wrong_type`` adds the emb
    row of the other token type, ``mask_dropped`` leaves the OCR mask out
    of the copy scores."""
    def epilogue(y, cls_w, cls_b, ptr_w, ptr_b, ptr_keys, ocr_mask, ans_tbl, ocr_tbl, emb_rows,
                 step, n_fixed, qk_scale, dec_len, buffers=None):
        if fault == "mask_dropped":
            ocr_mask = torch.zeros_like(ocr_mask)
        scores, idx, nxt = TDS.fused_epilogue_plain(
            y, cls_w, cls_b, ptr_w, ptr_b, ptr_keys, ocr_mask, ans_tbl, ocr_tbl, emb_rows, step,
            n_fixed, qk_scale, dec_len)
        if fault == "mask_dropped":
            return scores, idx, nxt
        s = scores[:, 0]
        idx = s.shape[-1] - 1 - s.flip(-1).argmax(-1) if fault == "higher_tie" else idx[:, 0, 0]
        v_p, n = cls_w.shape[0], ocr_tbl.shape[1]
        is_ocr = idx >= v_p
        rows = torch.arange(y.shape[0])
        raw = torch.where(is_ocr[:, None], ocr_tbl[rows, (idx - v_p).clamp(0, n - 1)].float(),
                          ans_tbl[idx.clamp(max=v_p - 1)].float())
        kind = is_ocr.long() if fault == "higher_tie" else 1 - is_ocr.long()
        emb = emb_rows[2 * min(int(step) + 1, dec_len - 1) + kind].to(torch.bfloat16).float()
        return scores, idx.to(torch.int32)[:, None, None], (raw + emb).to(y.dtype)[:, None, :]
    return epilogue


@pytest.mark.parametrize("fault", [None, "higher_tie", "wrong_type", "mask_dropped"])
def test_check_fused_epilogue_rejects_a_planted_fault(fault, monkeypatch):
    """check_fused_epilogue (#6) on the CPU, untimed, at the serving widths
    and batch 1 and 2: the twin passes (its planted tie goes to the lower
    row), and an epilogue that breaks the tie to the higher index, adds the
    emb row of the wrong token type or drops the OCR mask is rejected (the
    first by the planted tie, the second by the next embedding, the third
    by the scores)."""
    dev = torch.device("cpu")
    record = {}
    if fault is None:
        CS.check_fused_epilogue(dev, record, batches=(1, 2), timed=False)
        assert record["fused_epilogue"]["max_abs_err"] == 0.0
        return
    monkeypatch.setattr(TDS, "fused_epilogue", _epilogue_with_fault(fault))
    match = {"higher_tie": "planted tie", "wrong_type": "token, embedding",
             "mask_dropped": "disagrees with its plain version"}[fault]
    with pytest.raises(SystemExit, match=match):
        CS.check_fused_epilogue(dev, record, batches=(1, 2), timed=False)


def _epilogue_with_launch_setup(kept: str):
    """fused_epilogue_plain behind a model of the kernel's launch setup:
    the shared-memory attribute of each instantiation (batch <= 2, <= 8)
    is set at a cache miss, to the largest launch of the instantiation
    (``per_instantiation``), or to the launch's own bytes with the cache
    keyed by batch (``per_batch``); a launch of more bytes than the
    attribute is refused, as the card refuses it."""
    attr, seen = {}, set()
    smem = lambda b: (b * 768 + 8 * 768) * 4  # csrc/fused_epilogue.cu smem_bytes

    def epilogue(*args, buffers=None):
        b = args[0].shape[0]
        mb = 2 if b <= 2 else 8
        key = mb if kept == "per_instantiation" else b
        if key not in seen:
            seen.add(key)
            attr[mb] = smem(mb) if kept == "per_instantiation" else smem(b)
        if smem(b) > attr[mb]:
            raise RuntimeError("fused_epilogue: CUDA error 1 (invalid argument)")
        return TDS.fused_epilogue_plain(*args)
    return epilogue


@pytest.mark.parametrize("kept", ["per_instantiation", "per_batch"])
def test_check_epilogue_batch_order_rejects_a_setup_kept_per_batch(kept, monkeypatch):
    """check_epilogue_batch_order (#6) on the CPU at EPI_ORDER (batch 2, 1,
    2, 8, 3, 8): a launch setup made once an instantiation, at its largest
    launch, passes; one kept per batch, which leaves the attribute at
    batch 1's after batch 1, is refused at the second batch-2 call."""
    dev = torch.device("cpu")
    record = {}
    monkeypatch.setattr(TDS, "fused_epilogue", _epilogue_with_launch_setup(kept))
    if kept == "per_instantiation":
        CS.check_epilogue_batch_order(dev, record)
        assert record["fused_epilogue"]["max_abs_err"] == 0.0
        return
    with pytest.raises(SystemExit, match=r"did not launch at \[2,1,768\], call 3 of"):
        CS.check_epilogue_batch_order(dev, record)


def _ptr_scores_with_fault(fault: str):
    """ptr_scores_int8_plain with one planted fault: ``scale_order`` folds
    the scale as (acc * ks) * scale, ``scale_dropped`` leaves 1 / sqrt(D)
    out, ``last_tile_skipped`` leaves the keys of a partial last tile of
    the launch plan unscored (zero)."""
    def scores(q, k8, ks, mask):
        d = q.shape[-1]
        s = torch.einsum("bsd,bnd->bsn", q.float(), k8.float())
        if fault == "scale_order":
            return (s * ks[:, None, :]) * (1.0 / d ** 0.5) + mask[:, None, :]
        if fault == "scale_dropped":
            return s * ks[:, None, :] + mask[:, None, :]
        out = TPS.ptr_scores_int8_plain(q, k8, ks, mask)
        plan = TPS.launch_plan(q.shape[0], k8.shape[1])
        out[..., (plan.tiles_per_row - 1) * plan.keys_per_tile:] = 0.0
        return out
    return scores


@pytest.mark.parametrize("fault", [None, "scale_order", "scale_dropped", "last_tile_skipped"])
def test_check_ptr_scores_rejects_a_planted_fault(fault, monkeypatch):
    """check_ptr_scores (#12) on the CPU, untimed, at batch 1 over 960 and
    961 slots and batch 8 over 961 (a last tile of one key in both plan
    forms): the twin passes, and scores that fold the scale in the other
    order (caught only by the integer-q case, bit for bit), drop it, or
    skip the last partial tile are rejected."""
    dev = torch.device("cpu")
    record = {}
    cases = ((1, 960), (1, 961), (8, 961))
    if fault is None:
        CS.check_ptr_scores(dev, record, cases=cases, timed=False)
        assert record["ptr_scores_int8"]["max_abs_err"] == 0.0
        return
    monkeypatch.setattr(TPS, "ptr_scores_int8", _ptr_scores_with_fault(fault))
    match = "bit for bit" if fault == "scale_order" else "ptr_scores_int8"
    with pytest.raises(SystemExit, match=match):
        CS.check_ptr_scores(dev, record, cases=cases, timed=False)


SASS = """
	code for sm_90a
		Function : _ZN2vt3ptr22ptr_scores_int8_kernelILi3ELi4EEEvPKfPKaS3_S3_Pfiifix
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                  /* 0x00000a00ff017b82 */
        /*0010*/                   PRMT R4, R2, 0x7540, R3 ;               /* 0x0000754002047816 */
        /*0020*/              @!P0 FADD R5, R4, -8388736 ;                 /* 0x4b00008004057421 */
        /*0030*/                   I2F.RP R6, R7 ;                         /* 0x0000000700067306 */
        /*0040*/                   EXIT ;                                  /* 0x000000000000794d */
		Function : _ZN2vt9epilogue21fused_epilogue_kernelILi2EEEvNS0_6ParamsE
        /*0000*/                   I2FP.F32.S32 R0, R1 ;                   /* 0x0000000100007245 */
"""


def test_sass_opcodes_and_the_i2f_check():
    """_build.sass_opcodes reads each kernel's opcodes (predicates
    dropped); check_no_i2f passes the pointer scores with no I2F-family
    conversion but an integer division's reciprocal seed, whatever other
    kernels hold, and fails one with an int8 or int32 conversion."""
    from vitxtgqa_tpu_torch.ops import _build

    ops = _build.sass_opcodes(SASS)
    ptr = "_ZN2vt3ptr22ptr_scores_int8_kernelILi3ELi4EEEvPKfPKaS3_S3_Pfiifix"
    assert ops[ptr] == ["LDC", "PRMT", "FADD", "I2F.RP", "EXIT"]
    assert ops["_ZN2vt9epilogue21fused_epilogue_kernelILi2EEEvNS0_6ParamsE"] == ["I2FP.F32.S32"]
    CS.check_no_i2f(ops)
    for conversion in ("I2F.F32.S8", "I2FP.F32.S32"):
        with pytest.raises(SystemExit, match="I2F"):
            CS.check_no_i2f({**ops, ptr: ops[ptr] + [conversion]})
    with pytest.raises(SystemExit, match="missing"):
        CS.check_no_i2f({})


def test_stop_child_processes_fails_on_a_process_left_running():
    """The end-of-run check refuses a child process that is still running,
    and passes once it has been reaped."""
    import subprocess

    child = subprocess.Popen(["sleep", "60"])
    try:
        assert child.pid in [pid for pid, _ in CS.child_processes()]
        with pytest.raises(SystemExit, match="still running"):
            CS.stop_child_processes()
    finally:
        child.kill()
        child.wait()
    assert child.pid not in [pid for pid, _ in CS.child_processes()]
    CS.stop_child_processes()


# ---------------------------------------------------------------------------
# slice m: the zoo's T2S-family models
# ---------------------------------------------------------------------------

# (model, batch, Options fields, full-eval, recompute oracle) of a tiny
# forward whose kernel calls are counted.  The tiny wide geometry (text 10,
# 8 frames x 30 OCR slots, 4 decoder slots, top-2, width 128): T2S-shaped
# joint sequences of 384 rows (flash; the block from 6 sequences; MIST's
# too), M4C's 10 + 1 + 240 + 4 -> 256 (flash; the block from 8), TranSTR's
# 0 + 2 + 240 + 4 -> 256 (no question rows), wo_sg's compact 10 + 2 +
# 2 x 30 + 4 -> 128 (neither)
ZOO_LAUNCH_CASES = {
    "wo_tg_preset_b2": ("t2s_wo_tg", 2, dict(kv_cache_int8=True, compact_serving=True), False,
                        False),
    "wo_tg_full_eval_b6": ("t2s_wo_tg", 6, dict(kv_cache_int8=True), True, False),
    "wo_sg_preset_b2": ("t2s_wo_sg", 2, dict(kv_cache_int8=True, compact_serving=True), False,
                        False),
    "wo_sg_preset_b6": ("t2s_wo_sg", 6, dict(kv_cache_int8=True, compact_serving=True), False,
                        False),
    "wo_sg_compact_full_eval_b6": ("t2s_wo_sg", 6, dict(kv_cache_int8=True,
                                                         compact_serving=True), True, False),
    "m4c_int8_b2": ("m4c", 2, dict(kv_cache_int8=True), False, False),
    "m4c_int8_b8": ("m4c", 8, dict(kv_cache_int8=True), False, False),
    "m4c_bf16_b8": ("m4c", 8, {}, False, False),
    "m4c_recompute_b8": ("m4c", 8, {}, False, True),
    "t5vitevqa_bf16_b6": ("t5vitevqa", 6, {}, False, False),
    "gt_box_int8_b2": ("gt_box", 2, dict(kv_cache_int8=True), False, False),
    "transtr_int8_b2": ("transtr", 2, dict(kv_cache_int8=True), False, False),
    "transtr_int8_b8": ("transtr", 8, dict(kv_cache_int8=True), False, False),
    "transtr_bf16_b8": ("transtr", 8, {}, False, False),
    "transtr_recompute_b2": ("transtr", 2, {}, False, True),
    "mist_int8_b2": ("mist", 2, dict(kv_cache_int8=True), False, False),
    "mist_int8_b6": ("mist", 6, dict(kv_cache_int8=True), False, False),
    "mist_bf16_b6": ("mist", 6, {}, False, False),
    "mist_recompute_b2": ("mist", 2, {}, False, True),
}


def _zoo_tiny(key, b, planted=False, **kw):
    """A tiny zoo model (width 128) and its batch, with the fused-decode
    gate opened as on a CUDA tensor by the caller."""
    from vitxtgqa_tpu_torch.core.registry import registry
    from vitxtgqa_tpu_torch.run import setup_imports

    setup_imports()
    cfg = tiny_model_config(hidden=128, frames=FRAMES, ocr_per_frame=OCR_PF).to_dict()
    if key == "m4c":
        cfg["obj"]["mmt_in_dim"], cfg["ocr"]["mmt_in_dim"] = 32, 40
    opts = {k: kw.pop(k) for k in list(kw) if k not in ("inference_only", "decode_recompute")}
    cls = registry.get_model_class(key)
    if key not in CS.T2S_FAMILY:
        kw.pop("inference_only", None)
    nf = 32 + FRAMES * OCR_PF
    model = cls(cfg, nf, opts=cpu_options(**opts), **kw).init_weights(0)
    batch = synthetic_batch(batch=b, frames=FRAMES, ocr_per_frame=OCR_PF, dec_steps=4,
                            text_len=10, video_feat_dim=32, fasttext_dim=16, phoc_dim=24,
                            num_final_outputs=nf, text_vocab=128, seed=0, gt_box=key == "gt_box")
    if planted:
        CS.collapse_ground_ids(batch, frames=1, ocr_per_frame=OCR_PF)
    return cfg, model, {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}


def _count_plain_calls(monkeypatch):
    counts = {name: 0 for name in CS.REPLACES}

    def counting(fn, kernel):
        def call(*a, **kw):
            counts[kernel] += 1
            return fn(*a, **kw)
        return call

    for mod, plain, kernel in PLAIN_OF:
        monkeypatch.setattr(mod, plain, counting(getattr(mod, plain), kernel))
    gate = TC.TransformerEncoder.fused_decode_ok
    monkeypatch.setattr(TC.TransformerEncoder, "fused_decode_ok",
                        lambda self, x: gate(self, types.SimpleNamespace(is_cuda=True,
                                                                         shape=x.shape)))
    return counts


def _zoo_want(case, cfg, model):
    key, b, _, full_eval, recompute = ZOO_LAUNCH_CASES[case]
    if recompute:
        return CS.expected_recompute_launches(cfg, b, model.opts, text_len=10, dec_len=4,
                                              model=key)
    return CS.expected_launches(cfg, b, model.opts, full_eval=full_eval, text_len=10, dec_len=4,
                                model=key)


@pytest.mark.parametrize("case", sorted(ZOO_LAUNCH_CASES))
def test_expected_launches_count_the_zoo_forwards(case, monkeypatch):
    """chip_smoke.expected_launches (and expected_recompute_launches) with
    the zoo's model keys against the calls a tiny forward of each makes on
    the CPU (plain versions counted, the fused-decode gate opened as on a
    CUDA tensor): the QTV only in the T2S family, M4C's and TranSTR's
    256-row sequences, compact serving only where the grounding gives the
    lists (wo_sg's serving decode, over 128 slots), wo_tg's and
    full-eval's fallbacks."""
    key, b, opts, full_eval, recompute = ZOO_LAUNCH_CASES[case]
    counts = _count_plain_calls(monkeypatch)
    cfg, model, tb = _zoo_tiny(key, b, inference_only=not full_eval, decode_recompute=recompute,
                               **opts)
    model(tb, torch.Generator().manual_seed(0))
    want = _zoo_want(case, cfg, model)
    assert counts == want and any(want.values())


def test_zoo_geometries_of_the_production_configs():
    """The zoo's joint sequences at production width: M4C 1,024 rows,
    wo_sg's compact 128, wo_tg none (no gather list), TranSTR 1,024 (no
    question rows), MIST 1,152; zoo_masks holds those lengths, M4C's with a
    few dozen allowed keys; selector_masks TranSTR's with 1 or 2 allowed
    encoder keys a row (row 0's OCR key in the last 64-key tile) and MIST's
    with a frame entry of 2.0 or more in row 0, 5 picks and 25 OCR slots a
    row."""
    assert CS.joint_lengths(CS.zoo_config("m4c"), model="m4c") == (CS.L_M4C, None)
    assert CS.joint_lengths(CS.zoo_config("t2s_wo_sg"), model="t2s_wo_sg") == (CS.L_JOINT,
                                                                              CS.L_WO_SG)
    assert CS.joint_lengths(CS.zoo_config("t2s_wo_tg"), model="t2s_wo_tg") == (CS.L_JOINT, None)
    for key in ("t5vitevqa", "gt_box"):
        assert CS.joint_lengths(CS.zoo_config(key), model=key)[0] == CS.L_JOINT
    (m4c, km, wo), (sg, kc, wc) = CS.zoo_masks(torch.device("cpu"))
    assert km.shape == (CS.BATCH, CS.L_M4C) and wo == CS.L_M4C - CS.DEC_LEN
    assert kc.shape == (CS.BATCH, CS.L_WO_SG) and wc == CS.L_WO_SG - CS.DEC_LEN
    live = (km > 0).sum(1)
    assert 20 <= int(live.min()) and int(live.max()) <= 20 + 1 + 15
    assert CS.joint_lengths(CS.zoo_config("transtr"), model="transtr") == (CS.L_TRANSTR, None)
    assert CS.joint_lengths(CS.zoo_config("mist"), model="mist") == (CS.L_JOINT, None)
    (_, kt, wt), (_, kmist, wmist) = CS.selector_masks(torch.device("cpu"))
    assert kt.shape == (CS.BATCH, CS.L_TRANSTR) and wt == CS.L_TRANSTR - CS.DEC_LEN
    live = (kt > 0).sum(1)
    assert int(live.max()) == 2 and int(live.min()) == 1 and float(kt[0, 960]) == 1.0
    assert kmist.shape == (CS.BATCH, CS.L_JOINT) and wmist == CS.WRITE_OFFSET
    assert float(kmist[0, 20:84].max()) >= 2.0 and bool((kmist[:, 20:84].sum(1) == 5).all())
    assert int((kmist[:, 84:1044] > 0).sum(1).min()) == int((kmist[:, 84:1044] > 0).sum(1).max()) \
        == 25


def test_check_zoo_geometries_dry_run():
    """check_zoo_geometries untimed on the CPU (each wrapper there runs its
    plain version; the flash checks at batch 1): every case reached, errors
    0."""
    record = {}
    CS.check_zoo_geometries(torch.device("cpu"), record, timed=False, flash_batch=1)
    for name in ("decode_attention_int8", "decode_attention", "fused_decode_step",
                 "flash_attention_merged", "flash_attention_merged_bwd"):
        assert record[name]["max_abs_err"] == 0.0, name


# the plain version behind each kernel that MIST's mask reaches on the CPU
BONUS_TWINS = {"flash_attention_merged": (TFA, "flash_attention_merged_plain"),
               "decode_attention": (TDA, "decode_attention_plain"),
               "fused_decode_step": (TDS, "fused_decode_step_plain")}


@pytest.mark.parametrize("kernel", sorted(BONUS_TWINS))
def test_check_zoo_geometries_rejects_a_kernel_that_adds_the_mask(kernel, monkeypatch):
    """A kernel and its twin that both read a mask entry above 1 as more
    than one allowed key (as the XLA bias (1 - m) * -10000 does: here their
    output moved by 1 wherever the mask holds one) agree with each other,
    and the check against the kernel itself on the mask clipped to 1
    rejects them."""
    mod, name = BONUS_TWINS[kernel]
    real = getattr(mod, name)

    def bonus(*a, **kw):
        mask = next(t for t in a if torch.is_tensor(t) and t.dtype == torch.float32
                    and t.dim() == 2)
        out = real(*a, **kw)
        if bool((mask > 1).any()):
            (out[0] if isinstance(out, tuple) else out).add_(1.0)
        return out

    monkeypatch.setattr(mod, name, bonus)
    with pytest.raises(SystemExit, match="disagrees"):
        CS.check_zoo_geometries(torch.device("cpu"), {}, timed=False, flash_batch=1)


def _scatter_into_slot_0():
    """A fault of the compact scatter: the -1 entries of a padded gather
    list written into copy slot 0 (after the real entries) instead of the
    trash slot."""
    from vitxtgqa_tpu_torch.models.base import JointQAModel

    real = JointQAModel.__dict__["_scatter_dynamic"].__func__

    def scatter(dynamic, idx, full_n, may_pad):
        full = real(dynamic, idx, full_n, may_pad)
        pad = idx < 0
        if may_pad and pad.any():
            for row in pad.any(1).nonzero()[:, 0]:
                last = pad[row].nonzero()[-1, 0]
                full[row, :, 0] = dynamic[row, :, last]
        return full

    return staticmethod(scatter)


@pytest.mark.parametrize("fault", [None, "padded_into_slot_0"])
def test_compact_agreement_rejects_an_unwrapped_padded_list(fault, monkeypatch):
    """Slice m (ii)'s check of wo_sg under the serving preset on a batch
    whose row 0 has one real frame: the -1-padded gather list reaches the
    trash-slot scatter (padded_scatter_probe), and the compact decode
    agrees with the exact geometry (compact_agreement) within STEP0_TOL;
    with the padded entries scattered into copy slot 0 instead, slot 0's
    score moves by its mask's 1.0 and the check rejects it."""
    from vitxtgqa_tpu_torch.models.base import JointQAModel

    if fault:
        monkeypatch.setattr(JointQAModel, "_scatter_dynamic", _scatter_into_slot_0())
    _, compact, tb = _zoo_tiny("t2s_wo_sg", 2, planted=True, kv_cache_int8=True,
                               compact_serving=True)
    _, exact, _ = _zoo_tiny("t2s_wo_sg", 2, planted=True, kv_cache_int8=True)
    seen = []
    with CS.padded_scatter_probe(seen):
        c = compact(tb, torch.Generator().manual_seed(0))
    e = exact(tb, torch.Generator().manual_seed(0))
    assert seen and all(pad for _, pad in seen) and any(neg for neg, _ in seen)
    agree, d0 = CS.compact_agreement(c, e, tb["temporal_id"], 32)
    if fault:
        assert d0 > CS.STEP0_TOL
    else:
        assert agree == 1.0 and d0 <= 1e-4


@pytest.mark.parametrize("fault", ["ignores_missing_lists", "never_compacts"])
@pytest.mark.parametrize("case", ["wo_tg_preset_b2", "wo_sg_preset_b2",
                                  "wo_sg_compact_full_eval_b6"])
def test_slice_m_rejects_a_compact_gate_fault(case, fault, monkeypatch):
    """A compact gate that ignores a missing gather list (the gate before
    the ablations: compact serving alone) raises on wo_tg and on wo_sg's
    full-eval, failing the slice; one that never compacts leaves wo_sg's
    serving decode uncompacted, whose launches (the fused epilogue, no
    compact MMT) count_launches rejects.  Where a fault changes nothing
    (wo_tg never compacts; wo_sg's full-eval neither), the slice passes."""
    from vitxtgqa_tpu_torch.models.t2s import T2S as PT2S

    gate = {"ignores_missing_lists": lambda self, g, full_eval: self.opts.compact_serving,
            "never_compacts": lambda self, g, full_eval: False}[fault]
    monkeypatch.setattr(PT2S, "_compact_ok", gate)
    key, b, opts, full_eval, _ = ZOO_LAUNCH_CASES[case]
    counts = _count_plain_calls(monkeypatch)
    cfg, model, tb = _zoo_tiny(key, b, inference_only=not full_eval, **opts)
    broken = (fault == "ignores_missing_lists" and (key == "t2s_wo_tg" or full_eval)
              or fault == "never_compacts" and case == "wo_sg_preset_b2")
    if fault == "ignores_missing_lists" and broken:
        with pytest.raises(KeyError):
            model(tb, torch.Generator().manual_seed(0))
        return
    model(tb, torch.Generator().manual_seed(0))
    if broken:
        with pytest.raises(SystemExit, match="launched"):
            CS.count_launches("slice m", {}, counts, _zoo_want(case, cfg, model))
    else:
        CS.count_launches("slice m", {}, counts, _zoo_want(case, cfg, model))


# ---------------------------------------------------------------------------
# slice o: data parallelism, dry-run on two gloo ranks on the CPU
# ---------------------------------------------------------------------------


def test_slice_o_launches_count_each_ranks_kernel_calls(tmp_path):
    """chip_smoke.expected_train_launches against the calls each of two
    data-parallel ranks makes in one training step (tests/torch_dp_ranks.py)
    at the tiny wide geometry (384 joint rows: the flash route; lane-aligned
    widths: the block gate), every dropout 0: each rank launches the
    one-process step's kernels, #1, #1b, #9a and #9b, on its rows."""
    from tests import torch_dp_ranks
    from vitxtgqa_tpu_torch import Options

    cfg = _no_dropout_config(OCR_PF, 128).to_dict()
    nf = 32 + FRAMES * OCR_PF
    batch = synthetic_batch(batch=4, frames=FRAMES, ocr_per_frame=OCR_PF, dec_steps=4,
                            text_len=10, video_feat_dim=32, fasttext_dim=16, phoc_dim=24,
                            num_final_outputs=nf, text_vocab=128, seed=0)
    state = {k: v.numpy() for k, v in
             T2S(cfg, nf, opts=cpu_options()).init_weights(0).state_dict().items()}
    case = dict(kind="launches", cfg=cfg, nf=nf, state=state, batch=batch, seed=7,
                plain_of=SP_PLAIN_OF,
                losses=[{"type": "pos_bce_loss", "weight": 1.0}, {"type": "InfoNCE", "weight": 1000}])
    ranks = torch_dp_ranks.start({"step": case}, tmp_path).results()
    want = CS.expected_train_launches(cfg, Options(device="cpu"))
    assert min(want[n] for n in ("flash_attention_merged", "flash_attention_merged_bwd",
                                 "block_train_fwd", "block_train_bwd")) > 0
    for rank in ranks:
        assert {n: rank["step"].get(n, 0) for n in CS.REPLACES} == want


@pytest.fixture(scope="module")
def dp_dry():
    return CS.dp_spawn("cpu", 1, dry=True)


def test_slice_o_parity_holds_and_rejects_the_planted_faults(dp_dry):
    """dp_spawn's dry run (two gloo ranks on the CPU, the tiny model of
    entry.dryrun_model_and_batch in float32): the data-parallel step
    against the one-process step within float32 noise, each planted fault
    outside slice e's limits (dp_parity fails the run otherwise), and
    o(ii)'s readings of both ranks (the same global losses)."""
    par = dp_dry["parity"]
    assert par["loss_rel"] <= 1e-5 and par["grad_norm_rel"] <= 1e-5
    assert par["max_grad_rel"] <= 1e-4
    for fault in CS.DP_FAULTS:
        r = par["planted"][fault]
        assert (r["loss_rel"] > CS.LOSS_REL_TOL or r["grad_norm_rel"] > CS.GNORM_REL_TOL
                or r["max_grad_rel"] > CS.GRAD_REL_TOL), fault
    ranks = dp_dry["timing"]["ranks"]
    assert [r["rank"] for r in ranks] == [0, 1] and ranks[0]["losses"] == ranks[1]["losses"]
    assert all(r["allreduce_bytes"] > 0 and len(r["step_ms_all"]) == 2 for r in ranks)


def _dp_cli_extra():
    """The dry run's options: the CPU, float32, tiny widths (the runtime
    tests'), the fixtures' geometry."""
    from tests.test_torch_runtime import tiny_opts

    return [o for o in tiny_opts("/fixtures", "/save") if not o.startswith((
        "dataset_attributes.vtextgqa.data_root_dir", "training_parameters.save_dir",
        "training_parameters.batch_size", "training_parameters.num_workers",
        "training_parameters.seed"))]


def test_slice_o_cli_dry_run():
    """dp_cli on the CPU: torchrun's two gloo processes run the CLI (three
    iterations, validation, predictions) on fixtures, their losses equal the
    one-process run's, rank 0 writes one log and the checkpoints, the test
    report has each question once, and nothing is left running."""
    out = CS.dp_cli("cpu", extra=_dp_cli_extra())
    assert out["world_size"] == CS.DP_RANKS and out["predictions"] == 6
    np.testing.assert_allclose(out["losses"], out["losses_one_process"], rtol=1e-5)


GOOD_CLI = {"losses": [3.0, 2.0, 1.0], "losses_one_process": [3.0, 2.0, 1.0],
            "checkpoints": True, "world_size": 2, "log_files": ["run.log"],
            "predictions": [1, 2, 3], "questions": 3, "left": []}


@pytest.mark.parametrize("fault", [
    dict(losses=[3.0, 2.0, 1.01]), dict(losses=[3.0, 2.0]), dict(checkpoints=False),
    dict(world_size=1), dict(log_files=["a.log", "b.log"]), dict(predictions=[1, 2, 2]),
    dict(predictions=[1, 2]), dict(left=[(7, "python -m vitxtgqa_tpu_torch.run")])],
    ids=["loss_off", "step_missing", "no_checkpoint", "one_rank", "two_logs",
         "a_question_twice", "a_question_missing", "a_process_left"])
def test_slice_o_cli_checks_reject_a_planted_fault(fault):
    assert CS.dp_cli_faults(GOOD_CLI) == []
    assert CS.dp_cli_faults({**GOOD_CLI, **fault})


# ---------------------------------------------------------------------------
# slice r: the mesh's sp and pp axes, dry runs on gloo ranks on the CPU
# ---------------------------------------------------------------------------

# the launches a rank of each (how the ranks group, axes, training): a
# pipeline of the first 3 or 2 ranks of a world of 4 (the fourth sits out
# pp 3) and data x sp = 2 x 2, at the tiny wide geometry (384 joint rows:
# the flash route; 6 x 384 rows at width 128: the eval block's gate, which
# a microbatch's rows may miss) with the production layer counts 3 / 2 / 3
# and every dropout 0, at a global batch of 6
MESH_LAUNCH_RUNS = {
    "pp3_eval": ("first", 3, False), "pp3_train": ("first", 3, True),
    "pp2_eval": ("first", 2, False), "pp2_train": ("first", 2, True),
    "dsp_train": ("mesh", (2, 2, 1), True),
}
MESH_LAUNCH_BATCH = 6


def _mesh_launch_config():
    cfg = _no_dropout_config(OCR_PF, 128).to_dict()
    for sect, n in CS.MESH_LAYERS.items():
        cfg[sect]["num_hidden_layers"] = n
    return cfg


@pytest.fixture(scope="module")
def slice_r_dry(tmp_path_factory):
    """(the launch runs' config, each rank's plain-version calls in
    MESH_LAUNCH_RUNS on four ranks of tests/torch_mesh_ranks.py, mesh_spawn's
    dry run of r(i)): the four ranks start first and run while this process
    runs the dry run's three."""
    from tests import torch_mesh_ranks

    cfg = _mesh_launch_config()
    b, nf = MESH_LAUNCH_BATCH, 32 + FRAMES * OCR_PF
    batch = synthetic_batch(batch=b, frames=FRAMES, ocr_per_frame=OCR_PF, dec_steps=4,
                            text_len=10, video_feat_dim=32, fasttext_dim=16, phoc_dim=24,
                            num_final_outputs=nf, text_vocab=128, seed=0)
    rng = np.random.default_rng(1)
    noise = {(b, 2, FRAMES): rng.gumbel(size=(b, 2, FRAMES)).astype(np.float32),
             (b, 2, FRAMES * OCR_PF): rng.gumbel(size=(b, 2, FRAMES * OCR_PF)).astype(np.float32)}
    state = {k: v.numpy() for k, v in
             T2S(cfg, nf, opts=cpu_options()).init_weights(0).state_dict().items()}
    case = dict(kind="launches", cfg=cfg, nf=nf, state=state, batch=batch, noise=noise,
                runs=MESH_LAUNCH_RUNS, plain_of=SP_PLAIN_OF,
                losses=[{"type": "pos_bce_loss", "weight": 1.0},
                        {"type": "InfoNCE", "weight": 1000}])
    ranks = torch_mesh_ranks.start({"launches": case}, tmp_path_factory.mktemp("mesh_launch"),
                                   world=4)
    try:
        dry = CS.mesh_spawn("cpu", "pp3", dry=True)
        return cfg, ranks.results(), dry
    finally:
        for p in ranks.procs:
            if p.poll() is None:
                p.kill()
            p.wait()


@pytest.mark.parametrize("run", sorted(MESH_LAUNCH_RUNS))
def test_slice_r_launches_count_each_ranks_kernel_calls(slice_r_dry, run):
    """chip_smoke.expected_pp_launches (for the rank's stage) and
    expected_sp_launches (a data row's rows) against the calls each rank
    makes in a full-eval forward with the int8 cache or a training step on
    a pipeline of 3 or 2 stages, or on data x sp: a pipelined stack's
    layers once a microbatch on the stage that owns them, the tanh form on
    the last stage, the eval block where a microbatch's rows reach its
    gate; the split-head flash pair on data x sp."""
    from vitxtgqa_tpu_torch import Options

    cfg, ranks, _ = slice_r_dry
    how, axes, train = MESH_LAUNCH_RUNS[run]
    seen = 0
    for rank in ranks:
        got = rank["launches"].get(run)
        if got is None:
            continue
        seen += 1
        counts = {n: got["counts"].get(n, 0) for n in CS.REPLACES}
        opts = Options(device="cpu", kv_cache_int8=not train)
        if how == "first":
            want = CS.expected_pp_launches(cfg, got["rows"], opts, axes, got["stage"],
                                           full_eval=not train, train=train, text_len=10,
                                           dec_len=4)
        else:
            want = CS.expected_sp_launches(cfg, got["rows"], opts, axes[1], train=True,
                                           text_len=10, dec_len=4)
        assert counts == want, (run, got["stage"])
        assert sum(want.values()) > 0
    assert seen == (3 if run.startswith("pp3") else 4)
    if run == "pp2_eval":   # the QTV's microbatches of 3 x 384 rows miss the eval block's gate
        assert all(r["launches"][run]["counts"].get("fused_block_tanh", 0) == 0 for r in ranks)


def test_slice_r_pp3_holds_and_rejects_the_planted_faults(slice_r_dry):
    """mesh_spawn's dry run of r(i) (three gloo ranks on the CPU, the tiny
    model at the production layer counts in float32): full-eval equal to
    one process; the pipelined step within float32 noise of the
    one-process step; a stage skipped and a replicated gradient summed over
    the stages each outside slice e's limits (mesh_train fails the run
    otherwise)."""
    ev, step = slice_r_dry[2]["eval"], slice_r_dry[2]["step"]
    assert ev["token_agreement"] == 1.0 and max(ev["refneg_max_abs_diff"].values()) <= 1e-5
    assert step["loss_rel"] <= 1e-5 and step["grad_norm_rel"] <= 1e-5
    assert step["max_grad_rel"] <= 1e-4
    assert sorted(step["planted"]) == sorted(CS.MESH_FAULTS)
    for fault, r in step["planted"].items():
        assert (r["loss_rel"] > CS.LOSS_REL_TOL or r["grad_norm_rel"] > CS.GNORM_REL_TOL
                or r["max_grad_rel"] > CS.GRAD_REL_TOL), fault


# ---------------------------------------------------------------------------
# slice s: tensor parallelism, dry runs on gloo ranks on the CPU
# ---------------------------------------------------------------------------

# the kernels the model path reaches under tensor parallelism, counted by
# the calls of their plain versions and split forms on the CPU
TP_PLAIN_OF = SP_PLAIN_OF + [
    ("vitxtgqa_tpu_torch.ops.fused_block", "fused_block_tp", "fused_block_tp"),
    ("vitxtgqa_tpu_torch.ops.fused_block", "fused_block_tanh_tp", "fused_block_tanh_tp"),
    ("vitxtgqa_tpu_torch.ops.block_train", "block_train_fwd_tp_steps", "block_train_fwd_tp"),
    ("vitxtgqa_tpu_torch.ops.block_train", "recompute_tp", "block_train_fwd_tp"),
    ("vitxtgqa_tpu_torch.ops.block_train", "block_train_bwd_tp_steps", "block_train_bwd_tp"),
]


@pytest.fixture(scope="module")
def slice_s_dry(tmp_path_factory):
    """(the launch runs' config, each rank's calls in a full-eval forward and
    a training step at model 2 on two ranks of tests/torch_tp_ranks.py,
    mesh_spawn's dry run of s(ii)): the ranks start first and run while
    this process runs the dry run's two."""
    from tests import torch_tp_ranks

    cfg = _mesh_launch_config()
    b, nf = MESH_LAUNCH_BATCH, 32 + FRAMES * OCR_PF
    batch = synthetic_batch(batch=b, frames=FRAMES, ocr_per_frame=OCR_PF, dec_steps=4,
                            text_len=10, video_feat_dim=32, fasttext_dim=16, phoc_dim=24,
                            num_final_outputs=nf, text_vocab=128, seed=0)
    rng = np.random.default_rng(1)
    noise = {(b, 2, FRAMES): rng.gumbel(size=(b, 2, FRAMES)).astype(np.float32),
             (b, 2, FRAMES * OCR_PF): rng.gumbel(size=(b, 2, FRAMES * OCR_PF)).astype(np.float32)}
    state = {k: v.numpy() for k, v in
             T2S(cfg, nf, opts=cpu_options()).init_weights(0).state_dict().items()}
    case = dict(kind="launches", cfg=cfg, nf=nf, state=state, batch=batch, noise=noise,
                plain_of=TP_PLAIN_OF, losses=[{"type": "pos_bce_loss", "weight": 1.0},
                                              {"type": "InfoNCE", "weight": 1000}])
    ranks = torch_tp_ranks.start({"launches": case}, tmp_path_factory.mktemp("tp_launch"),
                                 world=2)
    try:
        dry = CS.mesh_spawn("cpu", "dtp2", dry=True)
        return cfg, ranks.results(), dry
    finally:
        for p in ranks.procs:
            if p.poll() is None:
                p.kill()
            p.wait()


@pytest.mark.parametrize("train", [False, True], ids=["full_eval", "train"])
def test_slice_s_launches_count_each_ranks_kernel_calls(slice_s_dry, train):
    """chip_smoke.expected_tp_launches against the calls each of two ranks
    makes at model 2 in a full-eval forward over the bf16 cache and in a
    training step: in every layer where the unsplit block would run, its
    split form once (the eval block's tanh form in the QTV's last layer;
    #9a's a second time for the remat recompute), no unsplit block; the
    flash and decode kernels as in one process."""
    from vitxtgqa_tpu_torch import Options
    from vitxtgqa_tpu_torch.parallel.mesh import ModelGroup

    cfg, ranks, _ = slice_s_dry
    opts = Options(device="cpu", tp=ModelGroup(None, 0, 2))
    for rank in ranks:
        got = rank["launches"]["train" if train else "eval"]
        counts = {n: got["counts"].get(n, 0) for n in CS.REPLACES}
        want = CS.expected_tp_launches(cfg, got["rows"], opts, full_eval=not train, train=train,
                                       text_len=10, dec_len=4)
        assert counts == want
        forms = (("block_train_fwd_tp", "block_train_bwd_tp") if train
                 else ("fused_block_tp", "fused_block_tanh_tp"))
        layers = sum(cfg[s]["num_hidden_layers"] for s in ("text_bert", "translayers", "mmt"))
        assert all(want[f] > 0 for f in forms)
        if train:   # a layer: the forward and its recompute, one backward; the MMT's 3 passes
            n = layers + 2 * cfg["mmt"]["num_hidden_layers"]
            assert (want["block_train_fwd_tp"], want["block_train_bwd_tp"]) == (2 * n, n)


def test_slice_s_holds_and_rejects_the_planted_faults(slice_s_dry):
    """mesh_spawn's dry run of s(ii) (four gloo ranks on the CPU at data 2 x
    model 2, the tiny model at the production layer counts in float32): full-eval
    over the bf16 cache equal to one process; the step within float32
    noise of the one-process step; an attention input gradient left a
    rank's partial and the whole parameters' gradients summed over the
    model replicas each outside slice e's limits (mesh_train fails the run
    otherwise)."""
    ev, step = slice_s_dry[2]["eval"], slice_s_dry[2]["step"]
    assert ev["token_agreement"] == 1.0 and max(ev["refneg_max_abs_diff"].values()) <= 1e-5
    assert step["loss_rel"] <= 1e-5 and step["grad_norm_rel"] <= 1e-5
    assert step["max_grad_rel"] <= 1e-4
    assert sorted(step["planted"]) == sorted(CS.TP_FAULTS)
    for fault, r in step["planted"].items():
        assert (r["loss_rel"] > CS.LOSS_REL_TOL or r["grad_norm_rel"] > CS.GNORM_REL_TOL
                or r["max_grad_rel"] > CS.GRAD_REL_TOL), fault


def test_slice_s_split_form_checks_reject_the_planted_sums():
    """check_tp_blocks on the CPU (the twins at tiny widths): every rank's
    whole outputs alike and equal to the twin's, the unsplit block's twin
    within its tolerance, and each of TP_SUM_FAULTS outside it (the check
    fails the run otherwise); the split forms' record gets their errors
    beside the launches an earlier slice counted into it."""
    names = ["block_train_bwd_tp", "block_train_fwd_tp", "fused_block_tanh_tp", "fused_block_tp"]
    record = {name: {"launches": 3} for name in names}
    CS.check_tp_blocks(torch.device("cpu"), record, rows_list=(160,), d=128, m=256,
                       timed=False)
    assert sorted(record) == names
    assert all(r["max_abs_err"] == 0.0 and r["launches"] == 3 for r in record.values())
    with pytest.raises(SystemExit, match="planted fault summed_twice passes"):
        real = CS.tp_reduce
        try:
            CS.tp_reduce = lambda fault=None: real(None if fault == "summed_twice" else fault)
            CS.check_tp_blocks(torch.device("cpu"), {}, rows_list=(160,), d=128, m=256,
                               timed=False)
        finally:
            CS.tp_reduce = real


def test_slice_s_cli_dry_run_restores_its_checkpoint_whole():
    """dp_cli with slice s's mesh.model=2 on the CPU: torchrun's two gloo
    processes at model 2 run the CLI, their losses within float32 noise of
    the one-process run's, and ckpt/final restores in a trainer of this
    process with every optimizer moment at the whole parameter's shape
    (reload_whole fails the run otherwise)."""
    out = CS.dp_cli("cpu", extra=_dp_cli_extra() + list(CS.TP_CLI_AXES), ranks=CS.TP_CLI_RANKS,
                    label="s(ii)", reload=True)
    assert out["world_size"] == CS.TP_CLI_RANKS and out["predictions"] == 6
    np.testing.assert_allclose(out["losses"], out["losses_one_process"], rtol=1e-5)


def test_slice_s_kernels_enter_the_record_line():
    """The split forms are kernels of the record line (REPLACES, SOURCE,
    TOL), the eval block's split forms on the eval block's source and the
    training block's on its, with the tolerances of the unsplit kernels."""
    for name in ("fused_block", "fused_block_tanh", "block_train_fwd", "block_train_bwd"):
        assert CS.TOL[name + "_tp"] == CS.TOL[name]
    assert CS.S_PLANS == ("dtp2",) and CS.MESH_PLANS["dtp2"] == (4, (2, 2, 1, 1))
    assert set(CS.S_PLANS) <= set(CS.FOUR_RANK_WORLD)


# ---------------------------------------------------------------------------
# slice p: the engine at bucket 48, the serve demo, the raw-video pipeline
# ---------------------------------------------------------------------------

VIT_PLAIN_OF = ((TFF, "fused_ffn_plain", "fused_ffn"),
                (TFAT, "fused_attention_plain", "fused_attention"))
P_GEOMETRY = dict(videos=2, frames=8, width=64, height=48, ocr_per_frame=3, questions=3, fps=10)
P_VIT = dict(image_size=32, patch_size=16, hidden_size=64, num_layers=1, num_heads=4, mlp_dim=128)


def _plain_launch_counters(monkeypatch):
    """chip_smoke's launch counters read the plain twins' calls (the
    fused-decode gate opened as on a CUDA tensor, _count_plain_calls; the
    ViT's twins too)."""
    from vitxtgqa_tpu_torch.ops import _build

    counts = _count_plain_calls(monkeypatch)
    for mod, plain, kernel in VIT_PLAIN_OF:
        real = getattr(mod, plain)
        monkeypatch.setattr(mod, plain, lambda *a, _r=real, _k=kernel, **kw: (
            counts.__setitem__(_k, counts[_k] + 1), _r(*a, **kw))[1])
    monkeypatch.setattr(_build, "launch_counts", lambda: dict(counts))
    monkeypatch.setattr(_build, "reset_launch_counts",
                        lambda: counts.update({k: 0 for k in counts}))
    return counts


def test_slice_p_serve_demo_dry_run(monkeypatch):
    """serve_demo_slice on the CPU at the tiny wide geometry (384 joint
    rows: flash; the block from 6 sequences), buckets (2, 6): the launches
    counted over the warm-up and every group the clients' requests formed
    equal serve_demo_launches' derivation from the group sizes (bucket 2
    through the fused decode step and epilogue, 6 through the block and
    the int8 decode attention), and serve_demo_faults passes."""
    from vitxtgqa_tpu_torch import serve as S

    _plain_launch_counters(monkeypatch)
    cfg = tiny_model_config(hidden=128, frames=FRAMES, ocr_per_frame=OCR_PF)
    nf = 32 + FRAMES * OCR_PF
    knobs = S.Knobs(buckets=(2, 6), wait_ms=5.0, clients=3, requests=12, rps=100.0)
    out = CS.serve_demo_slice({}, "cpu", knobs=knobs, device="cpu", model_config=cfg,
                              num_final_outputs=nf, batch_kw=dict(
                                  frames=FRAMES, ocr_per_frame=OCR_PF, dec_steps=4, text_len=10,
                                  video_feat_dim=32, fasttext_dim=16, phoc_dim=24,
                                  text_vocab=128))
    assert sum(out["group_sizes"]) == 12 and out["report"]["groups"] == len(out["group_sizes"])
    want = CS.serve_demo_launches(cfg, cpu_options(kv_cache_int8=True), (2, 6),
                                  out["group_sizes"], text_len=10, dec_len=4)
    assert out["launches"] == want
    assert want["fused_decode_step"] > 0 and want["fused_block"] > 0


def test_slice_p_engine_check_rejects_a_response_from_the_wrong_group():
    """engine_row_faults on two groups of 4 served on the CPU: each group's
    responses are its direct forward's rows; a response of the other
    group's forward in their place is flagged."""
    from vitxtgqa_tpu_torch.serving.engine import ServingEngine, group_generator, to_device

    sl = _TinySlices()
    model = sl.model()
    batch = synthetic_batch(batch=8, frames=FRAMES, ocr_per_frame=OCR_PF, dec_steps=4,
                            text_len=10, video_feat_dim=32, fasttext_dim=16, phoc_dim=24,
                            num_final_outputs=sl.nf, text_vocab=128, seed=0)
    rows = [{k: v[i] for k, v in batch.items()} for i in range(8)]
    cpu = torch.device("cpu")
    with ServingEngine(model, buckets=(4,), max_wait_ms=300) as eng:
        groups = [[f.result(timeout=120) for f in [eng.submit(r) for r in rows[4 * g:4 * g + 4]]]
                  for g in range(2)]
        assert eng._group_counter == 2
    direct = []
    for g in range(2):
        with torch.inference_mode():
            out = model(to_device({k: v[4 * g:4 * g + 4] for k, v in batch.items()}, cpu),
                        group_generator(0, g, cpu))
        direct.append({k: v.numpy() for k, v in out.items() if torch.is_tensor(v) and v.ndim})
        assert CS.engine_row_faults(groups[g], direct[g]) == []
    planted = list(groups[0])
    planted[2] = groups[1][2]
    assert CS.engine_row_faults(planted, direct[0]) == [2]


@pytest.fixture(scope="module")
def pipeline_dry(no_cuda_sync):
    """pipeline_slice on the CPU: the tiny ViT, 2 videos of 8 frames at 64
    x 48 written by cv2 (stage 1), stage 4 at tiny widths (the e2e tests'
    options), the plain-call counters in place of the launch counters."""
    from tests.test_torch_e2e_pipeline import tiny_opts
    from vitxtgqa_tpu_torch.models.vit import ViTConfig

    pytest.importorskip("cv2")
    with pytest.MonkeyPatch.context() as mp:
        _plain_launch_counters(mp)
        return CS.pipeline_slice("cpu", {}, "cpu", geo=P_GEOMETRY, vit_cfg=ViTConfig(**P_VIT),
                                 extra=tiny_opts(), cv2_video=True)


def test_slice_p_pipeline_dry_run(pipeline_dry):
    """Every stage ran: stage 1 decoded the cv2 clips, stage 2's features
    equal the plain path's (the CPU runs the plain versions), stage 4 with
    both configs predicted every question in the EvalAI schema, answering
    as the plain versions, with the launches derived (count_launches
    inside), and the reference .pth predicted as its weights' port file."""
    assert pipeline_dry["cv2"] and pipeline_dry["stage2"]["max_rel_l2"] == 0.0
    for config in CS.PIPELINE_CONFIGS:
        run = pipeline_dry[f"stage4_{config}"]
        assert run["answer_agreement"] == 1.0 and run["rows"] == 6
    assert pipeline_dry["stage4_t2s_serving.yml"]["launches"]["decode_attention_int8"] > 0
    assert pipeline_dry["ckpt_equal"] and set(pipeline_dry["seconds"]) >= {
        "stage1", "stage2", "stage3", "stage4_ckpt"}


def test_slice_p_rejects_a_missing_or_repeated_question(pipeline_dry):
    rows = pipeline_dry["stage4_t2s_abinet.yml"]["predictions"]
    qids = [r["question_id"] for r in rows]
    g = {"frame_topk": 2, "ocr_topk": 2, "frame_num": FRAMES}
    assert CS.prediction_faults(rows, qids, g) == []
    assert CS.prediction_faults(rows[1:], qids, g)
    assert CS.prediction_faults(rows[:-1] + rows[:1], qids, g)


def test_slice_p_rejects_a_reference_dict_missing_a_live_name(tmp_path):
    """Stage 4 from a reference .pth that lacks a live parameter fails the
    slice (the trainer's restore raises KeyError naming it)."""
    from tests.test_torch_e2e_pipeline import tiny_opts
    from vitxtgqa_tpu_torch import e2e_pipeline as P
    from vitxtgqa_tpu_torch.models.vit import ViTConfig

    inp = CS.pipeline_inputs(str(tmp_path), P_GEOMETRY, cv2_video=False)
    feats, work = str(tmp_path / "feats"), str(tmp_path / "work")
    P.extract_features(inp["frames"], feats, cfg=ViTConfig(**P_VIT), device="cpu")
    os.makedirs(work)
    P.assemble_data_root(work, inp["questions"], inp["ocr"], feats, inp["meta"])
    config = os.path.join(CS.ROOT, "configs", "t2s_abinet.yml")
    k = CS.runtime_trainer(P.inference_argv(work, config, "t2s", extra_opts=tiny_opts()))
    k.close()
    gone = "mmt.encoder.layer.0.output.dense.bias"
    ref = CS.write_reference_pth(k.model.state_dict(), str(tmp_path / "ref.pth"),
                                 {"Grounding_Module.frame_attn.weight": (4, 64)}, drop=(gone,))
    with pytest.raises(SystemExit, match=f"KeyError.*{gone}"):
        CS.stage4(P, work, config, ckpt=ref, extra=tiny_opts())


@pytest.mark.parametrize("case", ["flipped_row_on_a_near_tie", "more_rows_than_the_cap",
                                  "no_run_on_the_kernels_grounding",
                                  "forced_run_disagrees", "a_row_of_equal_grounding_off"])
def test_near_tie_check_holds_flipped_rows_against_plain_on_the_kernels_grounding(case):
    """near_tie_faults: a row whose grounding flipped, its copy scores 1
    off plain's, passes when plain on the kernels' grounding agrees within
    STEP0_TOL and the rows stay within the cap; each planted fault fails:
    a second such row over a cap of 1, no forced run, a forced run that
    disagrees in that row, and a row of equal grounding whose copy score
    is 1 off (the check every earlier slice keeps)."""
    rng = np.random.default_rng(0)
    kp = rng.standard_normal((4, 3, 10)).astype(np.float32)
    pp = kp + 0.01
    pp[1, 0, 8] += 1.0
    forced = kp - 0.01
    same = np.array([True, False, True, True])
    cap = 1
    if case == "more_rows_than_the_cap":
        same[3] = False
    elif case == "no_run_on_the_kernels_grounding":
        forced = None
    elif case == "forced_run_disagrees":
        forced[1, 0, 9] += 1.0
    elif case == "a_row_of_equal_grounding_off":
        pp[2, 0, 8] += 1.0
    faults, step0 = CS.near_tie_faults(kp, pp, forced, same, cap)
    if case == "flipped_row_on_a_near_tie":
        assert faults == [] and step0 == pytest.approx(0.01, abs=1e-6)
    else:
        assert faults, case
    # the earlier slices' check, on the same arrays, sees the flipped row
    assert np.abs(kp[:, 0] - pp[:, 0]).max() > CS.STEP0_TOL


def test_bf16_ulp_is_the_spacing_of_bfloat16():
    """bf16_ulp(x): the next bfloat16 above |x| (one more in its bits) less |x|."""
    for x in (1.0, 1.5, 0.3, 0.013, 3e-5, -2.5):
        t = torch.tensor(abs(x), dtype=torch.bfloat16)
        nxt = (t.view(torch.int16) + 1).view(torch.bfloat16)
        assert CS.bf16_ulp(x if x > 0 else -float(t)) == float(nxt) - float(t), x


def test_grounding_probe_forces_a_grounding_and_swap_margins_name_the_flips():
    """On the tiny T2S on the CPU: two forwards whose OCR features differ
    pick other slots in some rows; a third on the first batch with the
    second's grounding forced in returns that grounding; swap_margins
    pairs each pick of one with a pick of the other in the same frame, and
    each run ranks its own pick at least as high."""
    from vitxtgqa_tpu_torch.serving.engine import group_generator

    sl = _TinySlices()
    model = sl.model(plain=True).eval()
    batch = synthetic_batch(batch=4, frames=FRAMES, ocr_per_frame=OCR_PF, dec_steps=4,
                            text_len=10, video_feat_dim=32, fasttext_dim=16, phoc_dim=24,
                            num_final_outputs=sl.nf, text_vocab=128, seed=0)
    tb = {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}
    moved = dict(tb)
    gen = torch.Generator().manual_seed(3)
    moved["context_feature_0"] = tb["context_feature_0"] + 0.5 * torch.randn(
        tb["context_feature_0"].shape, generator=gen)
    cpu = torch.device("cpu")
    outs, probes = [], []
    for b in (moved, tb):
        probes.append(CS.GroundingProbe(model))
        with torch.inference_mode():
            outs.append(model(b, group_generator(0, 0, cpu)))
        probes[-1].remove()
    kern, plain = probes
    same = np.asarray([torch.equal(outs[0]["ground_box"][r], outs[1]["ground_box"][r])
                       for r in range(4)])
    assert not same.all()
    force = CS.GroundingProbe(model, force=kern.out)
    with torch.inference_mode():
        forced = model(tb, group_generator(0, 0, cpu))
    force.remove()
    for k in ("ground_frame", "ground_box"):
        assert torch.equal(forced[k], outs[0][k])
    assert not torch.equal(forced["pos_scores"], outs[1]["pos_scores"])
    swaps = CS.swap_margins(kern, plain, np.flatnonzero(~same))
    assert {s["row"] for s in swaps} == set(np.flatnonzero(~same).tolist())
    per_frame = model.Grounding_Module.ocr_frame_num
    for s in swaps:
        key = "pos_obj_idx" if s["kind"] == "frame" else "pos_ocr_idx"
        kset, pset = (set(p.out[key][s["row"]].tolist()) for p in (kern, plain))
        assert s["kernel_pick"] in kset - pset and s["plain_pick"] in pset - kset
        if s["kind"] == "ocr":
            assert s["kernel_pick"] // per_frame == s["plain_pick"] // per_frame
        assert s["plain_margin_ulps"] == pytest.approx(
            s["plain_margin"] / CS.bf16_ulp(s["plain_score"]))
        a, b = (plain.scores[s["kind"]][s["row"], i].item()
                for i in (s["kernel_pick"], s["plain_pick"]))
        if a > 0 and b > 0:
            assert s["plain_log_margin"] == pytest.approx(np.log(b) - np.log(a), rel=1e-6)
            assert s["plain_log_margin_ulps"] == pytest.approx(
                s["plain_log_margin"] / CS.bf16_ulp(np.log(b)))
        assert np.isnan(s["row_log_score_diff"]) or s["row_log_score_diff"] >= 0


# ---------------------------------------------------------------------------
# slice q: the legacy image-VQA zoo
# ---------------------------------------------------------------------------

# the tiny geometry of slice q's dry runs (the card's: CS.LEGACY_GEOMETRY)
LEGACY_TINY = dict(CS.LEGACY_GEOMETRY, batch=6, vocab=60, embed=8, hidden=16, feat=16,
                   boxes={"vqa2": 7, "textvqa": 9}, grid=5, answers={"vqa2": 20, "textvqa": 20})


def test_slice_q_geometry_is_the_configs():
    """The six models at configs/pythia_vqa2.yml's / lorra_textvqa.yml's
    widths (ban and top_down_bottom_up on pythia's block), batch 128, MMF's
    feature shapes and answer spaces; a batch's shapes at a geometry."""
    g = CS.LEGACY_GEOMETRY
    assert (g["batch"], g["text_len"], g["vocab"], g["embed"], g["hidden"]) == (
        128, 14, 100_000, 300, 1024)
    assert (g["feat"], g["boxes"], g["grid"], g["ocr"], g["context"], g["answers"]) == (
        2048, {"vqa2": 100, "textvqa": 137}, 196, 50, 300, {"vqa2": 3129, "textvqa": 8000})
    for key in CS.LEGACY:
        cfg = CS.legacy_config(key)
        assert (cfg["vocab_size"], cfg["embed_dim"], cfg["hidden_dim"]) == (100_000, 300, 1024)
    b = CS.legacy_batch("lorra", LEGACY_TINY)
    assert b["image_feature_0"].shape == (6, 9, 16) and b["targets"].shape == (6, 20 + 50)
    assert b["context_feature_0"].shape == (6, 50, 300) and b["order_vectors"].shape == (6, 50, 50)
    for i, n in enumerate(b["image_info_0_max_features"]):
        assert not b["image_feature_0"][i, n:].any() and b["image_feature_0"][i, :n].all()
    assert CS.legacy_batch("ban", LEGACY_TINY)["targets"].shape == (6, 20)


def test_slice_q_check_dry_run(no_cuda_sync):
    """legacy_check on the CPU at the tiny geometry, float32 against
    float32: every model within the limits (equal), every planted fault
    outside them and each of the three limits catching one; then the
    Adamax steps move parameters and no kernel launched."""
    out = CS.legacy_check(torch.device("cpu"), LEGACY_TINY, dtype=torch.float32)
    assert sorted(out) == sorted(CS.LEGACY)
    for key, rec in out.items():
        assert rec["loss_rel"] == rec["grad_norm_rel"] == rec["max_grad_rel"] == 0.0, key
        assert rec["params_moved"] >= 1 and len(rec["step_ms_all"]) == CS.LEGACY_STEPS
    planted = {f: out[m]["planted"][f]["outside"] for f, m in CS.LEGACY_FAULTS.items()}
    assert all(planted.values()) and {x for v in planted.values() for x in v} == {
        "loss", "norm", "gradient"}


@pytest.mark.parametrize("fault", sorted(CS.LEGACY_FAULTS))
def test_slice_q_rejects_each_planted_fault_alone(fault, no_cuda_sync):
    """The model alone is within the limits; with ``fault`` planted and
    limits too wide to catch it, the check fails ("passes the limits")."""
    key = CS.LEGACY_FAULTS[fault]
    out = CS.legacy_check(torch.device("cpu"), LEGACY_TINY, dtype=torch.float32, models=(key,),
                          faults={}, timed=False)
    assert not out[key]["outside"]
    try:
        CS.legacy_check(torch.device("cpu"), LEGACY_TINY, dtype=torch.float32, models=(key,),
                        faults={fault: key}, timed=False, limits=(1e9, 1e9, 1e9))
    except SystemExit as e:
        assert "passes the limits" in str(e)
    else:
        raise AssertionError(f"{fault} passed limits of 1e9")


def test_slice_q_runtime_dry_run(no_cuda_sync):
    """legacy_runtime on the CPU at the tiny geometry (float32, no
    workers): LoRRA on textvqa trains, validates and writes every EvalAI
    record; the two-dataset run (pythia on vqa2 and vizwiz) draws the
    port's MultiDataset schedule."""
    def extra(model):
        return ["training_parameters.device=cpu",
                "training_parameters.tpu.compute_dtype=float32",
                f"model_attributes.{model}.vocab_size=60", f"model_attributes.{model}.embed_dim=8",
                f"model_attributes.{model}.hidden_dim=16"]

    out = CS.legacy_runtime("cpu", LEGACY_TINY, extra=extra, workers=0)
    assert sorted(out) == ["lorra_textvqa", "pythia_vqa2_vizwiz"]
    assert out["lorra_textvqa"]["records"] == {"textvqa_val": 6, "textvqa_test": 3}
    two = out["pythia_vqa2_vizwiz"]
    assert len(two["schedule"]) == 2 * CS.LEGACY_RUNTIME_STEPS == len(two["losses"])
