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
import pathlib
import types

import numpy as np
import pytest
import torch

import chip_smoke as CS
from tests import torch_sp_ranks
from tests.torch_helpers import cpu_options, one_torch_thread  # noqa: F401
from vitxtgqa_tpu.utils.synthetic import tiny_model_config
from vitxtgqa_tpu_torch.losses import Losses
from vitxtgqa_tpu_torch.models import common as TC
from vitxtgqa_tpu_torch.models.t2s import T2S, t2s_production_config
from vitxtgqa_tpu_torch.ops import block_train as TBT
from vitxtgqa_tpu_torch.ops import decode_attention as TDA
from vitxtgqa_tpu_torch.ops import decode_step as TDS
from vitxtgqa_tpu_torch.ops import flash_attention as TFA
from vitxtgqa_tpu_torch.ops import fused_block as TFB
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
    backward, since its port); each source is in the repo and each REPLACES
    line is the def of the Pallas kernel's wrapper (#10b: of its backward's
    _flash_bwd_impl)."""
    root = pathlib.Path(repo_root)
    assert len(CS.REPLACES) == 17
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
