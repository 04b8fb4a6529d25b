"""chip_smoke.py's slice t (the model axis beside sp and pp, and model 4)
rehearsed on the CPU: its launch derivation against the calls each rank
makes, and its world of four gloo ranks with the planted faults.

Four ranks of tests/torch_tp_ranks.py count the calls of the plain
versions and split forms in a full-eval forward and a training step on
each of slice t's meshes (the tiny model at the production layer counts),
while this process runs ``tp_mesh_slice``'s dry run (another four gloo
ranks, the tiny model in float32).  On the CPU the wrappers take their
plain versions, so a call of one stands for a launch on the card.
"""

import numpy as np
import pytest

import chip_smoke as CS
from tests.test_torch_chip_smoke import (FRAMES, MESH_LAUNCH_BATCH, OCR_PF, TP_PLAIN_OF,
                                         _mesh_launch_config)
from tests.torch_helpers import cpu_options, one_torch_thread  # noqa: F401
from vitxtgqa_tpu_torch.models.t2s import T2S
from vitxtgqa_tpu_torch.utils.synthetic import synthetic_batch


@pytest.fixture(scope="module")
def slice_t_dry(tmp_path_factory):
    """(the launch runs' config, each rank's calls on each of T_PLANS'
    meshes, tp_mesh_slice's dry run): the ranks start first and run while
    this process runs the dry run's four."""
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
    cases = {plan: dict(kind="launches", mesh=CS.MESH_PLANS[plan][1], cfg=cfg, nf=nf,
                        state=state, batch=batch, noise=noise, plain_of=TP_PLAIN_OF,
                        losses=[{"type": "pos_bce_loss", "weight": 1.0},
                                {"type": "InfoNCE", "weight": 1000}])
             for plan in CS.T_PLANS}
    ranks = torch_tp_ranks.start(cases, tmp_path_factory.mktemp("tp_mesh_launch"), world=4)
    try:
        dry = CS.tp_mesh_slice({}, "cpu (dry run)", dry=True)
        return cfg, ranks.results(), dry
    finally:
        for p in ranks.procs:
            if p.poll() is None:
                p.kill()
            p.wait()


@pytest.mark.parametrize("train", [False, True], ids=["full_eval", "train"])
@pytest.mark.parametrize("plan", CS.T_PLANS)
def test_slice_t_launches_count_each_ranks_kernel_calls(slice_t_dry, plan, train):
    """chip_smoke.expected_mesh_launches against the calls each of four
    ranks makes on the plan's mesh in a full-eval forward over the bf16
    cache and in a training step: at model 2 x sp 2 the split-head flash
    pair (#10 / #10b) in the merged flash's place on a rank's heads, at
    model 2 x pp 2 a stage's layers once a microbatch, and the split forms
    in every unsplit block's place."""
    from vitxtgqa_tpu_torch import Options
    from vitxtgqa_tpu_torch.parallel.mesh import Mesh, ModelGroup, PPGroup, SPGroup

    cfg, ranks, _ = slice_t_dry
    data, model, sp, pp = CS.MESH_PLANS[plan][1]
    shape = {"data": data, "model": model, "sp": sp, "pp": pp}
    for rank in ranks:
        got = rank[plan]["train" if train else "eval"]
        c = got["coords"]
        groups = dict(model=ModelGroup(None, c["model"], model),
                      sp=SPGroup(None, c["sp"], sp) if sp > 1 else None,
                      pp=PPGroup(None, c["pp"], pp) if pp > 1 else None)
        mesh = Mesh(shape=shape, coords=c, **groups)
        opts = Options(device="cpu", tp=groups["model"], sp=groups["sp"], pp=groups["pp"])
        counts = {n: got["counts"].get(n, 0) for n in CS.REPLACES}
        want = CS.expected_mesh_launches(cfg, got["rows"], opts, mesh, full_eval=not train,
                                         train=train, text_len=10, dec_len=4)
        assert counts == want, (plan, c)
        forms = (("block_train_fwd_tp", "block_train_bwd_tp") if train
                 else ("fused_block_tp",))
        assert all(want[f] > 0 for f in forms)
        assert not any(want[f] for f in ("fused_block", "block_train_fwd", "block_train_bwd"))
        if sp > 1:
            split = ("flash_attention", "flash_attention_bwd") if train else ("flash_attention",)
            assert all(want[f] > 0 for f in split) and want["flash_attention_merged"] == 0


def test_slice_t_holds_and_rejects_the_planted_faults(slice_t_dry):
    """tp_mesh_slice's dry run (four gloo ranks on the CPU, the tiny model at
    the production layer counts in float32): full-eval at model 2 x sp 2
    and model 2 x pp 2 equal to one process; the steps at model 2 x sp 2,
    model 2 x pp 2 and model 4 within float32 noise of the one-process
    step; a vocabulary lookup left unsummed and the pointer's scores left
    a partial each outside slice e's limits (mesh_train fails the run
    otherwise)."""
    dry = slice_t_dry[2]
    assert sorted(p for p in CS.T_PLANS if p in dry) == sorted(CS.T_PLANS)
    for plan in ("tsp", "tpp"):
        ev = dry[plan]["eval"]
        assert ev["token_agreement"] == 1.0 and max(ev["refneg_max_abs_diff"].values()) <= 1e-5
    for plan in CS.T_PLANS:
        step = dry[plan]["step"]
        assert step["loss_rel"] <= 1e-5 and step["grad_norm_rel"] <= 1e-5, plan
        assert step["max_grad_rel"] <= 1e-4, plan
    planted = dry["tsp"]["step"]["planted"]
    assert sorted(planted) == sorted(CS.VOCAB_FAULTS)
    for fault, r in planted.items():
        assert (r["loss_rel"] > CS.LOSS_REL_TOL or r["grad_norm_rel"] > CS.GNORM_REL_TOL
                or r["max_grad_rel"] > CS.GRAD_REL_TOL), fault
    assert "eval" not in dry["tp4"] and "planted" not in dry["tpp"]["step"]


def test_slice_t_plans():
    """Slice t's plans are one world of four ranks: model 2 x sp 2, model 2
    x pp 2 and model 4, each of data 1."""
    assert CS.T_PLANS == ("tsp", "tpp", "tp4")
    assert {CS.MESH_PLANS[p] for p in CS.T_PLANS} == {
        (4, (1, 2, 2, 1)), (4, (1, 2, 1, 2)), (4, (1, 4, 1, 1))}
    assert CS.slice_of("tsp") == "t" and CS.slice_of("dtp2") == "s" and CS.slice_of("dsp") == "r"
