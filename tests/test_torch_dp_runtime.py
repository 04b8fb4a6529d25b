"""The port's runtime under data parallelism on two gloo ranks against the
JAX trainer on a 2-device ``data`` mesh and the port in one process.

One set of ranks (tests/torch_dp_ranks.py, no JAX in them) runs ``run()``'s
trainer and CLI cases once, started by a module-scoped fixture in the
background while this process runs the JAX trainer; each test reads its
case.  CPU, float32, tiny widths, the fixture tree of
tests/test_torch_runtime.py, a global batch of 4 (2 rows a rank) and
``training_parameters.tpu.mesh.data=2`` (the JAX trainer's 2-device mesh;
one process: -1).  Limits as tests/test_torch_runtime.py's trajectory
test: each step's losses within rtol 1e-5, the validation metrics equal
and its losses within rtol 1e-5, the parameters as
tests/test_torch_dp.py holds them; every question predicted once; a
resumed run equal to an uninterrupted one bit for bit.
"""

import os

import jax
import numpy as np
import pytest
import torch

from tests import torch_dp_ranks
from tests.test_torch_dp import FRAMES, N_OCR, WORLD, _assert_params_close
from tests.test_torch_runtime import TRAIN3, _cli, fixroot, tiny_opts  # noqa: F401
from tests.test_torch_train import _patch_jax_gumbel, _tree_to_port
from tests.torch_helpers import one_torch_thread  # noqa: F401
from vitxtgqa_tpu.utils.torch_convert import convert_t2s_like, unflatten

# the runtime cases: global batch 4 over the two ranks, the mesh's data
# axis 2 for the ranks and the JAX trainer (one process: -1)
RUN_TP = dict(TRAIN3, batch_size=4)
MESH2, MESH1 = ["training_parameters.tpu.mesh.data=2"], ["training_parameters.tpu.mesh.data=-1"]


def _rank_cases(root, fixroot):
    save = lambda name: os.path.join(root, name)
    best = os.path.join(save("dp_run"), "ckpt", "best")
    resume_tp = dict(TRAIN3, batch_size=4, snapshot_interval=3)
    resume_argv = lambda name, **tp: (_cli_argv(fixroot, save(name), MESH2, dropout=True,
                                                **{**resume_tp, **tp}))
    return {
        "run": dict(kind="trainer", argv=_cli_argv(fixroot, save("dp_run"), MESH2),
                    noise=_run_noise(), reseed=True),
        "predict": dict(kind="run", argv=_cli(_repo(), "t2s_serving.yml", "inference")
                        + tiny_opts(fixroot, save("dp_predict"), batch_size=4) + MESH2
                        + [f"training_parameters.resume_file={best}"]),
        "straight": dict(kind="trainer", argv=resume_argv("straight", max_iterations=4),
                         reseed=True),
        "first": dict(kind="trainer", argv=resume_argv("first"), reseed=True),
        "resumed": dict(kind="trainer", argv=resume_argv("resumed", max_iterations=4) + [
            "training_parameters.resume_file="
            + os.path.join(save("first"), "ckpt", "best")]),
    }


def _repo():
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cli_argv(fixroot, save_dir, mesh, dropout=False, **tp):
    return (_cli(_repo()) + tiny_opts(fixroot, save_dir, dropout=dropout, **{**RUN_TP, **tp})
            + mesh)


def _run_noise():
    rng = np.random.default_rng(5)
    return (rng.gumbel(size=(4, 2, FRAMES)).astype(np.float32),
            rng.gumbel(size=(4, 2, N_OCR)).astype(np.float32))


@pytest.fixture(scope="module", autouse=True)
def ranks(tmp_path_factory, fixroot):
    """The two ranks, started in the background when the module starts;
    ``.results()`` waits for them.  Stopped at the module's end."""
    root = tmp_path_factory.mktemp("dp_runtime_ranks")
    r = torch_dp_ranks.start(_rank_cases(str(root), fixroot), root, world=WORLD)
    yield r
    for p in r.procs:
        if p.poll() is None:
            p.kill()
        p.wait()


def _series(meter, key):
    return list(meter[key].series)


def _port_run_one_process(repo_root, fixroot, save_dir, noise):
    """The port's trainer in one process on the same arguments (mesh data
    -1), its gumbel draws the global noise."""
    import random

    from tests.test_torch_runtime import _port_trainer
    from vitxtgqa_tpu_torch.training import trainer as T

    real = T.step_generators

    def gens(seed, step, device, group=None):
        return real(seed, step, device, group)[0], tuple(torch.from_numpy(n) for n in noise)

    T.step_generators = gens
    try:
        t = _port_trainer(repo_root, _cli_argv(fixroot, save_dir, MESH1))
        for ds in t.datasets.values():
            ds.rng = random.Random(13)
            ds.answer_processor.processor.rng = np.random.default_rng(7)
        t.train()
        t.close()
    finally:
        T.step_generators = real
    return t


def test_two_rank_run_matches_the_jax_trainer(repo_root, fixroot, tmp_path, ranks,
                                              monkeypatch):
    """run()'s trainer on two ranks (global batch 4, mesh data 2: three
    steps, the snapshot's validation and the final one) against the JAX
    BaseTrainer on a 2-device data mesh and the port in one process, from
    the same initial weights (the port's seeded init): each step's losses,
    the validation losses and metrics, the parameters after three steps.
    The ranks' series are equal."""
    import random

    import flax
    import vitxtgqa_tpu
    from tests.test_torch_runtime import SIX
    from vitxtgqa_tpu.core.config import build_config as jax_build
    from vitxtgqa_tpu.core.flags import get_parser as jax_parser
    from vitxtgqa_tpu.core.registry import registry as jax_registry
    from vitxtgqa_tpu.models.t2s import T2S as JT2S

    noise = _run_noise()
    _patch_jax_gumbel(monkeypatch, {n.shape: n for n in noise})
    one = _port_run_one_process(repo_root, fixroot, str(tmp_path / "one"), noise)

    vitxtgqa_tpu.setup_imports()

    def jit_init(self, rngs, batch, train=False):
        return jax.jit(lambda r, b: flax.linen.Module.init(self, r, b, train=train))(rngs, batch)

    monkeypatch.setattr(JT2S, "init", jit_init)
    argv = _cli_argv(fixroot, str(tmp_path / "jax"), MESH2)
    jargs = jax_parser().parse_args(argv)
    jt = jax_registry.get_trainer_class("base_trainer")(
        jax_build(jargs.config, opts=jargs.opts, args=jargs))
    jt.load()
    assert dict(jt.mesh.shape)["data"] == WORLD
    # the port's seeded init (the ranks' and the one-process trainer's)
    t0 = _port_trainer_init(repo_root, fixroot, tmp_path)
    jt.params = jax.device_put(
        unflatten(convert_t2s_like({k: v.copy() for k, v in t0.items()}, text_layers=1,
                                   qtv_layers=1, mmt_layers=1)), jt.param_sharding)
    jt.opt_state = jax.jit(jt.tx.init)(jt.params)
    for ds in jt.datasets.values():
        ds.rng = random.Random(13)
        ds.answer_processor.processor.rng = np.random.default_rng(7)
    jt.train()

    r0, r1 = (r["run"] for r in ranks.results())
    assert r0["series"] == r1["series"] and r0["iteration"] == 3
    for key in ("train/total_loss", "train/vtextgqa/pos_bce_loss", "train/vtextgqa/InfoNCE"):
        got = r0["series"][key]
        assert len(got) == 3, key
        np.testing.assert_allclose(got, _series(one.meter, key), rtol=1e-5, err_msg=key)
        np.testing.assert_allclose(got, _series(jt.meter, key), rtol=1e-5, err_msg=key)
    vals = [k for k in jt.meter.meters if k.startswith("val/")]
    assert sorted(vals) == sorted(k for k in r0["series"] if k.startswith("val/"))
    assert {f"val/vtextgqa/{t}" for t in SIX} <= set(vals)
    for key in vals:
        got = r0["series"][key]
        for ref in (_series(one.meter, key), _series(jt.meter, key)):
            if "loss" in key or "InfoNCE" in key:
                np.testing.assert_allclose(got, ref, rtol=1e-5, err_msg=key)
            else:
                assert got == ref, key
    want = _tree_to_port(jax.tree_util.tree_map(np.asarray, jt.params))
    assert all(np.array_equal(r0["state"][k], r1["state"][k]) for k in r0["state"])
    got = {k: r0["state"][k] for k in want}
    one_state = {k: v.detach().numpy() for k, v in one.model.state_dict().items() if k in want}
    lr = float(jt.config.optimizer_attributes.params.lr)
    _assert_params_close(got, want, t0, lr)
    _assert_params_close(got, one_state, t0, lr)
    assert r0["writes"] > 0 and r1["writes"] == 0


def _port_trainer_init(repo_root, fixroot, tmp_path):
    """The seeded initial weights of the trainers of these arguments."""
    from tests.test_torch_runtime import _port_trainer

    t = _port_trainer(repo_root, _cli_argv(fixroot, str(tmp_path / "init"), MESH1))
    return {k: v.detach().numpy().copy() for k, v in t.model.state_dict().items()}


def test_two_rank_predictions_list_each_question_once(ranks):
    """configs/t2s_serving.yml predicting the test split on two ranks from
    the two-rank run's ckpt/best: rank 0 writes one report, a row per
    question (6 over batches of 4: the padded last batch's copies and the
    sampler's wrap-around rows left out); rank 1 writes nothing, neither
    checkpoints nor reports."""
    r0, r1 = (r["predict"] for r in ranks.results())
    (rows,) = r0["reports"].values()
    qids = [row["question_id"] for row in rows]
    assert len(qids) == len(set(qids)) == r0["rows"] == 6
    assert r1["reports"] == {} and r0["writes"] == r1["writes"] == 0


def test_two_rank_predictions_go_over_the_bf16_cache(repo_root, tmp_path, ranks):
    """configs/t2s_serving.yml (the int8 cache on) predicting on two ranks:
    the data mesh turns the int8 cache off, as the JAX trainer does on its
    data mesh, and rank 0's report equals, row for row, one process
    predicting over the bf16 cache from the same checkpoint (the answers,
    grounded frames and sources equal, the boxes within 1e-5)."""
    import pickle

    from vitxtgqa_tpu_torch.run import run

    r0, r1 = (r["predict"] for r in ranks.results())
    assert not r0["kv_cache_int8"] and not r1["kv_cache_int8"]
    with open(os.path.join(ranks.directory, "cases.pkl"), "rb") as f:
        argv = pickle.load(f)["predict"]["argv"]
    argv = [o for o in argv if o not in MESH2 and "save_dir" not in o] + MESH1 + [
        f"training_parameters.save_dir={tmp_path / 'one'}",
        "training_parameters.tpu.kv_cache_int8=False"]
    t = run(argv)
    assert not t.opts.kv_cache_int8
    (got,), (want,) = r0["reports"].values(), torch_dp_ranks._reports(t.logger.save_dir).values()
    assert len(got) == len(want) == 6
    by_q = {row["question_id"]: row for row in want}
    for row in got:
        ref = by_q[row["question_id"]]
        for k in ("video_id", "answer", "grounded frame", "pred_source"):
            assert row[k] == ref[k], k
        np.testing.assert_allclose(row["grounded box"], ref["grounded box"], atol=1e-5)


def test_a_resumed_two_rank_run_equals_an_uninterrupted_one(ranks):
    """Four steps straight on two ranks (dropout on) against three, a
    snapshot and a resume from it for the fourth: the fourth step's loss and
    the parameters equal bit for bit, on both ranks."""
    for rank, r in enumerate(ranks.results()):
        straight, first, resumed = r["straight"], r["first"], r["resumed"]
        got, want = resumed["series"]["train/total_loss"], straight["series"]["train/total_loss"]
        assert len(first["series"]["train/total_loss"]) == 3, rank
        assert len(got) == 1 and len(want) == 4 and got[0] == want[3], rank
        assert sorted(resumed["final"]) == sorted(straight["final"])
        assert all(np.array_equal(resumed["final"][k], straight["final"][k])
                   for k in straight["final"]), rank
    assert ranks.results()[1]["straight"]["writes"] == 0
