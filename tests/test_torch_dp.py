"""The port under data parallelism on two gloo ranks against the port in
one process and the JAX package on a 2-device ``data`` mesh: the loader's
rank slices, the training step, the entry point and the pieces (the
runtime on two ranks: tests/test_torch_dp_runtime.py).

One set of ranks (tests/torch_dp_ranks.py, no JAX in them) runs every rank
case of this module once, started by a module-scoped fixture in the
background while this process computes the references; each test reads its
case.  The JAX reference runs in this process on 2 of the 8 virtual CPU
devices of tests/conftest.py, its batch sharded over ``data``.  CPU,
float32, tiny widths; inputs, weights and gumbel noise are made here with
numpy (the port's seeded init for the weights, converted to the JAX tree).

Limits: each step's loss within rtol 1e-5, as tests/test_torch_train.py
holds the one-process port to JAX; the parameters after three Adam steps
within 1e-3 of the learning rate (one step's scale) plus 1e-3 relative,
each tensor's change alike in direction and size (a key projection's
bias, whose gradient is float32 noise, held small).  The loaders' rank
slices against the JAX package's ``EpochSampler`` and
``DataLoader(rank, world_size)`` exactly.
"""

import ast
import copy
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tests import torch_dp_ranks
from tests.test_torch_runtime import fixroot  # noqa: F401
from tests.test_torch_train import (
    _no_dropout_config,
    _patch_jax_gumbel,
    _tree_to_port,
)
from tests.torch_helpers import cpu_options, one_torch_thread  # noqa: F401
from vitxtgqa_tpu.utils.synthetic import synthetic_batch
from vitxtgqa_tpu.utils.torch_convert import convert_t2s_like, unflatten
from vitxtgqa_tpu_torch.models.t2s import T2S

WORLD = 2
FRAMES, OCR_PF, DEC_STEPS = 8, 3, 4
N_OCR = FRAMES * OCR_PF
NF = 32 + N_OCR
GLOBAL = 4   # the global batch of the step cases: 2 rows a rank
LOSSES = [{"type": "pos_bce_loss", "weight": 1.0}, {"type": "InfoNCE", "weight": 1000}]
OA = {"type": "Adam", "params": {"lr": 1e-3, "eps": 1e-8, "weight_decay": 0}}
TP = {"clip_gradients": True, "max_grad_l2_norm": 0.25, "lr_scheduler": True, "lr_steps": [2],
      "lr_ratio": 0.1, "use_warmup": True, "warmup_factor": 0.2, "warmup_iterations": 1}
STEPS = 3


def _ns(d):
    import types

    return types.SimpleNamespace(**d)


def _step_batch(seed=3):
    """The global batch of the step cases; odd rows keep one active decode
    step of three, so that rank 0 counts 6 active steps and rank 1 2."""
    batch = synthetic_batch(batch=GLOBAL, frames=FRAMES, ocr_per_frame=OCR_PF,
                            dec_steps=DEC_STEPS, text_len=10, video_feat_dim=32, fasttext_dim=16,
                            phoc_dim=24, num_final_outputs=NF, text_vocab=128, seed=seed)
    batch["train_loss_mask"][1::2, 1:] = 0.0
    return batch


def _step_noise(b=GLOBAL):
    rng = np.random.default_rng(5)
    return {(b, 2, FRAMES): rng.gumbel(size=(b, 2, FRAMES)).astype(np.float32),
            (b, 2, N_OCR): rng.gumbel(size=(b, 2, N_OCR)).astype(np.float32)}


def _init_state(cfg):
    model = T2S(cfg, NF, bos_idx=2, opts=cpu_options()).init_weights(0)
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def _plain(node):
    if hasattr(node, "items"):
        return {k: _plain(v) for k, v in node.items()}
    return node


def _rank_cases():
    cfg = _plain(_no_dropout_config(OCR_PF, 64))
    state = _init_state(cfg)
    batch = _step_batch()
    common = dict(cfg=cfg, nf=NF, state=state, batch=batch, losses=LOSSES)
    dropout_cfg = copy.deepcopy(cfg)
    for sect in ("text_bert", "translayers", "mmt", "encoder"):
        dropout_cfg[sect].update(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
    rows = {k: v[:2] for k, v in batch.items()}
    return {
        "steps": dict(kind="steps", steps=STEPS, noise=_step_noise(), oa=OA, tp=TP, **common),
        "generators": dict(kind="generators", seed=7, **common),
        "nan": dict(kind="generators", seed=7, nan_rank=1, **common),
        "dropout": dict(kind="dropout", seed=7, rows=rows,
                        **{**common, "cfg": dropout_cfg}),
    }


@pytest.fixture(scope="module", autouse=True)
def ranks(tmp_path_factory):
    """The two ranks, started in the background when the module starts;
    ``.results()`` waits for them.  Stopped at the module's end."""
    root = tmp_path_factory.mktemp("dp_ranks")
    r = torch_dp_ranks.start(_rank_cases(), root, world=WORLD)
    yield r
    for p in r.procs:
        if p.poll() is None:
            p.kill()
        p.wait()


# ---------------------------------------------------------------------------
# the loader's rank slices
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("shuffle", [True, False])
def test_sampler_rank_slices_equal_the_jax_samplers(world, shuffle):
    """The epoch's order is the JAX EpochSampler's at world size 1, and a
    rank loader's real rows over an epoch (one row a batch, the last batch
    padded) are the JAX EpochSampler(rank, world_size)'s indices, its
    wrap-around copies left out: at 10 and 7 samples (neither a multiple of
    3, 7 none of 2), over two epochs."""
    from vitxtgqa_tpu.data.loader import EpochSampler as JSampler
    from vitxtgqa_tpu_torch.data.loader import DataLoader, EpochSampler

    for n in (10, 7):
        one, whole = EpochSampler(n, shuffle=shuffle, seed=3), JSampler(n, shuffle=shuffle, seed=3)
        loaders = [DataLoader(_Indices(n), batch_size=1, shuffle=shuffle, seed=3, pad_last=True,
                              rank=rank, world_size=world) for rank in range(world)]
        for epoch in (0, 1):
            for x in [one, whole] + loaders:
                x.set_epoch(epoch)
            assert one.indices() == whole.indices(), (n, epoch)
            for rank, loader in enumerate(loaders):
                want = JSampler(n, shuffle=shuffle, seed=3, rank=rank, world_size=world)
                want.set_epoch(epoch)
                got = [int(q) for bt in loader
                       for q in bt["tensors"]["question_id"][:bt["host"]["n_valid"]]]
                assert got == want.indices()[:len(range(rank, n, world))], (n, rank, epoch)


class _Indices:
    """A dataset whose sample is its index (no draws)."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"question_id": np.int64(i), "image_id": f"v{i}"}


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("form", ["train", "val"])
def test_loader_rank_batches_equal_the_jax_loaders(world, form):
    """DataLoader(rank, world_size) against the JAX package's at n = 13 (no
    multiple of 2 or 3) and 2 rows a rank: every rank yields the same
    number of batches; each batch's real rows (n_valid, the rank's
    positions below n) are the JAX rank loader's; the union of the ranks'
    j-th batches is the one-process j-th global batch.  Training
    (drop_last) yields the one-process count of batches, where the JAX
    multi-host loader may yield one more, holding wrap-around copies."""
    from vitxtgqa_tpu.data.loader import DataLoader as JLoader
    from vitxtgqa_tpu_torch.data.loader import DataLoader, merge_rows

    n, b = 13, 2
    kw = (dict(shuffle=True, seed=5, drop_last=True) if form == "train"
          else dict(shuffle=False, drop_last=False, pad_last=True))
    ds = _Indices(n)
    one = [list(bt["tensors"]["question_id"][:bt["host"]["n_valid"]])
           for bt in DataLoader(ds, batch_size=b * world, **kw)]
    per_rank = []
    for rank in range(world):
        got = list(DataLoader(ds, batch_size=b, rank=rank, world_size=world, **kw))
        want = list(JLoader(ds, batch_size=b, rank=rank, world_size=world, **kw))
        assert len(got) == len(one) and len(want) in (len(got), len(got) + 1)
        for g, w in zip(got, want):
            k = g["host"]["n_valid"]
            real = list(g["tensors"]["question_id"][:k])
            assert real == list(w["tensors"]["question_id"][:k])
            assert g["tensors"]["question_id"].shape == (b,)
        per_rank.append([list(g["tensors"]["question_id"][:g["host"]["n_valid"]]) for g in got])
    for j, rows in enumerate(one):
        assert merge_rows([r[j] for r in per_rank]) == rows, j
    flat = [q for rows in one for q in rows]
    assert len(flat) == len(set(flat)) == (n if form == "val" else n // (b * world) * b * world)


@pytest.mark.parametrize("workers", [0, 1])
def test_rank_batches_are_the_one_process_rows(repo_root, fixroot, workers):
    """On the fixture train and val splits, two epochs: rank r's batches are
    rows r, r + 2 of the one-process loader's global batches bit for bit,
    draws included (no workers: each rank assembles the global batch in
    order, and carries the one-process generator state; workers: each
    sample seeded by its index), and the val split's padded last batch
    counts only its real rows."""
    from tests.test_torch_runtime import _datasets
    from vitxtgqa_tpu_torch.data.loader import DataLoader, infinite_batches

    for split, kw in (("train", dict(shuffle=True, seed=13, drop_last=True)),
                      ("val", dict(shuffle=False, drop_last=False, pad_last=True))):
        one_ds, _ = _datasets(repo_root, fixroot, split)
        one = DataLoader(one_ds, batch_size=4, num_workers=workers, **kw)
        loaders = [one]
        for rank in range(WORLD):
            ds, _ = _datasets(repo_root, fixroot, split)
            loaders.append(DataLoader(ds, batch_size=2, num_workers=workers, rank=rank,
                                      world_size=WORLD, **kw))
        try:
            its = [infinite_batches(ld) for ld in loaders]
            for _ in range(2 * len(one)):
                want, *got = [next(it) for it in its]
                for rank, g in enumerate(got):
                    for k, v in want["tensors"].items():
                        assert np.array_equal(g["tensors"][k], v[rank::WORLD]), (split, k)
                    assert g["host"]["n_valid"] == len(range(rank, want["host"]["n_valid"],
                                                             WORLD))
                    if workers == 0:
                        assert g["host"]["data_rng"] == want["host"]["data_rng"]
        finally:
            for ld in loaders:
                ld.close()
        assert [ld.__len__() for ld in loaders] == [len(one)] * 3


def test_a_loader_of_ranks_needs_drop_or_pad():
    from vitxtgqa_tpu_torch.data.loader import DataLoader

    with pytest.raises(ValueError, match="drops or pads"):
        DataLoader(_Indices(5), batch_size=2, rank=0, world_size=2)


# ---------------------------------------------------------------------------
# the training step
# ---------------------------------------------------------------------------


def _jax_steps(monkeypatch, cfg, state, batch, noise, steps):
    """The JAX T2S step (value_and_grad, the optax chain of JAX's
    build_optimizer) on a 2-device data mesh, the batch sharded over it:
    each step's loss, and the parameters after."""
    from vitxtgqa_tpu.losses import Losses as JLosses
    from vitxtgqa_tpu.models.t2s import T2S as JT2S
    from vitxtgqa_tpu.training.optim import build_optimizer as jax_build

    _patch_jax_gumbel(monkeypatch, noise)
    jm = JT2S(config=cfg, num_final_outputs=NF, bos_idx=2, train_variant_scan=True)
    jlosses = JLosses(LOSSES)
    tx, _ = jax_build(_ns(OA), _ns(TP), cfg)
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))
    params = unflatten(convert_t2s_like({k: v.copy() for k, v in state.items()}, text_layers=1,
                                        qtv_layers=1, mmt_layers=2))
    params = jax.device_put(params, NamedSharding(mesh, P()))
    opt_state = tx.init(params)
    sharded = jax.device_put(batch, NamedSharding(mesh, P("data")))

    @jax.jit
    def step(params, opt_state, tensors):
        def loss_fn(p):
            out = jm.apply({"params": p}, tensors, train=True,
                           rngs={"dropout": jax.random.key(1), "gumbel": jax.random.key(2)})
            return jlosses.total(tensors, out)[0]

        total, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return jax.tree_util.tree_map(lambda p, u: p + u, params, updates), opt_state, total

    totals = []
    for _ in range(steps):
        params, opt_state, total = step(params, opt_state, sharded)
        totals.append(float(total))
    return totals, _tree_to_port(jax.tree_util.tree_map(np.asarray, params))


def _port_steps(cfg, state, batch, noise, steps):
    """The port in one process on the global batch."""
    from vitxtgqa_tpu_torch.losses import Losses
    from vitxtgqa_tpu_torch.training.optim import build_optimizer
    from vitxtgqa_tpu_torch.training.step import train_step

    model = T2S(cfg, NF, bos_idx=2, opts=cpu_options())
    model.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in state.items()})
    opt = build_optimizer(model, _ns(OA), _ns(TP), cfg)
    tensors = {k: torch.as_tensor(v) for k, v in batch.items()}
    gumbel = tuple(torch.from_numpy(noise[(GLOBAL, 2, n)]) for n in (FRAMES, N_OCR))
    losses = [float(train_step(model, Losses(LOSSES), opt, tensors,
                               (torch.Generator().manual_seed(0), gumbel))["loss"])
              for _ in range(steps)]
    return losses, {k: v.detach().numpy() for k, v in model.state_dict().items()}


def _assert_params_close(got, want, init, lr):
    """The parameters after a few Adam steps: each entry within 1e-3 of the
    learning rate (the scale of one step) plus 1e-3 relative, and each
    tensor's change alike in direction and size (tests/test_torch_runtime.
    py's test); a key projection's bias, whose gradient is float32 noise
    (softmax is shift-invariant), held to stay that small.  (Adam moves an
    entry with a near-zero gradient by a step of either size: an entry of
    a bias 100 times below its tensor's largest can differ by a percent,
    as the one-process port's does from JAX's.)"""
    noise = [k for k in want if k.endswith("attention.self.key.bias")]
    assert noise and all(max(abs(got[k]).max(), abs(want[k]).max()) < 1e-2 * lr for k in noise)
    for k in want:
        if k not in noise:
            np.testing.assert_allclose(got[k], want[k], atol=1e-3 * lr, rtol=1e-3, err_msg=k)
    for k in want:
        g, w = (got[k] - init[k]).ravel(), (want[k] - init[k]).ravel()
        if k in noise or not np.any(w):
            continue
        cos = float(g @ w / (np.linalg.norm(g) * np.linalg.norm(w)))
        ratio = float(np.linalg.norm(g) / np.linalg.norm(w))
        assert cos > 0.999 and abs(ratio - 1) < 1e-3, (k, cos, ratio)


def test_two_rank_steps_equal_one_process_and_jax(ranks, monkeypatch):
    """Three clipped, scheduled Adam steps on two ranks (2 rows each, the
    ranks' active decode steps 6 and 2) against the port in one process and
    the JAX step on a 2-device data mesh on the global batch of 4: each
    step's loss and the parameters after.  Both ranks report the global
    loss and hold the same parameters.  A mean of the ranks' own pos-BCE
    ratios would be another loss."""
    cfg = _no_dropout_config(OCR_PF, 64)
    batch, noise = _step_batch(), _step_noise()
    state = _init_state(_plain(cfg))
    want_losses, want = _jax_steps(monkeypatch, cfg, state, batch, noise, STEPS)
    one_losses, one = _port_steps(_plain(cfg), state, batch, noise, STEPS)
    r0, r1 = (r["steps"]["steps"] for r in ranks.results())
    assert r0 == r1 and all(s["applied"] for s in r0)
    got = [s["loss"] for s in r0]
    np.testing.assert_allclose(got, one_losses, rtol=1e-5)
    np.testing.assert_allclose(got, want_losses, rtol=1e-5)
    g0, g1 = (ranks.results()[r]["steps"]["state"] for r in range(WORLD))
    assert all(np.array_equal(g0[k], g1[k]) for k in g0)
    _assert_params_close(g0, one, state, OA["params"]["lr"])
    _assert_params_close(g0, want, state, OA["params"]["lr"])
    counts = [batch["train_loss_mask"][r::WORLD].sum() for r in range(WORLD)]
    assert counts[0] != counts[1]

    from vitxtgqa_tpu_torch.losses import pos_bce_loss as terms

    def pos_bce_loss(tensors, out):
        num, den = terms(tensors, out)
        return num / den.clamp_min(1.0)

    model = T2S(_plain(cfg), NF, bos_idx=2, opts=cpu_options())
    model.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in state.items()})
    tensors = {k: torch.as_tensor(v) for k, v in batch.items()}
    gumbel = tuple(torch.from_numpy(noise[(GLOBAL, 2, n)]) for n in (FRAMES, N_OCR))
    with torch.no_grad():
        out = model(tensors, gumbel, train=True)
    whole = float(pos_bce_loss(tensors, out))
    ratios = [float(pos_bce_loss({k: v[r::WORLD] for k, v in tensors.items()},
                                 {"pos_scores": out["pos_scores"][r::WORLD]}))
              for r in range(WORLD)]
    # (a mean of ratios: 100 times the step's loss limit away)
    assert abs(sum(ratios) / WORLD - whole) > 100 * 1e-5 * abs(whole)
    assert abs(r0[0]["parts"]["vtextgqa/pos_bce_loss"] - whole) <= 1e-5 * abs(whole)


def test_the_step_generators_draw_the_one_process_gumbel_noise(ranks):
    """A step with step_generators(seed, 0, "cpu", group) (every dropout
    0): the gumbel draws of each rank are its rows of the one-process
    draws at the global batch, so the loss and the gradient norm are the
    one-process step's."""
    from vitxtgqa_tpu_torch.losses import Losses
    from vitxtgqa_tpu_torch.training.optim import build_optimizer
    from vitxtgqa_tpu_torch.training.step import step_generators, train_step

    cfg = _plain(_no_dropout_config(OCR_PF, 64))
    state = _init_state(cfg)
    model = T2S(cfg, NF, bos_idx=2, opts=cpu_options())
    model.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in state.items()})
    r = train_step(model, Losses(LOSSES), build_optimizer(model, model_config=cfg),
                   {k: torch.as_tensor(v) for k, v in _step_batch().items()},
                   step_generators(7, 0, "cpu"))
    got = [x["generators"] for x in ranks.results()]
    assert got[0]["loss"] == got[1]["loss"] and got[0]["applied"]
    np.testing.assert_allclose(got[0]["loss"], float(r["loss"]), rtol=1e-5)
    np.testing.assert_allclose(got[0]["norm"], float(r["grad_norm"]), rtol=1e-4)


def test_a_non_finite_loss_on_one_rank_skips_the_update_on_both(ranks):
    """NaN features on rank 1 alone: the global loss is NaN on both ranks,
    and both skip the update (no count, the parameters as they were, the
    gradients dropped)."""
    for rank, r in enumerate(ranks.results()):
        got = r["nan"]
        assert not got["applied"] and got["count"] == 0, rank
        assert np.isnan(got["loss"]) and got["unchanged"] and got["grads_dropped"], rank


def test_the_ranks_dropout_masks_differ(ranks):
    """The same two rows on both ranks with dropout 0.1: the dropout
    streams fold in the rank, so the ranks' scores differ; in one process
    the same generators give the same scores twice."""
    from vitxtgqa_tpu_torch.training.step import step_generators

    got = [r["dropout"]["pos_scores"] for r in ranks.results()]
    assert not np.allclose(got[0], got[1])
    a, b = (step_generators(7, 0, "cpu")[0].initial_seed() for _ in range(2))
    assert a == b


# ---------------------------------------------------------------------------
# the runtime
# ---------------------------------------------------------------------------


def test_dryrun_multichip_on_two_ranks():
    """entry.dryrun_multichip(2, device="cpu"): two spawned gloo ranks take
    the T2S step on JAX's default mesh of two devices (model 2), held to the
    one-process step."""
    from vitxtgqa_tpu_torch.entry import DRYRUN_LIMITS, dryrun_multichip

    out = dryrun_multichip(2, device="cpu")
    loss_tol, norm_tol, tol, update_tol = DRYRUN_LIMITS["cpu"]
    assert out["ranks"] == 2 and out["loss_rel"] <= loss_tol and out["norm_rel"] <= norm_tol
    assert out["grad_rel"][0] <= tol and out["update_rel"][0] <= update_tol


@pytest.mark.parametrize("kw, err, words", [
    (dict(model=2, sp=2), ValueError, "model=2 x sp=2 x pp=1 needs a multiple of 4 processes"),
    (dict(pp=4), ValueError, "sp=1 x pp=4 needs a multiple of 4 processes; the world has 2"),
    (dict(sp=4), ValueError, "sp=4 x pp=1 needs a multiple of 4 processes; the world has 2")])
def test_dryrun_multichip_refuses_the_unported_axes(kw, err, words):
    """The model, sp and pp axes run (tests/test_torch_mesh.py,
    tests/test_torch_tp_mesh.py) and raise, before any rank starts, for a
    world too small for them: model x sp, pp or sp alone on two ranks."""
    from vitxtgqa_tpu_torch.entry import dryrun_multichip

    with pytest.raises(err, match=words):
        dryrun_multichip(2, device="cpu", **kw)


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------


def test_tiny_model_config_is_the_jax_packages():
    from vitxtgqa_tpu.utils.synthetic import tiny_model_config as jax_tiny
    from vitxtgqa_tpu_torch.utils.synthetic import tiny_model_config

    assert _plain(tiny_model_config(hidden=96, frames=4)) == _plain(jax_tiny(hidden=96, frames=4))


def test_rank_rows_draws_the_global_noise():
    """RankRows over a generator: rank r's draw is rows r::size of the
    one-process draw at the global shape, for each kind."""
    from vitxtgqa_tpu_torch.ops.gumbel import RankRows, sample

    for kind in ("gumbel", "normal", "uniform"):
        whole = sample(torch.Generator().manual_seed(3), (6, 5), kind)
        for r in range(3):
            got = RankRows(torch.Generator().manual_seed(3), r, 3)((2, 5), kind)
            assert torch.equal(got, whole[r::3]), (kind, r)


def test_merge_rows_restores_the_global_order():
    from vitxtgqa_tpu_torch.data.loader import merge_rows

    assert merge_rows([[0, 2, 4], [1, 3]]) == [0, 1, 2, 3, 4]
    assert merge_rows([[0, 3], [1], [2]]) == [0, 1, 2, 3]
    assert merge_rows([[], []]) == []


def _launch_sites(path):
    """(function, launched entry, whether under ``torch.cuda.device(...)``,
    the stream argument's source) of every ``_build.lib().vt_*(...)`` call
    in ``path`` that passes a stream."""
    tree = ast.parse(open(path).read())
    out = []

    def visit(node, fn, guarded):
        if isinstance(node, ast.FunctionDef):
            fn = node.name
        if isinstance(node, ast.With) and any(
                ast.unparse(item.context_expr).startswith("torch.cuda.device(")
                for item in node.items):
            guarded = True
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr.startswith("vt_")
                and ast.unparse(node.func.value) == "_build.lib()"):
            streams = [ast.unparse(a) for a in node.args if "stream_of" in ast.unparse(a)]
            out.append((fn, node.func.attr, guarded, streams))
        for child in ast.iter_child_nodes(node):
            visit(child, fn, guarded)

    visit(tree, None, False)
    return out


def test_every_kernel_launches_on_its_tensors_device_and_stream(repo_root):
    """A rank's tensors sit on cuda:LOCAL_RANK: every kernel launch of the
    wrappers runs under torch.cuda.device(its tensor's device) and on that
    device's current stream (_build.stream_of(tensor)); the two plan
    queries (the decode attention's occupancy, the epilogue's grid) read
    the current device, which run.py's init_world sets."""
    ops = os.path.join(repo_root, "vitxtgqa_tpu_torch", "ops")
    queries = {"vt_decode_attention_clusters", "vt_fused_epilogue_grid", "vt_error_string"}
    seen = 0
    for name in sorted(os.listdir(ops)):
        if not name.endswith(".py"):
            continue
        for fn, entry, guarded, streams in _launch_sites(os.path.join(ops, name)):
            if entry in queries:
                continue
            seen += 1
            assert guarded and len(streams) == 1, (name, fn, entry)
    assert seen >= 17


def test_the_answer_table_gathers_in_float32_for_its_backward():
    """The teacher-forced pass gathers its decoder slots' answer rows from
    the float32 LayerNormed table (PrevPredEmbeddings.tables(...,
    float32_answers=True)), so the gather's backward adds the batch's many
    contributions to a row in float32: in bf16 they round at every add,
    and a rank's partial sums then differ from the whole batch's by
    percents (the difference slice o found on the card).  The gradients of
    the classifier table and the answer LayerNorm's scale, bf16 modules,
    against float64: within 5e-3 from the float32 gather, more than 1e-2
    from the bf16 one; the forward equal bit for bit."""
    from vitxtgqa_tpu_torch.models.common import PrevPredEmbeddings, TransformerConfig

    d, v, b, s = 64, 50, 48, 12

    def grads(float32_answers, dtype=torch.bfloat16):
        ppe = PrevPredEmbeddings(TransformerConfig(hidden_size=d, hidden_dropout_prob=0.0))
        with torch.no_grad():
            for i, p in enumerate(ppe.parameters()):
                p.copy_(torch.randn(p.shape, generator=torch.Generator().manual_seed(i)) * 0.5)
        ppe = ppe.to(dtype)
        table = torch.nn.Parameter(torch.randn(v, d, generator=torch.Generator().manual_seed(7)))
        ocr = torch.randn(b, 10, d, generator=torch.Generator().manual_seed(8)).to(dtype)
        prev = torch.zeros(b, s, dtype=torch.long)
        prev[:, 1] = 3
        cot = torch.randn(b, s, d, generator=torch.Generator().manual_seed(9)).to(dtype)
        ans, ocr_t = ppe.tables(table, ocr, float32_answers=float32_answers)
        out = ppe.embed(ans, ocr_t, prev)
        (out.float() * cot.float()).sum().backward()
        return table.grad.double(), ppe.ans_layer_norm.weight.grad.double(), out.detach()

    want_table, want_scale, _ = grads(True, torch.float64)
    rel = lambda g, w: float((g - w).norm() / w.norm())
    t32, s32, out32 = grads(True)
    t16, s16, out16 = grads(False)
    assert torch.equal(out32, out16)
    assert rel(t32, want_table) < 5e-3 and rel(s32, want_scale) < 5e-3
    assert rel(t16, want_table) > 1e-2 and rel(s16, want_scale) > 1e-2
