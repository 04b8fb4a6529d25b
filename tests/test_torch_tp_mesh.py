"""The mesh's model axis beside sp and pp: model x sp and model x pp steps
and full-eval on gloo ranks against JAX's step on the same mesh of CPU
devices and the port in one process, a checkpoint written on a model x pp
mesh restored whole in one process, and the encoder on the whole data x
model x sp x pp mesh.

Two worlds of ranks (tests/torch_tp_ranks.py, no JAX in them) run every
rank case of this module once, started by a module fixture in the
background while this process computes the references: four ranks for
model 2 x sp 2 (the step, full-eval) and model 2 x pp 2 (the step and its
checkpoint), eight for the encoder at model 2 x sp 2 x pp 2.  CPU,
float32, tiny widths; inputs, weights and gumbel noise made here with
numpy (tests/test_torch_tp.py's).

JAX's references run in this process on CPU devices under jit, with its
sequence parallelism and pipeline switched on where the mesh has those
axes, as its trainer does.  JAX's shard_map sequence parallelism inside
its pipeline does not lower ("Cannot lower jaxpr with verifier errors" at
the shard_map, at sp 2 x pp 2 with or without a model axis), so the
encoder's reference on JAX's eight-device mesh runs the model sharding and
the pipeline, and the one-device encoder beside it.

Limits (tests/test_torch_tp.py's): the steps' loss within rtol 1e-5, the
norm 1e-4, each applied gradient and parameter after within 1e-4 of its
tensor's largest entry; full-eval's tokens equal and its scores within
2e-5; the encoder's outputs within 2e-5, its gradients within 1e-4 of
their tensor's largest entry; the shards of every sp or pp replica equal
bit for bit; the checkpoint's state equal bit for bit to the ranks' shards
concatenated.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_tp_ranks
from tests.test_torch_dp import NF, OA
from tests.test_torch_dp import TP as TRAIN
from tests.test_torch_mesh import _step_config
from tests.test_torch_tp import (_check_step, _eval_inputs, _jax_eval, _jax_mesh_step,
                                 _port_step, _rel_close, _step_case, _tp_step_inputs)
from tests.torch_helpers import cpu_options, fast_jit, one_torch_thread  # noqa: F401
from vitxtgqa_tpu.models import common as JC
from vitxtgqa_tpu.ops.masks import MaskSpec as JMaskSpec
from vitxtgqa_tpu_torch.utils.convert import bert_layer_entries, convert_entries
from vitxtgqa_tpu.utils.torch_convert import flatten

FWD_TOL, GRAD_TOL = 2e-5, 1e-4
# (data, model, sp, pp) of the steps on world "a"
MESHES = {"model_sp": (1, 2, 2, 1), "model_pp": (1, 2, 1, 2)}
# the encoder on the whole mesh (world "b"): lane-aligned widths, 2 layers
# (one a stage), every dropout 0 (sequence parallelism and the pipeline
# both take it), 256 keys with an 8-slot causal tail; 4 rows, 2 microbatches
ENC_MESH = (1, 2, 2, 2)
ENC_CFG = dict(hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
               intermediate_size=256, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
ENC_B, ENC_L, ENC_DEC = 4, 256, 8


@functools.lru_cache(maxsize=None)
def _encoder_inputs():
    """The encoder's JAX params, their port state, input, key mask and
    cotangent."""
    rng = np.random.default_rng(31)
    jcfg = JC.TransformerConfig(**ENC_CFG)
    x = (rng.standard_normal((ENC_B, ENC_L, 128)) * 0.5).astype(np.float32)
    km = np.ones((ENC_B, ENC_L), np.float32)
    km[1, 150:] = 0.0
    km[3, 90:] = 0.0
    km[:, ENC_L - ENC_DEC:] = 0.0
    shapes = jax.eval_shape(JC.TransformerEncoder(jcfg).init, jax.random.key(0), jnp.asarray(x),
                            JMaskSpec(key_mask=jnp.asarray(km), dec_len=ENC_DEC))["params"]

    def draw(path, s):
        name = path[-1].key
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        return (rng.standard_normal(s.shape) * (0.02 if name == "bias" else 0.08)).astype(
            np.float32)

    params = jax.tree_util.tree_map_with_path(draw, shapes)
    state = {k: v.numpy() for k, v in _to_port(params).items()}
    g = rng.standard_normal(x.shape).astype(np.float32)
    return params, state, x, km, g


def _to_port(tree):
    entries = [e for i in range(ENC_CFG["num_hidden_layers"])
               for e in bert_layer_entries("", "", i)]
    return convert_entries(flatten(jax.tree_util.tree_map(np.asarray, tree)), entries)


@pytest.fixture(scope="module", autouse=True)
def worlds(tmp_path_factory):
    """World "a" (four ranks: the model x sp and model x pp steps, the
    model x sp full-eval) and world "b" (eight ranks: the encoder on the
    whole mesh); ``[w].results()`` waits for world w."""
    root = tmp_path_factory.mktemp("tp_mesh_ranks")
    _, state, x, km, g = _encoder_inputs()
    cfg, e_state, e_batch, e_noise = _eval_inputs()
    a = {name: {**_step_case(mesh, _step_config(), 0),
                **({"ckpt": str(root / "ckpt")} if name == "model_pp" else {})}
         for name, mesh in MESHES.items()}
    a["eval"] = dict(kind="eval", mesh=MESHES["model_sp"], cfg=cfg, nf=NF, state=e_state,
                     batch=e_batch, noise=e_noise)
    b = {"encoder": dict(kind="encoder", mesh=ENC_MESH, cfg=ENC_CFG, state=state, x=x,
                         key_mask=km, g=g, dec_len=ENC_DEC, drop_seed=None)}
    out = {}
    for w, cases, n in (("a", a, 4), ("b", b, 8)):
        os.makedirs(root / w)
        out[w] = torch_tp_ranks.start(cases, root / w, world=n)
    out["root"] = root
    yield out
    for r in (out["a"], out["b"]):
        for p in r.procs:
            if p.poll() is None:
                p.kill()
            p.wait()


def test_the_groups_follow_jax_device_order():
    """build_mesh's groups on a data x model x sp x pp mesh are JAX's mesh
    lines: an sp group the ranks that share (d, m, p), a model group those
    that share (d, s, p), a pp group (d, m, s), and the ranks that hold the
    same shards (ModelGroup.replicas) those that share m, in the device
    order of JAX's build_mesh over the same devices."""
    from vitxtgqa_tpu.parallel.mesh import build_mesh as jax_build_mesh
    from vitxtgqa_tpu_torch.parallel.mesh import AXES, _line_ranks, rank_coords

    shape = {"data": 1, "model": 2, "sp": 2, "pp": 2}
    devices = np.array([d.id for d in jax.devices()[:8]])
    jmesh = jax_build_mesh(data=1, model=2, sp=2, pp=2, devices=jax.devices()[:8])
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    assert list(ids.reshape(-1)) == list(devices)
    for rank in range(8):
        c = rank_coords(rank, shape)
        assert ids[tuple(c[a] for a in AXES)] == rank
        for axes in (("sp",), ("model",), ("pp",), ("data", "sp", "pp")):
            line = _line_ranks(shape, axes, {a: c[a] for a in AXES if a not in axes})
            sl = tuple(slice(None) if a in axes else c[a] for a in AXES)
            assert sorted(line) == sorted(ids[sl].reshape(-1).tolist()), (rank, axes)
            assert rank in line


@pytest.mark.parametrize("name", sorted(MESHES))
def test_model_mesh_step_equals_jax_on_its_mesh_and_one_process(worlds, name):
    """One clipped Adam step at the global batch 4 (dropout 0) on model 2 x
    sp 2 or model 2 x pp 2 (four ranks): every rank reports the global loss
    and norm and holds the same whole parameters; against JAX's step on the
    same mesh (param_shardings, its sequence parallelism or pipeline on)
    and the port in one process: the loss within rtol 1e-5, the norm 1e-4,
    every applied gradient and parameter update within 1e-4 of its
    tensor's largest entry."""
    data, model, sp, pp = MESHES[name]
    want = _jax_mesh_step(data, model, sp, pp)
    one = _port_step("plain", 0)
    _, state, _, _ = _tp_step_inputs()
    ranks = [r[name] for r in worlds["a"].results()]
    axis = "sp" if sp > 1 else "pp"
    assert [(r["coords"]["model"], r["coords"][axis]) for r in ranks] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    _check_step(ranks, want, one, state)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_sp_and_pp_replicas_hold_the_same_shards(worlds, name):
    """After the step the ranks of one model coordinate (the sp or pp
    replicas) hold the same parameters bit for bit, shards and whole ones;
    the two model coordinates hold different shards of every split
    weight, the vocabulary-parallel ones among them."""
    ranks = [r[name] for r in worlds["a"].results()]
    by_m = {}
    for r in ranks:
        by_m.setdefault(r["coords"]["model"], []).append(r["own"])
    for owns in by_m.values():
        assert len(owns) == 2
        assert all(np.array_equal(owns[0][k], owns[1][k]) for k in owns[0])
    a, b = by_m[0][0], by_m[1][0]
    for k in ("classifier.module.weight", "text_bert.embeddings.word_embeddings.weight",
              "ocr_ptr_net.query.weight", "mmt.encoder.layer.0.attention.self.query.weight"):
        assert a[k].shape == b[k].shape and not np.array_equal(a[k], b[k]), k
    assert np.array_equal(a["mmt.encoder.layer.0.output.LayerNorm.weight"],
                          b["mmt.encoder.layer.0.output.LayerNorm.weight"])


def test_model_sp_full_eval_equals_one_process_and_jax(worlds):
    """Full-eval at model 2 x sp 2 (the greedy decode over the bf16 cache,
    then ref / neg teacher-forced; the attentions' query rows over the sp
    ranks on each model rank's heads): the tokens equal to the port's in
    one process and to JAX's, the scores within 2e-5."""
    from vitxtgqa_tpu_torch.models.t2s import T2S

    cfg, state, batch, noise = _eval_inputs()
    model = T2S(cfg, NF, bos_idx=2, inference_only=False, opts=cpu_options())
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    with torch.no_grad():
        out = model({k: torch.as_tensor(v) for k, v in batch.items()},
                    tuple(map(torch.from_numpy, noise)))
    jout = _jax_eval()
    for r in worlds["a"].results():
        got = r["eval"]
        for ref in ({k: out[k].numpy() for k in got}, jout):
            assert np.array_equal(got["pos_scores"].argmax(-1), ref["pos_scores"].argmax(-1))
            for k in got:
                np.testing.assert_allclose(got[k], ref[k], atol=FWD_TOL, rtol=FWD_TOL, err_msg=k)


def test_model_pp_checkpoint_restores_whole_in_one_process(worlds):
    """The checkpoint that rank 0 writes after the model 2 x pp 2 step holds
    every parameter whole, bit for bit the two model coordinates' shards
    concatenated (the vocabulary-parallel tables by rows); it loads into
    the model and the optimizer in one process, which then hold it."""
    from vitxtgqa_tpu_torch.models.t2s import T2S
    from vitxtgqa_tpu_torch.training.checkpoint import Checkpoint
    from vitxtgqa_tpu_torch.training.optim import build_optimizer

    ranks = [r["model_pp"] for r in worlds["a"].results()]
    saved = Checkpoint(str(worlds["root"] / "ckpt")).load(
        os.path.join(str(worlds["root"] / "ckpt"), "ckpt", "final"))
    own = {r["coords"]["model"]: r["own"] for r in ranks}
    for k, v in saved["model"].items():
        a, b = own[0][k], own[1][k]
        dims = [i for i in range(a.ndim) if a.shape[i] != v.shape[i]]
        want = a if not dims else np.concatenate([a, b], axis=dims[0])
        assert np.array_equal(v.numpy(), want), k
    cfg = _step_config()
    model = T2S(cfg, NF, bos_idx=2, opts=cpu_options())
    model.load_state_dict(saved["model"])
    opt = build_optimizer(model, OA, TRAIN, cfg)
    opt.load_state_dict(saved["optimizer"])
    assert opt.count == 1
    for k, v in model.state_dict().items():
        assert torch.equal(v, saved["model"][k]), k
        np.testing.assert_array_equal(v.numpy(), ranks[0]["state"][k])


@functools.lru_cache(maxsize=None)
def _jax_encoder():
    """JAX's encoder (the training pass's output, the input's and the
    parameters' gradients for the cotangent, the eval pass with the tanh
    residual) on one device and on an eight-device data 1 x model 2 x sp 2
    x pp 2 mesh: its parameters under param_shardings, its pipeline on (its
    sequence parallelism does not lower inside the pipeline; module
    docstring)."""
    from vitxtgqa_tpu.parallel.mesh import build_mesh, param_shardings

    params, _, x, km, g = _encoder_inputs()
    jenc = JC.TransformerEncoder(JC.TransformerConfig(**ENC_CFG))
    spec = JMaskSpec(key_mask=jnp.asarray(km), dec_len=ENC_DEC)

    def fn(p, x, g):
        y, vjp = jax.vjp(lambda p, x: jenc.apply({"params": p}, x, spec, deterministic=True),
                         p, x)
        gp, gx = vjp(g)
        y_eval = jenc.apply({"params": p}, x, spec, deterministic=True, tanh_residual_base=x)
        return y, gx, gp, y_eval

    read = lambda r: (np.asarray(r[0]), np.asarray(r[1]),
                      {k: v.numpy() for k, v in _to_port(r[2]).items()}, np.asarray(r[3]))
    one = read(fast_jit(fn, params, jnp.asarray(x), jnp.asarray(g)))
    mesh = build_mesh(data=1, model=2, sp=2, pp=2, devices=jax.devices()[:8])
    JC.set_pipeline(mesh, "pp")
    try:
        sharded = jax.device_put(params, param_shardings(params, mesh))
        on_mesh = read(fast_jit(fn, sharded, jnp.asarray(x), jnp.asarray(g)))
    finally:
        JC.set_pipeline(None)
    return one, on_mesh


def test_whole_mesh_encoder_equals_jax(worlds):
    """The encoder at data 1 x model 2 x sp 2 x pp 2 on eight ranks: a
    model rank's layer shards in each of two pipeline stages, its heads'
    query rows over the sp ranks (no dropout), the eval pass with the tanh
    residual.  Every rank's training output within 2e-5, the input's and
    every parameter's gradient (made whole) within 1e-4 of its tensor's
    largest entry, and the eval pass within 2e-5, of JAX's on its
    eight-device mesh and on one device."""
    ranks = [r["encoder"] for r in worlds["b"].results()]
    assert sorted(tuple(r["coords"][a] for a in ("model", "sp", "pp")) for r in ranks) == [
        (m, s, p) for m in range(2) for s in range(2) for p in range(2)]
    for want_y, want_dx, want_grads, want_eval in _jax_encoder():
        for r in ranks:
            assert r["pipelined"] and len(r["sharded"]) == 10 * ENC_CFG["num_hidden_layers"]
            np.testing.assert_allclose(r["y"], want_y, atol=FWD_TOL, rtol=FWD_TOL)
            np.testing.assert_allclose(r["y_eval"], want_eval, atol=FWD_TOL, rtol=FWD_TOL)
            _rel_close(r["dx"], want_dx, GRAD_TOL, "dx")
            for k, w in want_grads.items():
                if not k.endswith("attention.self.key.bias"):
                    _rel_close(r["grads"][k], w, GRAD_TOL, k)
