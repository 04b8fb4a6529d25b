"""The port on the mesh's sp and pp axes (data x sp, the GPipe pipeline,
sp x pp) on gloo ranks against JAX's sequential modules on one device and
the port in one process.

Two worlds of ranks (tests/torch_mesh_ranks.py, no JAX in them) run every
rank case of this module once, started by a module-scoped fixture in the
background while this process computes the references: four ranks for the
layouts, the pipelined encoder (pp 2 from build_mesh, pp 3 over the first
three ranks) and the data x sp and sp x pp steps; two for the pp step and
run() under mesh.sp=2 and mesh.pp=2.  JAX's own tests/test_pipeline.py
shows its GPipe schedule equal to its sequential stack, so the JAX side
here is the sequential TransformerEncoder / T2S on one device.  CPU,
float32, tiny widths; inputs, weights and gumbel noise made here with
numpy.

Limits: the pipelined encoder's outputs within 2e-5 of JAX's, every
gradient within 1e-4 of its tensor's largest entry; the steps' loss
within rtol 1e-5 of the port's one process and JAX's, the gradient norm
and each parameter's update within entry.DRYRUN_LIMITS["cpu"] of the one
process, the parameters as tests/test_torch_dp.py holds them to JAX and
equal on every rank; run()'s losses within rtol 1e-5 of one process, its
validation metrics and predictions equal, each question predicted once; a
resume on the pp mesh equal to an uninterrupted run bit for bit.  The JAX
references and entry.dryrun_multichip's dry runs run in threads of this
process while the ranks run.
"""

import concurrent.futures
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from tests import torch_mesh_ranks
from tests.test_torch_dp import FRAMES, N_OCR, NF, OA, TP, _assert_params_close, _ns, _plain
from tests.test_torch_runtime import TRAIN3, _cli, fixroot, tiny_opts  # noqa: F401
from tests.test_torch_train import _patch_jax_gumbel, _tree_to_port
from tests.torch_helpers import cpu_options, fast_jit, one_torch_thread  # noqa: F401
from vitxtgqa_tpu.models import common as JC
from vitxtgqa_tpu.ops.masks import MaskSpec as JMaskSpec
from vitxtgqa_tpu.utils.synthetic import synthetic_batch, tiny_model_config
from vitxtgqa_tpu.utils.torch_convert import convert_t2s_like, flatten, unflatten
from vitxtgqa_tpu_torch.utils.convert import bert_layer_entries, convert_entries

WORLD_A, WORLD_B = 4, 2
# (data, sp, pp) of the layouts checked against the JAX mesh's device order
LAYOUTS = [(2, 2, 1), (1, 2, 2), (2, 1, 2), (4, 1, 1), (1, 4, 1), (1, 1, 4)]
# the pipelined encoder: 6 layers (over 2 and 3 stages), lane-aligned widths
# and a MaskSpec over 256 keys with an 8-slot causal tail (the port's flash
# and training block routes); 12 rows divide into 0, S and 2S microbatches
ENC_CFG = dict(hidden_size=128, num_hidden_layers=6, num_attention_heads=2,
               intermediate_size=256, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
ENC_B, ENC_L, ENC_DEC = 12, 256, 8
ENC_CASES = [(pp, m) for pp in (2, 3) for m in (0, pp, 2 * pp)]
FWD_TOL, GRAD_TOL = 2e-5, 1e-4
# the steps: every stack 2 layers (pp 2 pipelines the text BERT, the QTV
# and the MMT), the global batch of 4 over (data, sp, pp)
STEP_MESHES = {"data_sp": (2, 2, 1), "sp_pp": (1, 2, 2), "pp": (1, 1, 2)}
STEP_WORLD = {"data_sp": "a", "sp_pp": "a", "pp": "b"}
GLOBAL = 4
LOSSES = [{"type": "pos_bce_loss", "weight": 1.0}, {"type": "InfoNCE", "weight": 1000}]
# run(): every stack 2 layers, every dropout 0, global batch 4, three steps
RUN_MESHES = {"sp": ["training_parameters.tpu.mesh.sp=2"],
              "pp": ["training_parameters.tpu.mesh.pp=2"]}


# ---------------------------------------------------------------------------
# inputs and the rank cases
# ---------------------------------------------------------------------------


def _enc_cfgs():
    return JC.TransformerConfig(**ENC_CFG), ENC_CFG


@functools.lru_cache(maxsize=None)
def _encoder_inputs():
    """(JAX params, port state, x, key mask, cotangent): random numpy
    weights in the JAX tree's shapes (no init compiled), the port's by the
    port's converter."""
    rng = np.random.default_rng(11)
    jcfg, _ = _enc_cfgs()
    x = (rng.standard_normal((ENC_B, ENC_L, 128)) * 0.5).astype(np.float32)
    lengths = rng.integers(ENC_L // 3, ENC_L - ENC_DEC + 1, ENC_B)
    km = (np.arange(ENC_L)[None, :] < lengths[:, None]).astype(np.float32)
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


def _step_config(node: bool = False):
    """The steps' model config as plain dicts (the ranks', the port's), or
    as the JAX package's ConfigNode (``node``: JAX's optimizer reads its
    learning-rate scales as attributes)."""
    cfg = tiny_model_config(hidden=64, frames=FRAMES, ocr_per_frame=3, layers=2)
    c = {k: (dict(v) if hasattr(v, "items") else v) for k, v in _plain(cfg).items()}
    for sect in ("text_bert", "translayers", "mmt", "encoder"):
        c[sect].update(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    c["obj"]["dropout_prob"] = c["ocr"]["dropout_prob"] = 0.0
    return type(cfg)(c) if node else c


@functools.lru_cache(maxsize=None)
def _step_inputs():
    """(config, initial state, global batch, noise) of the step cases."""
    from vitxtgqa_tpu_torch.models.t2s import T2S

    cfg = _step_config()
    model = T2S(cfg, NF, bos_idx=2, opts=cpu_options()).init_weights(0)
    state = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
    batch = synthetic_batch(batch=GLOBAL, frames=FRAMES, ocr_per_frame=3, dec_steps=4,
                            text_len=10, video_feat_dim=32, fasttext_dim=16, phoc_dim=24,
                            num_final_outputs=NF, text_vocab=128, seed=3)
    batch["train_loss_mask"][1::2, 1:] = 0.0
    rng = np.random.default_rng(5)
    noise = {(GLOBAL, 2, FRAMES): rng.gumbel(size=(GLOBAL, 2, FRAMES)).astype(np.float32),
             (GLOBAL, 2, N_OCR): rng.gumbel(size=(GLOBAL, 2, N_OCR)).astype(np.float32)}
    return cfg, state, batch, noise


def _run_argv(fixroot, save_dir, mesh=(), run_type="train+inference", **tp):
    layers = [f"model_attributes.t2s.{s}.num_hidden_layers=2"
              for s in ("text_bert", "translayers", "mmt")]
    return (_cli(_repo(), "t2s_abinet.yml", run_type)
            + tiny_opts(fixroot, save_dir, dropout=False, batch_size=GLOBAL,
                        evalai_inference=True, **{**TRAIN3, **tp}) + layers + list(mesh))


def _repo():
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _step_case(name):
    cfg, state, batch, noise = _step_inputs()
    return dict(kind="step", mesh=STEP_MESHES[name], cfg=cfg, nf=NF, state=state, batch=batch,
                noise=noise, losses=LOSSES, oa=OA, tp=TP)


# the dry runs of entry.dryrun_multichip: (ranks, mesh axes)
DRYRUNS = {"data2_sp2": (4, dict(model=1, sp=2)), "pp2": (2, dict(pp=2))}


def _dryruns():
    from vitxtgqa_tpu_torch.entry import dryrun_multichip

    return {name: dryrun_multichip(n, device="cpu", **kw) for name, (n, kw) in DRYRUNS.items()}


@pytest.fixture(scope="module", autouse=True)
def background():
    """The JAX references (the encoder's, then the steps') and the dry runs,
    each computed in a thread of its own from the module's start while the
    ranks run; a test reads ``[name].result()``."""
    with concurrent.futures.ThreadPoolExecutor(max_workers=2) as pool:
        refs = pool.submit(lambda: (_jax_encoder(), _step_refs()))
        out = {"jax": refs, "dryruns": pool.submit(_dryruns)}
        yield out
        for f in out.values():
            f.exception()


@pytest.fixture(scope="module", autouse=True)
def worlds(tmp_path_factory, fixroot):
    """The two worlds, started when the module starts; ``[w].results()``
    waits for world ``w``.  Stopped at the module's end."""
    _, state, x, km, g = _encoder_inputs()
    a = {"layout": dict(kind="layout", meshes=LAYOUTS),
         "encoder": dict(kind="encoder", cfg=ENC_CFG, state=state, x=x, key_mask=km, g=g,
                         dec_len=ENC_DEC, pp=(2, 3))}
    b = {}
    for name, world in STEP_WORLD.items():
        (a if world == "a" else b)[name] = _step_case(name)
    root = tmp_path_factory.mktemp("mesh_ranks")
    for name, mesh in RUN_MESHES.items():
        b[f"run_{name}"] = dict(kind="run", argv=_run_argv(fixroot, str(root / f"run_{name}"),
                                                           mesh))
    # a resume on the pp mesh: four steps straight, three and a snapshot,
    # then the fourth from ckpt/best
    pp = RUN_MESHES["pp"]
    for name, steps in (("straight", 4), ("first", 3)):
        b[f"resume_{name}"] = dict(kind="run", argv=_run_argv(
            fixroot, str(root / f"resume_{name}"), pp, max_iterations=steps, run_type="train"))
    b["resume_resumed"] = dict(kind="run", argv=_run_argv(
        fixroot, str(root / "resume_resumed"), pp, max_iterations=4, run_type="train")
        + ["training_parameters.resume_file=" + str(root / "resume_first" / "ckpt" / "best")])
    out = {}
    for w, cases, n in (("a", a, WORLD_A), ("b", b, WORLD_B)):
        os.makedirs(root / w)
        out[w] = torch_mesh_ranks.start(cases, root / w, world=n)
    yield out
    for r in out.values():
        for p in r.procs:
            if p.poll() is None:
                p.kill()
            p.wait()


# ---------------------------------------------------------------------------
# the pipelined encoder
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_encoder():
    """JAX's sequential encoder on one device: the training-pass output,
    the gradients of the input and of the parameters (port names) for the
    cotangent, and the eval pass with the tanh residual."""
    params, _, x, km, g = _encoder_inputs()
    jenc = JC.TransformerEncoder(_enc_cfgs()[0])
    spec = JMaskSpec(key_mask=jnp.asarray(km), dec_len=ENC_DEC)

    def fn(p, x, g):
        y, vjp = jax.vjp(lambda p, x: jenc.apply({"params": p}, x, spec, deterministic=True),
                         p, x)
        gp, gx = vjp(g)
        y_eval = jenc.apply({"params": p}, x, spec, deterministic=True, tanh_residual_base=x)
        return y, gx, gp, y_eval

    y, gx, gp, y_eval = fast_jit(fn, params, jnp.asarray(x), jnp.asarray(g))
    return (np.asarray(y), np.asarray(gx), {k: v.numpy() for k, v in _to_port(gp).items()},
            np.asarray(y_eval))


def _grad_close(got, want, what):
    """A gradient within GRAD_TOL of its tensor's scale (its largest entry):
    a weight's gradient sums 3,072 rows' products, so float32 rounding
    grows with its size."""
    np.testing.assert_allclose(got, want, rtol=GRAD_TOL, atol=GRAD_TOL * np.abs(want).max(),
                               err_msg=what)


@pytest.mark.parametrize("pp, m", ENC_CASES, ids=[f"pp{p}_m{m}" for p, m in ENC_CASES])
def test_pipelined_encoder_equals_the_jax_sequential_encoder(worlds, background, pp, m):
    """The six-layer encoder over pp stages and m microbatches (0: one a
    stage): on every stage the training pass's output within 2e-5 of JAX's
    sequential stack and the input's gradient within 1e-4 (of the tensor's
    largest entry); every layer's gradients within 1e-4 alike on every
    stage, the same bit for bit on all of them (the backward all-gathers
    the stages' gradients); the eval pass with the tanh residual (inside
    the last stage's last layer) within 2e-5."""
    want_y, want_dx, want_grads, want_eval = background["jax"].result()[0]
    got = [r["encoder"][(pp, m)] for r in worlds["a"].results() if (pp, m) in r["encoder"]]
    assert len(got) == (WORLD_A if WORLD_A % pp == 0 else pp)
    for r in got:
        np.testing.assert_allclose(r["y"], want_y, atol=FWD_TOL, rtol=FWD_TOL)
        np.testing.assert_allclose(r["y_eval"], want_eval, atol=FWD_TOL, rtol=FWD_TOL)
        _grad_close(r["dx"], want_dx, "dx")
    for k, w in want_grads.items():
        # the stages of one pp group: ranks 0..pp-1 (both groups alike at pp 2)
        g = got[0]["grads"][k]
        for s in range(1, pp):
            np.testing.assert_array_equal(got[s]["grads"][k], g, err_msg=f"{k} on stage {s}")
        if k.endswith("attention.self.key.bias"):
            # rounding noise on both sides: softmax ignores the key bias
            assert np.abs(g).max() < GRAD_TOL and np.abs(w).max() < GRAD_TOL, k
        else:
            _grad_close(g, w, k)


def _pp_options(stages, **kw):
    from vitxtgqa_tpu_torch.parallel.mesh import PPGroup

    return cpu_options(pp=PPGroup(group=None, rank=0, size=stages), **kw)


def test_eligibility_is_the_jax_gate(background, monkeypatch):
    """TransformerEncoder.pipelined against JAX's _pp_eligible for every
    layer count (2, 3, 6), stage count (2, 3), pass (deterministic or not)
    and dropout (0 or 0.1); forward takes the pipeline exactly then (eval;
    training with a dropout generator; training with none)."""
    from vitxtgqa_tpu_torch.models import common as TC
    from vitxtgqa_tpu_torch.ops.masks import MaskSpec
    from vitxtgqa_tpu_torch.parallel import pipeline as P

    background["jax"].result()  # set_pipeline below is JAX's process-wide switch
    calls = []
    monkeypatch.setattr(P, "pipeline_encoder_apply", lambda layers, x, *a, **kw: (
        calls.append(len(layers)), x)[1])
    x = torch.zeros(2, 4, 16)
    spec = MaskSpec(key_mask=torch.ones(2, 4))
    for layers in (2, 3, 6):
        for stages in (2, 3):
            for rate in (0.0, 0.1):
                kw = dict(hidden_size=16, num_hidden_layers=layers, num_attention_heads=2,
                          intermediate_size=32, hidden_dropout_prob=rate,
                          attention_probs_dropout_prob=rate)
                JC.set_pipeline(JMesh(np.array(jax.devices()[:stages]), ("pp",)))
                try:
                    jenc = JC.TransformerEncoder(JC.TransformerConfig(**kw)).bind({"params": {}})
                    want = {det: bool(jenc._pp_eligible(det)) for det in (True, False)}
                finally:
                    JC.set_pipeline(None)
                enc = TC.TransformerEncoder(TC.TransformerConfig(**kw), _pp_options(stages))
                for det in (True, False):
                    assert enc.pipelined(det) == want[det], (layers, stages, rate, det)
                for train, gen in ((False, None), (True, torch.Generator()), (True, None)):
                    calls.clear()
                    if not enc.pipelined(not train or gen is None):
                        continue
                    enc(x, spec, train=train, gen=gen)
                    assert calls == [layers], (layers, stages, rate, train)
    # both rates 0.1: a training pass with a generator stays whole, eval pipelines
    assert not enc.pipelined(False) and enc.pipelined(True)


def test_the_decode_keeps_the_single_stage_layout(monkeypatch):
    """encode_with_cache and the cached decode steps of an encoder with a
    pp group never reach the pipeline and equal the encoder without one."""
    from vitxtgqa_tpu_torch.models import common as TC
    from vitxtgqa_tpu_torch.ops.masks import DecodeStepSpec, MaskSpec
    from vitxtgqa_tpu_torch.parallel import pipeline as P

    monkeypatch.setattr(P, "pipeline_encoder_apply", lambda *a, **k: pytest.fail("pipelined"))
    kw = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2, intermediate_size=64)
    whole = TC.TransformerEncoder(TC.TransformerConfig(**kw), cpu_options())
    staged = TC.TransformerEncoder(TC.TransformerConfig(**kw), _pp_options(2))
    staged.load_state_dict(whole.state_dict())
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 10, 32)).astype(np.float32))
    km = torch.ones(2, 10)
    km[:, 6:] = 0.0
    outs = []
    for enc in (whole, staged):
        with torch.no_grad():
            h, kvs = enc.encode_with_cache(x, MaskSpec(key_mask=km))
            y, _ = enc.decode_step(x[:, :1], [(k.clone(), v.clone()) for k, v in kvs], 0,
                                   DecodeStepSpec(key_mask=km, step=0, write_offset=6), 6)
        outs.append((h, y))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_rows_that_do_not_divide_into_the_microbatches_raise():
    """6 rows into 4 microbatches (pp_microbatches=4 over 2 stages), and 5
    rows into one a stage: a ValueError naming both numbers, before any
    collective (the group here has none)."""
    from vitxtgqa_tpu_torch.models import common as TC
    from vitxtgqa_tpu_torch.ops.masks import MaskSpec
    from vitxtgqa_tpu_torch.parallel.pipeline import microbatches

    assert microbatches(12, 3, 0) == (3, 4) and microbatches(12, 3, 6) == (6, 2)
    kw = dict(hidden_size=16, num_hidden_layers=2, num_attention_heads=2, intermediate_size=32)
    for rows, m in ((6, 4), (5, 0)):
        enc = TC.TransformerEncoder(TC.TransformerConfig(**kw), _pp_options(2, pp_microbatches=m))
        with pytest.raises(ValueError, match=f"{rows} rows do not divide into {m or 2} "
                                             "microbatches"):
            with torch.no_grad():
                enc(torch.zeros(rows, 4, 16), MaskSpec(key_mask=torch.ones(rows, 4)))


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _step_refs():
    """(JAX's step on one device: loss, parameters after; the port's step
    in one process: loss, norm, parameters after) on the global batch."""
    from vitxtgqa_tpu.losses import Losses as JLosses
    from vitxtgqa_tpu.models.t2s import T2S as JT2S
    from vitxtgqa_tpu.training.optim import build_optimizer as jax_build
    from vitxtgqa_tpu_torch.losses import Losses
    from vitxtgqa_tpu_torch.models.t2s import T2S
    from vitxtgqa_tpu_torch.training.optim import build_optimizer
    from vitxtgqa_tpu_torch.training.step import train_step

    cfg, state, batch, noise = _step_inputs()
    model = T2S(cfg, NF, bos_idx=2, opts=cpu_options())
    model.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in state.items()})
    opt = build_optimizer(model, _ns(OA), _ns(TP), cfg)
    gumbel = tuple(torch.from_numpy(noise[(GLOBAL, 2, n)]) for n in (FRAMES, N_OCR))
    r = train_step(model, Losses(LOSSES), opt, {k: torch.as_tensor(v) for k, v in batch.items()},
                   (torch.Generator().manual_seed(0), gumbel))
    one = {"loss": float(r["loss"]), "norm": float(r["grad_norm"]),
           "state": {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}}

    mp = pytest.MonkeyPatch()
    try:
        _patch_jax_gumbel(mp, noise)
        jm = JT2S(config=cfg, num_final_outputs=NF, bos_idx=2, train_variant_scan=True)
        jlosses = JLosses(LOSSES)
        tx, _ = jax_build(_ns(OA), _ns(TP), _step_config(node=True))
        params = unflatten(convert_t2s_like({k: v.copy() for k, v in state.items()},
                                            text_layers=2, qtv_layers=2, mmt_layers=2))

        def step(params, opt_state, tensors):
            def loss_fn(p):
                out = jm.apply({"params": p}, tensors, train=True,
                               rngs={"dropout": jax.random.key(1), "gumbel": jax.random.key(2)})
                return jlosses.total(tensors, out)[0]

            total, grads = jax.value_and_grad(loss_fn)(params)
            updates, opt_state = tx.update(grads, opt_state, params)
            return jax.tree_util.tree_map(lambda p, u: p + u, params, updates), total

        new, total = fast_jit(step, params, tx.init(params),
                              {k: jnp.asarray(v) for k, v in batch.items()})
        want = {"loss": float(total),
                "state": _tree_to_port(jax.tree_util.tree_map(np.asarray, new))}
    finally:
        mp.undo()
    return want, one


@pytest.mark.parametrize("name", sorted(STEP_MESHES))
def test_mesh_steps_equal_one_process_and_jax(worlds, background, name):
    """One clipped Adam step at the global batch 4 on data x sp = 2 x 2 and
    sp x pp = 2 x 2 (four ranks) and on pp = 2 (two ranks): every rank
    reports the global loss and holds the same parameters after the step;
    the loss within rtol 1e-5 of one port process and of JAX on one device,
    the gradient norm and each parameter's update within DRYRUN_LIMITS
    ["cpu"] of the one process, the parameters close to JAX's; the text
    BERT, QTV and MMT passes ran pipelined under pp (1 + 1 + 3 a step) and
    none without."""
    from vitxtgqa_tpu_torch.entry import DRYRUN_LIMITS, largest_gap

    want, one = background["jax"].result()[1]
    _, state, _, _ = _step_inputs()
    ranks = [r[name] for r in worlds[STEP_WORLD[name]].results()]
    r0 = ranks[0]
    assert all(r["applied"] for r in ranks)
    assert all(r["loss"] == r0["loss"] and r["norm"] == r0["norm"] for r in ranks)
    assert all(np.array_equal(r["state"][k], r0["state"][k]) for r in ranks for k in r0["state"])
    assert r0["pipelined"] == ([2, 2, 2, 2, 2] if STEP_MESHES[name][2] > 1 else [])
    loss_tol, norm_tol, _, update_tol = DRYRUN_LIMITS["cpu"]
    np.testing.assert_allclose(r0["loss"], one["loss"], rtol=loss_tol)
    np.testing.assert_allclose(r0["loss"], want["loss"], rtol=loss_tol)
    assert abs(r0["norm"] - one["norm"]) <= norm_tol * one["norm"]
    delta = lambda s: {k: torch.from_numpy(s[k] - state[k]).flatten() for k in state}
    gap, where = largest_gap(delta(r0["state"]), delta(one["state"]))
    assert gap <= update_tol, (gap, where)
    lr = OA["params"]["lr"]
    _assert_params_close({k: r0["state"][k] for k in want["state"]}, want["state"], state, lr)


# ---------------------------------------------------------------------------
# the layout
# ---------------------------------------------------------------------------


def test_rank_layout_is_the_jax_meshs_device_order(worlds):
    """build_mesh on four ranks for each (data, sp, pp): world rank r has
    the coordinates of device r in JAX's build_mesh over four devices, and
    each of its groups joins the ranks along that axis of JAX's device
    array, in order."""
    from vitxtgqa_tpu.parallel.mesh import build_mesh

    ranks = worlds["a"].results()
    devices = jax.devices()[:WORLD_A]
    for i, (data, sp, pp) in enumerate(LAYOUTS):
        jm = build_mesh(data=data, sp=sp, pp=pp, devices=devices)
        ids = np.vectorize(lambda d: d.id)(jm.devices)
        names = list(jm.axis_names)
        for rank, r in enumerate(ranks):
            got = r["layout"][i]
            where = dict(zip(names, (int(w[0]) for w in np.nonzero(ids == devices[rank].id))))
            assert got["coords"] == {a: where.get(a, 0) for a in ("data", "model", "sp", "pp")}
            for axis in ("data", "sp", "pp"):
                if axis not in names or jm.shape[axis] == 1:
                    assert got["groups"][axis] is None, (i, axis)
                    continue
                line = np.moveaxis(ids, names.index(axis), -1)[
                    tuple(where[a] for a in names if a != axis)]
                want = [next(j for j, d in enumerate(devices) if d.id == x) for x in line]
                assert got["groups"][axis] == (where[axis], want), (i, axis, rank)
            if pp > 1:
                assert got["peers"] == got["groups"]["pp"][1]


def test_a_mesh_the_world_cannot_hold_raises():
    """mesh_shape: -1 takes the world over sp x pp; a product other than
    the world, a world that sp x pp does not divide, a global batch the
    data axis does not divide raise ValueError, as does model beside sp in
    a world too small for them, which runs in one that holds them
    (tests/test_torch_tp_mesh.py holds the model axis beside sp and pp)."""
    from vitxtgqa_tpu_torch.parallel.mesh import mesh_shape, rank_coords

    assert mesh_shape(-1, 1, 2, 2, world=8) == {"data": 2, "model": 1, "sp": 2, "pp": 2}
    assert rank_coords(5, {"data": 2, "model": 1, "sp": 2, "pp": 2}) == {
        "data": 1, "model": 0, "sp": 0, "pp": 1}
    for kw, words in ((dict(sp=4), "multiple of 4 processes; the world has 2"),
                      (dict(data=2, pp=2), "needs 4 processes"),
                      (dict(data=2, batch_size=3), "batch_size 3")):
        with pytest.raises(ValueError, match=words):
            mesh_shape(**{"data": -1, "world": 2, **kw})
    assert mesh_shape(model=2, sp=2, world=4) == {"data": 1, "model": 2, "sp": 2, "pp": 1}
    with pytest.raises(ValueError, match="model=2 x sp=2 x pp=1 needs a multiple of 4"):
        mesh_shape(model=2, sp=2, world=2)


# ---------------------------------------------------------------------------
# run() on two ranks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def one_process_run(fixroot, tmp_path_factory):
    """run() in this process on the same arguments (the mesh's defaults)."""
    from vitxtgqa_tpu_torch.run import run
    from tests.torch_dp_ranks import _reports, _series

    t = run(_run_argv(fixroot, str(tmp_path_factory.mktemp("mesh_one") / "one")))
    return {"series": _series(t.meter), "reports": _reports(t.logger.save_dir),
            "questions": {s: len(ds) for s, ds in t.datasets.items()}}


@pytest.mark.parametrize("name", sorted(RUN_MESHES))
def test_run_on_two_ranks_equals_one_process(worlds, one_process_run, name):
    """run() (train+inference, EvalAI predictions) on two ranks with
    mesh.sp=2 or mesh.pp=2: three steps' losses within rtol 1e-5 of the
    one-process run, the validation metrics equal (its losses within rtol
    1e-5), both ranks' series equal; rank 0 writes the val and test
    reports, each question once, the rows the one-process run's."""
    r0, r1 = (r[f"run_{name}"] for r in worlds["b"].results())
    one = one_process_run
    assert r0["series"] == r1["series"] and r0["iteration"] == 3
    assert r0["mesh"] == {"data": 1, "model": 1, **({"sp": 2, "pp": 1} if name == "sp"
                                                    else {"sp": 1, "pp": 2})}
    assert sorted(r0["series"]) == sorted(one["series"])
    for key, want in one["series"].items():
        if "loss" in key or "InfoNCE" in key or key.endswith("grad_norm"):
            np.testing.assert_allclose(r0["series"][key], want, rtol=1e-5, err_msg=key)
        else:
            assert r0["series"][key] == want, key
    assert len(r0["reports"]) == 2 and r1["reports"] == {}
    for (fname, rows), (wname, want) in zip(sorted(r0["reports"].items()),
                                            sorted(one["reports"].items())):
        split = "val" if "_val_" in fname else "test"
        assert f"_{split}_" in wname
        qids = [row["question_id"] for row in rows]
        assert len(qids) == len(set(qids)) == one["questions"][split]
        assert rows == want, split


def test_a_resumed_pp_run_equals_an_uninterrupted_one(worlds):
    """run() on the pp = 2 mesh: four steps straight against three, a
    snapshot (ckpt/best, whole, written by rank 0) and a resume from it for
    the fourth: the fourth step's loss and ckpt/final's parameters equal
    bit for bit, on both ranks' series."""
    for r in worlds["b"].results():
        straight, first, resumed = (r[f"resume_{n}"] for n in ("straight", "first", "resumed"))
        got, want = resumed["series"]["train/total_loss"], straight["series"]["train/total_loss"]
        assert len(first["series"]["train/total_loss"]) == 3
        assert len(got) == 1 and len(want) == 4 and got[0] == want[3]
    r0 = worlds["b"].results()[0]
    straight, resumed = r0["resume_straight"]["final"], r0["resume_resumed"]["final"]
    assert sorted(resumed) == sorted(straight)
    assert all(np.array_equal(resumed[k], straight[k]) for k in straight)


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(DRYRUNS))
def test_dryrun_multichip_on_the_mesh(background, name):
    """entry.dryrun_multichip on the CPU: data x sp = 2 x 2 on four ranks and
    a two-stage pipeline on two, each held to the one-process step at
    DRYRUN_LIMITS["cpu"] (it raises otherwise)."""
    from vitxtgqa_tpu_torch.entry import DRYRUN_LIMITS

    n, kw = DRYRUNS[name]
    out = background["dryruns"].result()[name]
    loss_tol, norm_tol, tol, update_tol = DRYRUN_LIMITS["cpu"]
    assert out["ranks"] == n
    assert out["mesh"] == {"data": n // 2, "model": 1, "sp": 1, "pp": 1, **kw}
    assert out["loss_rel"] <= loss_tol and out["norm_rel"] <= norm_tol
    assert out["grad_rel"][0] <= tol and out["update_rel"][0] <= update_tol
