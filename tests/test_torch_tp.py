"""The port on the mesh's model axis (tensor parallelism) on gloo ranks
against JAX (its Pallas references, and its step on a data x model mesh of
CPU devices under param_shardings) and the port in one process.

Two worlds of ranks (tests/torch_tp_ranks.py, no JAX in them) run every
rank case of this module once, started by a module-scoped fixture in the
background while this process computes the references: four ranks for
the data 2 x model 2 step, two for the model-2 cases (the encoder on the
kernels' routes with dropout, the step with dropout, full-eval, run() with
its checkpoint and a resume).  CPU, float32, tiny widths; inputs, weights
and gumbel noise made here with numpy.

Limits: the split forms' twins, their shards summed, within 2e-5 of the
unsplit twin and of the JAX block, gradients 1e-4 of each tensor's largest
entry; the steps' loss within rtol 1e-5, each gradient and updated
parameter within 1e-4 of its tensor's largest entry (a key projection's
bias, float32 noise since softmax ignores it, left out; the steps start
off the seeded init, whose zero biases would make a tensor's largest entry
one step's size); full-eval's tokens equal,
its scores within 2e-5; a resumed run equal to an uninterrupted one bit
for bit, its checkpoint the ranks' shards gathered bit for bit.
"""

import concurrent.futures
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_tp_ranks
from tests.test_torch_dp import FRAMES, N_OCR, NF, OA, _ns, _plain
from tests.test_torch_dp import TP as TRAIN
from tests.test_torch_mesh import LOSSES, _step_config, _step_inputs
from tests.test_torch_runtime import TRAIN3, _cli, fixroot, tiny_opts  # noqa: F401
from tests.test_torch_train import _patch_jax_gumbel, _tree_to_port
from tests.torch_helpers import cpu_options, fast_jit, one_torch_thread  # noqa: F401
from vitxtgqa_tpu.utils.synthetic import synthetic_batch, tiny_model_config
from vitxtgqa_tpu.utils.torch_convert import convert_t2s_like, unflatten

FWD_TOL, GRAD_TOL = 2e-5, 1e-4
# the encoder on the kernels' routes: lane-aligned widths (the training
# block's split form), 256 keys with an 8-slot causal tail (the flash
# route, its dropout drawn at each rank's head offset), 2 layers
ENC_CFG = dict(hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
               intermediate_size=256, hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
ENC_B, ENC_L, ENC_DEC, ENC_SEED = 2, 256, 8, 3
# run(): model 2, every dropout 0 for the resume's, global batch 4
RUN_AXES = ["training_parameters.tpu.mesh.model=2"]
GLOBAL = 4


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rel_close(got, want, tol, what):
    """max |got - want| within ``tol`` of max |want|."""
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


def _noise_entry(name):
    return name.endswith("attention.self.key.bias")


# ---------------------------------------------------------------------------
# the split forms' twins (in this process)
# ---------------------------------------------------------------------------


def _block_weights(seed, rows, d=128, m=256):
    """numpy operands in the port's layout (nn.Linear weights [out, in])."""
    rng = np.random.default_rng(seed)
    mk = lambda *s, scale=0.05: (rng.standard_normal(s) * scale).astype(np.float32)
    return dict(x_q=mk(rows, d, scale=1.0), ctx=mk(rows, d, scale=1.0), wo=mk(d, d), bo=mk(d),
                s1=1.0 + mk(d), g1=mk(d), w1=mk(m, d), b1=mk(m), w2=mk(d, m), b2=mk(d),
                s2=1.0 + mk(d), g2=mk(d))


def _shards(w, n):
    """Every rank's shards of the block's weights: (ctx, wo, w1, b1, w2)."""
    cut = lambda a, dim: [T(c) for c in np.split(a, n, axis=dim)]
    return list(zip(cut(w["ctx"], 1), cut(w["wo"], 1), cut(w["w1"], 0), cut(w["b1"], 0),
                    cut(w["w2"], 1)))


def _jax_layout(w):
    return [jnp.asarray(w[k].T if k in ("wo", "w1", "w2") else w[k])
            for k in ("x_q", "ctx", "wo", "bo", "s1", "g1", "w1", "b1", "w2", "b2", "s2", "g2")]


@pytest.mark.parametrize("tanh", [False, True])
@pytest.mark.parametrize("n", [2, 4])
def test_split_eval_block_twin_sums_to_the_unsplit_block_and_jax(n, tanh):
    """fused_block_tp_steps' twin (#2 / #3's split form) on n ranks' shards,
    their partials summed: every rank's output equal, within 2e-5 of the
    unsplit twin and of the JAX block (pallas_ffn in interpret mode)."""
    from vitxtgqa_tpu.ops.pallas_ffn import fused_block, fused_block_tanh
    from vitxtgqa_tpu_torch.ops import fused_block as FB
    from vitxtgqa_tpu_torch.parallel import tensor_parallel as TP

    w = _block_weights(1, 70)
    res = np.random.default_rng(2).standard_normal(w["x_q"].shape).astype(np.float32)
    vec = {k: T(w[k]) for k in ("bo", "s1", "g1", "b2", "s2", "g2")}
    steps = [FB.fused_block_tp_steps(T(w["x_q"]), c, wo, vec["bo"], vec["s1"], vec["g1"], w1, b1,
                                     w2, vec["b2"], vec["s2"], vec["g2"],
                                     res=T(res) if tanh else None)
             for c, wo, w1, b1, w2 in _shards(w, n)]
    outs = [o.numpy() for o in TP.drive(steps, TP.shard_sum)]
    assert all(np.array_equal(o, outs[0]) for o in outs)
    whole = [T(w[k]) for k in ("x_q", "ctx", "wo", "bo", "s1", "g1", "w1", "b1", "w2", "b2",
                               "s2", "g2")]
    unsplit = (FB.fused_block_tanh_plain(T(res), *whole) if tanh
               else FB.fused_block_plain(*whole)).numpy()
    np.testing.assert_allclose(outs[0], unsplit, atol=FWD_TOL, rtol=FWD_TOL)
    want = (fused_block_tanh(jnp.asarray(res), *_jax_layout(w), interpret=True) if tanh
            else fused_block(*_jax_layout(w), interpret=True))
    # 5e-5 as tests/test_torch_ops.py: the Pallas gelu's A&S erf
    np.testing.assert_allclose(outs[0], np.asarray(want), atol=5e-5)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_split_training_block_twins_sum_to_the_unsplit_block_and_jax(rate):
    """block_train_fwd_tp_steps' and block_train_bwd_tp_steps' twins (#9a /
    #9b's split forms) on 2 ranks' shards with the seed's masks: y and the
    whole residuals equal on both ranks, the output and the 12 gradients
    (the shards' concatenated) within 2e-5 / 1e-4 of each tensor's largest
    entry of the unsplit twin and of JAX's block_train (interpret mode, the
    same masks)."""
    from vitxtgqa_tpu.ops.pallas_block_bwd import block_train
    from vitxtgqa_tpu_torch.ops import block_train as BT
    from vitxtgqa_tpu_torch.parallel import tensor_parallel as TP

    n, rows, d = 2, 96, 128
    w = _block_weights(3, rows)
    seed = torch.tensor([11], dtype=torch.int64)
    cot = np.random.default_rng(4).standard_normal((rows, d)).astype(np.float32)
    vec = {k: T(w[k]) for k in ("bo", "s1", "g1", "b2", "s2", "g2")}
    shards = _shards(w, n)
    fwd = TP.drive([BT.block_train_fwd_tp_steps(
        T(w["x_q"]), c, wo, vec["bo"], vec["s1"], vec["g1"], w1, b1, w2, vec["b2"], vec["s2"],
        vec["g2"], rate, seed) for c, wo, w1, b1, w2 in shards], TP.shard_sum)
    for r in range(1, n):
        for i in (0, 1, 4):
            assert torch.equal(fwd[r][i], fwd[0][i])
    grads = TP.drive([BT.block_train_bwd_tp_steps(
        T(cot), c, fwd[0][1], fwd[r][2], fwd[r][3], fwd[0][4], wo, w1, w2, vec["s1"],
        vec["g1"], vec["s2"], rate, seed) for r, (c, wo, w1, b1, w2) in enumerate(shards)],
        TP.shard_sum)
    # the shards' gradients made whole: dctx, dWo by columns, dW1, db1 by
    # rows, dW2 by columns; the rest whole and equal on every rank
    dims = {1: 1, 2: 1, 6: 0, 7: 0, 8: 1}
    got = []
    for i in range(12):
        if i in dims:
            got.append(np.concatenate([g[i].numpy() for g in grads], axis=dims[i]))
        else:
            assert all(torch.equal(g[i], grads[0][i]) for g in grads), BT.GRAD_NAMES[i]
            got.append(grads[0][i].numpy())
    masks = BT.seed_masks(seed, rows, d, rate, torch.device("cpu"))
    whole = [T(w[k]).requires_grad_() for k in ("x_q", "ctx", "wo", "bo", "s1", "g1", "w1",
                                                 "b1", "w2", "b2", "s2", "g2")]
    y = BT.block_train_plain(*whole, *masks, rate=rate)
    y.backward(T(cot))
    np.testing.assert_allclose(fwd[0][0].numpy(), y.detach().numpy(), atol=FWD_TOL,
                               rtol=FWD_TOL)
    ma, mf = (None, None) if masks[0] is None else (jnp.asarray(masks[0].numpy()),
                                                      jnp.asarray(masks[1].numpy()))
    f = lambda *a: block_train(*a, mask_a=ma, mask_f=mf, rate=rate, interpret=True)
    want_y, vjp = jax.vjp(f, *_jax_layout(w))
    np.testing.assert_allclose(fwd[0][0].numpy(), np.asarray(want_y), atol=FWD_TOL,
                               rtol=FWD_TOL)
    for i, (name, g, p, jw) in enumerate(zip(BT.GRAD_NAMES, got, whole, vjp(jnp.asarray(cot)))):
        _rel_close(g, p.grad.numpy(), GRAD_TOL, name)
        _rel_close(g.T if i in (2, 6, 8) else g, np.asarray(jw), GRAD_TOL, name)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_flash_twins_at_a_head_offset_are_the_whole_layers_heads(rate):
    """#1 and #1b's twins on a rank's 2 of 4 heads at head offset 2: the
    output, lse and dq / dk / dv equal the whole layer's twin on those
    heads (the dropout mask drawn at the global heads), and at offset 0
    (rate > 0) another mask."""
    from vitxtgqa_tpu_torch.ops import flash_attention as FA

    rng = np.random.default_rng(5)
    b, l, h, dec = 2, 130, 4, 6
    q, k, v, g = (T(rng.standard_normal((b, l, h * 64)).astype(np.float32)) for _ in range(4))
    km = torch.ones(b, l)
    km[1, 60:] = 0.0
    seed = torch.tensor([9], dtype=torch.int64)
    half = lambda t: t[..., 128:].contiguous()
    out, lse = FA.flash_attention_merged_plain(q, k, v, km, dec, h, rate, seed, True)
    dq, dk, dv = FA.flash_attention_merged_bwd_plain(q, k, v, km, out, lse, g, dec, h, rate,
                                                     seed)
    o2, l2 = FA.flash_attention_merged_plain(half(q), half(k), half(v), km, dec, 2, rate, seed,
                                             True, head_offset=2)
    np.testing.assert_allclose(o2.numpy(), half(out).numpy(), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(l2.numpy(), lse[:, 2:].numpy(), atol=1e-6, rtol=1e-6)
    got = FA.flash_attention_merged_bwd_plain(half(q), half(k), half(v), km, o2, l2, half(g),
                                              dec, 2, rate, seed, head_offset=2)
    for a, w in zip(got, (dq, dk, dv)):
        np.testing.assert_allclose(a.numpy(), half(w).numpy(), atol=1e-5, rtol=1e-5)
    if rate:
        o0 = FA.flash_attention_merged_plain(half(q), half(k), half(v), km, dec, 2, rate, seed)
        assert not torch.allclose(o0, o2)


def test_the_rule_table_names_the_split_layers_shards():
    """A T2S at model 2 (tiny widths): exactly the parameters PARAM_RULES
    names are shards (Q/K/V and FFN-in weights and biases by rows, the
    attention-output and FFN-out weights by columns; the classifier's and
    the word embeddings' vocabulary rows, the OCR pointer network's query
    and key by rows), every other parameter whole; its seeded init is the
    one-process init's shards; shard_state then a concatenation of the
    shards gives the whole state back."""
    from vitxtgqa_tpu_torch.models.t2s import T2S
    from vitxtgqa_tpu_torch.parallel import tensor_parallel as TP
    from vitxtgqa_tpu_torch.parallel.mesh import ModelGroup

    cfg = _step_config()
    whole = T2S(cfg, NF, bos_idx=2, opts=cpu_options()).init_weights(0).state_dict()
    models = [T2S(cfg, NF, bos_idx=2, opts=cpu_options(tp=ModelGroup(None, r, 2))).init_weights(0)
              for r in range(2)]
    dims = TP.sharded_dims(models[0])
    assert dims == {k: TP.rule_dim(k) for k in whole if TP.rule_dim(k) is not None}
    layers = sum(k.endswith("attention.self.query.weight") for k in whole)
    # 6 weights and 4 biases a layer; the classifier's weight and bias, the
    # word embeddings, the pointer's query and key weights and biases
    assert layers == 6 and len(dims) == 10 * layers + 7
    assert sum(k.startswith("ocr_ptr_net.") for k in dims) == 4
    assert TP.rule_dim("mmt.encoder.layer.0.output.dense.weight") == 1
    assert TP.rule_dim("mmt.encoder.layer.0.attention.output.dense.bias") is None
    states = [m.state_dict() for m in models]
    for k, v in whole.items():
        if k in dims:
            got = torch.cat([s[k] for s in states], dim=dims[k])
            assert torch.equal(got, v), k
            assert torch.equal(TP.shard_state(whole, dims, 1, 2)[k], states[1][k]), k
        else:
            assert torch.equal(states[0][k], v) and torch.equal(states[1][k], v), k


@pytest.mark.parametrize("heads", [6, 3])
def test_decode_attention_plans_a_ranks_heads(heads):
    """#7's launch plan on a rank's heads at model 2 and 4 (6 and 3 of 12):
    a head grouping exists at every batch of the decode (1 to 48) over
    1,152 and 384 cache slots, its groups divide the heads and the grid
    stays within the plan's wave, as at 12 heads."""
    from vitxtgqa_tpu_torch.ops import decode_attention as DA

    for batch in (1, 2, 8, 48):
        for cache in (1152, 384):
            plan = DA.launch_plan(batch, cache, heads, 2)
            assert heads % plan.head_groups == 0
            assert plan.heads_per_group * plan.head_groups == heads
            assert plan.blocks == batch * plan.head_groups * plan.cluster
            assert plan.blocks <= max(DA.WAVE, batch * plan.cluster)


def test_model_beside_sp_or_pp_and_int8_on_a_model_mesh_raise():
    """mesh_shape: data -1 takes the world over model, and over model x sp
    or model x pp, which run (tests/test_torch_tp_mesh.py) and raise
    ValueError in a world that does not hold them; Options(tp=...) takes
    sp and pp beside it, and with the int8 cache or W8A8 raises naming
    queue 2."""
    from vitxtgqa_tpu_torch.parallel.mesh import ModelGroup, PPGroup, SPGroup, mesh_shape

    assert mesh_shape(-1, 2, world=4) == {"data": 2, "model": 2, "sp": 1, "pp": 1}
    for kw in (dict(sp=2), dict(pp=2)):
        assert mesh_shape(-1, 2, world=8, **kw) == {"data": 2, "model": 2, "sp": 1, "pp": 1,
                                                     **kw}
        with pytest.raises(ValueError, match="needs a multiple of 4 processes; the world has 1"):
            mesh_shape(-1, 2, world=1, **kw)
    with pytest.raises(ValueError, match="needs a multiple of 2 processes"):
        mesh_shape(-1, 2, world=3)
    tp = ModelGroup(None, 0, 2)
    opts = cpu_options(tp=tp, sp=SPGroup(None, 0, 2), pp=PPGroup(None, 0, 2))
    assert (opts.tp, opts.sp.size, opts.pp.size) == (tp, 2, 2)
    for kw in (dict(kv_cache_int8=True), dict(w8a8=True)):
        with pytest.raises(NotImplementedError, match="queue 2"):
            cpu_options(tp=ModelGroup(None, 0, 2), **kw)


def test_a_mesh_predicts_over_the_bf16_cache_as_jax_does(repo_root):
    """options_from_config on configs/t2s_serving.yml (int8 cache on): a
    data, model or pp axis above 1 turns the int8 cache and W8A8 off, as
    the JAX trainer does; one process and an sp-only mesh keep them;
    Options built directly keep their choice."""
    from vitxtgqa_tpu_torch.core.config import build_config
    from vitxtgqa_tpu_torch.parallel.mesh import Mesh
    from vitxtgqa_tpu_torch.training.trainer import options_from_config

    tp = build_config(os.path.join(repo_root, "configs", "t2s_serving.yml"), opts=[
        "training_parameters.device=cpu", "training_parameters.tpu.w8a8=True"]
    ).training_parameters
    for axes, on in (({}, True), ({"sp": 2}, True), ({"data": 2}, False), ({"pp": 2}, False),
                     ({"model": 2}, False)):
        shape = {"data": 1, "model": 1, "sp": 1, "pp": 1, **axes}
        o = options_from_config(tp, mesh=Mesh(shape=shape, coords={a: 0 for a in shape}))
        assert (o.kv_cache_int8, o.w8a8) == (on, on), axes
    assert cpu_options(kv_cache_int8=True).kv_cache_int8


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _encoder_inputs():
    rng = np.random.default_rng(17)
    from vitxtgqa_tpu_torch.models.common import TransformerConfig, TransformerEncoder

    shapes = TransformerEncoder(TransformerConfig(**ENC_CFG), cpu_options()).state_dict()
    state = {k: ((1.0 if k.endswith("LayerNorm.weight") else 0.0)
                 + rng.standard_normal(v.shape) * (0.02 if v.dim() == 1 else 0.08)
                 ).astype(np.float32) for k, v in shapes.items()}
    x = (rng.standard_normal((ENC_B, ENC_L, 128)) * 0.5).astype(np.float32)
    km = np.ones((ENC_B, ENC_L), np.float32)
    km[1, 150:] = 0.0
    km[:, ENC_L - ENC_DEC:] = 0.0
    g = rng.standard_normal(x.shape).astype(np.float32)
    return state, x, km, g


def _dropout_config():
    """The step's tiny config with every dropout at 0.1."""
    cfg = _plain(tiny_model_config(hidden=64, frames=FRAMES, ocr_per_frame=3, layers=2))
    cfg = {k: (dict(v) if hasattr(v, "items") else v) for k, v in cfg.items()}
    for sect in ("text_bert", "translayers", "mmt", "encoder"):
        cfg[sect].update(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
    return cfg


@functools.lru_cache(maxsize=None)
def _tp_step_inputs():
    """tests/test_torch_mesh.py's step inputs with every parameter drawn
    off the init (its biases are 0): each tensor's largest entry is then the
    scale of the limits, not a step's size."""
    cfg, state, batch, noise = _step_inputs()
    rng = np.random.default_rng(12)
    state = {k: (v + rng.standard_normal(v.shape).astype(np.float32) * 0.02) for k, v in
             state.items()}
    return cfg, state, batch, noise


@functools.lru_cache(maxsize=None)
def _eval_inputs():
    cfg, state, _, _ = _step_inputs()
    batch = synthetic_batch(batch=3, frames=FRAMES, ocr_per_frame=3, dec_steps=4, text_len=10,
                            video_feat_dim=32, fasttext_dim=16, phoc_dim=24,
                            num_final_outputs=NF, text_vocab=128, seed=8)
    rng = np.random.default_rng(9)
    noise = (rng.gumbel(size=(3, 2, FRAMES)).astype(np.float32),
             rng.gumbel(size=(3, 2, N_OCR)).astype(np.float32))
    # weights off the init's scale, so that full-eval's tokens are far from ties
    rng = np.random.default_rng(10)
    state = {k: (v + rng.standard_normal(v.shape).astype(np.float32) * 0.05
                 if v.ndim == 2 else v) for k, v in state.items()}
    return cfg, state, batch, noise


def _step_case(mesh, cfg, drop_seed):
    _, state, batch, noise = _tp_step_inputs()
    return dict(kind="step", mesh=mesh, cfg=cfg, nf=NF, state=state, batch=batch, noise=noise,
                losses=LOSSES, oa=OA, tp=TRAIN, drop_seed=drop_seed)


def _run_argv(fixroot, save_dir, steps, resume=None):
    layers = [f"model_attributes.t2s.{s}.num_hidden_layers=2"
              for s in ("text_bert", "translayers", "mmt")]
    return (_cli(_repo(), "t2s_abinet.yml", "train+inference")
            + tiny_opts(fixroot, save_dir, dropout=False, batch_size=GLOBAL,
                        evalai_inference=True, **{**TRAIN3, "max_iterations": steps})
            + layers + RUN_AXES
            + ([f"training_parameters.resume_file={resume}"] if resume else []))


def _repo():
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def background():
    """The JAX references (the data x model step, full-eval) computed in a
    thread of this process from the module's start while the ranks run."""
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        out = {"jax": pool.submit(lambda: (_jax_mesh_step(), _jax_eval()))}
        yield out
        out["jax"].exception()


@pytest.fixture(scope="module", autouse=True)
def worlds(tmp_path_factory, fixroot):
    """World "a" (four ranks: the data 2 x model 2 step) and world "b" (two
    ranks: the encoder, the step with dropout, full-eval, run() straight,
    then three steps and a resume); ``[w].results()`` waits for world w."""
    state, x, km, g = _encoder_inputs()
    root = tmp_path_factory.mktemp("tp_ranks")
    cfg, e_state, e_batch, e_noise = _eval_inputs()
    a = {"step": _step_case((2, 2), _step_config(), 0)}
    first = str(root / "first")
    b = {"encoder": dict(kind="encoder", cfg=ENC_CFG, state=state, x=x, key_mask=km, g=g,
                         dec_len=ENC_DEC, drop_seed=ENC_SEED),
         "step": _step_case((1, 2), _dropout_config(), 5),
         "eval": dict(kind="eval", cfg=cfg, nf=NF, state=e_state, batch=e_batch, noise=e_noise),
         "straight": dict(kind="run", argv=_run_argv(fixroot, str(root / "straight"), 4)),
         "first": dict(kind="run", argv=_run_argv(fixroot, first, 3)),
         "resumed": dict(kind="run", argv=_run_argv(
             fixroot, str(root / "resumed"), 4, os.path.join(first, "ckpt", "best")))}
    out = {}
    for w, cases, n in (("a", a, 4), ("b", b, 2)):
        os.makedirs(root / w)
        out[w] = torch_tp_ranks.start(cases, root / w, world=n)
    yield out
    for r in out.values():
        for p in r.procs:
            if p.poll() is None:
                p.kill()
            p.wait()


def test_split_encoder_equals_one_process(worlds):
    """A 2-layer encoder at lane-aligned widths split over 2 ranks (the
    flash route with its dropout at each rank's head offset, the training
    block's split form, both dropouts at 0.1): the training pass's output
    and input gradient within 2e-5, every parameter's gradient (made whole)
    within 1e-4 of its largest entry, and the eval pass with the tanh
    residual within 2e-5 of the encoder in one process."""
    from vitxtgqa_tpu_torch.models.common import TransformerConfig, TransformerEncoder
    from vitxtgqa_tpu_torch.ops.masks import MaskSpec

    state, x, km, g = _encoder_inputs()
    enc = TransformerEncoder(TransformerConfig(**ENC_CFG), cpu_options())
    enc.load_state_dict({k: T(v) for k, v in state.items()})
    spec = MaskSpec(key_mask=T(km), dec_len=ENC_DEC)
    xg = T(x).requires_grad_()
    y = enc(xg, spec, train=True, gen=torch.Generator().manual_seed(ENC_SEED))
    y.backward(T(g))
    with torch.no_grad():
        y_eval = enc(T(x), spec, tanh_residual_base=T(x))
    for r in worlds["b"].results():
        got = r["encoder"]
        assert len(got["sharded"]) == 10 * ENC_CFG["num_hidden_layers"]
        np.testing.assert_allclose(got["y"], y.detach().numpy(), atol=FWD_TOL, rtol=FWD_TOL)
        np.testing.assert_allclose(got["y_eval"], y_eval.numpy(), atol=FWD_TOL, rtol=FWD_TOL)
        np.testing.assert_allclose(got["dx"], xg.grad.numpy(), atol=FWD_TOL, rtol=FWD_TOL)
        for k, p in enc.named_parameters():
            if not _noise_entry(k):
                _rel_close(got["grads"][k], p.grad.numpy(), GRAD_TOL, k)


@functools.lru_cache(maxsize=None)
def _port_step(cfg_name, drop_seed):
    """The port's step in one process on the global batch: loss, norm,
    applied gradients, parameters after."""
    from vitxtgqa_tpu_torch.losses import Losses
    from vitxtgqa_tpu_torch.models.t2s import T2S
    from vitxtgqa_tpu_torch.training.optim import build_optimizer
    from vitxtgqa_tpu_torch.training.step import step_generators, train_step

    _, state, batch, noise = _tp_step_inputs()
    cfg = _step_config() if cfg_name == "plain" else _dropout_config()
    model = T2S(cfg, NF, bos_idx=2, opts=cpu_options())
    model.load_state_dict({k: T(v) for k, v in state.items()})
    opt = build_optimizer(model, _ns(OA), _ns(TRAIN), cfg)
    names = [k for k, _ in model.named_parameters()]
    applied = {}
    apply = opt.apply

    def keep_and_apply():
        applied.update({k: m.grad.detach().numpy().copy() for k, (_, m) in zip(names, opt.pairs)})
        apply()

    opt.apply = keep_and_apply
    gumbel = tuple(T(noise[(GLOBAL, 2, n)]) for n in (FRAMES, N_OCR))
    r = train_step(model, Losses(LOSSES), opt, {k: torch.as_tensor(v) for k, v in batch.items()},
                   (step_generators(drop_seed, 1, torch.device("cpu"))[0], gumbel))
    return {"loss": float(r["loss"]), "norm": float(r["grad_norm"]), "grads": applied,
            "state": {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}}


def _jax_mesh_step(data=2, model=2, sp=1, pp=1):
    """JAX's step on a data x model x sp x pp mesh of CPU devices (data 2
    x model 2 by default), its parameters under param_shardings, the
    batch's rows over data, and its sequence parallelism and pipeline
    switched on where those axes are above 1 (as its trainer does; traced
    under jit): the loss, the gradients clipped as the optimizer clips
    them, the parameters after (port names)."""
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from vitxtgqa_tpu.losses import Losses as JLosses
    from vitxtgqa_tpu.models import common as JC
    from vitxtgqa_tpu.models.t2s import T2S as JT2S
    from vitxtgqa_tpu.ops import attention as JA
    from vitxtgqa_tpu.parallel.mesh import build_mesh, param_shardings
    from vitxtgqa_tpu.training.optim import build_optimizer as jax_build

    cfg, state, batch, noise = _tp_step_inputs()
    mp = pytest.MonkeyPatch()
    try:
        _patch_jax_gumbel(mp, noise)
        jm = JT2S(config=cfg, num_final_outputs=NF, bos_idx=2, train_variant_scan=True)
        jlosses = JLosses(LOSSES)
        tx, _ = jax_build(_ns(OA), _ns(TRAIN), _step_config(node=True))
        mesh = build_mesh(data=data, model=model, sp=sp, pp=pp,
                          devices=jax.devices()[:data * model * sp * pp])
        if sp > 1:
            JA.set_sequence_parallel(mesh, "sp")
        if pp > 1:
            JC.set_pipeline(mesh, "pp")
        params = unflatten(convert_t2s_like({k: v.copy() for k, v in state.items()},
                                            text_layers=2, qtv_layers=2, mmt_layers=2))
        params = jax.device_put(params, param_shardings(params, mesh))
        tensors = jax.device_put({k: jnp.asarray(v) for k, v in batch.items()},
                                 NamedSharding(mesh, P("data")))
        clip = float(TRAIN["max_grad_l2_norm"])

        def step(params, opt_state, tensors):
            def loss_fn(p):
                out = jm.apply({"params": p}, tensors, train=True,
                               rngs={"dropout": jax.random.key(1), "gumbel": jax.random.key(2)})
                return jlosses.total(tensors, out)[0]

            total, grads = jax.value_and_grad(loss_fn)(params)
            norm = jnp.sqrt(sum(jnp.sum(g * g) for g in jax.tree_util.tree_leaves(grads)))
            clipped = jax.tree_util.tree_map(lambda g: g * jnp.minimum(1.0, clip / norm), grads)
            updates, opt_state = tx.update(grads, opt_state, params)
            return (jax.tree_util.tree_map(lambda p, u: p + u, params, updates), total, clipped,
                    norm)

        new, total, grads, norm = fast_jit(step, params, tx.init(params), tensors)
        assert "model" in str(jax.tree_util.tree_leaves(new)[0].sharding.mesh.axis_names)
        to_port = lambda tree: _tree_to_port(jax.tree_util.tree_map(np.asarray, tree))
        return {"loss": float(total), "norm": float(norm), "grads": to_port(grads),
                "state": to_port(new)}
    finally:
        JA.set_sequence_parallel(None)
        JC.set_pipeline(None)
        mp.undo()


def _jax_eval():
    """JAX's full-eval forward (one device) on the eval case: the scores."""
    from vitxtgqa_tpu.models.t2s import T2S as JT2S

    cfg, state, batch, noise = _eval_inputs()
    mp = pytest.MonkeyPatch()
    try:
        _patch_jax_gumbel(mp, {n.shape: n for n in noise})
        jm = JT2S(config=cfg, num_final_outputs=NF, bos_idx=2)
        params = unflatten(convert_t2s_like({k: v.copy() for k, v in state.items()},
                                            text_layers=2, qtv_layers=2, mmt_layers=2))
        out = fast_jit(lambda p, t: jm.apply({"params": p}, t, train=False,
                                             rngs={"gumbel": jax.random.key(3)}),
                       params, {k: jnp.asarray(v) for k, v in batch.items()})
        return {k: np.asarray(out[k]) for k in ("pos_scores", "ref_scores", "neg_scores")}
    finally:
        mp.undo()


def _check_step(ranks, want, one, state):
    """The ranks' step against the port's one-process step and (``want``)
    JAX's: the loss, the norm, every applied gradient and every parameter
    after (a key projection's bias: its change held to float32 noise)."""
    r0 = ranks[0]
    assert all(r["applied"] for r in ranks)
    assert all(r["loss"] == r0["loss"] and r["norm"] == r0["norm"] for r in ranks)
    assert all(np.array_equal(r["state"][k], r0["state"][k]) for r in ranks for k in r0["state"])
    for ref in [one] + ([want] if want else []):
        np.testing.assert_allclose(r0["loss"], ref["loss"], rtol=1e-5)
        np.testing.assert_allclose(r0["norm"], ref["norm"], rtol=1e-4)
        for k, g in ref["grads"].items():
            if not _noise_entry(k):
                _rel_close(r0["grads"][k], g, GRAD_TOL, k)
        for k, p in ref["state"].items():
            if _noise_entry(k):   # float32 noise on both sides, held that small
                assert np.abs(r0["state"][k] - state[k]).max() < 1e-2 * OA["params"]["lr"], k
            else:
                _rel_close(r0["state"][k], p, GRAD_TOL, k)


def test_data_model_step_equals_jax_on_its_mesh_and_one_process(worlds, background):
    """One clipped Adam step at the global batch 4 on data 2 x model 2 (four
    ranks, dropout 0): every rank reports the global loss and norm and holds
    the same whole parameters; against JAX's step on a data 2 x model 2
    mesh under param_shardings and the port in one process: the loss within
    rtol 1e-5, every applied gradient and parameter update within 1e-4 of
    its tensor's largest entry."""
    want = background["jax"].result()[0]
    one = _port_step("plain", 0)
    _, state, _, _ = _tp_step_inputs()
    ranks = [r["step"] for r in worlds["a"].results()]
    assert [r["coords"]["model"] for r in ranks] == [0, 1, 0, 1]
    _check_step(ranks, want, one, state)


def test_model_step_with_dropout_equals_one_process(worlds):
    """The step at model 2 with every dropout at 0.1 against the port in
    one process from the same seed: each rank draws the one process's masks
    (the attention's at its heads' offset), so the loss, gradients and
    updates agree at the step's limits."""
    _, state, _, _ = _tp_step_inputs()
    _check_step([r["step"] for r in worlds["b"].results()], None, _port_step("dropout", 5),
                state)


def test_full_eval_tokens_equal_one_process_and_jax(worlds, background):
    """Full-eval (the greedy decode over the bf16 cache, then ref / neg
    teacher-forced) at model 2: the tokens equal to the port's in one
    process and to JAX's, the scores within 2e-5."""
    from vitxtgqa_tpu_torch.models.t2s import T2S

    cfg, state, batch, noise = _eval_inputs()
    model = T2S(cfg, NF, bos_idx=2, inference_only=False, opts=cpu_options())
    model.load_state_dict({k: T(v) for k, v in state.items()})
    with torch.no_grad():
        out = model({k: torch.as_tensor(v) for k, v in batch.items()}, tuple(map(T, noise)))
    jout = background["jax"].result()[1]
    for r in worlds["b"].results():
        got = r["eval"]
        for ref in ({k: out[k].numpy() for k in got}, jout):
            assert np.array_equal(got["pos_scores"].argmax(-1), ref["pos_scores"].argmax(-1))
            for k in got:
                np.testing.assert_allclose(got[k], ref[k], atol=FWD_TOL, rtol=FWD_TOL, err_msg=k)


def test_model_run_checkpoint_is_whole_and_resumes_exactly(worlds):
    """run() at mesh.model=2: predictions written once by rank 0 over the
    bf16 cache; ckpt/final holds every parameter and Adam moment whole,
    bit for bit the ranks' shards concatenated; three steps, a snapshot and
    a resume give the fourth step's loss and the final parameters of four
    steps straight, bit for bit."""
    r0, r1 = (r["straight"] for r in worlds["b"].results())
    assert r0["mesh"]["model"] == 2 and not r0["kv_cache_int8"]
    assert r0["series"] == r1["series"] and len(r0["reports"]) == 2 and r1["reports"] == {}
    saved = r0["saved"]
    for k, v in saved["model"].items():
        a, b = r0["own"][k], r1["own"][k]
        want = a if a.shape == v.shape else np.concatenate(
            [a, b], axis=next(i for i in range(a.ndim) if a.shape[i] != v.shape[i]))
        assert np.array_equal(v, want), k
    for i, moments in saved["moments"].items():
        dim = r0["sharded"][i]
        for key, v in moments.items():
            a, b = r0["own_moments"][i][key], r1["own_moments"][i][key]
            assert np.array_equal(v, a if dim is None else np.concatenate([a, b], axis=dim))
    for r in worlds["b"].results():
        straight, first, resumed = r["straight"], r["first"], r["resumed"]
        got, want = resumed["series"]["train/total_loss"], straight["series"]["train/total_loss"]
        assert len(first["series"]["train/total_loss"]) == 3
        assert len(got) == 1 and len(want) == 4 and got[0] == want[3]
        assert all(np.array_equal(resumed["own"][k], straight["own"][k]) for k in straight["own"])
    resumed, straight = (worlds["b"].results()[0][n]["saved"]["model"]
                         for n in ("resumed", "straight"))
    assert all(np.array_equal(resumed[k], straight[k]) for k in straight)
