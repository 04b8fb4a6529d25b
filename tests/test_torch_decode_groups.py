"""The fused decode (#5 fused_decode_step, #6 fused_epilogue) above 8 batch
rows: the port's plain versions against the JAX package's at batches that
run as several launches on the card (ops/decode_step.row_groups: groups of
8 rows, the last one 1-8), the wrappers' gates and scratch, and the tiny
T2S forced onto the fused decode at batch 9 and 16 against the JAX T2S.

CPU, float32, the geometry of tests/test_torch_decode_step.py.  The JAX
kernels run in Pallas interpret mode (its step takes blocks of 8 rows
where 8 divides the batch, else of 1: 16 and 9 run both forms), the
port's wrappers their plain versions on CPU tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_decode_step import (DEC, LP, N_LAYERS, QK, V_FIX, V_P, WRITE_OFF, D, H, M,
                                          _cache, _check_step, _epilogue_case, _np, _stacks)
from tests.test_torch_t2s import FRAMES, _force_fused_decode, _setup, _state_numpy, _tensors
from tests.torch_helpers import one_torch_thread  # noqa: F401
from vitxtgqa_tpu.ops import pallas_decode_step as PDS
from vitxtgqa_tpu_torch.ops import _build
from vitxtgqa_tpu_torch.ops import decode_step as TDS

T = torch.from_numpy


@pytest.mark.parametrize("b", [9, 16, 48])
def test_plain_step_matches_the_jax_reference_above_8_rows(b):
    """y within 2e-5, row8 bit-exact, rowsc within 1e-7 against
    fused_step_reference; at 9 and 16 against the Pallas kernel in
    interpret mode too (1-row and 8-row blocks)."""
    jst, tst = _stacks()
    kv8, kvs, x_t, mask = _cache(seed=b, b=b)
    got = TDS.fused_decode_step_plain(T(x_t), tst, T(kv8), T(kvs), T(mask), 2, WRITE_OFF, H)
    jargs = (jnp.asarray(x_t), jst, jnp.asarray(kv8), jnp.asarray(kvs), jnp.asarray(mask))
    _check_step(got, PDS.fused_step_reference(*jargs, 2, WRITE_OFF, H))
    if b < 48:
        _check_step(got, PDS.fused_decode_step(*jargs, jnp.int32(2), WRITE_OFF, H,
                                               interpret=True))


@pytest.mark.parametrize("b", [9, 12])
def test_plain_epilogue_matches_pallas_interpret_above_8_rows(b):
    """Scores within 1e-5, tokens exact, the next embedding within 1e-5
    against JAX's interpret fused_epilogue (1-row blocks at 9, 4-row at
    12), a copy slot winning every row."""
    y, cls_w, cls_b, ptr_w, ptr_b, keys, mask, ans, ocr, emb = _epilogue_case("ocr", b=b, seed=b)
    scale = 1.0 / QK ** 0.5
    want = PDS.fused_epilogue(jnp.asarray(y), jnp.asarray(cls_w.T), jnp.asarray(cls_b),
                              jnp.asarray(ptr_w.T), jnp.asarray(ptr_b), jnp.asarray(keys),
                              jnp.asarray(mask), jnp.asarray(ans), jnp.asarray(ocr),
                              jnp.asarray(emb), jnp.int32(1), V_FIX, scale, DEC, interpret=True)
    got = TDS.fused_epilogue_plain(T(y), T(cls_w), T(cls_b), T(ptr_w), T(ptr_b), T(keys),
                                   T(mask), T(ans), T(ocr), T(emb), 1, V_FIX, scale, DEC)
    assert got[0].shape == (b, 1, V_P + keys.shape[1])
    np.testing.assert_allclose(_np(got[0]), np.asarray(want[0]), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(_np(got[1]), np.asarray(want[1]))
    np.testing.assert_allclose(_np(got[2]), np.asarray(want[2]), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("b,groups", [(1, [(0, 1)]), (8, [(0, 8)]), (9, [(0, 8), (8, 1)]),
                                      (10, [(0, 8), (8, 2)]), (16, [(0, 8), (8, 8)]),
                                      (48, [(8 * i, 8) for i in range(6)]),
                                      (51, [(8 * i, 8) for i in range(6)] + [(48, 3)])])
def test_row_groups_cover_the_batch_once(b, groups):
    assert TDS.row_groups(b) == groups
    assert sum(rows for _, rows in groups) == b and all(1 <= r <= TDS.GROUP_ROWS
                                                        for _, r in groups)


def test_check_step_shape_admits_any_batch_and_refuses_the_other_caps():
    """Batch 48 and 192 pass; past the caps each message names its
    ROADMAP item: heads wider than 128 (queue 2 item 5), the widths and
    caches past 4,096 slots (queue 2 item 3)."""
    for b in (1, 9, 48, 192, 576):
        TDS.check_step_shape(768, 3072, 12, 768, b, 1152)
    for args, item in (((1024, 4096, 4, 1024, 48, 1152), "queue 2 item 5"),
                       ((704, 2816, 11, 704, 48, 1152), "queue 2 item 3"),
                       ((768, 3072, 12, 768, 48, 4100), "queue 2 item 3")):
        with pytest.raises(NotImplementedError, match=item):
            TDS.check_step_shape(*args)


def test_buffers_hold_the_batch_and_one_group_of_scratch():
    buf = TDS.step_buffers(N_LAYERS, 48, D, M, "cpu", H)
    assert buf["y"].shape == (48, 1, D) and buf["row8"].shape == (N_LAYERS, 48, 1, 2 * D)
    assert buf["rowsc"].shape == (N_LAYERS, 48, 2, 1)
    assert buf["qkv"].shape == (8, 3 * D) and buf["opart"].shape == (H, 8, D)
    assert buf["arrive"].shape == (8 * H,) and not buf["arrive"].any()
    small = TDS.step_buffers(N_LAYERS, 3, D, M, "cpu", H)
    assert small["qkv"].shape == (3, 3 * D)
    epi = TDS.epilogue_buffers(48, QK, "cpu")
    assert epi["q"].shape == (8, QK) and epi["part_v"].shape == (8, TDS.EPILOGUE_MAX_GRID)
    assert TDS.epilogue_buffers(2, QK, "cpu")["q"].shape == (2, QK)


def test_wrappers_on_cpu_run_plain_at_any_batch_and_count_nothing():
    _, tst = _stacks()
    kv8, kvs, x_t, mask = _cache(seed=5, b=9)
    _build.reset_launch_counts()
    got = TDS.fused_decode_step(T(x_t), tst, T(kv8), T(kvs), T(mask), 1, WRITE_OFF, H)
    want = TDS.fused_decode_step_plain(T(x_t), tst, T(kv8), T(kvs), T(mask), 1, WRITE_OFF, H)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    args = [T(a) for a in _epilogue_case("fixed", b=9)]
    got = TDS.fused_epilogue(*args, 1, V_FIX, QK ** -0.5, DEC)
    want = TDS.fused_epilogue_plain(*args, 1, V_FIX, QK ** -0.5, DEC)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert _build.launch_counts() == {name: 0 for name in _build.LAUNCHES}


@pytest.mark.parametrize("b", [9, 16])
@pytest.mark.parametrize("compact", [False, True])
def test_t2s_fused_decode_above_8_rows_matches_jax(b, compact, monkeypatch):
    """The tiny T2S with the int8 cache and the fused decode forced on in
    both packages at batch 9 and 16 (the exact geometry: #5 and #6;
    compact serving: #5 and the epilogue in PyTorch, JAX's step_fused):
    greedy tokens and grounding exact, scores within 2e-5, one plain step
    a decode step (a launch a group on the card)."""
    import vitxtgqa_tpu.models.grounding as G
    from vitxtgqa_tpu.models.common import (set_compact_serving, set_fused_decode_max_batch,
                                            set_kv_cache_int8)
    from vitxtgqa_tpu.models.t2s import T2S as JT2S
    from vitxtgqa_tpu.utils.torch_convert import convert_t2s_like, unflatten

    ocr_pf = 3
    cfg, nf, batch, model = _setup(ocr_pf, 64, b, True, seed=b, compact_serving=compact,
                                   fused_decode_max_batch=b)
    _force_fused_decode(monkeypatch)
    set_fused_decode_max_batch(b)  # the cap of the JAX serving branch (base.py:335)
    set_compact_serving(compact)
    set_kv_cache_int8(True)
    n = FRAMES * ocr_pf
    rng = np.random.default_rng(b)
    noise = {(b, 2, FRAMES): rng.gumbel(size=(b, 2, FRAMES)).astype(np.float32),
             (b, 2, n): rng.gumbel(size=(b, 2, n)).astype(np.float32)}

    def jax_gumbel(r, logits, tau=1.0, axis=-1, hard=True):
        y = jax.nn.softmax((logits + jnp.asarray(noise[tuple(logits.shape)])) / tau, axis=axis)
        yh = jnp.put_along_axis(jnp.zeros_like(y), jnp.argmax(y, axis=axis, keepdims=True), 1.0,
                                axis=axis, inplace=False)
        return yh + y - jax.lax.stop_gradient(y)

    monkeypatch.setattr(G, "gumbel_softmax", jax_gumbel)
    params = unflatten(convert_t2s_like(_state_numpy(model), text_layers=1, qtv_layers=1,
                                        mmt_layers=2))
    traced = []  # the JAX branch taken: its kernels traced once each in the scan
    for name in ("fused_decode_step", "fused_epilogue"):
        real = getattr(PDS, name)
        monkeypatch.setattr(PDS, name, lambda *a, _r=real, _n=name, **k: traced.append(_n)
                            or _r(*a, **k))
    jm = JT2S(config=cfg, num_final_outputs=nf, bos_idx=2, inference_only=True)
    want = jax.jit(lambda p, bt: jm.apply({"params": p}, bt, train=False,
                                          rngs={"gumbel": jax.random.key(0)}))(params, batch)
    calls = []
    for name in ("fused_decode_step_plain", "fused_epilogue_plain"):
        real = getattr(TDS, name)
        monkeypatch.setattr(TDS, name, lambda *a, _r=real, _n=name, **k: calls.append(_n)
                            or _r(*a, **k))
    got = model(_tensors(batch), (torch.from_numpy(noise[(b, 2, FRAMES)]),
                                  torch.from_numpy(noise[(b, 2, n)])))
    w, g = np.asarray(want["pos_scores"]), got["pos_scores"].numpy()
    np.testing.assert_allclose(g, w, atol=2e-5, rtol=2e-5)
    np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1))
    np.testing.assert_array_equal(got["ground_frame"].numpy(), np.asarray(want["ground_frame"]))
    np.testing.assert_array_equal(got["ground_box"].numpy(), np.asarray(want["ground_box"]))
    steps = w.shape[1]
    assert set(traced) == ({"fused_decode_step"} if compact
                           else {"fused_decode_step", "fused_epilogue"})
    assert calls.count("fused_decode_step_plain") == steps
    assert calls.count("fused_epilogue_plain") == (0 if compact else steps)
