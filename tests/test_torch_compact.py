"""The port's compact serving pieces against the JAX package, and its
defining property against the port's own full path.

CPU, float32, one torch thread.  ``_scatter_dynamic`` (both gather-list
forms) against JAX's; then compact serving against the full serving decode
of the same model: the kept rows attend to the same keys either way, so at
step 0 the fixed-vocabulary scores and the kept copy scores agree within
summation order, and the never-kept copy slots hold -1e4 (the documented
deviation from the reference's raw-mask pointer scores).  The end-to-end
slices against JAX T2S are SLICE_CASES "compact_*" in
tests/test_torch_t2s.py and the compact cases of test_full_eval_matches_jax
in tests/test_torch_train.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_helpers import cpu_options, one_torch_thread  # noqa: F401
from vitxtgqa_tpu.utils.synthetic import tiny_model_config
from vitxtgqa_tpu_torch.models.base import JointQAModel
from vitxtgqa_tpu_torch.models.t2s import T2S
from vitxtgqa_tpu_torch.utils.synthetic import synthetic_batch


@pytest.mark.parametrize("may_pad", [False, True])
def test_scatter_dynamic_matches_jax(may_pad):
    """Exact: a scatter of the same values.  With may_pad, -1 entries of the
    gather list go to the trash slot and leave -1e4 behind."""
    from vitxtgqa_tpu.models.base import JointQAModel as JJoint

    rng = np.random.default_rng(0)
    b, s, n, full_n = 3, 4, 6, 20
    idx = np.stack([rng.permutation(full_n)[:n] for _ in range(b)]).astype(np.int32)
    if may_pad:
        idx[1, 3:] = -1
    dyn = rng.standard_normal((b, s, n)).astype(np.float32)
    want = JJoint._scatter_dynamic(jnp.asarray(dyn), jnp.asarray(idx), full_n, may_pad)
    got = JointQAModel._scatter_dynamic(torch.from_numpy(dyn), torch.from_numpy(idx), full_n,
                                        may_pad)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_compact_serving_keeps_the_full_paths_kept_scores():
    """Step 0 of compact serving against the full serving decode of the same
    weights, batch and noise: fixed-vocabulary and kept copy scores within
    1e-5, every never-kept copy slot -1e4, grounding equal; and at every
    step the kept entries agree on the rows whose tokens agree so far."""
    frames, ocr_pf, b = 8, 3, 3
    n = frames * ocr_pf
    nf = 32 + n
    cfg = tiny_model_config(hidden=64, frames=frames, ocr_per_frame=ocr_pf)
    batch = synthetic_batch(batch=b, frames=frames, ocr_per_frame=ocr_pf, dec_steps=4,
                            text_len=10, video_feat_dim=32, fasttext_dim=16, phoc_dim=24,
                            num_final_outputs=nf, text_vocab=128, seed=3)
    tb = {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}
    full = T2S(cfg, nf, opts=cpu_options(kv_cache_int8=True)).init_weights(1)
    compact = T2S(cfg, nf, opts=cpu_options(kv_cache_int8=True, compact_serving=True))
    compact.load_state_dict(full.state_dict())
    noise = lambda: torch.Generator().manual_seed(9)
    f, c = full(tb, noise()), compact(tb, noise())
    assert torch.equal(f["ground_frame"], c["ground_frame"])
    fs, cs = f["pos_scores"].numpy(), c["pos_scores"].numpy()
    pinned = cs[..., 32:] == -1e4
    assert pinned.any() and (pinned.sum(-1) == n - frames * 2).all()
    kept = np.concatenate([np.ones_like(pinned[..., :1]).repeat(32, -1), ~pinned], axis=-1)
    np.testing.assert_allclose(cs[:, 0][kept[:, 0]], fs[:, 0][kept[:, 0]], atol=1e-5, rtol=1e-5)
    tok_f, tok_c = fs.argmax(-1), cs.argmax(-1)
    for t in range(1, fs.shape[1]):
        same = (tok_f[:, :t] == tok_c[:, :t]).all(-1)
        for row in np.nonzero(same)[0]:
            np.testing.assert_allclose(cs[row, t][kept[row, t]], fs[row, t][kept[row, t]],
                                       atol=1e-5, rtol=1e-5)
