"""The port's CLIP towers (vitxtgqa_tpu_torch/models/clip.py) against the
JAX CLIP (vitxtgqa_tpu/models/clip.py) on the CPU in float32, at the JAX
tests' tiny geometries (tests/test_clip_parity.py).

The weights are a seeded state dict of the port's CLIP, in OpenAI's
layout, its BatchNorm running statistics randomised: the JAX side takes it
through build_clip_params, the port through load_state_dict alone.  Images
are NCHW for the port and transposed to NHWC for JAX.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tests.torch_helpers import one_torch_thread  # noqa: F401
from vitxtgqa_tpu.models import clip as JC
from vitxtgqa_tpu_torch.models import clip as TC
from vitxtgqa_tpu_torch.utils.convert import clip_state_dict_from_jax

ATOL, RTOL = 2e-4, 1e-3  # tests/test_clip_parity.py:55-57
# the JAX tests' geometries (tests/test_clip_parity.py): a ViT and a ResNet
GEOMETRIES = {
    "vit": dict(embed_dim=16, image_resolution=32, vision_layers=2, vision_width=64,
                vision_patch_size=16, context_length=12, vocab_size=50, transformer_width=128,
                transformer_heads=2, transformer_layers=2),
    "resnet": dict(embed_dim=32, image_resolution=32, vision_layers=(1, 1, 1, 1),
                   vision_width=16, vision_patch_size=0, context_length=10, vocab_size=40,
                   transformer_width=128, transformer_heads=2, transformer_layers=1),
}


def _state(kind: str, seed: int = 0):
    """(the port CLIP loaded from a seeded OpenAI-layout state dict, that
    state dict as numpy), the BatchNorms' running statistics randomised."""
    model = TC.CLIP(TC.CLIPConfig(**GEOMETRIES[kind]), device="cpu").init_weights(seed)
    rng = np.random.default_rng(seed + 1)
    sd = model.state_dict()
    for k, v in sd.items():
        if k.endswith("running_mean"):
            sd[k] = torch.from_numpy(rng.normal(0, 0.3, v.shape).astype(np.float32))
        elif k.endswith("running_var"):
            sd[k] = torch.from_numpy(rng.uniform(0.5, 1.5, v.shape).astype(np.float32))
    port = TC.CLIP(model.cfg, device="cpu")
    port.load_state_dict(sd)
    return port.eval(), {k: v.numpy() for k, v in sd.items()}


def _inputs(kind: str, seed: int, b: int):
    g = GEOMETRIES[kind]
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((b, 3, g["image_resolution"], g["image_resolution"]))
    text = rng.integers(0, g["vocab_size"], (b, g["context_length"]))
    return images.astype(np.float32), text.astype(np.int64)


@pytest.fixture(scope="module", params=sorted(GEOMETRIES))
def both(request):
    """(kind, the port CLIP, its images and texts, the JAX outputs: the
    image features, the EOT and per-token text features and both logit
    matrices from one jitted call, and the JAX config)."""
    kind = request.param
    port, sd = _state(kind)
    cfg, variables = JC.build_clip_params(sd)
    images, text = _inputs(kind, 3, 3)
    jm = JC.CLIP(cfg)

    def run(v, x, t):
        img = jm.apply(v, x, method=JC.CLIP.encode_image)
        txt, word = jm.apply(v, t, method=JC.CLIP.encode_text)
        return (img, txt, word) + jm.apply(v, x, t)
    want = [np.asarray(w) for w in jax.jit(run)(variables, images.transpose(0, 2, 3, 1), text)]
    return kind, port, images, text, want, cfg


def test_towers_match_jax(both):
    """encode_image and encode_text (the EOT feature and every token's)
    within the JAX test's limits; infer_clip_config equal on both sides."""
    kind, port, images, text, want, cfg = both
    assert dataclasses.asdict(TC.infer_clip_config(port.state_dict())) == dataclasses.asdict(cfg)
    assert dataclasses.asdict(port.cfg) == dataclasses.asdict(cfg)
    with torch.no_grad():
        got = [port.encode_image(torch.from_numpy(images)).numpy()]
        got += [x.numpy() for x in port.encode_text(torch.from_numpy(text))]
    for g, w in zip(got, want[:3]):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL)


def test_logits_match_jax(both):
    """Both logit matrices within the JAX logits test's limits (atol 2e-3,
    rtol 1e-3: tests/test_clip_parity.py:123-128)."""
    kind, port, images, text, want, _ = both
    with torch.no_grad():
        got = port(torch.from_numpy(images), torch.from_numpy(text))
    for g, w in zip(got, want[3:]):
        np.testing.assert_allclose(g.numpy(), w, atol=2e-3, rtol=1e-3)


@pytest.mark.parametrize("kind", sorted(GEOMETRIES))
def test_state_dict_round_trips_through_build_clip_params(kind):
    """A state dict through build_clip_params and clip_state_dict_from_jax
    comes back unchanged, name for name and bit for bit."""
    _, sd = _state(kind, seed=5)
    _, variables = JC.build_clip_params(sd)
    back = clip_state_dict_from_jax(variables)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)


def test_load_clip_reads_a_checkpoint_with_the_metadata_keys(tmp_path):
    """load_clip on a saved state dict with a TorchScript checkpoint's
    metadata keys builds the geometry and the weights on the CPU."""
    port, sd = _state("resnet", seed=7)
    blob = {k: torch.from_numpy(v) for k, v in sd.items()}
    blob.update(input_resolution=torch.tensor(32), context_length=torch.tensor(10),
                vocab_size=torch.tensor(40))
    path = tmp_path / "clip.pt"
    torch.save(blob, path)
    loaded = TC.load_clip(str(path), device="cpu")
    assert loaded.cfg == port.cfg and not loaded.training
    images, text = _inputs("resnet", 8, 2)
    with torch.no_grad():
        a = loaded(torch.from_numpy(images), torch.from_numpy(text))[0]
        b = port(torch.from_numpy(images), torch.from_numpy(text))[0]
    assert torch.equal(a, b)


def test_the_clip_configs_match_jax():
    assert dataclasses.asdict(TC.CLIP_VIT_B_32) == dataclasses.asdict(JC.CLIP_VIT_B_32)
    assert dataclasses.asdict(TC.CLIP_RN50) == dataclasses.asdict(JC.CLIP_RN50)
