"""The port's ViT frame-feature path (models/vit.py, video_feat.py) against
the JAX package's (vitxtgqa_tpu/models/vit.py).

float32 on the CPU, at a tiny width (image 64, patch 8, hidden 128, 2
layers, MLP 256, 4 heads).  Weights are made by the JAX model's init and
carried to the port with utils/convert.vit_from_jax_params; frames are
made with numpy from a seed.  On the CPU the JAX ViT never takes its
Pallas kernels (they need the TPU), while the port takes its kernel ops'
plain versions wherever the kernels' gates hold: the fused FFN (#13) from
2,048 rows and the bias-tensor attention (#14) from 256 tokens; the tests
count those routes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_helpers import cpu_options, one_torch_thread  # noqa: F401
from vitxtgqa_tpu.models import vit as JV
from vitxtgqa_tpu.utils.torch_convert import convert_vit_state, flatten
from vitxtgqa_tpu_torch.models import vit as TV
from vitxtgqa_tpu_torch.ops import ffn as TFFN
from vitxtgqa_tpu_torch.ops import fused_attention as TFA
from vitxtgqa_tpu_torch.utils.convert import strip_vit_prefix, vit_from_jax_params
from vitxtgqa_tpu_torch.utils.synthetic import synthetic_frames

TINY = dict(image_size=64, patch_size=8, hidden_size=128, num_layers=2, num_heads=4,
            mlp_dim=256)
TOL = 2e-5


def _configs(ln_eps=1e-12, **kw):
    """(JAX config, port config) of the same geometry."""
    geo = {**TINY, "ln_eps": ln_eps, **kw}
    return JV.ViTConfig(**geo), TV.ViTConfig(**geo)


def _jax_params(jcfg, seed=0):
    """The JAX model's own init, with the CLS token and the biases and
    LayerNorm parameters moved off their constant inits so that a swapped
    or dropped one shows."""
    params = JV.ViT(jcfg).init(jax.random.key(seed),
                               jnp.zeros((1, jcfg.image_size, jcfg.image_size, 3)))["params"]
    flat = {k: np.asarray(v) for k, v in flatten(params).items()}
    rng = np.random.default_rng(seed)
    for k, v in flat.items():
        if k.endswith(("bias", "scale")) or k == "cls_token":
            flat[k] = (v + rng.standard_normal(v.shape) * 0.05).astype(np.float32)
    return flat


def _unflat(flat):
    tree = {}
    for path, arr in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(arr)
    return tree


def _port_vit(tcfg, flat, **opts):
    model = TV.ViT(tcfg, cpu_options(**opts))
    model.load_state_dict(vit_from_jax_params(flat))
    return model.eval()


def _images(n, size, seed=0):
    frames = synthetic_frames(n, size, size, seed)
    return np.array(JV.preprocess_frames(jnp.asarray(frames), size))


@pytest.mark.parametrize("size", [(224, 224), (240, 320), (120, 160)])
def test_preprocess_frames_matches_jax(size):
    """uint8 frames -> resized and normalised, against jax.image.resize's
    antialiased bilinear: at 224 (no resize), a downscale from 240 x 320
    and an upscale from 120 x 160."""
    frames = synthetic_frames(3, *size, seed=1)
    want = np.asarray(JV.preprocess_frames(jnp.asarray(frames), 224))
    got = TV.preprocess_frames(torch.from_numpy(frames), 224)
    assert got.dtype == torch.float32 and got.shape == (3, 224, 224, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)


def test_preprocess_frames_needs_the_antialiased_resize():
    """Without antialiasing the 240 x 320 downscale moves far past the
    tolerance: the test above holds the antialiasing."""
    frames = torch.from_numpy(synthetic_frames(2, 240, 320, seed=1))
    x = frames.float().permute(0, 3, 1, 2) / 255.0
    plain = torch.nn.functional.interpolate(x, size=(224, 224), mode="bilinear",
                                            align_corners=False)
    got = TV.preprocess_frames(frames, 224).permute(0, 3, 1, 2)
    assert (plain * 2 - 1 - got).abs().max() > 100 * TOL


# name: (ln_eps, frames, image size, #13 route taken, #14 route taken).  ViT
# tokens: (64 / 8)^2 + 1 = 65, so 32 frames are 2,080 rows (>= 2,048: #13);
# at image 128 there are 257 tokens (>= 256: #14)
VIT_CASES = {
    "l16_eps": (1e-12, 2, 64, False, False),
    "b32_eps": (1e-5, 2, 64, False, False),
    "ffn_route": (1e-12, 32, 64, True, False),
    "attention_route": (1e-5, 2, 128, False, True),
}


@pytest.mark.parametrize("case", sorted(VIT_CASES))
def test_vit_matches_jax(case, monkeypatch):
    """CLS and tokens within 2e-5 of the JAX ViT from the same weights and
    images, with the fused FFN and bias-attention routes counted."""
    eps, n, size, ffn_route, attn_route = VIT_CASES[case]
    jcfg, tcfg = _configs(eps, image_size=size)
    flat = _jax_params(jcfg)
    images = _images(n, size)
    want_cls, want_tok = JV.ViT(jcfg).apply({"params": _unflat(flat)}, jnp.asarray(images))
    calls = {"ffn": 0, "attention": 0}

    def counting(mod, name, key):
        fn = getattr(mod, name)

        def call(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(mod, name, call)

    counting(TFFN, "fused_ffn_plain", "ffn")
    counting(TFA, "fused_attention_plain", "attention")
    with torch.inference_mode():
        cls, tok = _port_vit(tcfg, flat)(torch.from_numpy(images))
    assert cls.shape == (n, 128) and tok.shape == (n, tcfg.num_patches, 128)
    np.testing.assert_allclose(cls.numpy(), np.asarray(want_cls), atol=TOL)
    np.testing.assert_allclose(tok.numpy(), np.asarray(want_tok), atol=TOL)
    assert calls == {"ffn": 2 * ffn_route, "attention": 2 * attn_route}


def test_vit_plain_option_takes_the_same_branches():
    """Options(plain=True) runs the plain versions along the same gates and
    gives the same features on the CPU."""
    _, tcfg = _configs()
    flat = _jax_params(JV.ViTConfig(**TINY))
    images = torch.from_numpy(_images(32, 64))
    with torch.inference_mode():
        a = _port_vit(tcfg, flat)(images)[0]
        b = _port_vit(tcfg, flat, plain=True)(images)[0]
    assert torch.equal(a, b)


def test_weights_carry_both_ways():
    """vit_from_jax_params gives the port's state dict exactly (names,
    shapes, values), and vitxtgqa_tpu's convert_vit_state maps it back onto
    the JAX params bit for bit."""
    jcfg, tcfg = _configs(num_layers=3)
    flat = _jax_params(jcfg, seed=4)
    sd = vit_from_jax_params(flat)
    model = TV.ViT(tcfg, cpu_options())
    assert sorted(sd) == sorted(model.state_dict())
    model.load_state_dict(sd)
    back = flatten(convert_vit_state({k: v.numpy() for k, v in model.state_dict().items()},
                                     jcfg))
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(np.asarray(back[k]).reshape(v.shape), v, err_msg=k)


def test_an_hf_checkpoint_loads_after_the_prefix_strip():
    """A checkpoint of a model with a head (``vit.`` names, pooler,
    classifier) loads strictly into the port ViT after strip_vit_prefix."""
    _, tcfg = _configs()
    sd = TV.ViT(tcfg, cpu_options()).init_weights(3).state_dict()
    hf = {f"vit.{k}": v.clone() for k, v in sd.items()}
    hf.update({"vit.pooler.dense.weight": torch.zeros(128, 128),
               "vit.pooler.dense.bias": torch.zeros(128),
               "classifier.weight": torch.zeros(10, 128), "classifier.bias": torch.zeros(10)})
    model = TV.ViT(tcfg, cpu_options())
    model.load_state_dict(strip_vit_prefix(hf))
    assert all(torch.equal(model.state_dict()[k], v) for k, v in sd.items())


@pytest.mark.parametrize("wrap", ["model_blob", "module_prefix", "both"])
def test_a_wrapped_checkpoint_loads_after_the_prefix_strip(wrap, tmp_path):
    """A checkpoint saved as {"model": state_dict, ...} and / or with
    DataParallel ``module.`` prefixes, which vitxtgqa_tpu's
    load_state_dict unwraps, loads strictly into the port ViT through
    torch.load(weights_only=True) and strip_vit_prefix, as video_feat.main
    loads --weights."""
    _, tcfg = _configs()
    sd = TV.ViT(tcfg, cpu_options()).init_weights(5).state_dict()
    blob = {f"vit.{k}": v.clone() for k, v in sd.items()}
    blob["classifier.weight"] = torch.zeros(10, 128)
    if wrap != "model_blob":
        blob = {f"module.{k}": v for k, v in blob.items()}
    if wrap != "module_prefix":
        blob = {"model": blob, "epoch": torch.tensor(3)}
    torch.save(blob, tmp_path / "ckpt.pth")
    model = TV.ViT(tcfg, cpu_options())
    model.load_state_dict(strip_vit_prefix(torch.load(tmp_path / "ckpt.pth", weights_only=True)))
    assert all(torch.equal(model.state_dict()[k], v) for k, v in sd.items())


def test_feature_extractor_matches_jax():
    """make_feature_extractor on uint8 frames (resized from 48 x 80) against
    the JAX extractor: CLS [B, D] float32."""
    jcfg, tcfg = _configs(1e-5)
    flat = _jax_params(jcfg, seed=2)
    frames = synthetic_frames(3, 48, 80, seed=5)
    jextract, _ = JV.make_feature_extractor(jcfg, params=_unflat(flat))
    want = np.asarray(jextract(_unflat(flat), jnp.asarray(frames)))
    extract, model = TV.make_feature_extractor(tcfg, vit_from_jax_params(flat), cpu_options())
    got = extract(frames)
    assert not model.training and got.dtype == torch.float32 and got.shape == (3, 128)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)
    torch.testing.assert_close(extract(torch.from_numpy(frames)), got, rtol=0, atol=0)


def test_video_feat_writes_one_feature_per_frame(tmp_path):
    """video_feat.write_features: <video>/<n>.jpg in numeric order ->
    <video>/<n>.npy, float32 [1, D], each the extractor's CLS of that frame
    (PIL-resized to the model's size, as the CLI loads them)."""
    from PIL import Image

    from vitxtgqa_tpu_torch import video_feat

    _, tcfg = _configs()
    extract, _ = TV.make_feature_extractor(tcfg, None, cpu_options())
    names = {"vid_b": [1, 2, 10], "vid_a": [3]}
    frames = {}
    for i, (vid, ns) in enumerate(names.items()):
        (tmp_path / "frames" / vid).mkdir(parents=True)
        imgs = synthetic_frames(len(ns), 30, 40, seed=i)
        for n, img in zip(ns, imgs):
            Image.fromarray(img).save(tmp_path / "frames" / vid / f"{n}.jpg")
    (tmp_path / "frames" / "notes.txt").write_text("not a video")
    size = (tcfg.image_size, tcfg.image_size)

    def load(path):
        frames[path] = np.asarray(Image.open(path).convert("RGB").resize(size), dtype=np.uint8)
        return frames[path]

    written = video_feat.write_features(str(tmp_path / "frames"), str(tmp_path / "out"),
                                        extract, load, batch=2)
    assert written == 4
    assert [v for v, _, _ in video_feat.iter_videos(str(tmp_path / "frames"))] == ["vid_a",
                                                                                   "vid_b"]
    for vid, ns in names.items():
        assert sorted(p.name for p in (tmp_path / "out" / vid).iterdir()) == sorted(
            f"{n}.npy" for n in ns)
        for n in ns:
            feat = np.load(tmp_path / "out" / vid / f"{n}.npy")
            assert feat.dtype == np.float32 and feat.shape == (1, 128)
            img = frames[str(tmp_path / "frames" / vid / f"{n}.jpg")]
            np.testing.assert_allclose(feat, extract(img[None]).numpy(), atol=1e-6)


def test_presets_are_the_jax_presets():
    for name in ("VIT_L_16", "VIT_B_32"):
        j, t = dataclasses.asdict(getattr(JV, name)), dataclasses.asdict(getattr(TV, name))
        j.pop("dtype"), j.pop("dropout")
        assert t == j, name
    assert TV.VIT_L_16.num_patches + 1 == 197 and TV.VIT_B_32.num_patches + 1 == 50


def test_the_extractor_defaults_to_bf16_on_the_card():
    """Without options the extractor is built on the card in bf16, the
    dtype its kernels take; where there is no card that raises, and
    nothing falls back to the CPU."""
    _, tcfg = _configs()
    if torch.cuda.is_available():
        _, model = TV.make_feature_extractor(tcfg)
        p = next(model.parameters())
        assert p.is_cuda and p.dtype == torch.bfloat16
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            TV.make_feature_extractor(tcfg)
