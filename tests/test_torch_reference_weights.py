"""The reference's released state dicts loaded into the port
(vitxtgqa_tpu_torch/utils/torch_convert.py) against the JAX package's
converter (vitxtgqa_tpu/utils/torch_convert.py), for every registered
video model.

A reference-style state dict is made with numpy from a seed over the
port's parameter names at the tiny width (tests/test_torch_zoo.zoo_config),
with the reference's dead parameters planted beside them (the names the
JAX converter's docstrings list as skipped), wrapped as the reference
saves it ({"model": ...}, DataParallel ``module.`` prefixes) and written
with ``torch.save``.  JAX's name map is the oracle: ``reference_state``
must equal its ``convert_*`` followed by the port's
``from_jax_family_params`` bit for bit, and the names JAX's converter
reads must be the port's parameter names.
"""

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_zoo import (NF, assert_outputs_match, shared_noise, tensors, zoo_batch,
                                  zoo_config)
from tests.torch_helpers import cpu_options, one_torch_thread  # noqa: F401
from vitxtgqa_tpu.utils.torch_convert import (convert_mist, convert_t2s_like, convert_transtr,
                                              unflatten)
from vitxtgqa_tpu_torch.core.registry import registry
from vitxtgqa_tpu_torch.run import setup_imports
from vitxtgqa_tpu_torch.utils.convert import FAMILY_FLAGS, from_jax_family_params
from vitxtgqa_tpu_torch.utils.torch_convert import (load_reference_weights, load_state_dict,
                                                    reference_state)

KEYS = sorted(FAMILY_FLAGS)
# the reference's parameters that no forward of its models reads
# (vitxtgqa_tpu/utils/torch_convert.py:1-13, :219-224, :284-290)
DEAD = {
    "common": {"Grounding_Module.frame_attn.weight": (4, 64),
               "Grounding_Module.frame_attn.bias": (4,),
               "Grounding_Module.frame_indicator.weight": (1, 64),
               "Grounding_Module.encoder.layer.0.attention.self.query.weight": (64, 64),
               "linear_obj_frame_to_mmt_in.weight": (64, 82)},
    "transtr": {"spatial_enhance.weight_ih_l0": (256, 64),
                "VideoQAmodel.text_encoder.embeddings.word_embeddings.weight": (30, 64),
                "VideoQAmodel.vl_encoder.layer.0.attention.q_lin.weight": (64, 64),
                "VideoQAmodel.ans_decoder.layers.0.norm1.weight": (64,)},
    "mist": {"VideoQAmodel.ISTA.0.seg_embed.weight": (64, 64),
             "VideoQAmodel.ISTA.1.patch_embed.bias": (64,),
             "VideoQAmodel.ttrans.layer.0.attention.q_lin.weight": (64, 64),
             "VideoQAmodel.clip.visual.proj": (64, 32),
             "VideoQAmodel.crossmodal_matching.weight": (1, 64)},
}
# persistent buffers of the port that a reference dict may lack: none in
# any registered video model (every state-dict entry is a parameter)
BUFFERS = {key: () for key in KEYS}


def port_model(key, seed=0):
    setup_imports()
    cfg = zoo_config(key)
    return registry.get_model_class(key)(cfg, NF, bos_idx=2,
                                         opts=cpu_options()).init_weights(seed)


def dead_names(key):
    return {**DEAD["common"], **DEAD.get(key, {})}


def reference_dict(model, key, seed=1, classifier="classifier.module.", around=False):
    """The reference's state dict of ``model``'s names: numpy float32 from
    ``seed`` (``around``: the model's weights moved by 0.02 of it, the
    scale of a trained model's activations), the classifier under
    ``classifier``, the dead names planted."""
    rng = np.random.default_rng(seed)
    sd = {}
    for name, v in model.state_dict().items():
        if name.startswith("classifier.module."):
            name = classifier + name[len("classifier.module."):]
        noise = rng.standard_normal(tuple(v.shape))
        sd[name] = (v.numpy() + 0.02 * noise if around else noise).astype(np.float32)
    for name, shape in dead_names(key).items():
        sd[name] = rng.standard_normal(shape).astype(np.float32)
    return sd


def save_reference(sd, path):
    """Saved as the reference saves a checkpoint: the model under "model",
    every name with DataParallel's ``module.`` prefix, beside the
    optimizer's state and the run's counters."""
    blob = {"model": {f"module.{k}": torch.from_numpy(v) for k, v in sd.items()},
            "optimizer": {"state": {}, "param_groups": [{"lr": 1e-4}]},
            "best_iteration": 3, "best_metric_value": 0.25}
    torch.save(blob, path)
    return path


def jax_convert(sd, key):
    """JAX's converter of ``key`` at the tiny width: one text-BERT and one
    QTV layer, two MMT layers (TranSTR: two DETR layers; MIST: two ISTA
    rounds, its defaults)."""
    if key == "transtr":
        return convert_transtr(sd, text_layers=1, mmt_layers=2)
    if key == "mist":
        return convert_mist(sd, text_layers=1, mmt_layers=2)
    flags = {k: v for k, v in FAMILY_FLAGS[key].items() if k != "selector"}
    return convert_t2s_like(sd, text_layers=1, qtv_layers=1, mmt_layers=2, **flags)


class Recording(dict):
    """A state dict that records the names read from it."""

    def __init__(self, *a):
        super().__init__(*a)
        self.read = set()

    def __getitem__(self, name):
        self.read.add(name)
        return super().__getitem__(name)


@pytest.mark.parametrize("classifier", ["classifier.module.", "classifier."],
                         ids=["classifier_module", "classifier"])
@pytest.mark.parametrize("key", KEYS)
def test_reference_state_equals_jax_conversion(key, classifier, tmp_path):
    """A saved reference checkpoint through ``load_state_dict`` and
    ``reference_state``: every tensor equal bit for bit to JAX's
    ``convert_*`` followed by ``from_jax_family_params``, the dead names
    (and nothing else) dropped, and the names JAX's converter reads equal
    to the port's parameter names under the checkpoint's classifier
    prefix."""
    model = port_model(key)
    sd = reference_dict(model, key, classifier=classifier)
    loaded = load_state_dict(save_reference(sd, tmp_path / "ref.pth"))
    assert sorted(loaded) == sorted(sd)
    state, dropped = reference_state(loaded, model)

    recording = Recording(sd)
    want = from_jax_family_params(jax_convert(recording, key), key)
    assert sorted(state) == sorted(want) == sorted(model.state_dict())
    for name, value in want.items():
        assert state[name].dtype == value.dtype and torch.equal(state[name], value), name
    assert dropped == sorted(dead_names(key))
    params = {n if not n.startswith("classifier.module.") else
              classifier + n[len("classifier.module."):] for n, _ in model.named_parameters()}
    assert recording.read == params
    assert tuple(n for n in model.state_dict() if n not in dict(model.named_parameters())) \
        == BUFFERS[key]


@pytest.mark.parametrize("key", KEYS)
def test_a_missing_name_or_a_wrong_shape_raises(key):
    """A live name missing (under neither classifier prefix) raises
    KeyError listing every missing name; a live tensor of another shape
    raises ValueError naming it."""
    model = port_model(key)
    sd = reference_dict(model, key)
    gone = ["mmt.encoder.layer.1.output.dense.bias", "classifier.module.bias"]
    with pytest.raises(KeyError) as err:
        reference_state({k: v for k, v in sd.items() if k not in gone}, model)
    assert all(name in str(err.value) for name in gone)
    wrong = dict(sd)
    wrong["mmt.encoder.layer.0.intermediate.dense.weight"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="mmt.encoder.layer.0.intermediate.dense.weight"):
        reference_state(wrong, model)


def test_loaded_t2s_serves_as_jax_on_the_converted_params(tmp_path, monkeypatch):
    """T2S loaded from a reference checkpoint (``load_reference_weights``)
    serves as the JAX T2S on JAX's conversion of the same file: scores
    within 2e-5, tokens and grounding exact."""
    from vitxtgqa_tpu.models.t2s import T2S as JT2S
    from vitxtgqa_tpu_torch.models.t2s import T2S

    gumbel = shared_noise(monkeypatch, "t2s")
    cfg, batch = zoo_config("t2s"), zoo_batch("t2s")
    model = T2S(cfg, NF, bos_idx=2, inference_only=True, opts=cpu_options()).init_weights(0)
    sd = reference_dict(model, "t2s", seed=4, around=True)
    dropped = load_reference_weights(model, save_reference(sd, tmp_path / "t2s.pth"))
    assert dropped == sorted(dead_names("t2s"))
    jm = JT2S(config=cfg, num_final_outputs=NF, bos_idx=2, inference_only=True)
    params = unflatten(jax_convert(sd, "t2s"))
    want = jax.jit(lambda p, bt: jm.apply({"params": p}, bt, train=False,
                                          rngs={"gumbel": jax.random.key(0)}))(params, batch)
    assert_outputs_match(model(tensors(batch), gumbel), want)

