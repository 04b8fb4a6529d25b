"""The port's single-device entry point: the counterpart of
``__graft_entry__.entry()``.

    fn, args = entry()
    out = fn(*args)   # the serving forward on the card

``entry()`` builds T2S at production dims (configs/t2s_abinet.yml's model,
``models/t2s.t2s_production_config``; 5050 answers + 960 OCR copy slots,
BOS 2) with random weights from seed 0, and a synthetic batch of 2 videos
on the device.  ``fn`` is the serving forward (the pos greedy decode and
the grounding), its gumbel draws fixed by a seed.  The JAX module's
``dryrun_multichip`` (TP / DP sharding) is ROADMAP.md queue 1 item 5.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from vitxtgqa_tpu_torch import Options
from vitxtgqa_tpu_torch.models.t2s import PRODUCTION_NUM_FINAL_OUTPUTS, T2S, t2s_production_config
from vitxtgqa_tpu_torch.serving.engine import group_generator, to_device
from vitxtgqa_tpu_torch.utils.synthetic import synthetic_batch


def entry(device: Any = "cuda") -> Tuple[Callable[..., Dict[str, Any]], tuple]:
    """(fn, args): ``fn(*args)`` is the serving forward of the production
    T2S on ``device`` (the card by default) at batch 2."""
    opts = Options(device=device)
    model = T2S(t2s_production_config(), PRODUCTION_NUM_FINAL_OUTPUTS, bos_idx=2, opts=opts,
                inference_only=True).init_weights(0)
    batch = to_device(synthetic_batch(batch=2, num_final_outputs=PRODUCTION_NUM_FINAL_OUTPUTS),
                      opts.device)

    def fn(tensors):
        return model(tensors, group_generator(3, 0, opts.device))

    return fn, (batch,)
