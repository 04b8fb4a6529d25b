"""The port's mode switches, in one explicit object.

The JAX package carries its modes as process-wide trace-time globals
(``set_kv_cache_int8``, ``set_use_pallas``, ``set_remat``, ...), which
needed a reset fixture between tests (tests/conftest.py).  Here a model
takes one frozen ``Options`` at construction and every layer reads it from
there.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional

import torch

if TYPE_CHECKING:
    from vitxtgqa_tpu_torch.parallel.mesh import SPGroup

REMAT_MODES = ("none", "attn")


@dataclasses.dataclass(frozen=True)
class Options:
    """device: where parameters and activations live.  The default is the
        CUDA card: a model built with it on a machine without CUDA raises
        (PyTorch does, when it allocates); nothing falls back to the CPU.
        Pass ``device="cpu"`` to run on the CPU.
    dtype: compute dtype of the transformer stacks (float32 or bfloat16);
        grounding, the pointer network and the classifier compute in
        float32 as in the JAX package.  The default (None) is bfloat16 on a
        CUDA device, whose kernels are bf16, and float32 on the CPU; float32
        on CUDA raises unless ``plain`` (the plain versions take it).
    kv_cache_int8: quantize the unified decode KV cache to int8 with
        per-token scales (the serving default of bench.py).
    plain: run every kernel op through its plain PyTorch version even on
        CUDA — the oracle mode used to check the kernels on the card.
    fused_decode: with the int8 cache on CUDA, run each greedy-decode step
        as the single-kernel decode step plus the fused epilogue
        (ops/decode_step.py) — the counterpart of the JAX
        ``set_fused_decode`` (default on).
    fused_decode_max_batch: the fused decode engages only at batch <= this
        cap — the counterpart of ``set_fused_decode_max_batch`` (JAX
        default 2).
    w8a8: the eval post-attention block runs its three products int8 x
        int8 with per-row activation scales and per-output-channel weight
        scales (ops/fused_block.fused_block_w8a8) wherever the fused block
        engages; the fused decode is off under it — the JAX ``set_w8a8``.
    compact_serving: the serving and full-eval decodes run the MMT on the
        rows the pos grounding keeps (question, top-k frames, top-k OCR
        slots per frame) and pin never-kept copy scores to -1e4 — the JAX
        ``set_compact_serving`` (configs/t2s_serving.yml sets it, with
        ``kv_cache_int8``).

    Training (the counterpart of ``training_parameters.tpu.remat`` in
    configs/t2s_abinet.yml, with that config's default):
    remat: "attn" keeps only each layer's input, attention context and
        row log-sum-exp for the backward, which recomputes the q/k/v
        projections and relaunches the block's forward kernel instead of
        holding their activations; "none" keeps them.  The JAX
        ``set_remat`` (its "full", "dots" and "attn_qkv" modes are not
        ported).
    Parallelism:
    sp: an SPGroup (parallel/mesh.build_sp_group) to run every
        full-sequence attention sequence-parallel over its ranks, each
        rank holding the whole model and batch — the JAX
        ``set_sequence_parallel``; None (default) runs it whole.

    The config's other training switches (``kernel_dropout``,
    ``fused_block_bwd``, ``fused_block_fwd``) have no field: on the card
    the training block always runs its kernels with in-kernel dropout, and
    ``plain`` is the one way to run the plain versions instead.
    """

    device: torch.device = torch.device("cuda")
    dtype: Optional[torch.dtype] = None
    kv_cache_int8: bool = False
    plain: bool = False
    fused_decode: bool = True
    fused_decode_max_batch: int = 2
    w8a8: bool = False
    compact_serving: bool = False
    remat: str = "attn"
    sp: Optional["SPGroup"] = None

    def __post_init__(self):
        object.__setattr__(self, "device", torch.device(self.device))
        cuda = self.device.type == "cuda"
        if self.dtype is None:
            object.__setattr__(self, "dtype", torch.bfloat16 if cuda else torch.float32)
        if self.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"unsupported compute dtype {self.dtype}")
        if cuda and self.dtype == torch.float32 and not self.plain:
            raise ValueError(
                "dtype float32 on a CUDA device: the port's kernels are bf16; use "
                "torch.bfloat16 (the default there), or plain=True for the plain versions"
            )
        if self.remat not in REMAT_MODES:
            raise ValueError(
                f"remat {self.remat!r}: the port has {REMAT_MODES} (the JAX "
                "'full', 'dots' and 'attn_qkv' modes are ROADMAP.md queue 1 "
                "item 6)"
            )


def entry_device(device=None, knob: str = "device='cpu'") -> torch.device:
    """The device an entry point (serve, the raw-video pipeline, the
    runtime) runs on: the card unless the caller names another (``None``
    and ``"auto"`` mean the card).  On a machine without CUDA the card
    raises, naming ``knob``, the caller's way to ask for the CPU; nothing
    falls back to the CPU."""
    name = "cuda" if device is None or str(device) == "auto" else str(device)
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{name} is a CUDA device and this machine has none; set {knob} to "
                           "run the plain versions on the CPU")
    return dev
