"""The port's mode switches, in one explicit object.

The JAX package carries its modes as process-wide trace-time globals
(``set_kv_cache_int8``, ``set_use_pallas``, ``set_remat``, ...), which
needed a reset fixture between tests (tests/conftest.py).  Here a model
takes one frozen ``Options`` at construction and every layer reads it from
there.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional, Union

import torch

if TYPE_CHECKING:
    from vitxtgqa_tpu_torch.parallel.mesh import ModelGroup, PPGroup, SPGroup

REMAT_MODES = ("none", "attn", "attn_qkv", "dots", "full")


def parse_remat(value) -> str:
    """A ``training_parameters.tpu.remat`` value as the JAX ``set_remat``
    reads it (vitxtgqa_tpu/models/common.py): False / None / "none" /
    "false" off, True / "true" / "full" the whole layer, "dots", "attn" and
    "attn_qkv" as named, case-insensitive.  Anything else raises."""
    if value is None or isinstance(value, bool):
        return "full" if value else "none"
    mode = str(value).lower()
    mode = {"false": "none", "true": "full"}.get(mode, mode)
    if mode not in REMAT_MODES:
        raise ValueError(f"remat {value!r}: one of {REMAT_MODES} (or true / false)")
    return mode


def parse_compact_train(value):
    """A ``training_parameters.tpu.compact_train`` value as the JAX
    ``set_compact_train`` reads it: "live" (any case) is "live", another
    string is True unless it is "", "0", "false" or "none"; anything else
    is its truth value."""
    if isinstance(value, str):
        mode = value.lower()
        return "live" if mode == "live" else mode not in ("", "0", "false", "none")
    return bool(value)


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

    Training (the counterpart of ``training_parameters.tpu`` in
    configs/t2s_abinet.yml, with that config's remat):
    remat: what a training layer keeps for its backward, the JAX
        ``set_remat`` (parse_remat reads its config values): "attn" keeps
        the layer's input, attention context and row log-sum-exp, and the
        backward recomputes the q/k/v projections and relaunches the
        block's forward kernel; "attn_qkv" keeps q/k/v too; "dots" keeps
        the products' outputs (q/k/v and the block's residuals) and
        relaunches the flash forward; "full" keeps the layer's input only
        and recomputes the whole layer; "none" keeps everything.  The
        table is ops/attention.AttentionFn's docstring.
    compact_train: False; True: the training forward runs the pos and neg
        teacher-forced passes on the rows the grounding keeps, the ref
        pass full, and fills the never-kept copy scores with the ref
        pass's, detached; "live": the same with the fill's gradient kept
        (the JAX ``set_compact_train``; models/t2s.py).
    Parallelism:
    tp: a ModelGroup (parallel/mesh.build_mesh's ``model``) to split every
        transformer layer over its ranks, Megatron's layout of the JAX
        mesh's ``model`` axis (parallel/tensor_parallel.py): each rank holds
        its share of the heads (Q/K/V column-parallel, the attention output
        row-parallel) and of the FFN (in column-, out row-parallel), and the
        post-attention block runs its kernels' split forms around two
        all-reduces; the classifier, the text BERT's word embeddings and
        the OCR pointer's query and key are vocabulary- or column-parallel
        where the group divides them; None (default) holds every layer
        whole.  It composes with ``sp`` and ``pp`` (a model rank's heads
        over its sp group, its shards in each pipeline stage).  The int8
        cache, W8A8 and the fused decode have no split forms (JAX runs none
        of them on a model mesh): with ``tp`` they raise (ROADMAP.md queue
        2).
    sp: an SPGroup (parallel/mesh.build_sp_group) to run every
        full-sequence attention sequence-parallel over its ranks, each
        rank holding the whole model and batch — the JAX
        ``set_sequence_parallel``; None (default) runs it whole.
    pp: a PPGroup (parallel/mesh.build_mesh) to run every eligible
        transformer stack (its layer count a multiple of the stages; eval,
        or no dropout) through the GPipe schedule over its ranks
        (parallel/pipeline.py) — the JAX ``set_pipeline``; None (default)
        runs every stack on one rank.
    pp_microbatches: the schedule's microbatches (0: one a stage), the
        JAX ``training_parameters.tpu.pp_microbatches``.

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
    compact_train: Union[bool, str] = False
    tp: Optional["ModelGroup"] = None
    sp: Optional["SPGroup"] = None
    pp: Optional["PPGroup"] = None
    pp_microbatches: int = 0

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
        if self.pp_microbatches < 0:
            raise ValueError(f"pp_microbatches={self.pp_microbatches}: 0 (one a stage) or more")
        if self.tp is not None and (self.kv_cache_int8 or self.w8a8):
            raise NotImplementedError(
                "Options(tp=...) with kv_cache_int8 or w8a8: the int8 cache's kernels, the "
                "W8A8 block and the fused decode have no tensor-parallel forms (JAX runs none "
                "of them on a model mesh; ROADMAP.md queue 2, TP forms still to port)")
        if self.remat not in REMAT_MODES:
            raise ValueError(f"remat {self.remat!r}: one of {REMAT_MODES}")
        if self.compact_train not in (False, True, "live"):
            raise ValueError(f"compact_train {self.compact_train!r}: False, True or 'live'")


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
