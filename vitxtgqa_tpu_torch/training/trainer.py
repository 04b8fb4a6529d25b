"""Training / evaluation orchestration of the port.

Counterpart of vitxtgqa_tpu/training/trainer.py (reference:
pythia/trainers/base_trainer.py:26-489), with its method names: one
``training/step.train_step`` per iteration (forward, losses, backward, the
NaN tripwire, clipping, the scheduled Adam update), validation by the
full-eval forward (``T2S(..., inference_only=False)``), and on the host the
metering, the logging cadence (a one-batch validation probe every
``log_interval``, full validation, early stopping and a checkpoint every
``snapshot_interval``), EvalAI prediction dumps and the final validation.

The JAX trainer turns the config's ``training_parameters.tpu`` switches
into process-wide globals; here ``options_from_config`` maps them onto the
one ``Options`` of the trainer's model, and raises on a switch the port
does not have rather than dropping it.  Every CUDA kernel of the path runs
on the card; ``training_parameters.device: cpu`` runs the plain versions on
the CPU.

Per iteration the trainer keeps the host-clock time of the iteration and of
its wait for the batch (``timings``; the iteration ends in a device
synchronize), and per validation pass its time.

Data parallelism (the JAX trainer's ``data`` mesh axis,
vitxtgqa_tpu/training/trainer.py:110-165): in a torch.distributed world of
N processes (``python -m vitxtgqa_tpu_torch.run`` under ``torchrun``, which
joins it), each rank loads its rows of every global batch of
``batch_size`` (data/loader.py), runs its kernels on them, and the losses
and gradients are summed over the ranks (losses.py, training/optim.py), so
that the run equals the one-process run on the same global batches.  The
JAX trainer turns its Pallas kernels and the int8 cache off on a
multi-device mesh (vitxtgqa_tpu/training/trainer.py:391-422): there
``pallas_call`` replicates under GSPMD, a property of that compiler and not
of the function; here each rank runs its kernels on its own rows and keeps
the cache the config asks for.  Every rank runs the same iterations and
validation batches (a collective on one rank alone would hang).  The
validation losses and metrics, the logged training values and the
predictions are the global batch's: each rank's rows (the real ones: the
padding and the sampler's wrap-around copies are counted nowhere) are
gathered once a pass and merged in the one-process order, losses as
(numerator, denominator) sums.  Rank 0 alone logs, writes checkpoints and
predictions; early stopping is decided once and broadcast.

The mesh's sp and pp axes (``training_parameters.tpu.mesh.sp`` / ``.pp``,
``pp_microbatches``; parallel/mesh.build_mesh lays the world out as the
JAX mesh): the model's Options carry the sp and pp groups, so every
full-sequence attention splits its query rows over the sp ranks and every
eligible stack runs the GPipe schedule over the pp stages.  The sp and pp
ranks of one data row replicate that row: the loader's rows, the dropout
and gumbel draws and the losses' shares are the data coordinate's, and
the records are gathered over the data group alone, so each question is
counted once.  The model axis (``tpu.mesh.model``) splits the layers and
the vocabulary-sized weights over its ranks (parallel/tensor_parallel.py)
beside any of the others.  The parameters are checked equal after they
load and after the first step: the whole ones over the world, the shards
over the ranks of their model coordinate.

More than one dataset (``--datasets a,b``): the first is the primary one
(its validation, head sizes, loss and metric keys, as in JAX); training
draws each iteration's dataset from data/multi_dataset.MultiDataset, the
JAX schedule of (seed, iteration), and on a data axis each rank its rows
of that dataset's global batch.  The legacy image-VQA models (KERNEL_FREE:
no kernel on their forward) run in the config's compute dtype, float32 on
the card too, and their datasets write their own EvalAI records
(``format_for_evalai``).
"""

from __future__ import annotations

import inspect
import json
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from vitxtgqa_tpu_torch import Options
from vitxtgqa_tpu_torch.core.config import ConfigNode
from vitxtgqa_tpu_torch.core.meter import Meter
from vitxtgqa_tpu_torch.core.registry import registry
from vitxtgqa_tpu_torch.data.dataset import collate
from vitxtgqa_tpu_torch.data.loader import (
    DataLoader,
    infinite_batches,
    merge_rows,
    prefetch_batches,
)
from vitxtgqa_tpu_torch.data.multi_dataset import MultiDataset
from vitxtgqa_tpu_torch.losses import Losses
from vitxtgqa_tpu_torch.metrics.metrics import MetricContext, Metrics, decode_answers, pred_indices
from vitxtgqa_tpu_torch.options import entry_device, parse_compact_train, parse_remat
from vitxtgqa_tpu_torch.parallel.collectives import (
    broadcast_scalar,
    gather_objects,
    is_main_process,
    process_count,
)
from vitxtgqa_tpu_torch.parallel.mesh import Mesh, build_mesh, mesh_shape
from vitxtgqa_tpu_torch.parallel.tensor_parallel import check_replicas, local_state, whole_state
from vitxtgqa_tpu_torch.training.checkpoint import Checkpoint
from vitxtgqa_tpu_torch.training.early_stopping import EarlyStopping
from vitxtgqa_tpu_torch.training.optim import build_optimizer
from vitxtgqa_tpu_torch.training.step import step_generators, train_step
from vitxtgqa_tpu_torch.utils.logger import Logger
from vitxtgqa_tpu_torch.utils.torch_convert import reference_state
from vitxtgqa_tpu_torch.utils.timer import Timer

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tpu_get(tpu, key: str, default=None):
    value = tpu.get(key) if tpu is not None else None
    return default if value is None else value


def mesh_axes(tp: Any) -> Dict[str, int]:
    """training_parameters.tpu.mesh's axes (data -1, model / sp / pp 1 where
    absent)."""
    mesh = _tpu_get(getattr(tp, "tpu", None), "mesh", {}) or {}
    return {k: int(_tpu_get(mesh, k, -1 if k == "data" else 1)) for k in ("data", "model", "sp",
                                                                          "pp")}


def options_from_config(tp: Any, kernel_free: bool = False,
                        mesh: Optional[Mesh] = None) -> Options:
    """The Options of a run from ``training_parameters`` (device) and its
    ``tpu`` section:
      * device: ``cpu`` runs on the CPU; ``auto`` (the default) and ``cuda``
        run on the card, and raise where there is none;
      * compute_dtype: absent takes Options' default for the device (bf16 on
        the card, float32 on the CPU); float32 on the card raises for a
        model whose forward reaches the port's kernels, which are bf16;
        ``kernel_free`` (a model that reaches none: the legacy image-VQA
        models' KERNEL_FREE) takes it there, as JAX takes it everywhere;
      * use_pallas: absent or true is the kernels; false raises on the card
        (the plain versions are the oracle, never the main path);
      * remat: every value the JAX trainer takes (options.parse_remat:
        none / false / None off, true / full, dots, attn, attn_qkv);
      * compact_train: false, true or "live" (options.parse_compact_train,
        JAX's set_compact_train);
      * kernel_dropout, fused_block_bwd, fused_block_fwd: either.  The port
        has one training block, its kernels with in-kernel dropout; JAX's
        false forms (base.yml's default, which the zoo's configs keep) run
        XLA's block with materialised masks and autodiff: the same function
        with another dropout stream, as the port's can never be JAX's;
      * fused_grads: either, logged (arm_lines).  JAX's dense_mm computes
        the projections' weight and bias gradients as products with
        float32 accumulation; the port's backward already does (cuBLAS
        and torch.sum accumulate bf16 in float32), and keeps its training
        block's kernels where JAX turns its block kernel off (ROADMAP.md,
        known deviations);
      * variant_scan: either (the port loops over the three variants);
      * kv_cache_int8, fused_decode, fused_decode_max_batch, w8a8,
        compact_serving: the Options fields of the same names;
      * mesh: data x model x sp x pp over the world's processes
        (parallel/mesh.mesh_shape: data -1 takes the rest, the product the
        world size, the global batch divisible by the data axis; every
        combination of the axes); ``mesh`` (the trainer's build_mesh,
        required where model, sp or pp is above 1) gives Options its tp,
        sp and pp groups.  On a mesh of data x model x pp above 1 the
        int8 cache and W8A8 are off whatever the config says, as the JAX
        trainer turns them off with its Pallas kernels there
        (vitxtgqa_tpu/training/trainer.py:402-415; the port keeps its
        kernels): such a mesh predicts over the bf16 cache, as JAX's
        does; an sp-only mesh keeps them, as in JAX;
      * pp_microbatches: Options.pp_microbatches (0: one a stage).
    prefetch, async_checkpoint, profile_steps and debug_nans are read by
    the trainer or have no effect on the model; keys the JAX trainer reads
    nowhere (dense_mm, split_dense) are ignored, as there."""
    tpu = getattr(tp, "tpu", None)
    device = str(getattr(tp, "device", "auto") or "auto")
    if device not in ("cpu", "auto") and not device.startswith("cuda"):
        raise ValueError(f"training_parameters.device={device!r}: use cpu, cuda or auto")
    dev = entry_device(device, knob="training_parameters.device=cpu")
    if dev.type == "cuda" and process_count() > 1 and dev.index is None:
        # a rank's card: the current device, which run.py's init_world set
        dev = torch.device("cuda", torch.cuda.current_device())
    cuda = dev.type == "cuda"

    dtype = None
    name = _tpu_get(tpu, "compute_dtype")
    if name is not None:
        if str(name) not in DTYPES:
            raise ValueError(f"training_parameters.tpu.compute_dtype={name!r}: the port computes "
                             f"in {sorted(DTYPES)}")
        dtype = DTYPES[str(name)]
        if cuda and dtype == torch.float32 and not kernel_free:
            raise ValueError(
                "training_parameters.tpu.compute_dtype=float32 on the card: the port's kernels "
                "are bf16; set training_parameters.tpu.compute_dtype=bfloat16 (or run on the "
                "CPU with training_parameters.device=cpu)")
    if cuda and _tpu_get(tpu, "use_pallas", True) is False:
        raise ValueError(
            "training_parameters.tpu.use_pallas=false on the card: the port runs its kernels "
            "there; the plain versions are the oracle (Options.plain), never the main path")
    shape = (mesh.shape if mesh is not None
             else mesh_shape(**mesh_axes(tp), batch_size=getattr(tp, "batch_size", None)))
    if mesh is None and (shape["model"] > 1 or shape["sp"] > 1 or shape["pp"] > 1):
        raise ValueError(f"mesh model={shape['model']}, sp={shape['sp']}, pp={shape['pp']}: "
                         "options_from_config takes the built mesh (mesh=parallel/mesh."
                         "build_mesh(...), which every rank calls alike)")
    # the JAX trainer's test (its spmd_devs): data x model x pp above 1
    int8_ok = shape["data"] * shape["model"] * shape["pp"] == 1
    return Options(
        device=dev, dtype=dtype, remat=parse_remat(_tpu_get(tpu, "remat", "none")),
        compact_train=parse_compact_train(_tpu_get(tpu, "compact_train", False)),
        # no kernel to take float32 on the card: the plain versions are the
        # only ones its forward reaches
        plain=bool(kernel_free and cuda and dtype == torch.float32),
        kv_cache_int8=int8_ok and bool(_tpu_get(tpu, "kv_cache_int8", False)),
        fused_decode=bool(_tpu_get(tpu, "fused_decode", True)),
        fused_decode_max_batch=int(_tpu_get(tpu, "fused_decode_max_batch", 2)),
        w8a8=int8_ok and bool(_tpu_get(tpu, "w8a8", False)),
        compact_serving=bool(_tpu_get(tpu, "compact_serving", False)),
        tp=mesh.model if mesh is not None else None,
        sp=mesh.sp if mesh is not None else None,
        pp=mesh.pp if mesh is not None else None,
        pp_microbatches=int(_tpu_get(tpu, "pp_microbatches", 0)),
    )


def arm_lines(opts: Options, tpu=None) -> List[str]:
    """The log lines of the opt-in training arms an Options (and, for
    fused_grads, which maps onto no field, ``training_parameters.tpu``)
    has on, as the JAX trainer writes them
    (vitxtgqa_tpu/training/trainer.py)."""
    lines = []
    if opts.remat != "none":
        lines.append(f"transformer-layer rematerialisation enabled ({opts.remat})")
    if _tpu_get(tpu, "fused_grads", False):
        lines.append("fused dense grads: the port's backward already accumulates the "
                     "projections' weight and bias gradients in float32 (the same function); "
                     "the training block keeps its kernels")
    if opts.compact_train:
        lines.append("EXPERIMENTAL compact training enabled (pos/neg variants on grounding-kept "
                     f"rows, {'live' if opts.compact_train == 'live' else 'stop-gradient'} ref "
                     "fill: an estimator deviation, see models/t2s.py)")
    return lines


def kernel_free(model_key: str) -> bool:
    """Whether the registered model's forward reaches no kernel of the port
    (the legacy image-VQA models)."""
    try:
        return bool(getattr(registry.get_model_class(model_key), "KERNEL_FREE", False))
    except KeyError:
        return False


def build_model(model_key: str, model_cfg: Any, dataset_name: str, opts: Options,
                inference_only: bool = False, example: Optional[Dict[str, Any]] = None):
    """Instantiate a registered model with registry-resolved head sizes
    (reference wiring: build_utils.py:38-51, vqa2/builder.py:40-48).  The
    legacy image-VQA models take their input widths from ``example`` (a
    batch of the data), where the flax models infer them at init."""
    cls = registry.get_model_class(model_key)
    num_final = registry.get(f"{dataset_name}_num_final_outputs")
    # legacy answer processors (vqa_answer, soft_copy_answer) have no decode
    # BOS; their models never decode, so any value works
    proc = registry.get(f"{dataset_name}_answer_processor")
    # only a model with a serving variant takes the flag (T2S and its
    # ablations; the others' eval forward is one pass already), as in JAX
    kwargs = {}
    params = inspect.signature(cls).parameters
    if "inference_only" in params:
        kwargs["inference_only"] = inference_only
    if "example" in params:
        kwargs["example"] = example
    return cls(model_cfg, int(num_final), bos_idx=int(getattr(proc, "BOS_IDX", 2)), opts=opts,
               **kwargs)


def _host(out: Dict[str, Any]) -> Dict[str, Any]:
    """Model outputs as numpy (bf16 as float32); other values pass."""
    return {k: (v.detach().float().cpu().numpy() if torch.is_tensor(v) and v.is_floating_point()
                else v.detach().cpu().numpy() if torch.is_tensor(v) else v)
            for k, v in out.items()}


def _torch(arrays: Dict[str, Any]) -> Dict[str, Any]:
    return {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v for k, v in arrays.items()}


@registry.register_trainer("base_trainer")
class BaseTrainer:
    def __init__(self, config: ConfigNode):
        self.config = config
        self.tp = config.training_parameters
        self.run_type = getattr(self.tp, "run_type", "train+inference")
        self.timings: Dict[str, list] = {"iteration_ms": [], "data_wait_ms": [], "val_ms": []}

    # ------------------------------------------------------------------ load
    def load(self):
        tp = self.tp
        self.seed = int(getattr(tp, "seed", None) or 1)
        names = (
            self.config.datasets.split(",")
            if isinstance(self.config.datasets, str)
            else list(self.config.datasets)
        )
        self.dataset_names = [n.strip() for n in names if n.strip()]
        # the first dataset is the primary one: its validation, its head
        # sizes, its losses' and metrics' keys; with more, training draws
        # each step's dataset from the MultiDataset schedule
        self.dataset_name = self.dataset_names[0]
        self.ds_cfg = self.config.dataset_attributes[self.dataset_name]
        # the mesh of the world (every axis 1 in one process); the data
        # axis: None where it has one rank
        self.mesh = build_mesh(**mesh_axes(tp), batch_size=int(tp.batch_size))
        self.opts = options_from_config(tp, kernel_free(self.config.model), mesh=self.mesh)
        asked = {k: bool(_tpu_get(getattr(tp, "tpu", None), k, False))
                 for k in ("kv_cache_int8", "w8a8")}
        self.device = self.opts.device
        self.dp = self.mesh.data
        self.rank, self.world = (self.dp.rank, self.dp.size) if self.dp else (0, 1)

        save_dir = getattr(tp, "save_dir", "./save")
        if save_dir in ("./save", "save"):
            # default dir gets the reference's experiment slug
            # (ckpt_name_from_core_args, general.py:56-67)
            slug = f"{self.dataset_name}_{self.config.model}_{self.seed}"
            save_dir = os.path.join(save_dir, slug)
        self.logger = Logger(
            save_dir, level=getattr(tp, "logger_level", "info"),
            should_log=not getattr(tp, "should_not_log", False), main=is_main_process(),
        )
        registry.register("writer", self.logger)
        self.logger.write(f"device {self.device}, compute dtype {self.opts.dtype}")
        for line in arm_lines(self.opts, getattr(tp, "tpu", None)):
            self.logger.write(line)
        dropped = [k for k, on in asked.items() if on and not getattr(self.opts, k)]
        if dropped:
            self.logger.write(
                f"{' and '.join(dropped)} off on the {self.mesh.shape} mesh, as the JAX trainer "
                "turns them off with its kernels on a data x model x pp mesh above one device: "
                "the predictions go over the bf16 cache")
        if process_count() > 1:
            shape = self.mesh.shape
            self.logger.write(
                f"mesh data {shape['data']} x model {shape['model']} x sp {shape['sp']} x pp "
                f"{shape['pp']} over "
                f"{process_count()} processes: {int(tp.batch_size) // self.world} rows of each "
                f"global batch of {tp.batch_size} a data row"
                + (f", {self.opts.pp_microbatches or shape['pp']} microbatches a pipelined pass"
                   if shape["pp"] > 1 else ""))

        self._load_datasets()
        self._load_model()
        self._load_optimizer()
        self._load_extras(save_dir)

    def _load_datasets(self):
        builder = registry.get_builder_class(self.dataset_name)()
        tp = self.tp
        splits = set()
        if "train" in self.run_type:
            splits.update(["train", "val"])
        if "val" in self.run_type:
            splits.add("val")
        if "inference" in self.run_type or "test" in self.run_type:
            splits.add("test")
        if not splits:
            splits.add("val")

        self.datasets: Dict[str, Any] = {}
        self.loaders: Dict[str, DataLoader] = {}
        batch_size = int(tp.batch_size) // self.world  # this rank's rows of a global batch
        workers = int(getattr(tp, "num_workers", 0) or 0)
        for split in sorted(splits):
            try:
                ds = builder.load(split, self.ds_cfg, seed=self.seed, reference_compat=bool(
                    getattr(tp, "reference_compat", False)))
            except (FileNotFoundError, ValueError) as e:
                self.logger.write(f"split {split} unavailable: {e}", "warning")
                continue
            self.datasets[split] = ds
            self.loaders[split] = DataLoader(
                ds, batch_size=batch_size, shuffle=(split == "train"),
                seed=self.seed, drop_last=(split == "train"),
                pad_last=(split != "train"),
                num_workers=min(workers, 16), rank=self.rank, world_size=self.world,
            )
        if not self.datasets:
            raise RuntimeError(
                f"no dataset splits could be loaded for {self.dataset_name!r} "
                f"(data_root_dir={self.ds_cfg.data_root_dir!r}); check paths"
            )
        self._seed_sequence_draws()
        self.multi_train = None
        if len(self.dataset_names) > 1 and "train" in self.loaders:
            # multi-dataset training (reference: multi_dataset.py): every
            # dataset's train loader, each rank its rows of each global
            # batch, on the schedule of (seed, step)
            loaders = {self.dataset_name: self.loaders["train"]}
            for name in self.dataset_names[1:]:
                ds = registry.get_builder_class(name)().load(
                    "train", self.config.dataset_attributes[name], seed=self.seed)
                loaders[name] = DataLoader(ds, batch_size=batch_size, shuffle=True,
                                           seed=self.seed, drop_last=True,
                                           num_workers=min(workers, 16), rank=self.rank,
                                           world_size=self.world)
            self.multi_train = MultiDataset(loaders, proportional=bool(
                getattr(tp, "dataset_size_proportional_sampling", True)), seed=self.seed)
        primary = "train" if "train" in self.datasets else sorted(self.datasets)[0]
        self.primary_split = primary
        self.datasets[primary].update_registry_for_model()
        self.answer_processor = registry.get(f"{self.dataset_name}_answer_processor")

    def _seed_sequence_draws(self) -> None:
        """Seed the answer processors' choice among matching decode
        sequences from the run's seed (the JAX package leaves that
        generator unseeded; worker processes seed each sample from its
        (seed, epoch, index) already): a run repeats, every rank assembles
        the same global batches and keeps its data row's rows, and the sp /
        pp ranks of a data row, which replicate its compute, draw the same
        targets."""
        for i, split in enumerate(sorted(self.datasets)):
            rng = getattr(getattr(self.datasets[split], "answer_processor", None), "rng", None)
            if isinstance(rng, np.random.Generator):
                rng.bit_generator.state = np.random.default_rng(
                    np.random.SeedSequence([self.seed, i])).bit_generator.state

    def _load_model(self):
        tp = self.tp
        model_key = self.config.model
        if model_key not in self.config.model_attributes:
            # a lone model_attributes entry serves any --model (the JAX
            # trainer's rule for the ablation variants)
            if len(self.config.model_attributes) == 1:
                (only,) = list(self.config.model_attributes)
                self.logger.write(f"model {model_key!r} using the {only!r} attribute block")
                self.model_cfg = self.config.model_attributes[only]
            else:
                raise KeyError(
                    f"model {model_key!r} has no model_attributes entry in the config; "
                    f"available: {sorted(self.config.model_attributes)}")
        else:
            self.model_cfg = self.config.model_attributes[model_key]
        # prediction-only runs take the serving path (skips the contrastive
        # variants; predictions are identical, losses just can't be logged)
        serving = bool(getattr(tp, "evalai_inference", False)) and "train" not in self.run_type
        example = None
        if "example" in inspect.signature(registry.get_model_class(model_key)).parameters:
            # one sample of the data, for the model's input widths (the
            # legacy datasets draw nothing: reading it moves no generator)
            example = collate([self.datasets[self.primary_split][0]])["tensors"]
        self.model = build_model(model_key, self.model_cfg, self.dataset_name, self.opts,
                                 inference_only=serving, example=example).init_weights(self.seed)
        if serving:
            self.logger.write("serving mode: single-variant inference path")
        n_params = sum(p.numel() for p in self.model.parameters())
        self.logger.write(f"model {model_key}: {n_params / 1e6:.1f}M params")
        if process_count() > 1:
            # the same seeded init on every rank of the world (the shards on
            # the ranks of their model coordinate): checked once
            check_replicas(list(self.model.parameters()), "the initial parameters",
                           self.opts.tp)
        self.losses = Losses(list(getattr(self.model_cfg, "losses", []) or []),
                             self.dataset_name, group=self.dp)
        self.metrics = Metrics(list(getattr(self.model_cfg, "metrics", []) or []),
                               self.dataset_name,
                               reference_compat=bool(getattr(tp, "reference_compat", False)))

    def _load_optimizer(self):
        self.optimizer = build_optimizer(self.model, self.config.optimizer_attributes, self.tp,
                                         self.model_cfg, group=self.dp)

    def lr_at(self, iteration: int) -> float:
        return self.optimizer.base_lr * self.optimizer.schedule(iteration)

    def _load_extras(self, save_dir: str):
        tp = self.tp
        self.checkpoint = Checkpoint(save_dir, self.config)
        self.meter = Meter()
        self.early_stopping = EarlyStopping(
            monitored_metric=getattr(tp, "monitored_metric", "total_loss"),
            patience=int(getattr(tp, "patience", 4000)),
            minimize=bool(getattr(tp, "metric_minimize", True)),
            should_stop=bool(getattr(tp, "should_early_stop", False)),
        )
        self.iteration = 0
        self.current_epoch = 0
        self.epoch_batch = 0  # batches of current_epoch already trained on
        self.data_rng: Optional[Dict[str, Any]] = None
        self.datasets_drawn: list = []  # a multi-dataset run's dataset at each iteration
        self.max_iterations = int(getattr(tp, "max_iterations", 10000))
        self.log_interval = int(getattr(tp, "log_interval", 100))
        self.snapshot_interval = int(getattr(tp, "snapshot_interval", 1000))
        # the JAX trainer's step key is key(seed + 7); here the step's
        # generators are a function of (seed + 7, iteration)
        self.rng_seed = self.seed + 7

        resume_file = getattr(tp, "resume_file", None)
        if resume_file:
            self._restore(resume_file)
        elif getattr(tp, "resume", False):
            if os.path.exists(self.checkpoint.best_path):
                self._restore(self.checkpoint.best_path)

        self.metric_contexts = {
            split: MetricContext.from_config(self.ds_cfg, split, self.answer_processor)
            for split in self.datasets
        }

    def _restore(self, path: str):
        state = self.checkpoint.load(path, map_location=self.device)
        if not os.path.isdir(path):
            # a bare model blob, the port's or the reference's: weights
            # only, the reference's dead parameters dropped
            weights, dropped = reference_state(state["model"], self.model)
            self.model.load_state_dict(local_state(self.model, weights))
            self.logger.write(f"loaded model weights from {path}" + (
                f"; dropped {len(dropped)} names the model does not have, e.g. {dropped[:5]}"
                if dropped else ""))
            return
        self.model.load_state_dict(local_state(self.model, state["model"]))
        self.optimizer.load_state_dict(state["optimizer"])
        meta = self.checkpoint.load_meta(path)
        self.iteration = int(meta["iteration"])
        # resume the epoch-seeded data shuffle where the run left off, at
        # the next batch of the epoch, with the train dataset's generators
        # as they were (the JAX trainer restarts the epoch)
        self.current_epoch = int(meta.get("epoch", 0))
        self.epoch_batch = int(meta.get("epoch_batch", 0))
        self.data_rng = state.get("generator")
        if self.data_rng is not None and "train" in self.datasets:
            self.datasets["train"].set_rng_state(self.data_rng)
        # continue the early-stopping patience window (reference:
        # early_stopping.py:87-92 via checkpoint.py:126)
        self.early_stopping.init_from_meta(meta)
        self.logger.write(
            f"restored checkpoint {path} @ iteration {self.iteration} "
            f"(epoch {self.current_epoch}, batch {self.epoch_batch})")

    # ------------------------------------------------------------------ batches
    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _stage(self, tensors: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Host tensors ready for the copy to the device: pinned on the card's
        host, so that the copy runs asynchronously on the compute stream."""
        out = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in tensors.items()}
        if self.device.type == "cuda":
            out = {k: v.pin_memory() for k, v in out.items()}
        return out

    def _put(self, staged: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {k: v.to(self.device, non_blocking=True) for k, v in staged.items()}

    def _prefetched(self, it):
        """Wrap a batch iterator with a host thread that assembles and stages
        the next batches when training_parameters.tpu.prefetch > 0 (the
        numpy tensors stay under "tensors_host" for host-side scoring)."""
        depth = int(getattr(getattr(self.tp, "tpu", None), "prefetch", 0) or 0)
        if depth <= 0:
            return it
        return prefetch_batches(it, size=depth, device_put=self._stage, keep_host=True)

    def _split_device_batch(self, batch):
        """(device tensors, host-view batch) for a possibly-prefetched
        batch: stages on the spot when prefetch is off."""
        if "tensors_host" in batch:
            staged = batch["tensors"]
            batch = dict(batch)
            batch["tensors"] = batch.pop("tensors_host")
            return self._put(staged), batch
        return self._put(self._stage(batch["tensors"])), batch

    # ------------------------------------------------------------------ train
    def train(self):
        if "train" not in self.run_type:
            self.inference()
            return

        self.logger.write(f"training {self.config.model} for {self.max_iterations} iterations")
        should_stop = False
        if self.multi_train is not None:
            # the schedule resumes at the iteration (multi_dataset.py)
            batches = self._prefetched(self.multi_train.iter_from(self.iteration))
        else:
            batches = self._prefetched(infinite_batches(
                self.loaders["train"], start_epoch=self.current_epoch,
                start_batch=self.epoch_batch))
        train_timer = Timer()
        replicas_checked = False
        while self.iteration < self.max_iterations and not should_stop:
            t0 = time.perf_counter()
            batch = next(batches)
            t_data = time.perf_counter()
            self.iteration += 1
            host = batch["host"]
            if self.multi_train is None:
                self.current_epoch, self.epoch_batch = host["epoch"], host["epoch_batch"] + 1
                self.data_rng = host.get("data_rng")
            else:
                self.datasets_drawn.append(host.get("dataset_name"))
            tensors, batch = self._split_device_batch(batch)
            r = train_step(self.model, self.losses, self.optimizer, tensors,
                           step_generators(self.rng_seed, self.iteration, self.device, self.dp))
            if not replicas_checked and process_count() > 1:
                # every model / sp / pp / data rank steps alike: checked after the first step
                check_replicas(list(self.model.parameters()),
                               "the parameters after the first step", self.opts.tp)
                replicas_checked = True
            self._sync()
            t1 = time.perf_counter()
            self.timings["iteration_ms"].append((t1 - t0) * 1e3)
            self.timings["data_wait_ms"].append((t_data - t0) * 1e3)

            if self.iteration % self.log_interval == 0:
                update = {f"train/{k}": float(v) for k, v in r["losses"].items()}
                update["train/total_loss"] = float(r["loss"])
                update["train/grad_norm"] = float(r["grad_norm"])
                ctx = self.metric_contexts.get("train") or MetricContext(self.answer_processor)
                (merged,) = self._merged([self._record(batch["tensors"], _host(r["out"]),
                                                       batch["host"], losses=False)])
                train_metrics = self.metrics(merged["tensors"], merged["out"], merged["host"],
                                             ctx, train=True)
                update.update({f"train/{k}": v for k, v in train_metrics.items()})
                self.meter.update(update)
                elapsed = train_timer.get_time_since_start()
                ups = self.log_interval / max(elapsed / 1000.0, 1e-9)
                train_timer.reset()
                # ETA from the current log-interval rate
                # (reference: base_trainer.py:453-463)
                remaining_ms = (self.max_iterations - self.iteration) / max(ups, 1e-9) * 1000.0
                eta = Timer().get_time_hhmmss(remaining_ms)
                self.logger.write(
                    f"it {self.iteration}/{self.max_iterations} "
                    f"lr={self.lr_at(self.iteration):.2e} {ups:.2f} it/s eta={eta} | "
                    f"{self.meter.get_log_string()}"
                )
                self.logger.add_scalars(update, self.iteration)
                self._val_probe()

            if self.iteration % self.snapshot_interval == 0:
                should_stop = self._snapshot()
        if hasattr(batches, "close"):
            batches.close()  # stops the prefetch thread
        self.finalize()

    def _eval_out(self, tensors, step: int):
        """The eval forward (full-eval, or serving for a prediction-only
        run) on device tensors, its gumbel draws a function of (seed + 7,
        step) as the JAX trainer's fold_in(rng, step) key is."""
        return self.model(tensors, step_generators(self.rng_seed, step, self.device, self.dp)[1])

    def _val_probe(self):
        """1-batch validation estimate at log cadence
        (reference: base_trainer.py:347-357), from a persistent cycling
        iterator like the reference's."""
        if "val" not in self.loaders:
            return
        it = getattr(self, "_val_probe_iter", None)
        if it is None:
            it = iter(self.loaders["val"])
            self._val_probe_iter = it
        try:
            batch = next(it)
        except StopIteration:
            self._val_probe_iter = it = iter(self.loaders["val"])
            batch = next(it)
        dev, batch = self._split_device_batch(batch)
        out = _host(self._eval_out(dev, self.iteration))
        # every row, the padding too
        (merged,) = self._merged([self._record(batch["tensors"], out, batch["host"])])
        ldict = self._merged_losses(merged)
        probe = {f"val/{k}": float(v) for k, v in ldict.items()}
        self.meter.update(probe)
        self.logger.add_scalars(probe, self.iteration)

    def _snapshot(self) -> bool:
        """Full validation + early stopping + checkpoint
        (reference: base_trainer.py:363-392).  Returns True to stop."""
        if getattr(self.tp, "log_histograms", False):
            self.logger.add_histograms_for_params(
                {k: v.detach().float().cpu().numpy() for k, v in self.model.state_dict().items()},
                self.iteration)
        where = dict(epoch=self.current_epoch, epoch_batch=self.epoch_batch)
        if "val" not in self.loaders:
            self.checkpoint.save(self._state(), self.iteration, update_best=True,
                                 best_iteration=self.iteration, **where)
            return False
        loss_avg, metric_avg = self.evaluate("val")
        combined = {f"val/{k}": v for k, v in {**loss_avg, **metric_avg}.items()}
        self.meter.update(combined)
        self.logger.add_scalars(combined, self.iteration)
        self.logger.write(
            f"validation @ {self.iteration}: "
            + ", ".join(f"{k}={v:.4f}" for k, v in combined.items())
        )
        monitored = self.early_stopping.monitored_metric
        value = combined.get(f"val/{monitored}", loss_avg.get("total_loss", 0.0))
        is_best = self.early_stopping.is_best(value)
        # decided once (every rank holds the same merged values)
        stop = bool(broadcast_scalar(self.early_stopping(value, self.iteration)))
        self.checkpoint.save(
            self._state(), self.iteration, update_best=is_best,
            best_iteration=self.early_stopping.best_iteration,
            best_metric_value=self.early_stopping.best_value, **where)
        return stop

    def _state(self):
        """The snapshot's state on rank 0 (None on the others, which write
        nothing), whole: a tensor-parallel run's shards and their optimizer
        state gathered over the model group first (every rank takes part);
        the iteration counter and the data position ride in meta.json."""
        model = whole_state(self.model, self.model.state_dict())
        optimizer = self.optimizer.state_dict()
        if not is_main_process():
            return None
        return {"model": model, "optimizer": optimizer, "generator": self.data_rng}

    # ------------------------------------------------------------------ eval
    @staticmethod
    def _trim_padding(batch, out_np):
        """Drop padded eval rows (loader pad_last) before host-side scoring."""
        n = batch["host"].get("n_valid")
        tensors, host = batch["tensors"], batch["host"]
        if n is None or n == next(iter(tensors.values())).shape[0]:
            return tensors, out_np, host
        tensors = {k: v[:n] for k, v in tensors.items()}
        out_np = {
            k: (v[:n] if getattr(v, "ndim", 0) >= 1 and v.shape[:1] != () else v)
            for k, v in out_np.items()
        }
        host = {
            k: (v[:n] if isinstance(v, list) else v) for k, v in host.items()
        }
        return tensors, out_np, host

    def _record(self, tensors, out_np, host, losses: bool = True) -> Dict[str, Any]:
        """What scoring reads of this rank's rows of one batch: each loss's
        (weight, numerator, denominator) and the metrics' inputs, with the
        scores replaced by their argmax (the ranks gather this, not the
        scores)."""
        n = int(np.asarray(tensors["question_id"]).shape[0])
        rec: Dict[str, Any] = {
            "tensors": {"question_id": np.asarray(tensors["question_id"])},
            "out": {k: v for k, v in out_np.items() if not k.endswith("_scores")},
            "host": {k: v for k, v in host.items() if isinstance(v, list)}}
        if "pos_scores" in out_np:
            rec["out"]["pred_inds"] = pred_indices(out_np)
        if "scores" in out_np:
            # the legacy classifiers: the answer index, and the targets the
            # soft accuracy reads at it
            rec["out"] = {k: v for k, v in rec["out"].items() if k != "scores"}
            rec["out"]["pred_inds"] = np.asarray(out_np["scores"]).argmax(-1)
            if "targets" in tensors:
                rec["tensors"]["targets"] = np.asarray(tensors["targets"])
        if losses:
            flat = lambda x: x.detach().float().reshape(-1).cpu().tolist()
            rec["terms"] = {k: (w, flat(num), flat(den)) for k, (w, num, den) in
                            self.losses.terms(_torch(tensors), _torch(out_np)).items()
                            } if n else self.losses.zero_terms()
        return rec

    def _gather_rows(self, obj) -> list:
        """Every data row's ``obj`` in data order: gathered over the data
        group, whose ranks hold the rows of one sp / pp coordinate (the
        other sp / pp ranks hold copies of the same rows)."""
        return gather_objects(obj, self.dp.group) if self.dp is not None else [obj]

    def _merged(self, records: list) -> list:
        """The data rows' records of the same batches (one gather) merged
        into the global batches' records, rows in the one-process order."""
        every = self._gather_rows(records)
        merged = []
        for parts in zip(*every):
            rec: Dict[str, Any] = {}
            for field in ("tensors", "out"):
                rec[field] = {}
                for k, v in parts[0][field].items():
                    if getattr(v, "ndim", 0) >= 1:
                        rows = merge_rows([list(p[field][k]) for p in parts])
                        v = np.asarray(rows) if rows else v
                    rec[field][k] = v
            rec["host"] = {k: merge_rows([p["host"][k] for p in parts]) for k in parts[0]["host"]}
            if "terms" in parts[0]:
                rec["terms"] = {k: (w, np.sum([p["terms"][k][1] for p in parts], axis=0),
                                    np.sum([p["terms"][k][2] for p in parts], axis=0))
                                for k, (w, _, _) in parts[0]["terms"].items()}
            merged.append(rec)
        return merged

    @staticmethod
    def _merged_losses(rec) -> Dict[str, float]:
        return {k: w * float(np.sum(np.asarray(num) / np.maximum(np.asarray(den), 1.0)))
                for k, (w, num, den) in rec["terms"].items()}

    def evaluate(self, split: str):
        """Full-split evaluation: losses + configured metrics
        (reference: base_trainer.py:394-410), each the mean over batches;
        on a data axis each batch's are the global batch's."""
        t0 = time.perf_counter()
        loader = self.loaders[split]
        ctx = self.metric_contexts[split]
        loss_sums: Dict[str, float] = {}
        metric_sums: Dict[str, float] = {}
        records, n_batches = [], 0
        for i, batch in enumerate(self._prefetched(iter(loader))):
            dev, batch = self._split_device_batch(batch)
            out_np = _host(self._eval_out(dev, i))
            tensors, out_np, host = self._trim_padding(batch, out_np)
            n_batches += 1
            records.append(self._record(tensors, out_np, host))
        for rec in self._merged(records):
            ldict = self._merged_losses(rec)
            loss_sums["total_loss"] = loss_sums.get("total_loss", 0.0) + sum(ldict.values())
            for k, v in ldict.items():
                loss_sums[k] = loss_sums.get(k, 0.0) + v
            for k, v in self.metrics(rec["tensors"], rec["out"], rec["host"], ctx).items():
                metric_sums[k] = metric_sums.get(k, 0.0) + float(v)
        self.timings["val_ms"].append((time.perf_counter() - t0) * 1e3)
        if n_batches == 0:
            return {}, {}
        return (
            {k: v / n_batches for k, v in loss_sums.items()},
            {k: v / n_batches for k, v in metric_sums.items()},
        )

    def inference(self):
        for split in ("val", "test"):
            if split not in self.loaders:
                continue
            if (split == "val" and "val" not in self.run_type
                    and "inference" not in self.run_type):
                continue
            self.logger.write(f"=== inference on {split} ===")
            if getattr(self.tp, "evalai_inference", False):
                self.predict_for_evalai(split)
                continue
            loss_avg, metric_avg = self.evaluate(split)
            report = {**loss_avg, **metric_avg}
            self.logger.write(
                f"{split}: " + ", ".join(f"{k}={v:.4f}" for k, v in report.items())
            )
            self.logger.add_scalars({f"{split}/{k}": v for k, v in report.items()},
                                    self.iteration)

    def predict_for_evalai(self, split: str) -> Optional[str]:
        """Prediction JSON dump (reference: test_reporter.py:17-149,
        vtextgqa/dataset.py:315-363); returns its path (None on the ranks
        but 0 of a data axis, whose rows rank 0 gathers and writes, each
        question once)."""
        loader = self.loaders[split]
        ds = self.datasets[split]
        per_batch = []  # each batch's rows
        for bi, batch in enumerate(self._prefetched(iter(loader))):
            dev, batch = self._split_device_batch(batch)
            out = _host(self._eval_out(dev, bi))
            tensors, out, host = self._trim_padding(batch, out)
            if "pos_scores" not in out and hasattr(ds, "format_for_evalai"):
                # the legacy image-VQA datasets format their own records
                # (reference: test_reporter.py:126-134 delegates to
                # dataset.format_for_evalai; vqa2/dataset.py:180-206)
                per_batch.append(ds.format_for_evalai(tensors, out, host))
                continue
            pred_inds = np.asarray(out["pos_scores"]).argmax(-1)
            answers = decode_answers(pred_inds, host["context_tokens"], self.answer_processor)
            vocab_size = self.answer_processor.get_true_vocab_size()
            frames = np.asarray(out["ground_frame"]).tolist()
            boxes = np.asarray(out["ground_box"]).tolist()
            qids = np.asarray(tensors["question_id"]).tolist()
            rows = []
            for i, qid in enumerate(qids):
                sources = []
                for idx in pred_inds[i].tolist():
                    if idx >= vocab_size:
                        sources.append("OCR")
                    else:
                        if idx == self.answer_processor.EOS_IDX:
                            break
                        sources.append("VOCAB")
                rows.append(
                    {
                        "question_id": qid,
                        "video_id": host["image_id"][i],
                        "answer": answers[i],
                        "grounded frame": frames[i],
                        "grounded box": boxes[i],
                        "pred_source": sources,
                    }
                )
            per_batch.append(rows)
        every = self._gather_rows(per_batch)
        if not is_main_process():
            return None
        per_batch = [merge_rows(list(ranks)) for ranks in zip(*every)]
        predictions = [p for rows in per_batch for p in rows]
        report_dir = os.path.join(self.logger.save_dir, "reports")
        os.makedirs(report_dir, exist_ok=True)
        path = os.path.join(
            report_dir,
            f"{self.dataset_name}_{split}_{time.strftime('%Y%m%dT%H%M%S')}.json",
        )
        with open(path, "w") as f:
            json.dump(predictions, f)
        self.logger.write(f"wrote {len(predictions)} predictions to {path}")
        return path

    def close(self) -> None:
        """Stop the loaders' worker processes (a later pass starts them
        again)."""
        for loader in self.loaders.values():
            loader.close()

    def finalize(self):
        """Forced final validation, restore best, test inference
        (reference: base_trainer.py:280-291)."""
        if "train" in self.run_type:
            self._snapshot()
            self.checkpoint.finalize(self._state(), self.iteration, epoch=self.current_epoch,
                                     epoch_batch=self.epoch_batch)
            best = self.checkpoint.best_path
            if os.path.exists(best):
                self._restore(best)
        if "inference" in self.run_type or "predict" in self.run_type:
            self.inference()
