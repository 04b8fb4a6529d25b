"""Where the time of a T2S training step goes, on one CUDA card.

    python -m vitxtgqa_tpu_torch.training.profiling [--out DIR] [--batch N] [--reps N]

T2S at production width (t2s_production_config), bf16 with float32
master weights, random weights from seed 0, the production step
(Options' defaults: remat "attn", the block_train kernels, in-kernel
dropout; Adam with clipping and the schedule) at batch N (default 48, the
config's).  The host-clock time of 5 steps ending in
``torch.cuda.synchronize()`` (median and min), then ``torch.profiler`` over
``--reps`` more (default 2).  Device time counts only device-side events
(serving/profiling.py); the idle share is ``1 - device time per step /
median step time``.  Kernel time is grouped by the port's kernels (#1,
#1b, #9a, #9b), cuBLAS products and the rest.  Prints a summary and the
largest kernels; writes DIR/profile_train.json (default: build/).
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time
from collections import defaultdict

import torch

from vitxtgqa_tpu_torch.serving.profiling import device_events

TOP = 12
# (group, substrings of the kernel names it takes), first match wins
GROUPS = (
    ("#1 flash forward", ("flash_fwd_kernel",)),
    ("#1b flash backward", ("flash_bwd_",)),
    ("#9a block forward", ("LnFwdEpi", "GeluEpi")),
    ("#9b block backward", ("ln2_bwd_kernel", "LnBwdEpi", "GeluGradEpi", "StoreEpi",
                            "AtomicEpi")),
    ("cuBLAS products", ("gemm", "gemv", "xmma", "cutlass", "nvjet")),
)


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other (elementwise, reductions, copies, Adam)"


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("profile: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 2
    from vitxtgqa_tpu_torch import Options
    from vitxtgqa_tpu_torch.losses import Losses
    from vitxtgqa_tpu_torch.models.t2s import (PRODUCTION_NUM_FINAL_OUTPUTS, T2S,
                                               t2s_production_config)
    from vitxtgqa_tpu_torch.serving.engine import to_device
    from vitxtgqa_tpu_torch.training.optim import build_optimizer
    from vitxtgqa_tpu_torch.training.step import step_generators, train_step
    from vitxtgqa_tpu_torch.utils.synthetic import synthetic_batch

    arg = lambda flag, default: type(default)(argv[argv.index(flag) + 1]) if flag in argv else default
    batch_size, reps = arg("--batch", 48), arg("--reps", 2)
    out_dir = arg("--out", os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "build"))
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, nf = t2s_production_config(), PRODUCTION_NUM_FINAL_OUTPUTS
    model = T2S(cfg, nf, bos_idx=2, opts=Options(device=dev)).init_weights(0)
    opt = build_optimizer(model, model_config=cfg)
    losses = Losses(cfg["losses"])
    batch = to_device(synthetic_batch(batch=batch_size, num_final_outputs=nf, seed=0), dev)

    def step(i):
        train_step(model, losses, opt, batch, step_generators(0, i, dev))
        torch.cuda.synchronize()

    for i in range(2):
        step(i)
    torch.cuda.reset_peak_memory_stats()
    lat = []
    for i in range(5):
        t = time.perf_counter()
        step(2 + i)
        lat.append((time.perf_counter() - t) * 1e3)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(reps):
            step(7 + i)
    per_kernel = defaultdict(lambda: [0.0, 0])
    for name, us in device_events(prof):
        per_kernel[name][0] += us / 1e3 / reps
        per_kernel[name][1] += 1
    if not per_kernel:
        raise RuntimeError("the profiler saw no device events: device time not measured")
    groups = defaultdict(float)
    for name, (ms, _) in per_kernel.items():
        groups[group_of(name)] += ms
    device_ms = sum(groups.values())
    median = statistics.median(lat)
    card = torch.cuda.get_device_name(0)
    kernels = sorted(((n, ms, c / reps) for n, (ms, c) in per_kernel.items()), key=lambda r: -r[1])
    result = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
              "batch": batch_size, "reps": reps, "step_ms_all": lat, "step_ms_median": median,
              "step_ms_min": min(lat), "videos_per_s": batch_size / median * 1e3,
              "device_ms_per_step": device_ms, "idle_share": 1.0 - device_ms / median,
              "max_memory_allocated": torch.cuda.max_memory_allocated(),
              "groups_ms_per_step": dict(groups),
              "kernels": [{"name": n, "ms_per_step": ms, "calls_per_step": c}
                          for n, ms, c in kernels]}
    print(f"profile train, batch {batch_size}: step median {median:.3f} ms (min {min(lat):.3f}), "
          f"{result['videos_per_s']:.2f} videos/s, device {device_ms:.3f} ms per step, idle share "
          f"{result['idle_share']:.3f}, max_memory_allocated "
          f"{result['max_memory_allocated'] / 2**30:.2f} GiB; {card}", flush=True)
    for g, ms in sorted(groups.items(), key=lambda r: -r[1]):
        print(f"    {ms:9.3f} ms  {g}", flush=True)
    for n, ms, c in kernels[:TOP]:
        print(f"    {ms:9.3f} ms  x{c:<6g} {n[:100]}", flush=True)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "profile_train.json"), "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
