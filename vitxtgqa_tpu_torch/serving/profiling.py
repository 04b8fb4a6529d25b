"""Where the time of a serving forward goes, on one CUDA card.

    python -m vitxtgqa_tpu_torch.serving.profiling [--out DIR] [--reps N]

T2S at production width (t2s_production_config), bf16, random weights from
seed 0, in each serving configuration (CONFIGS), and the ViT frame-feature
extractor that makes its ``video_feat`` rows (VIT_CONFIGS: ViT-L/16 at 224
px over the extractor's default chunk of 64 frames of 240 x 320, from
uint8 frames to CLS features).  For each: the host-clock
latency of 5 direct forwards ending in ``torch.cuda.synchronize()``
(median and min), then ``torch.profiler`` over N more (default 3).  Device
time counts only the profiler's device-side events (kernels, memcpy,
memset), never the host-side operator rows that enclose them; the idle
share is ``1 - device time per forward / median latency``.  Prints a
summary line per configuration and its largest kernels, and writes
everything to DIR/profile.json (default: build/ beside the package).
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time
from collections import defaultdict

import torch

CONFIGS = (
    ("int8, batch 1, fused", dict(kv_cache_int8=True), 1),
    ("int8, batch 1, per-layer", dict(kv_cache_int8=True, fused_decode=False), 1),
    ("int8, batch 2, fused", dict(kv_cache_int8=True), 2),
    ("bf16, batch 8", dict(kv_cache_int8=False), 8),
    ("int8, batch 8", dict(kv_cache_int8=True), 8),
    # the serving preset (configs/t2s_serving.yml) and the W8A8 mode
    ("int8 + compact, batch 1", dict(kv_cache_int8=True, compact_serving=True), 1),
    ("int8 + compact, batch 8", dict(kv_cache_int8=True, compact_serving=True), 8),
    ("int8 + W8A8, batch 8", dict(kv_cache_int8=True, w8a8=True), 8),
    ("int8 + compact + W8A8, batch 8", dict(kv_cache_int8=True, compact_serving=True,
                                            w8a8=True), 8),
)
# (name, ViT preset, frames per forward)
VIT_CONFIGS = (("ViT-L/16 extractor, batch 64", "VIT_L_16", 64),)
TOP = 8


def device_events(prof):
    """(name, microseconds) of every device-side event the profiler saw,
    without the ranges that user annotations (``record_function``, such
    as ``Optimizer.step``) span on the device's timeline: those enclose
    kernels that are counted already."""
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def profile_config(model, batch, dev, reps: int) -> dict:
    """profile_forward over T2S forwards of ``batch``."""
    from vitxtgqa_tpu_torch.serving.engine import group_generator, to_device

    tb = to_device(batch, dev)

    def forward(i):
        with torch.inference_mode():
            model(tb, group_generator(0, i, dev))

    return profile_forward(forward, reps)


def profile_forward(forward, reps: int) -> dict:
    """Latency of ``forward(i)`` (5 calls after 3 warm-ups, each ending in
    a synchronize) and the device events of ``reps`` more under the
    profiler."""
    def timed(i):
        forward(i)
        torch.cuda.synchronize()

    for i in range(3):
        timed(i)
    lat = []
    for i in range(5):
        t = time.perf_counter()
        timed(i)
        lat.append((time.perf_counter() - t) * 1e3)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(reps):
            timed(i)
    per_kernel = defaultdict(lambda: [0.0, 0])
    for name, us in device_events(prof):
        per_kernel[name][0] += us / 1e3 / reps
        per_kernel[name][1] += 1
    if not per_kernel:
        raise RuntimeError("the profiler saw no device events: device time not measured")
    device_ms = sum(ms for ms, _ in per_kernel.values())
    median = statistics.median(lat)
    kernels = sorted(((name, ms, n / reps) for name, (ms, n) in per_kernel.items()),
                     key=lambda r: -r[1])
    return {"latency_ms_all": lat, "latency_ms_median": median, "latency_ms_min": min(lat),
            "device_ms_per_forward": device_ms, "idle_share": 1.0 - device_ms / median,
            "kernels": [{"name": n, "ms_per_forward": ms, "calls_per_forward": c}
                        for n, ms, c in kernels]}


def _t2s(new, state, opts):
    model = new(**opts)
    model.load_state_dict(state)
    return model


def profile_vit(preset: str, frames: int, dev, reps: int) -> dict:
    """profile_forward over the ViT extractor (bf16 on the card), uint8
    frames to CLS."""
    from vitxtgqa_tpu_torch.models import vit
    from vitxtgqa_tpu_torch.utils.synthetic import synthetic_frames

    extract, _ = vit.make_feature_extractor(getattr(vit, preset))
    x = torch.from_numpy(synthetic_frames(frames, 240, 320, seed=0)).to(dev)
    return profile_forward(lambda i: extract(x), reps)


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("profile: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 2
    from vitxtgqa_tpu_torch import Options
    from vitxtgqa_tpu_torch.models.t2s import (PRODUCTION_NUM_FINAL_OUTPUTS, T2S,
                                               t2s_production_config)
    from vitxtgqa_tpu_torch.utils.synthetic import synthetic_batch

    reps = int(argv[argv.index("--reps") + 1]) if "--reps" in argv else 3
    out_dir = (argv[argv.index("--out") + 1] if "--out" in argv else
               os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
                   os.path.abspath(__file__)))), "build"))
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, nf = t2s_production_config(), PRODUCTION_NUM_FINAL_OUTPUTS
    new = lambda **o: T2S(cfg, nf, bos_idx=2, opts=Options(
        device=dev, **o)).eval()
    state = new(kv_cache_int8=True).init_weights(0).state_dict()
    batch = synthetic_batch(batch=max(b for _, _, b in CONFIGS), num_final_outputs=nf, seed=0)
    card = torch.cuda.get_device_name(0)
    result = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
              "reps": reps, "configs": {}}
    runs = [(name, lambda o=opts, b=b: profile_config(_t2s(new, state, o), {
        k: v[:b] for k, v in batch.items()}, dev, reps)) for name, opts, b in CONFIGS]
    runs += [(name, lambda p=preset, b=b: profile_vit(p, b, dev, reps))
             for name, preset, b in VIT_CONFIGS]
    for name, run in runs:
        r = run()
        result["configs"][name] = r
        print(f"profile {name}: latency median {r['latency_ms_median']:.3f} ms "
              f"(min {r['latency_ms_min']:.3f}), device {r['device_ms_per_forward']:.3f} ms "
              f"per forward, idle share {r['idle_share']:.3f}", flush=True)
        for k in r["kernels"][:TOP]:
            print(f"    {k['ms_per_forward']:8.3f} ms  x{k['calls_per_forward']:<6g} "
                  f"{k['name'][:90]}", flush=True)
        torch.cuda.empty_cache()
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "profile.json"), "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
