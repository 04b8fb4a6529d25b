#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's T2S serving path once on one NVIDIA GPU.

    python3 chip_smoke.py [--out DIR]

Phases (each prints one line; any failure exits non-zero):
  1. environment: the card's name and power limit, torch / CUDA versions,
     TF32 switched off for float32 matmuls and convolutions;
  2. build: nvcc compiles vitxtgqa_tpu_torch/csrc into build/kernels/;
  3. kernels: each CUDA kernel against its plain PyTorch version at the
     serving shapes (batch 8, joint sequence 1152, hidden 768), bf16, with
     a ragged key mask from synthetic_batch; max |diff| against a stated
     tolerance, and median CUDA-event times of both;
  4. slice: T2S at production width (t2s_production_config) in bf16 with
     the int8 KV cache behind a ServingEngine(buckets=(8,)); 8 requests;
     launch counts per forward; the same batch, weights and gumbel noise
     through the plain versions on the card; engine throughput.
The line before the last is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``.  Details go to DIR/chip_smoke.json
(default DIR: build/).  Without a CUDA device it exits 2 and prints no
result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH = 8

# tolerances of kernel vs plain version, bf16 at the serving shapes.
# flash / decode outputs are attention averages of O(1) values (|out| ~ 0.1
# to 1): both sides round to bf16 (8 bits of mantissa) once more or less,
# and in a different order, so a few bf16 ulps of the largest output.
# fused_block outputs are LayerNorm outputs (|out| up to ~5), same reason.
TOL = {
    "flash_attention_merged": 2e-2,
    "fused_block": 6e-2,
    "fused_block_tanh": 6e-2,
    "decode_attention_int8": 2e-2,
}
REPLACES = {
    "flash_attention_merged": "vitxtgqa_tpu/ops/pallas_attention.py:550",
    "fused_block": "vitxtgqa_tpu/ops/pallas_ffn.py:233",
    "fused_block_tanh": "vitxtgqa_tpu/ops/pallas_ffn.py:370",
    "decode_attention_int8": "vitxtgqa_tpu/ops/pallas_attention.py:1006",
}
SOURCE = {
    "flash_attention_merged": "vitxtgqa_tpu_torch/csrc/flash_attention.cu",
    "fused_block": "vitxtgqa_tpu_torch/csrc/fused_block.cu",
    "fused_block_tanh": "vitxtgqa_tpu_torch/csrc/fused_block.cu",
    "decode_attention_int8": "vitxtgqa_tpu_torch/csrc/decode_attention.cu",
}
# kernel launches per serving forward: 2 QTV + 3 MMT encode attention
# calls; fused block in QTV layer 0 and the 3 MMT encode layers, its tanh
# form in the last QTV layer; 3 MMT layers x 12 decode steps
PER_FORWARD = {
    "flash_attention_merged": 5,
    "fused_block": 4,
    "fused_block_tanh": 1,
    "decode_attention_int8": 36,
}
# slice, kernels vs plain on the card: greedy tokens may diverge where two
# scores tie within bf16 noise, and diverge for the rest of the sequence
# after that; the first step sees identical inputs up to that noise
MIN_TOKEN_AGREEMENT = 0.8
STEP0_TOL = 0.15


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of fn() over reps runs (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def serving_masks(device):
    """The encoder key mask of a real batch at the serving geometry:
    [txt 20 | frames 64 | ocr 960] padded to 1152 rows."""
    import torch

    from vitxtgqa_tpu_torch.utils.synthetic import synthetic_batch

    b = synthetic_batch(batch=BATCH, seed=0)
    txt = (torch.arange(20)[None, :] < torch.as_tensor(b["text_len"])[:, None]).float()
    enc = torch.cat([txt, torch.as_tensor(b["frame_mask"]), torch.as_tensor(b["ocr_mask"])], dim=1)
    return torch.nn.functional.pad(enc, (0, 1152 - enc.shape[1])).to(device).contiguous()


def check_kernels(dev, record):
    import torch

    from vitxtgqa_tpu_torch.ops import decode_attention as DA
    from vitxtgqa_tpu_torch.ops import flash_attention as FA
    from vitxtgqa_tpu_torch.ops import fused_block as FB
    from vitxtgqa_tpu_torch.ops.attention import quantize_kv

    gen = torch.Generator(device=dev).manual_seed(1234)
    bf = torch.bfloat16
    rn = lambda *s, scale=1.0: (torch.randn(*s, generator=gen, device=dev) * scale).to(bf)
    h, l, d, m = 12, 1152, 768, 3072
    mask = serving_masks(dev)

    def report(name, err, ms, plain_ms, extra=""):
        tol = TOL[name]
        rec = record.setdefault(name, {"max_abs_err": 0.0, "ms": None, "plain_ms": None})
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        if ms is not None:
            rec["ms"], rec["plain_ms"] = ms, plain_ms
        status = "ok" if err <= tol else "FAIL"
        print(f"kernel {name}{extra}: max|diff| {err:.3e} (tol {tol:.0e}) {status}"
              + (f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms" if ms is not None else ""),
              flush=True)
        if err > tol:
            fail(f"{name}{extra} disagrees with its plain version")

    # 1. flash attention, dec_len 0 (QTV / MMT encode) and 12 (full-eval)
    q, k, v = (rn(BATCH, l, d) for _ in range(3))
    for dec_len in (0, 12):
        km = mask.clone()
        if dec_len:
            km[:, l - dec_len:] = 0.0
        got = FA.flash_attention_merged(q, k, v, km, dec_len, h)
        want = FA.flash_attention_merged_plain(q, k, v, km, dec_len, h)
        torch.cuda.synchronize()
        rows = km > 0
        if dec_len:
            rows[:, l - dec_len:] = True
        err = (got.float() - want.float()).abs()[rows].max().item()
        timed = dec_len == 0
        ms = cuda_time_ms(lambda: FA.flash_attention_merged(q, k, v, km, dec_len, h)) if timed else None
        pms = cuda_time_ms(lambda: FA.flash_attention_merged_plain(q, k, v, km, dec_len, h)) if timed else None
        report("flash_attention_merged", err, ms, pms, f" [8,1152,768] dec_len={dec_len}")

    # 2. fused block and its tanh form, rows 9216, 768 -> 3072
    x_q, ctx, res = rn(BATCH, l, d), rn(BATCH, l, d, scale=0.5), rn(BATCH, l, d)
    wo, w1, w2 = rn(d, d, scale=0.02), rn(m, d, scale=0.02), rn(d, m, scale=0.02)
    vec = lambda n, base=0.0: (base + torch.randn(n, generator=gen, device=dev) * 0.05).float()
    pv = (wo, vec(d), vec(d, 1.0), vec(d), w1, vec(m), w2, vec(d), vec(d, 1.0), vec(d))
    args = (x_q, ctx) + pv
    for name, fn, plain, a in (
        ("fused_block", FB.fused_block, FB.fused_block_plain, args),
        ("fused_block_tanh", FB.fused_block_tanh, FB.fused_block_tanh_plain, (res,) + args),
    ):
        got, want = fn(*a), plain(*a)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        report(name, err, cuda_time_ms(lambda: fn(*a)), cuda_time_ms(lambda: plain(*a)),
               " [9216,768]->3072")

    # 3. int8 decode attention at steps 0 and 11, write_offset 1140
    qd = rn(BATCH, 1, d)
    (k8, ks), (v8, vs) = quantize_kv(rn(BATCH, l, d)), quantize_kv(rn(BATCH, l, d))
    for step in (0, 11):
        dargs = (qd, k8, ks, v8, vs, mask, step, 1140, h)
        got, want = DA.decode_attention_int8(*dargs), DA.decode_attention_int8_plain(*dargs)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        timed = step == 11
        report("decode_attention_int8", err,
               cuda_time_ms(lambda: DA.decode_attention_int8(*dargs)) if timed else None,
               cuda_time_ms(lambda: DA.decode_attention_int8_plain(*dargs)) if timed else None,
               f" [8,1,768] x [8,1152,768] step={step}")


def run_slice(dev, record, card):
    import numpy as np
    import torch

    from vitxtgqa_tpu_torch.utils.synthetic import synthetic_batch
    from vitxtgqa_tpu_torch import Options
    from vitxtgqa_tpu_torch.models.t2s import (
        PRODUCTION_NUM_FINAL_OUTPUTS,
        T2S,
        t2s_production_config,
    )
    from vitxtgqa_tpu_torch.ops import _build
    from vitxtgqa_tpu_torch.serving.engine import ServingEngine, group_generator, to_device

    cfg = t2s_production_config()
    nf = PRODUCTION_NUM_FINAL_OUTPUTS
    opts = Options(device=dev, dtype=torch.bfloat16, kv_cache_int8=True)
    t0 = time.perf_counter()
    model = T2S(cfg, nf, bos_idx=2, opts=opts).init_weights(0).eval()
    plain_model = T2S(cfg, nf, bos_idx=2, opts=Options(
        device=dev, dtype=torch.bfloat16, kv_cache_int8=True, plain=True)).eval()
    plain_model.load_state_dict(model.state_dict())
    n_params = sum(p.numel() for p in model.parameters())
    print(f"slice: T2S production width, {n_params / 1e6:.1f}M params, bf16, int8 KV cache, "
          f"built in {time.perf_counter() - t0:.1f} s", flush=True)

    batch = synthetic_batch(batch=BATCH, num_final_outputs=nf, seed=0)
    samples = [{k: v[i] for k, v in batch.items()} for i in range(BATCH)]
    rng_seed = 0
    with ServingEngine(model, buckets=(BATCH,), max_wait_ms=2000, rng_seed=rng_seed) as eng:
        eng.warmup(samples[0])
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        futs = [eng.submit(s) for s in samples]
        outs = [f.result(timeout=600) for f in futs]
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        print("slice: launches in one served forward " + json.dumps(counts), flush=True)
        for name, want in PER_FORWARD.items():
            if counts[name] != want:
                fail(f"{name} launched {counts[name]} times in one forward, expected {want}")
            record[name]["launches"] = counts[name]

        for o in outs:
            if o["pos_scores"].shape != (12, nf) or o["pos_scores"].dtype != np.float32:
                fail(f"pos_scores {o['pos_scores'].shape} {o['pos_scores'].dtype}")
            if o["ground_frame"].shape != (5,) or o["ground_box"].shape != (64 * 5, 4):
                fail(f"grounding shapes {o['ground_frame'].shape} {o['ground_box'].shape}")
            for k in ("pos_scores", "ground_box"):
                if not np.isfinite(o[k]).all():
                    fail(f"non-finite {k}")
        engine_pos = np.stack([o["pos_scores"] for o in outs])

        # the same batch, weights and gumbel noise: direct forward through the
        # kernels (must equal the engine's rows) and through the plain versions
        tb = to_device(batch, dev)
        with torch.inference_mode():
            kern = model(tb, group_generator(rng_seed, 0, dev))
            plain = plain_model(tb, group_generator(rng_seed, 0, dev))
        kp, pp = kern["pos_scores"].cpu().numpy(), plain["pos_scores"].cpu().numpy()
        if not np.array_equal(kp, engine_pos):
            fail("engine rows differ from a direct forward on the same batch")
        diff_all = float(np.abs(kp - pp).max())
        diff0 = float(np.abs(kp[:, 0] - pp[:, 0]).max())
        agree = float((kp.argmax(-1) == pp.argmax(-1)).mean())
        gf_agree = float((kern["ground_frame"] == plain["ground_frame"]).float().mean().item())
        print(f"slice: kernels vs plain on the card: max|d pos_scores| {diff_all:.4e} "
              f"(step 0: {diff0:.4e}, tol {STEP0_TOL}), greedy-token agreement {agree:.4f} "
              f"(min {MIN_TOKEN_AGREEMENT}), ground_frame agreement {gf_agree:.4f}", flush=True)
        if diff0 > STEP0_TOL or agree < MIN_TOKEN_AGREEMENT:
            fail("the slice through the kernels disagrees with the plain versions")

        # per-forward latency (direct, batch 8) and engine throughput
        def fwd():
            with torch.inference_mode():
                model(tb, group_generator(rng_seed, 1, dev))
            torch.cuda.synchronize()

        lat = []
        for _ in range(5):
            t = time.perf_counter()
            fwd()
            lat.append((time.perf_counter() - t) * 1e3)
        n_groups = 10
        t = time.perf_counter()
        futs = [eng.submit(samples[i % BATCH]) for i in range(n_groups * BATCH)]
        for f in futs:
            f.result(timeout=600)
        wall = time.perf_counter() - t
    vps = n_groups * BATCH / wall
    print(f"slice: engine {vps:.2f} videos/s at batch {BATCH} ({n_groups} groups, "
          f"{wall:.3f} s); forward latency median {statistics.median(lat):.2f} ms "
          f"(min {min(lat):.2f}); card {card}", flush=True)
    return {
        "videos_per_s": vps, "forward_ms_median": statistics.median(lat),
        "forward_ms_all": lat, "pos_scores_max_abs_diff": diff_all,
        "step0_max_abs_diff": diff0, "token_agreement": agree,
        "ground_frame_agreement": gf_agree, "launches": counts,
        "params_m": n_params / 1e6,
    }


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from vitxtgqa_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    card = smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"env: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.lib()
    build_s = time.perf_counter() - t0
    log = (lib_path.parent / "nvcc.log").read_text().splitlines()
    ptxas = [ln.split("ptxas info    : ")[-1] for ln in log if "Used" in ln or "spill" in ln]
    print(f"build: {build_s:.1f} s -> {os.path.relpath(lib_path, ROOT)}; ptxas: "
          + " | ".join(ptxas), flush=True)

    record = {}
    check_kernels(dev, record)
    details = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
               "build_s": build_s, "kernels": record}
    details["slice"] = run_slice(dev, record, card)
    out_dir = argv[argv.index("--out") + 1] if "--out" in argv else os.path.join(ROOT, "build")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(details, f, indent=1)

    kernels = [
        {"name": name, "route": "cuda", "source": SOURCE[name], "replaces": REPLACES[name],
         "launches": record[name].get("launches", 0),
         "max_abs_err": record[name]["max_abs_err"], "ms": record[name]["ms"],
         "plain_ms": record[name]["plain_ms"]}
        for name in PER_FORWARD
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
