#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's T2S serving path once on one NVIDIA GPU.

    python3 chip_smoke.py [--out DIR]

Phases (each prints one or more lines; any failure exits non-zero):
  1. environment: the card's name and power limit, torch / CUDA versions,
     TF32 switched off for float32 matmuls and convolutions;
  2. build: nvcc compiles vitxtgqa_tpu_torch/csrc into build/kernels/, one
     process per source, all started together;
  3. kernels: each CUDA kernel against its plain PyTorch version at the
     serving shapes (joint sequence 1152, hidden 768, batch 8, and batch
     1 / 2 / 8 for the decode-step kernels), bf16, with a ragged key mask
     from synthetic_batch; max |diff| against a stated tolerance, and
     CUDA-event times of both.  The decode step's attention is planted
     (PLANTED / BACKGROUND / TRAP) so that reading a slot it must not read
     moves its output by far more than the tolerance;
  4. slices: T2S at production width (t2s_production_config) in bf16,
     behind a ServingEngine, in each serving configuration:
       a. int8 KV cache, batch 8 (per-layer int8 decode attention);
       b. int8 KV cache, buckets (1, 2): the single-kernel decode step and
          the fused epilogue; then the forward latency at batch 1 and 2
          through the fused and the per-layer decode;
       c. bf16 KV cache, batch 8 (per-layer bf16 decode attention).
     Each checks its launch counts per forward (derived from the gates),
     the outputs' shapes and finiteness, and the same batch, weights and
     gumbel noise through the plain versions on the card.
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
L_JOINT, WRITE_OFFSET, DEC_LEN = 1152, 1140, 12

# tolerances of kernel vs plain version, bf16 at the serving shapes.
# flash / decode outputs are attention averages of O(1) values (|out| ~ 0.1
# to 1): both sides round to bf16 (8 bits of mantissa) once more or less,
# and in a different order, so a few bf16 ulps of the largest output.
# fused_block and fused_decode_step outputs are LayerNorm outputs (|out| up
# to ~5), same reason.  The decode step's quantized rows may move by one
# int8 step and their scales by a bf16 ulp (< 1%): k / v round to bf16
# after accumulations in another order.  Epilogue scores are f32 dots of
# length 768 over O(1) values; tokens must agree wherever the top two
# plain scores differ by more than the score tolerance.
TOL = {
    "flash_attention_merged": 2e-2,
    "fused_block": 6e-2,
    "fused_block_tanh": 6e-2,
    "decode_attention_int8": 2e-2,
    "decode_attention": 2e-2,
    "fused_decode_step": 6e-2,
    "fused_epilogue": 2e-2,
}
ROW8_TOL, ROWSC_REL_TOL = 1, 1e-2
# the decode-step check plants its attention scores (decode_step_cache), per
# head after the 1/sqrt(64) scale: two allowed encoder keys and, from step
# 1, the decoder key before the current slot score PLANTED; the current
# token scores ~2 (its k is K_GAIN * q); every other allowed key scores
# BACKGROUND, and every slot the step must not read scores TRAP, so a
# kernel that reads one of them, or drops the current token, moves y by
# far more than the tolerance
PLANTED, BACKGROUND, TRAP, K_GAIN = (2.5, 1.5, 2.0), -6.0, 4.5, 0.25
REPLACES = {
    "flash_attention_merged": "vitxtgqa_tpu/ops/pallas_attention.py:550",
    "fused_block": "vitxtgqa_tpu/ops/pallas_ffn.py:233",
    "fused_block_tanh": "vitxtgqa_tpu/ops/pallas_ffn.py:370",
    "decode_attention_int8": "vitxtgqa_tpu/ops/pallas_attention.py:1006",
    "decode_attention": "vitxtgqa_tpu/ops/pallas_attention.py:896",
    "fused_decode_step": "vitxtgqa_tpu/ops/pallas_decode_step.py:207",
    "fused_epilogue": "vitxtgqa_tpu/ops/pallas_decode_step.py:472",
}
SOURCE = {
    "flash_attention_merged": "vitxtgqa_tpu_torch/csrc/flash_attention.cu",
    "fused_block": "vitxtgqa_tpu_torch/csrc/fused_block.cu",
    "fused_block_tanh": "vitxtgqa_tpu_torch/csrc/fused_block.cu",
    "decode_attention_int8": "vitxtgqa_tpu_torch/csrc/decode_attention.cu",
    "decode_attention": "vitxtgqa_tpu_torch/csrc/decode_attention.cu",
    "fused_decode_step": "vitxtgqa_tpu_torch/csrc/fused_decode_step.cu",
    "fused_epilogue": "vitxtgqa_tpu_torch/csrc/fused_epilogue.cu",
}
# slice, kernels vs plain on the card: greedy tokens may diverge where two
# scores tie within bf16 noise, and diverge for the rest of the sequence
# after that; the first step sees identical inputs up to that noise
MIN_TOKEN_AGREEMENT = 0.8
STEP0_TOL = 0.15


def expected_launches(cfg, batch: int, opts) -> dict:
    """Kernel launches in one serving forward, derived from the port's
    gates: flash in every QTV and MMT encode layer (joint sequence >= 256
    keys); the fused block in those layers where the rows reach its gate,
    the last QTV layer in its tanh form; per decode step either the fused
    step + epilogue or one decode attention per MMT layer."""
    from vitxtgqa_tpu_torch.ops import fused_block as FB

    n_qtv = cfg["translayers"]["num_hidden_layers"]
    n_mmt = cfg["mmt"]["num_hidden_layers"]
    block = FB.kernel_ok(768, 3072, batch * L_JOINT)
    fused = opts.fused_decode and opts.kv_cache_int8 and batch <= opts.fused_decode_max_batch
    per_layer = 0 if fused else n_mmt * DEC_LEN
    return {
        "flash_attention_merged": n_qtv + n_mmt,
        "fused_block": (n_qtv - 1 + n_mmt) if block else 0,
        "fused_block_tanh": 1 if block else 0,
        "decode_attention_int8": per_layer if opts.kv_cache_int8 else 0,
        "decode_attention": 0 if opts.kv_cache_int8 else per_layer,
        "fused_decode_step": DEC_LEN if fused else 0,
        "fused_epilogue": DEC_LEN if fused else 0,
    }


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Device time of one fn() call, averaged over reps back-to-back calls
    (CUDA events).  The calls are queued behind a ~20 ms spin kernel, so
    the host's own overhead per call (argument checks, launch) overlaps
    the device's work instead of showing as idle time between events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def serving_masks(device):
    """The encoder key mask of a real batch at the serving geometry,
    [txt 20 | frames 64 | ocr 960] padded to 1152 rows, and its OCR part."""
    import torch

    from vitxtgqa_tpu_torch.utils.synthetic import synthetic_batch

    b = synthetic_batch(batch=BATCH, seed=0)
    txt = (torch.arange(20)[None, :] < torch.as_tensor(b["text_len"])[:, None]).float()
    ocr = torch.as_tensor(b["ocr_mask"]).float()
    enc = torch.cat([txt, torch.as_tensor(b["frame_mask"]).float(), ocr], dim=1)
    enc = torch.nn.functional.pad(enc, (0, L_JOINT - enc.shape[1]))
    return enc.to(device).contiguous(), ocr.to(device).contiguous()


def decode_step_weights(dev, gen, n_layers=3, d=768, m=3072):
    """x_t [BATCH, 1, d] and the weight stacks of the decode-step check, in
    ops/decode_step.py's layout: q and the current token's k have ~unit
    entries in every layer (k = K_GAIN * q), so its attention can be
    planted."""
    import torch

    rn = lambda *s, scale: (torch.randn(*s, generator=gen, device=dev) * scale).to(torch.bfloat16)
    vec = lambda *s, base=0.0: (base + torch.randn(*s, generator=gen, device=dev) * 0.05).float()
    stacks = {"wq": rn(n_layers, d, d, scale=0.036), "wv": rn(n_layers, d, d, scale=0.036),
              "wo": rn(n_layers, d, d, scale=0.02), "w1": rn(n_layers, m, d, scale=0.02),
              "w2": rn(n_layers, d, m, scale=0.02)}
    for name in ("bq", "bv", "bo", "g1", "b1", "b2", "g2"):
        stacks[name] = vec(n_layers, 1, m if name == "b1" else d)
    for name in ("s1", "s2"):
        stacks[name] = vec(n_layers, 1, d, base=1.0)
    stacks["wk"], stacks["bk"] = stacks["wq"] * K_GAIN, stacks["bq"] * K_GAIN
    return rn(BATCH, 1, d, scale=1.0), stacks


def decode_step_cache(x_t, stacks, mask, step, gen, num_heads=12):
    """kv8 [L, B, Lp, 2d] int8 and kvs [L, B, 2, Lp] f32 for the decode
    step at ``step`` with the scores of PLANTED / BACKGROUND / TRAP.  Layer
    l's queries come from the plain step over layers < l, whose caches are
    planted already; a key row is q's direction per head, rounded to int8
    and scaled so that every head scores the slot's target.  Values are
    random int8 rows at scale 0.02 (|v| up to 2.5)."""
    import torch

    from vitxtgqa_tpu_torch.ops import decode_step as DS

    dev, (b, _, d), l = x_t.device, x_t.shape, mask.shape[1]
    n_layers, hd = stacks["wq"].shape[0], d // num_heads
    pos = WRITE_OFFSET + step
    slot = torch.arange(l, device=dev)
    allowed = (mask > 0) | ((slot >= WRITE_OFFSET) & (slot < pos))[None, :]
    target = torch.full((b, l), BACKGROUND, device=dev)
    target[~allowed] = TRAP
    for row in range(b):
        enc = allowed[row, :WRITE_OFFSET].nonzero()[:, 0]
        target[row, enc[0]], target[row, enc[len(enc) // 2]] = PLANTED[:2]
        if step:
            target[row, pos - 1] = PLANTED[2]
    kv8 = torch.randint(-127, 128, (n_layers, b, l, 2 * d), generator=gen, device=dev,
                        dtype=torch.int8)
    kvs = torch.full((n_layers, b, 2, l), 0.02, device=dev)
    for li in range(n_layers):
        x_l = x_t if li == 0 else DS.fused_decode_step_plain(
            x_t, {k: v[:li] for k, v in stacks.items()}, kv8[:li], kvs[:li], mask, step,
            WRITE_OFFSET, num_heads)[0]
        q = (x_l[:, 0].float() @ stacks["wq"][li].float().t()
             + stacks["bq"][li].float()).reshape(b, num_heads, hd)
        unit = q / q.abs().amax(-1, keepdim=True)
        gain = (unit * q).sum(-1) / hd ** 0.5     # [B, H]: score of `unit` at scale 1
        g_min = gain.amin(-1, keepdim=True)
        key = torch.round(127 * (g_min / gain)[..., None] * unit).reshape(b, 1, d)
        kv8[li, :, :, :d] = torch.where(target[..., None] < 0, -key, key).to(torch.int8)
        kvs[li, :, 0] = target.abs() / (127 * g_min)
    return kv8, kvs


def check_kernels(dev, record):
    import torch

    from vitxtgqa_tpu_torch.ops import decode_attention as DA
    from vitxtgqa_tpu_torch.ops import decode_step as DS
    from vitxtgqa_tpu_torch.ops import flash_attention as FA
    from vitxtgqa_tpu_torch.ops import fused_block as FB
    from vitxtgqa_tpu_torch.ops.attention import quantize_kv

    gen = torch.Generator(device=dev).manual_seed(1234)
    bf = torch.bfloat16
    rn = lambda *s, scale=1.0: (torch.randn(*s, generator=gen, device=dev) * scale).to(bf)
    h, l, d, m = 12, L_JOINT, 768, 3072
    mask, ocr_mask = serving_masks(dev)

    def report(name, err, ms, plain_ms, extra="", keep=True):
        """Print one check; ``keep``: its times are the record's (the main
        path's shape)."""
        tol = TOL[name]
        rec = record.setdefault(name, {"max_abs_err": 0.0, "ms": None, "plain_ms": None})
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        if ms is not None and keep:
            rec["ms"], rec["plain_ms"] = ms, plain_ms
        timing = f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms" if ms is not None else ""
        status = "ok" if err <= tol else "FAIL"
        print(f"kernel {name}{extra}: max|diff| {err:.3e} (tol {tol:.0e}) {status}{timing}",
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

    # 4. bf16 decode attention, same steps
    kb, vb = rn(BATCH, l, d), rn(BATCH, l, d)
    for step in (0, 11):
        dargs = (qd, kb, vb, mask, step, WRITE_OFFSET, h)
        got, want = DA.decode_attention(*dargs), DA.decode_attention_plain(*dargs)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        timed = step == 11
        report("decode_attention", err,
               cuda_time_ms(lambda: DA.decode_attention(*dargs)) if timed else None,
               cuda_time_ms(lambda: DA.decode_attention_plain(*dargs)) if timed else None,
               f" [8,1,768] x bf16 [8,1152,768] step={step}")

    # 5. the single-kernel decode step over 3 MMT layers, batch 1 / 2 / 8,
    # its attention planted (decode_step_cache)
    x_all, stacks = decode_step_weights(dev, gen)
    for step in (0, 11):
        kv8_all, kvs_all = decode_step_cache(x_all, stacks, mask, step, gen, h)
        for b in (1, 2, BATCH):
            kv8, kvs = kv8_all[:, :b].contiguous(), kvs_all[:, :b].contiguous()
            x_t, km = x_all[:b].contiguous(), mask[:b].contiguous()
            buffers = DS.step_buffers(3, b, d, m, dev)
            sargs = (x_t, stacks, kv8, kvs, km, step, WRITE_OFFSET, h)
            got = DS.fused_decode_step(*sargs, buffers=buffers)
            want = DS.fused_decode_step_plain(*sargs)
            torch.cuda.synchronize()
            err = (got[0].float() - want[0].float()).abs().max().item()
            d8 = (got[1].int() - want[1].int()).abs().max().item()
            dsc = ((got[2] - want[2]).abs() / want[2].abs()).max().item()
            print(f"kernel fused_decode_step [{b},1,768] step={step}: row8 max|diff| {d8} "
                  f"(tol {ROW8_TOL}), rowsc max rel diff {dsc:.3e} (tol {ROWSC_REL_TOL})",
                  flush=True)
            if d8 > ROW8_TOL or dsc > ROWSC_REL_TOL:
                fail(f"fused_decode_step quantized rows disagree at batch {b}, step {step}")
            timed = step == 11
            ms = cuda_time_ms(lambda: DS.fused_decode_step(*sargs, buffers=buffers)) if timed else None
            pms = cuda_time_ms(lambda: DS.fused_decode_step_plain(*sargs)) if timed else None
            report("fused_decode_step", err, ms, pms,
                   f" [{b},1,768] x 3 layers, kv8 [3,{b},1152,1536] step={step}", keep=b == 1)

    # 6. the fused epilogue, batch 1 / 2 / 8: scores, greedy token, next emb
    v_fix, v_p, n_ocr = 5050, 5120, 960
    cls_w = torch.zeros(v_p, d, device=dev)
    cls_w[:v_fix] = torch.randn(v_fix, d, generator=gen, device=dev) * 0.05
    cls_b = torch.full((v_p,), -1e30, device=dev)
    cls_b[:v_fix] = torch.randn(v_fix, generator=gen, device=dev) * 0.01
    ptr_w = torch.randn(d, d, generator=gen, device=dev) * 0.05
    ptr_b = torch.randn(d, generator=gen, device=dev) * 0.01
    keys_all = torch.randn(BATCH, n_ocr, d, generator=gen, device=dev) * 0.2
    ans = torch.zeros(v_p, d, device=dev, dtype=bf)
    ans[:v_fix] = rn(v_fix, d, scale=0.3)
    ocr_all = rn(BATCH, n_ocr, d, scale=0.3)
    emb = torch.randn(2 * DEC_LEN, d, generator=gen, device=dev) * 0.1
    y_all = rn(BATCH, 1, d)
    for b in (1, 2, BATCH):
        eargs = (y_all[:b].contiguous(), cls_w, cls_b, ptr_w, ptr_b, keys_all[:b].contiguous(),
                 ocr_mask[:b].contiguous(), ans, ocr_all[:b].contiguous(), emb, 3, v_fix,
                 1.0 / d ** 0.5, DEC_LEN)
        got, want = DS.fused_epilogue(*eargs), DS.fused_epilogue_plain(*eargs)
        torch.cuda.synchronize()
        err = (got[0] - want[0]).abs().max().item()
        top2 = want[0][:, 0].topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > TOL["fused_epilogue"]
        tok_ok = (got[1][:, 0, 0] == want[1][:, 0, 0]) | ~clear
        same = got[1][:, 0, 0] == want[1][:, 0, 0]
        emb_err = (got[2] - want[2]).float().abs()[same].max().item() if same.any() else 0.0
        print(f"kernel fused_epilogue [{b}] tokens {got[1][:, 0, 0].tolist()} vs plain "
              f"{want[1][:, 0, 0].tolist()}; next-embedding max|diff| {emb_err:.3e}", flush=True)
        if not bool(tok_ok.all()) or emb_err > TOL["fused_epilogue"]:
            fail(f"fused_epilogue token or embedding disagrees at batch {b}")
        report("fused_epilogue", err, cuda_time_ms(lambda: DS.fused_epilogue(*eargs)),
               cuda_time_ms(lambda: DS.fused_epilogue_plain(*eargs)),
               f" [{b},1,768] -> [{b},1,{v_p + n_ocr}]", keep=b == 1)


class Slices:
    """Production-width T2S models that share one set of random weights."""

    def __init__(self, dev):
        from vitxtgqa_tpu_torch.models.t2s import PRODUCTION_NUM_FINAL_OUTPUTS, t2s_production_config

        self.dev, self.cfg, self.nf = dev, t2s_production_config(), PRODUCTION_NUM_FINAL_OUTPUTS
        import torch

        t0 = time.perf_counter()
        self.state = self._new(kv_cache_int8=True).init_weights(0).state_dict()
        torch.cuda.synchronize()
        self.n_params = sum(v.numel() for v in self.state.values())
        print(f"slices: T2S production width, {self.n_params / 1e6:.1f}M params, bf16, "
              f"random weights from seed 0, built in {time.perf_counter() - t0:.1f} s", flush=True)

    def _new(self, **opts):
        import torch

        from vitxtgqa_tpu_torch import Options
        from vitxtgqa_tpu_torch.models.t2s import T2S

        return T2S(self.cfg, self.nf, bos_idx=2, opts=Options(
            device=self.dev, dtype=torch.bfloat16, **opts)).eval()

    def model(self, **opts):
        """A T2S in eval mode with these Options fields, bf16 on the card,
        holding the shared weights."""
        m = self._new(**opts)
        m.load_state_dict(self.state)
        return m


def check_outputs(outs, nf):
    import numpy as np

    for o in outs:
        if o["pos_scores"].shape != (DEC_LEN, nf) or o["pos_scores"].dtype != np.float32:
            fail(f"pos_scores {o['pos_scores'].shape} {o['pos_scores'].dtype}")
        if o["ground_frame"].shape != (5,) or o["ground_box"].shape != (64 * 5, 4):
            fail(f"grounding shapes {o['ground_frame'].shape} {o['ground_box'].shape}")
        for k in ("pos_scores", "ground_box"):
            if not np.isfinite(o[k]).all():
                fail(f"non-finite {k}")


def serve_slice(name, sl: Slices, record, opts: dict, groups, rng_seed=0):
    """Serve ``groups`` (one request count per group, each filling its own
    bucket) through a ServingEngine over the kernels; check the launch
    counts of every group's forward, that the engine's rows equal a direct
    forward, and the direct forward against the plain versions on the same
    batch, weights and gumbel noise.  Returns (model, summary)."""
    import numpy as np
    import torch

    from vitxtgqa_tpu_torch.ops import _build
    from vitxtgqa_tpu_torch.serving.engine import ServingEngine, group_generator, to_device
    from vitxtgqa_tpu_torch.utils.synthetic import synthetic_batch

    model, plain_model = sl.model(**opts), sl.model(plain=True, **opts)
    buckets = tuple(sorted(set(groups)))
    nb = max(buckets)
    batch = synthetic_batch(batch=nb, num_final_outputs=sl.nf, seed=0)
    samples = [{k: v[i] for k, v in batch.items()} for i in range(nb)]
    summary = {"opts": {k: str(v) for k, v in opts.items()}, "groups": []}
    with ServingEngine(model, buckets=buckets, max_wait_ms=300, rng_seed=rng_seed) as eng:
        eng.warmup(samples[0])
        torch.cuda.synchronize()
        for gid, n in enumerate(groups):
            _build.reset_launch_counts()
            outs = [f.result(timeout=600) for f in [eng.submit(s) for s in samples[:n]]]
            torch.cuda.synchronize()
            counts = _build.launch_counts()
            want = expected_launches(sl.cfg, n, model.opts)
            print(f"slice {name}: launches in one served forward at batch {n} "
                  + json.dumps(counts), flush=True)
            for k, v in want.items():
                if counts[k] != v:
                    fail(f"slice {name}: {k} launched {counts[k]} times in a batch-{n} "
                         f"forward, expected {v}")
                record.setdefault(k, {}).setdefault("launches", 0)
                record[k]["launches"] += counts[k]
            check_outputs(outs, sl.nf)

            sub = {k: v[:n] for k, v in batch.items()}
            tb = to_device(sub, sl.dev)
            with torch.inference_mode():
                kern = model(tb, group_generator(rng_seed, gid, sl.dev))
                plain = plain_model(tb, group_generator(rng_seed, gid, sl.dev))
            kp, pp = kern["pos_scores"].cpu().numpy(), plain["pos_scores"].cpu().numpy()
            if not np.array_equal(kp, np.stack([o["pos_scores"] for o in outs])):
                fail(f"slice {name}: engine rows differ from a direct forward on the same batch")
            diff_all = float(np.abs(kp - pp).max())
            diff0 = float(np.abs(kp[:, 0] - pp[:, 0]).max())
            agree = float((kp.argmax(-1) == pp.argmax(-1)).mean())
            gf = float((kern["ground_frame"] == plain["ground_frame"]).float().mean().item())
            print(f"slice {name}: batch {n} kernels vs plain on the card: max|d pos_scores| "
                  f"{diff_all:.4e} (step 0: {diff0:.4e}, tol {STEP0_TOL}), greedy-token "
                  f"agreement {agree:.4f} (min {MIN_TOKEN_AGREEMENT}), ground_frame agreement "
                  f"{gf:.4f}", flush=True)
            if diff0 > STEP0_TOL or agree < MIN_TOKEN_AGREEMENT:
                fail(f"slice {name}: the kernels disagree with the plain versions")
            summary["groups"].append({
                "batch": n, "launches": counts, "pos_scores_max_abs_diff": diff_all,
                "step0_max_abs_diff": diff0, "token_agreement": agree,
                "ground_frame_agreement": gf})
    del plain_model
    return model, summary


def forward_ms(model, batch, dev, reps=5):
    """Host-clock latency of direct forwards ending in a synchronize."""
    import torch

    from vitxtgqa_tpu_torch.serving.engine import group_generator, to_device

    tb = to_device(batch, dev)
    out = []
    for i in range(reps):
        t = time.perf_counter()
        with torch.inference_mode():
            model(tb, group_generator(0, i, dev))
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t) * 1e3)
    return out


def run_slices(dev, record, card):
    import torch

    from vitxtgqa_tpu_torch.serving.engine import ServingEngine
    from vitxtgqa_tpu_torch.utils.synthetic import synthetic_batch

    sl = Slices(dev)
    details = {"params_m": sl.n_params / 1e6}

    # a. int8 cache, batch 8: per-layer int8 decode; engine throughput
    model, details["int8_b8"] = serve_slice("int8_b8", sl, record, dict(kv_cache_int8=True),
                                            [BATCH])
    batch = synthetic_batch(batch=BATCH, num_final_outputs=sl.nf, seed=0)
    samples = [{k: v[i] for k, v in batch.items()} for i in range(BATCH)]
    lat = forward_ms(model, batch, dev)
    n_groups = 10
    with ServingEngine(model, buckets=(BATCH,), max_wait_ms=2000) as eng:
        eng.warmup(samples[0])
        t = time.perf_counter()
        futs = [eng.submit(samples[i % BATCH]) for i in range(n_groups * BATCH)]
        for f in futs:
            f.result(timeout=600)
        wall = time.perf_counter() - t
    vps = n_groups * BATCH / wall
    print(f"slice int8_b8: engine {vps:.2f} videos/s at batch {BATCH} ({n_groups} groups, "
          f"{wall:.3f} s); forward latency median {statistics.median(lat):.2f} ms "
          f"(min {min(lat):.2f}); card {card}", flush=True)
    details["int8_b8"].update(videos_per_s=vps, forward_ms_all=lat,
                              forward_ms_median=statistics.median(lat))
    del model

    # b. int8 cache, buckets (1, 2): the fused decode step and epilogue
    fused, details["int8_fused_b1_b2"] = serve_slice(
        "int8_fused_b1_b2", sl, record, dict(kv_cache_int8=True), [1, 2])
    per_layer = sl.model(kv_cache_int8=True, fused_decode=False)
    lat_rec = {}
    for b in (1, 2):
        sub = {k: v[:b] for k, v in batch.items()}
        forward_ms(fused, sub, dev, reps=2)  # warm-up
        forward_ms(per_layer, sub, dev, reps=2)
        f1, p1 = forward_ms(fused, sub, dev), forward_ms(per_layer, sub, dev)
        p2, f2 = forward_ms(per_layer, sub, dev), forward_ms(fused, sub, dev)
        fm, pm = statistics.median(f1 + f2), statistics.median(p1 + p2)
        lat_rec[b] = {"fused_ms_all": f1 + f2, "per_layer_ms_all": p1 + p2,
                      "fused_ms_median": fm, "per_layer_ms_median": pm}
        print(f"slice int8_fused_b1_b2: forward latency at batch {b}: fused decode median "
              f"{fm:.2f} ms (min {min(f1 + f2):.2f}), per-layer decode median {pm:.2f} ms "
              f"(min {min(p1 + p2):.2f}); card {card}", flush=True)
    details["int8_fused_b1_b2"]["latency"] = lat_rec
    del fused, per_layer

    # c. bf16 cache, batch 8: per-layer bf16 decode attention
    model, details["bf16_b8"] = serve_slice("bf16_b8", sl, record, dict(kv_cache_int8=False),
                                            [BATCH])
    del model
    torch.cuda.empty_cache()
    return details


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
    details["slices"] = run_slices(dev, record, card)
    out_dir = argv[argv.index("--out") + 1] if "--out" in argv else os.path.join(ROOT, "build")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(details, f, indent=1)

    kernels = [
        {"name": name, "route": "cuda", "source": SOURCE[name], "replaces": REPLACES[name],
         "launches": record[name].get("launches", 0),
         "max_abs_err": record[name]["max_abs_err"], "ms": record[name]["ms"],
         "plain_ms": record[name]["plain_ms"]}
        for name in REPLACES
    ]
    for k in kernels:
        if k["launches"] <= 0:
            fail(f"{k['name']} was never launched on the serving paths")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
