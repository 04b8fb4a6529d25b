"""Time every form of the flash forward body (#1, #10, #11, #14) and of the
backward (#1b, #10b) of the port package found under --root, for an A/B of
two checkouts on one card (run parent, change, change, parent back to
back):

    python3 vitxtgqa_tpu_torch/ab_kernels.py --root DIR [--reps N]

Forms and shapes: #1 at [8, 1152, 768] with the key mask of the synthetic
serving batch, dec_len 0 and 12; #1's dropout form (rate 0.1, with the
lse) and #1b at rate 0.1 and 0 at [48, 1152, 768] dec_len 12 (the
training step); #10b on a rank's 576 query rows at offset 576 against [4,
12, 1152, 64], dec_len 12 (the SP training step's); #10 on
split-head views, a rank's 576 query rows at offsets 0 and 576 against
[8, 12, 1152, 64], dec_len 0; #11 at [8, 1152, 768] dec_len 12; #14 with
no bias at [8, 16, 577, 64] (ViT-L/16 at 384 px) and with the key-mask and
the prefix-LM bias at [8, 12, 1152, 64]; and one ViT-L/16 forward at 384
px, batch 8 (random weights from seed 1), the path whose attention is #14
in all 24 layers.  Each time is CUDA events around --reps back-to-back
calls, the median of 5 such runs; beside each form the
time of F.scaled_dot_product_attention on the same inputs and mask where
one call computes the same function (#11's quantization has none).  Prints
one JSON line with the card's name and power limit.  Run it as a file, not
with -m, so that the package imported is the one under --root.
"""

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path = [root] + [p for p in sys.path if os.path.abspath(p) != os.path.dirname(__file__)]

    import torch
    import torch.nn.functional as F

    from vitxtgqa_tpu_torch import Options
    from vitxtgqa_tpu_torch.models.vit import VIT_L_16, ViT, preprocess_frames
    from vitxtgqa_tpu_torch.ops import _build
    from vitxtgqa_tpu_torch.ops import flash_attention as FA
    from vitxtgqa_tpu_torch.ops import fused_attention as FAT
    from vitxtgqa_tpu_torch.ops.masks import prefix_lm_bias, self_attention_bias
    from vitxtgqa_tpu_torch.utils.synthetic import synthetic_batch, synthetic_frames

    if not torch.cuda.is_available():
        raise SystemExit("ab_kernels: needs a CUDA device")
    _build.lib()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(11)
    rn = lambda *s: torch.randn(*s, generator=gen, device=dev).to(torch.bfloat16)
    split = lambda x, h: x.view(x.shape[0], x.shape[1], h, -1).transpose(1, 2)
    b = synthetic_batch(batch=8, seed=0)
    txt = (torch.arange(20)[None, :] < torch.as_tensor(b["text_len"])[:, None]).float()
    enc = torch.cat([txt, torch.as_tensor(b["frame_mask"]).float(),
                     torch.as_tensor(b["ocr_mask"]).float()], dim=1)
    mask8 = torch.nn.functional.pad(enc, (0, 1152 - enc.shape[1])).to(dev).contiguous()
    mask8_12 = mask8.clone()
    mask8_12[:, -12:] = 0.0
    mask48 = mask8_12[torch.arange(48) % 8].contiguous()
    seed = torch.tensor([7], dtype=torch.int64, device=dev)

    def timed(fn):
        for _ in range(3):
            fn()
        runs = []
        for _ in range(5):
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(40_000_000)
            start.record()
            for _ in range(args.reps):
                fn()
            end.record()
            end.synchronize()
            runs.append(start.elapsed_time(end) / args.reps)
        return statistics.median(runs)

    ms, sdpa = {}, {}
    allowed = lambda km, dec: FA._allowed(km, km.shape[1], dec)

    q, k, v = (rn(8, 1152, 768) for _ in range(3))
    qh, kh, vh = split(q, 12), split(k, 12), split(v, 12)
    for dec, km in ((0, mask8), (12, mask8_12)):
        ms[f"flash dec_len {dec}"] = timed(lambda: FA.flash_attention_merged(q, k, v, km, dec, 12))
        sdpa[f"flash dec_len {dec}"] = timed(
            lambda: F.scaled_dot_product_attention(qh, kh, vh, allowed(km, dec)))
    ms["flash_q8 dec_len 12"] = timed(lambda: FA.flash_attention_merged_q8(q, k, v, mask8_12, 12,
                                                                           12))
    for off in (0, 576):
        qs = qh[:, :, off:off + 576]
        am = FA._allowed(mask8, 1152, 0, off, 576)
        ms[f"split flash offset {off}"] = timed(lambda: FA.flash_attention(qs, kh, vh, mask8, 0,
                                                                           off))
        sdpa[f"split flash offset {off}"] = timed(
            lambda: F.scaled_dot_product_attention(qs, kh, vh, am))
    self_bias = self_attention_bias(mask8)
    prefix_bias = prefix_lm_bias(mask8_12[:, :-12].contiguous(), 12)
    for name, bias in (("fused key-mask bias 1152", self_bias),
                       ("fused prefix-LM bias 1152", prefix_bias)):
        am = bias.to(torch.bfloat16)
        ms[name] = timed(lambda: FAT.fused_attention(qh, kh, vh, bias))
        sdpa[name] = timed(lambda: F.scaled_dot_product_attention(qh, kh, vh, am))
    del q, k, v, qh, kh, vh
    qv, kv, vv = (split(rn(8, 577, 1024), 16) for _ in range(3))
    ms["fused no bias 577"] = timed(lambda: FAT.fused_attention(qv, kv, vv, None))
    sdpa["fused no bias 577"] = timed(lambda: F.scaled_dot_product_attention(qv, kv, vv))
    del qv, kv, vv
    cfg = dataclasses.replace(VIT_L_16, image_size=384)
    vit = ViT(cfg, Options(device=dev, dtype=torch.bfloat16)).init_weights(1).eval()
    with torch.inference_mode():
        images = preprocess_frames(
            torch.from_numpy(synthetic_frames(8, 240, 320, seed=3)).to(dev), cfg.image_size)
        ms["ViT-L/16 384 px forward [8]"] = timed(lambda: vit(images))
    del vit, images

    q, k, v, g = (rn(48, 1152, 768) for _ in range(4))
    fwd = lambda: FA.flash_attention_merged(q, k, v, mask48, 12, 12, 0.1, seed, return_lse=True)
    o, lse = fwd()
    ms["flash dropout 0.1 [48]"] = timed(fwd)
    qh, kh, vh = (split(t, 12).detach().requires_grad_() for t in (q, k, v))
    am = allowed(mask48, 12)
    sdpa["flash dropout 0.1 [48]"] = timed(
        lambda: F.scaled_dot_product_attention(qh, kh, vh, am, dropout_p=0.1))
    ms["flash bwd [48]"] = timed(lambda: FA.flash_attention_merged_bwd(
        q, k, v, mask48, o, lse, g, 12, 12, 0.1, seed))
    lib_out = F.scaled_dot_product_attention(qh, kh, vh, am, dropout_p=0.1)
    lib_g = torch.randn_like(lib_out)
    sdpa["flash bwd [48]"] = timed(lambda: torch.autograd.grad(lib_out, (qh, kh, vh), lib_g,
                                                               retain_graph=True))
    o0, lse0 = FA.flash_attention_merged(q, k, v, mask48, 12, 12, return_lse=True)
    ms["flash bwd rate 0 [48]"] = timed(lambda: FA.flash_attention_merged_bwd(
        q, k, v, mask48, o0, lse0, g, 12, 12))
    lib_out = F.scaled_dot_product_attention(qh, kh, vh, am)
    sdpa["flash bwd rate 0 [48]"] = timed(lambda: torch.autograd.grad(
        lib_out, (qh, kh, vh), lib_g, retain_graph=True))
    del q, k, v, g, o, lse, o0, lse0, qh, kh, vh, lib_out, lib_g
    torch.cuda.empty_cache()

    # #10b: an SP training rank's rows (offset 576 of 1152) at batch 4
    q, k, v, g = (rn(4, 1152, 768) for _ in range(4))
    qs, kh, vh = split(q, 12)[:, :, 576:], split(k, 12), split(v, 12)
    gs = split(g, 12)[:, :, :576]
    mask4 = mask48[:4].contiguous()
    o, lse = FA.flash_attention(qs, kh, vh, mask4, 12, 576, return_lse=True)
    ms["split flash bwd [4] offset 576"] = timed(lambda: FA.flash_attention_bwd(
        qs, kh, vh, mask4, o, lse, gs, 12, 576))
    lq, lk, lv = (t.detach().requires_grad_() for t in (qs, kh, vh))
    lib_out = F.scaled_dot_product_attention(lq, lk, lv, FA._allowed(mask4, 1152, 12, 576, 576))
    sdpa["split flash bwd [4] offset 576"] = timed(lambda: torch.autograd.grad(
        lib_out, (lq, lk, lv), gs, retain_graph=True))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"root": args.root, "ms": ms, "sdpa_ms": sdpa, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
