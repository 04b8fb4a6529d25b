"""Time every form of the flash forward body (#1, #10, #11, #14), of the
backward (#1b, #10b) and of the decode attention (#4, #7) of the port
package found under --root, for an A/B of two checkouts on one card (run
parent, change, change, parent back to back):

    python3 vitxtgqa_tpu_torch/ab_kernels.py --root DIR [--reps N]
        [--forms decode|block|step|epilogue]

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
in all 24 layers.  The decode attention (``--forms decode``: only these)
at step 11 of the 12 decoder slots over the serving batch's mask (its rows
repeated), #4 over the int8 cache and #7 over the bf16 cache at [8, 1152],
[1, 1152], [64, 1152] and [576, 1152] (the JAX bench's serving batch), and
#4 at the compact [8, 384]; each twice: warm (the same cache every call)
and cold (enough caches in turn that none is left in the 50 MB L2 from its
last call, as a forward's other kernels leave it).  Each time is CUDA
events around --reps back-to-back calls, the median of 5 such runs; beside
each form the time of F.scaled_dot_product_attention on the same inputs
and mask where one call computes the same function (#11's quantization has
none; #4's SDPA reads the dequantized cache).  Prints one JSON line with
the card's name and power limit.  Run it as a file, not with -m, so that
the package imported is the one under --root.

``--forms block`` times only the kernels on csrc/gemm_sm90.cuh's wgmma
body, and #8 beside them: #9a and #9b at 55,296 rows (48 x 1152: QTV,
MMT) and 960 (48 x 20: the text BERT), at rate 0.1 and 0, and at 55,296
rows with the FFN width 3,200 (narrow tiles; null where the package under
--root refuses it), with beside each (``gemm_ms``) the same three
(forward) or six (backward) products alone as bf16 torch.matmul calls: a
yardstick of the products, not a library column, since no single call
computes the block; #2 and the W8A8 block #8 on the same inputs at the
serving batch's 9,216 rows, batch 2's 2,304 and the compact MMT's 3,072,
#2's three products alone beside it, #3 at 9,216; and #13 at ViT-L/16's
12,608 rows, ViT-B/32's 3,200 and ViT-L/16 384 px's 4,616, its twin beside
it (``plain_ms``).

``--forms step`` times only the fused decode step #5 (3 MMT layers, step 11
of 12, its attention planted as chip_smoke.py's check plants it) at batch
1 and 2 over 1,152 keys and batch 1 over the compact 384, warm (the same
weights and cache every call) and cold (chip_smoke.cold_copies sets of
weight stacks and caches in turn), its twin beside each (``plain_ms``: a
record, not a yardstick).

``--forms epilogue`` times only the fused greedy-decode epilogue #6 and the
int8 pointer scores #12.  #6 at batch 1 and 2 over the serving batch's 960
OCR slots (classifier 5,050 of 5,120 padded rows, hidden and pointer
width 768), warm (the same weights and keys every call) and cold
(chip_smoke.cold_copies sets of classifier, pointer weights and keys in
turn), its two GEMVs alone as float32 torch.matmul beside each
(``yardstick_ms``); where the package under --root has
``epilogue_buffers``, the calls share one set of them, as a forward's do.
#12 at [B, 1, 768] x [B, 960, 768] int8 for B = 1, 8 and 576 (the JAX
bench's serving batch, 425 MB of keys) and at [8, 961] (no multiple of
either tile form's keys: the last tile holds one key), warm and cold, and
beside each the bf16-key einsum that the JAX package's default decode
takes instead (``OcrPtrNet.scores_from_keys`` on bf16 keys: a yardstick,
not a library column, since it reads twice the bytes).  Floors in the
same timing loop (``floor_ms``): x.sum() over 21 MB and 6 MB of float32
(the bytes of #6 at batch 1 and of #12 at batch 8), warm and cold, and a
one-element add_ (one launch).
"""

import argparse
import dataclasses
import itertools
import json
import os
import statistics
import subprocess
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--forms", choices=("all", "decode", "block", "step", "epilogue"), default="all")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path = [root] + [p for p in sys.path if os.path.abspath(p) != os.path.dirname(__file__)]

    import torch
    import torch.nn.functional as F

    from vitxtgqa_tpu_torch import Options
    from vitxtgqa_tpu_torch.models.vit import VIT_L_16, ViT, preprocess_frames
    from vitxtgqa_tpu_torch.ops import _build
    from vitxtgqa_tpu_torch.ops import decode_attention as DA
    from vitxtgqa_tpu_torch.ops import flash_attention as FA
    from vitxtgqa_tpu_torch.ops import fused_attention as FAT
    from vitxtgqa_tpu_torch.ops.attention import dequantize_kv, quantize_kv
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
    if args.forms == "block":
        return report(args.root, ms, sdpa, **block_forms(ms, timed, rn, dev, seed))
    if args.forms == "step":
        return report(args.root, ms, sdpa, **step_forms(ms, timed, dev))
    if args.forms == "epilogue":
        return report(args.root, ms, sdpa, **epilogue_forms(ms, timed, dev))

    # the decode attention, warm and cold
    compact = torch.nn.functional.pad(
        torch.cat([mask8[:, :25], torch.as_tensor(b["ocr_mask"]).float()[:, :320].to(dev)], 1),
        (0, 384 - 345)).contiguous()
    for form, km, wo in (("#4 [8,1152]", mask8, 1140), ("#7 [8,1152]", mask8, 1140),
                         ("#4 [1,1152]", mask8[:1], 1140), ("#7 [1,1152]", mask8[:1], 1140),
                         ("#4 [64,1152]", mask8[torch.arange(64) % 8], 1140),
                         ("#7 [64,1152]", mask8[torch.arange(64) % 8], 1140),
                         ("#4 [576,1152]", mask8[torch.arange(576) % 8], 1140),
                         ("#7 [576,1152]", mask8[torch.arange(576) % 8], 1140),
                         ("#4 [8,384]", compact, 372)):
        km = km.contiguous()
        n, l = km.shape
        int8 = form.startswith("#4")
        slot = torch.arange(l, device=dev)
        am = ((km > 0) | ((slot >= wo) & (slot <= wo + 11))[None, :])[:, None, None, :]
        set_bytes = n * l * 768 * 2 * (1 if int8 else 2)
        copies = max(1, -(-3 * 50 * 2 ** 20 // set_bytes))
        q, caches, kvs = rn(n, 1, 768), [], []
        for _ in range(copies):
            k, v = rn(n, l, 768), rn(n, l, 768)
            if int8:
                (k8, ks), (v8, vs) = quantize_kv(k), quantize_kv(v)
                caches.append((k8, ks, v8, vs))
                k, v = dequantize_kv(k8, ks, torch.bfloat16), dequantize_kv(v8, vs, torch.bfloat16)
            else:
                caches.append((k, v))
            kvs.append((split(k, 12), split(v, 12)))
        fn = DA.decode_attention_int8 if int8 else DA.decode_attention
        qh = split(q, 12)
        run = lambda c: fn(q, *c, km, 11, wo, 12)
        lib = lambda kv: F.scaled_dot_product_attention(qh, *kv, am)
        for temp, pick in (("warm", lambda i: 0), ("cold", lambda i: i % copies)):
            turn = itertools.count()
            ms[f"decode {form} {temp}"] = timed(lambda: run(caches[pick(next(turn))]))
            sdpa[f"decode {form} {temp}"] = timed(lambda: lib(kvs[pick(next(turn))]))
        del q, caches, kvs, k, v
        torch.cuda.empty_cache()
    if args.forms == "decode":
        return report(args.root, ms, sdpa)

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
    return report(args.root, ms, sdpa)


def block_forms(ms, timed, rn, dev, seed):
    """#9a / #9b (and the products alone as torch.matmul: returned under
    "gemm_ms"), #2, #3, #8 and #13 (and #13's twin: returned under
    "plain_ms") into ``ms``; a form that the package under --root refuses
    (NotImplementedError: #9 at m = 3,200 before the narrow tile) is null."""
    import torch

    from vitxtgqa_tpu_torch.ops import block_train as BT
    from vitxtgqa_tpu_torch.ops import ffn as FFN
    from vitxtgqa_tpu_torch.ops import fused_block as FB

    gemm, plain = {}, {}
    d = 768
    vec = lambda n, base=0.0: base + 0.05 * torch.randn(n, device=dev)

    def block_weights(m):
        wo, w1, w2 = (rn(*s) * 0.02 for s in ((d, d), (m, d), (d, m)))
        bo, s1, g1, b1, b2, s2, g2 = (vec(d), vec(d, 1.0), vec(d), vec(m), vec(d), vec(d, 1.0),
                                      vec(d))
        return (wo, bo, s1, g1, w1, b1, w2, b2, s2, g2)

    wargs = block_weights(3072)
    wo, w1, w2 = wargs[0], wargs[4], wargs[6]
    for rows, m, rates in ((48 * 1152, 3072, (0.1, 0.0)), (48 * 20, 3072, (0.1, 0.0)),
                           (48 * 1152, 3200, (0.1,))):
        wa = wargs if m == 3072 else block_weights(m)
        tag = f"[{rows}]" if m == 3072 else f"[{rows}] m {m}"
        x_q, ctx, gy = rn(rows, d), rn(rows, d), rn(rows, d)
        try:
            res = BT.block_train_fwd(x_q, ctx, *wa, rate=0.1, seed=seed)
        except NotImplementedError:
            res = None
        for rate in rates:
            kw = dict(rate=rate, seed=seed if rate else None)
            if res is None:
                ms[f"#9a {tag} rate {rate}"] = ms[f"#9b {tag} rate {rate}"] = None
                continue
            bwd_args = (gy, ctx, *res[1:], wa[0], wa[4], wa[6], wa[2], wa[3], wa[8])
            ms[f"#9a {tag} rate {rate}"] = timed(lambda: BT.block_train_fwd(x_q, ctx, *wa, **kw))
            ms[f"#9b {tag} rate {rate}"] = timed(lambda: BT.block_train_bwd(*bwd_args, **kw))
        if m == 3072:
            x, pre1, h = res[4], res[2], res[3]
            gemm[f"#9a [{rows}]"] = timed(lambda: (ctx @ wo.t(), x @ w1.t(), h @ w2.t()))
            gemm[f"#9b [{rows}]"] = timed(lambda: (gy @ w2, pre1 @ w1, gy @ wo, gy.t() @ ctx,
                                                   pre1.t() @ x, gy.t() @ h))
        del x_q, ctx, gy, res
        torch.cuda.empty_cache()

    # the eval block, its tanh form and the W8A8 block; the three products
    # alone as bf16 torch.matmul beside them
    q8 = FB.quantize_block_weights(wo, w1, w2)
    for rows in (8 * 1152, 2 * 1152, 8 * 384):
        x_q, ctx, res, h = rn(rows, d), rn(rows, d) * 0.5, rn(rows, d), rn(rows, 3072)
        args = (x_q, ctx) + wargs
        ms[f"#2 [{rows}]"] = timed(lambda: FB.fused_block(*args))
        gemm[f"#2 [{rows}]"] = timed(lambda: (ctx @ wo.t(), x_q @ w1.t(), h @ w2.t()))
        bo, s1, g1, b1, b2, s2, g2 = (wargs[i] for i in (1, 2, 3, 5, 7, 8, 9))
        ms[f"#8 [{rows}]"] = timed(lambda: FB.fused_block_w8a8(
            x_q, ctx, q8[0], q8[1], bo, s1, g1, q8[2], q8[3], b1, q8[4], q8[5], b2, s2, g2))
        if rows == 8 * 1152:
            ms[f"#3 [{rows}]"] = timed(lambda: FB.fused_block_tanh(res, *args))
        del x_q, ctx, res, h, args
    # the ViT FFN and its twin
    for rows, d_in, m in ((64 * 197, 1024, 4096), (64 * 50, 768, 3072), (8 * 577, 1024, 4096)):
        ffn = (rn(rows, d_in), rn(m, d_in) * 0.02, vec(m), rn(d_in, m) * 0.02, vec(d_in))
        ms[f"#13 [{rows}]"] = timed(lambda: FFN.fused_ffn(*ffn))
        plain[f"#13 [{rows}]"] = timed(lambda: FFN.fused_ffn_plain(*ffn))
        del ffn
    return {"gemm_ms": gemm, "plain_ms": plain}


def step_forms(ms, timed, dev):
    """#5 warm and cold into ``ms``, its twin (returned under "plain_ms")."""
    import torch

    import chip_smoke as CS
    from vitxtgqa_tpu_torch.ops import decode_step as DS

    plain = {}
    gen = torch.Generator(device=dev).manual_seed(1234)
    mask, _ = CS.serving_masks(dev)
    x_all, stacks = CS.decode_step_weights(dev, gen)
    for lp, km_all, wo in ((1152, mask, CS.WRITE_OFFSET),
                           (384, CS.compact_mask(dev), CS.COMPACT_OFFSET)):
        kv8_all, kvs_all = CS.decode_step_cache(x_all, stacks, km_all, 11, gen, 12, wo)
        for b in ((1, 2) if lp == 1152 else (1,)):
            kv8, kvs = kv8_all[:, :b].contiguous(), kvs_all[:, :b].contiguous()
            x_t, km = x_all[:b].contiguous(), km_all[:b].contiguous()
            bufs = DS.step_buffers(3, b, 768, 3072, dev, 12)
            copies = CS.cold_copies(CS.nbytes(*stacks.values(), kv8, kvs))
            sets = [(stacks, kv8, kvs)] + [({k: v.clone() for k, v in stacks.items()},
                                            kv8.clone(), kvs.clone()) for _ in range(copies - 1)]
            run = lambda st, k8, ks: DS.fused_decode_step(x_t, st, k8, ks, km, 11, wo, 12,
                                                          buffers=bufs)
            turn = itertools.count()
            ms[f"#5 [{b},{lp}] warm"] = timed(lambda: run(*sets[0]))
            ms[f"#5 [{b},{lp}] cold"] = timed(lambda: run(*sets[next(turn) % copies]))
            plain[f"#5 [{b},{lp}]"] = timed(lambda: DS.fused_decode_step_plain(
                x_t, stacks, kv8, kvs, km, 11, wo, 12))
            del sets
            torch.cuda.empty_cache()
    return {"plain_ms": plain}


def epilogue_forms(ms, timed, dev):
    """#6 and #12 warm and cold into ``ms``; their yardsticks and the
    floors (returned under "yardstick_ms" and "floor_ms")."""
    import math

    import torch
    import torch.nn.functional as F

    import chip_smoke as CS
    from vitxtgqa_tpu_torch.ops import decode_step as DS
    from vitxtgqa_tpu_torch.ops import ptr_scores as PS
    from vitxtgqa_tpu_torch.ops.attention import quantize_kv

    yard = {}
    gen = torch.Generator(device=dev).manual_seed(4321)
    rn = lambda *s, scale=1.0: torch.randn(*s, generator=gen, device=dev) * scale
    _, ocr_mask = CS.serving_masks(dev)
    d, v_fix, v_p, n = 768, 5050, 5120, 960
    ans = torch.zeros(v_p, d, device=dev, dtype=torch.bfloat16)
    ans[:v_fix] = rn(v_fix, d, scale=0.3).to(torch.bfloat16)
    cls_b = torch.full((v_p,), -1e30, device=dev)
    cls_b[:v_fix] = rn(v_fix, scale=0.01)
    ptr_b, emb = rn(d, scale=0.01), rn(2 * 12, d, scale=0.1)

    def weights(b):
        cls_w = torch.zeros(v_p, d, device=dev)
        cls_w[:v_fix] = rn(v_fix, d, scale=0.05)
        return cls_w, rn(d, d, scale=0.05), rn(b, n, d, scale=0.2)

    for b in (1, 2):
        y = rn(b, 1, d).to(torch.bfloat16)
        mask = ocr_mask[:b].contiguous()
        ocr = rn(b, n, d, scale=0.3).to(torch.bfloat16)
        first = weights(b)
        copies = CS.cold_copies(CS.nbytes(*first))
        sets = [first] + [weights(b) for _ in range(copies - 1)]
        kw = {"buffers": DS.epilogue_buffers(b, d, dev)} if hasattr(DS, "epilogue_buffers") else {}
        run = lambda cls_w, ptr_w, keys: DS.fused_epilogue(
            y, cls_w, cls_b, ptr_w, ptr_b, keys, mask, ans, ocr, emb, 3, v_fix,
            1.0 / math.sqrt(d), 12, **kw)
        y32 = y[:, 0].float()
        gemv = lambda cls_w, ptr_w, keys: (y32 @ cls_w.t(), y32 @ ptr_w.t())
        for temp, pick in (("warm", lambda i: 0), ("cold", lambda i: i % copies)):
            turn = itertools.count()
            ms[f"#6 [{b}] {temp}"] = timed(lambda: run(*sets[pick(next(turn))]))
            yard[f"#6 [{b}] {temp}"] = timed(lambda: gemv(*sets[pick(next(turn))]))
        del sets, first
        torch.cuda.empty_cache()

    for b, slots in ((1, n), (8, n), (576, n), (8, n + 1)):
        mask = F.pad(ocr_mask, (0, slots - n), value=1.0)
        mask = mask[torch.arange(b) % mask.shape[0]].contiguous()
        q = rn(b, 1, d, scale=0.5)
        copies = CS.cold_copies(b * slots * d)
        sets = []
        for _ in range(copies):
            kb = rn(b, slots, d).to(torch.bfloat16)
            sets.append((*quantize_kv(kb), kb))
        bf16_scores = lambda kbf: (torch.einsum("bsd,bnd->bsn", q, kbf.float()) / math.sqrt(d)
                                   + mask[:, None, :])
        key = f"#12 [{b}]" if slots == n else f"#12 [{b},{slots}]"
        for temp, pick in (("warm", lambda i: 0), ("cold", lambda i: i % copies)):
            turn = itertools.count()
            ms[f"{key} {temp}"] = timed(
                lambda: PS.ptr_scores_int8(q, *sets[pick(next(turn))][:2], mask))
            yard[f"{key} {temp}"] = timed(lambda: bf16_scores(sets[pick(next(turn))][2]))
        del sets, kb
        torch.cuda.empty_cache()

    floor = {}
    for mb in (21, 6):
        xs = [torch.randn(mb * 2 ** 18, device=dev) for _ in range(CS.cold_copies(mb * 2 ** 20))]
        for temp, pick in (("warm", lambda i: 0), ("cold", lambda i: i % len(xs))):
            turn = itertools.count()
            floor[f"x.sum {mb} MB {temp}"] = timed(lambda: xs[pick(next(turn))].sum())
        del xs
    one = torch.zeros(1, device=dev)
    floor["one-element add_"] = timed(lambda: one.add_(1))
    return {"yardstick_ms": yard, "floor_ms": floor}


def report(root, ms, sdpa, **beside) -> int:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"root": root, "ms": ms, "sdpa_ms": sdpa, **beside, "card": card}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
