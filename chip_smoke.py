#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's T2S serving, full-eval and training paths,
its ViT frame-feature path and its sequence-parallel path once on one
NVIDIA GPU.

    python3 chip_smoke.py [--out DIR]

Phases (each prints one or more lines; any failure exits non-zero):
  1. environment: the card's name and power limit, torch / CUDA versions,
     TF32 switched off for float32 matmuls and convolutions;
  2. build: nvcc compiles vitxtgqa_tpu_torch/csrc into build/kernels/, one
     process per source, all started together;
  3. kernels: each CUDA kernel against its plain PyTorch version at the
     serving shapes (joint sequence 1152, hidden 768, batch 8, and batch
     1 / 2 / 8 for the decode-step kernels), bf16, with a ragged key mask
     from synthetic_batch, and for the flash forwards (#1, its dropout
     form, #10; #1b with the first) also the masks of edge_masks: a batch
     row with no valid key, and valid keys in one key tile only (the tile
     walk's skip path), and again at 577 keys (check_padded_keys: 63
     padded keys, which a row of mask fills counts);
     max |diff| against a stated tolerance, and
     CUDA-event times of both.  The decode step's attention is planted
     (PLANTED / BACKGROUND / TRAP) so that reading a slot it must not read
     moves its output by far more than the tolerance.  The training
     kernels at L 1152, 12 heads, batch 4 (rows 4608): the flash forward
     with dropout 0.1 (dec_len 0 and 12) and its backward (rate 0 and
     0.1), the block forward (5 outputs) and backward (12 gradients,
     against autograd through block_train_plain), all with the same
     seed-regenerated masks as their twins; the in-kernel keep rate over
     >= 10^7 draws and the forward / backward stream equality; then again
     at the training step's own shapes: the flash pair at [48, 1152, 768]
     with the MMT mask, the block pair at 55,296 rows (QTV, MMT) and 960
     (text BERT), against the twins on the same inputs.  The serving
     modes' kernels: the W8A8 block at 9,216 and 3,072 rows (its ctx
     quantization bit for bit), the int8-emitting flash forward at [8,
     1152, 768] (its int8 cache and scales bit for bit, #1 timed on the
     same inputs), the int8 pointer scores at [8, 1, 768] x [8, 960, 768],
     and the decode attention and decode step again at the compact cache
     length 384.  The ViT's kernels: the fused FFN at ViT-L/16's 12,608
     rows and ViT-B/32's 3,200, the bias-tensor attention on split-head
     views with no bias and with a per-row bias at [8, 16, 577, 64] (577
     query rows and keys: a last key tile of one key) and with the key-mask
     and the prefix-LM bias at [8, 12, 1152, 64].  The sequence-parallel kernels:
     the split-head flash with a query-row offset (#10) on a rank's 576
     rows against 1,152 keys at batch 8, offsets 0 and 576, dec_len 0 and
     12, with dropout at offset 576 and its shards against the unsharded
     rows bit for bit; its backward (#10b) at batch 4, rate 0 and 0.1,
     offsets 0 and 576, against autograd through the twin on the serving
     mask and against the backward twin on edge_masks (dec_len 0 and 12);
     check_padded_keys holds #1b and #10b at 577 keys too (a row of mask
     fills weighs each key 1 / 640), and #14 with -1e9 on every key of a
     row at 577 keys.  Each kernel's bound (bytes over 3.35 TB/s or operations
     over the peak of their type: 989 TFLOP/s bf16, 1,979 TOP/s int8, 67
     TFLOP/s f32) is computed from the inputs of its timed call, and one
     PyTorch call that computes the same function is timed beside it where
     one exists (library_ms; the port never calls it);
  4. slices: T2S at production width (t2s_production_config) in bf16:
       a. int8 KV cache, batch 8 (per-layer int8 decode attention), and
          the same forward from a model built with Options(kv_cache_int8=
          True) alone (bf16 on the card by default), bit for bit;
       b. int8 KV cache, buckets (1, 2): the single-kernel decode step and
          the fused epilogue; then the forward latency at batch 1 and 2
          through the fused and the per-layer decode;
       c. bf16 KV cache, batch 8 (per-layer bf16 decode attention);
       d. full-eval, int8 cache, batch 8: the pos decode, then ref / neg
          from one teacher-forced pass at 2B;
       e. training: (i) one step at batch 4 through the kernels and through
          the plain versions from the same weights, batch, gumbel noise and
          dropout generator (loss, gradient norm, every parameter's
          gradient), and the plain step with each planted block fault,
          which the same limits must reject; (ii) batch 48, remat "attn",
          >= 3 Adam steps through the kernels, with the step time, videos/s
          and peak memory;
       f. the serving preset (configs/t2s_serving.yml: int8 cache + compact
          serving) at batch 8 and buckets (1, 2), and the batch-1 latency
          of compact against exact;
       g. W8A8 at batch 8 (int8 cache, bf16 cache, int8 + compact), and
          its token agreement with the bf16 block (printed: the weights are
          random);
       h. compact full-eval at batch 8;
       i. the module entry points of the two int8 kernels: the MMT
          encoder's encode_with_cache(quantize=True), whose cache must equal
          quantize_cache's bit for bit and decode to the same tokens, and
          OcrPtrNet.scores_from_keys over int8 keys;
       j. frames to answer: 64 uint8 frames at 240 x 320 through
          preprocess_frames and ViT-L/16 at 224 px (CLS features against
          the plain path, frames/s), the features served as one T2S request
          at batch 1 with the int8 cache, its tokens against the plain path
          end to end; then the ViT at 384 px (577 tokens) at batch 8, and
          its backward at batch 2 through #14 against the plain stack's
          (every parameter's gradient);
       k. sequence parallelism over 2 ranks (torch.multiprocessing.spawn,
          gloo, both ranks on the one card; the kernels are built before
          the ranks start): (i) serving and (ii) full-eval with the int8
          cache at batch 8, and (iii) a training step at batch 4 with the
          QTV and MMT attention dropout at 0, each rank's launches as
          derived (#10, #10b in #1's, #1b's place), the tokens (loss) equal
          across the ranks, against the unsharded plain versions from the
          same weights, batch and noise; the SP forward's latency against
          the unsharded one and one all-gather's time.
     a-c and f-g serve behind a ServingEngine; each slice checks its launch
     counts (derived from the gates), the outputs' shapes and finiteness,
     and the same inputs through the plain versions on the card.
The line before the last is the kernels' JSON record, the one before it the
card's name and power limit, the last line ``{"ok": true, "device":
{...}}``.  Details go to DIR/chip_smoke.json (default DIR: build/).
Without a CUDA device it exits 2 and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH = 8
L_JOINT, WRITE_OFFSET, DEC_LEN = 1152, 1140, 12
# the compact joint sequence: 20 question tokens + 5 frames + 64 x 5 OCR
# slots = 345 rows, padded with the decoder slots to 384
L_COMPACT, COMPACT_OFFSET = 384, 372

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
# The training kernels: the flash forward with dropout as the forward
# without; the block forward's five outputs are bf16 activations of |x| up
# to ~5 (x1h, x2h, y) with the twin's rounding chain, so a few bf16 ulps,
# as the eval block.  The two backward kernels are held scale-relative:
# max |diff| / max |twin| per gradient.  Their twins keep f32 where the
# kernels round P and dS (flash) or dlin2, dpre and dlin1 (block, as the
# Pallas kernel does) to bf16 before a product, a 2^-9 relative error per
# operand summed over 1152 keys or up to 55,296 rows.
# The serving modes' kernels: the W8A8 block's output is a LayerNorm output
# in bf16 like the eval block's; its int32 sums are exact on both sides, and
# the f32 epilogues differ in the order of the LayerNorm sums and in FMA
# contraction, which can move an element of x or h across the rounding
# boundary of its int8 step and its row by that step's weight (~1e-2 before
# the LayerNorm): a few bf16 ulps, as the eval block.  Its quantized ctx
# rows are exact (amax, IEEE division and rint only).  The int8-emitting
# flash: its output as #1's, its int8 cache and scales exact.  The int8
# pointer scores: f32 dots of length 768 over O(1) products in another
# order, scores of |s| < ~20.
# The ViT's kernels: the fused FFN's outputs are O(1) sums of 4,096 products
# in bf16; the kernel takes the gelu of the f32 pre-activation where the
# twin (ffn_reference) rounds it to bf16 first, so h differs by a bf16 ulp
# here and there: the JAX test's bf16 limit (tests/test_pallas_ffn.py).  The
# bias-tensor attention as the flash forward: averages of O(1) values.
# The split-head flash with a row offset (#10) as #1, and its backward
# (#10b) as #1b, scale-relative; its twin's gradients are autograd's
# through the forward twin in f32.
TOL = {
    "flash_attention_merged": 2e-2,
    "fused_block": 6e-2,
    "fused_block_tanh": 6e-2,
    "decode_attention_int8": 2e-2,
    "decode_attention": 2e-2,
    "fused_decode_step": 6e-2,
    "fused_epilogue": 2e-2,
    "flash_attention_merged_bwd": 3e-2,
    "block_train_fwd": 6e-2,
    "block_train_bwd": 3e-2,
    "fused_block_w8a8": 6e-2,
    "flash_attention_merged_q8": 2e-2,
    "ptr_scores_int8": 1e-3,
    "fused_ffn": 3e-2,
    "fused_attention": 2e-2,
    "flash_attention": 2e-2,
    "flash_attention_bwd": 3e-2,
}
# the in-kernel dropout draws: keep share within 0.001 of 1 - rate (the
# binomial standard deviation over 10^7 draws is 1e-4)
RATE, KEEP_TOL, MIN_DRAWS = 0.1, 1e-3, 10 ** 7
# H100 SXM peaks (NVIDIA's data sheet):
# dense bf16 tensor-core operations and HBM3 bandwidth; dense int8
# tensor-core operations; f32 outside the tensor cores
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12
PEAK_INT8_OPS, PEAK_F32_FLOPS = 1979e12, 67e12
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
    "flash_attention_merged_bwd": "vitxtgqa_tpu/ops/pallas_attention.py:779",
    "block_train_fwd": "vitxtgqa_tpu/ops/pallas_block_bwd.py:321",
    "block_train_bwd": "vitxtgqa_tpu/ops/pallas_block_bwd.py:428",
    "fused_block_w8a8": "vitxtgqa_tpu/ops/pallas_ffn.py:466",
    "flash_attention_merged_q8": "vitxtgqa_tpu/ops/pallas_attention.py:708",
    "ptr_scores_int8": "vitxtgqa_tpu/ops/pallas_attention.py:1078",
    "fused_ffn": "vitxtgqa_tpu/ops/pallas_ffn.py:74",
    "fused_attention": "vitxtgqa_tpu/ops/pallas_attention.py:1162",
    "flash_attention": "vitxtgqa_tpu/ops/pallas_attention.py:242",
    "flash_attention_bwd": "vitxtgqa_tpu/ops/pallas_attention.py:350",
}
SOURCE = {
    "flash_attention_merged": "vitxtgqa_tpu_torch/csrc/flash_attention.cu",
    "fused_block": "vitxtgqa_tpu_torch/csrc/fused_block.cu",
    "fused_block_tanh": "vitxtgqa_tpu_torch/csrc/fused_block.cu",
    "decode_attention_int8": "vitxtgqa_tpu_torch/csrc/decode_attention.cu",
    "decode_attention": "vitxtgqa_tpu_torch/csrc/decode_attention.cu",
    "fused_decode_step": "vitxtgqa_tpu_torch/csrc/fused_decode_step.cu",
    "fused_epilogue": "vitxtgqa_tpu_torch/csrc/fused_epilogue.cu",
    "flash_attention_merged_bwd": "vitxtgqa_tpu_torch/csrc/flash_bwd.cuh",
    "block_train_fwd": "vitxtgqa_tpu_torch/csrc/block_train.cu",
    "block_train_bwd": "vitxtgqa_tpu_torch/csrc/block_train.cu",
    "fused_block_w8a8": "vitxtgqa_tpu_torch/csrc/fused_block_w8a8.cu",
    "flash_attention_merged_q8": "vitxtgqa_tpu_torch/csrc/flash_attention.cu",
    "ptr_scores_int8": "vitxtgqa_tpu_torch/csrc/ptr_scores.cu",
    "fused_ffn": "vitxtgqa_tpu_torch/csrc/fused_ffn.cu",
    "fused_attention": "vitxtgqa_tpu_torch/csrc/fused_attention.cu",
    "flash_attention": "vitxtgqa_tpu_torch/csrc/flash_attention.cu",
    "flash_attention_bwd": "vitxtgqa_tpu_torch/csrc/flash_bwd.cuh",
}
# slice, kernels vs plain on the card: greedy tokens may diverge where two
# scores tie within bf16 noise, and diverge for the rest of the sequence
# after that; the first step sees identical inputs up to that noise
MIN_TOKEN_AGREEMENT = 0.8
STEP0_TOL = 0.15
# full-eval's ref / neg scores come from one teacher-forced pass on the
# decoded tokens: compared on the rows whose tokens agree, like step 0
REFNEG_TOL = 0.15
# the row log-sum-exp: f32 on both sides from the same bf16 operands
LSE_TOL = 1e-3
# training, kernels vs plain from the same weights, batch, noise and
# dropout generator: bf16 rounding at other places through 14 blocks,
# forward and backward.  The loss (InfoNCE x 1000 dominates it), the global
# gradient norm and the gradient of every parameter tensor (each a relative
# difference |g - g_plain| / |g_plain|, so a bias is held on its own and
# not beside its weight, and a gradient off by a scale counts as much as
# one off in direction) are held a few times beyond the readings of the
# kernels on the H100 (PERF.md); each planted fault (PLANTED_FAULTS) must
# break at least one of the three.
LOSS_REL_TOL, GNORM_REL_TOL, GRAD_REL_TOL = 5e-4, 1e-3, 5e-2
TRAIN_CHECK_BATCH = 4   # the kernel checks and the kernels-vs-plain step
TRAIN_BATCH = 48        # configs/t2s_abinet.yml training_parameters.batch_size
TRAIN_STEPS = 4         # the first is a warm-up; >= 3 are timed
# slice j: the extractor's default chunk (tools/video_feat/obtain_vit_feat.py
# --batch) and the timed forwards.  The CLS features are final-LayerNorm
# outputs (|x| up to ~5); through 24 layers of bf16 rounding at other places
# (the FFN's gelu rounding differs between kernel and twin) each frame's
# feature is held to a relative L2 difference of a few bf16 ulps (2^-8).
VIT_FRAMES, VIT_REPS = 64, 5
VIT_FEAT_REL_TOL = 3e-2
# the 384-px ViT's backward through #14 against the plain stack, batch 2:
# every parameter's gradient relative to the plain one's, the training
# step's limit
VIT_BWD_BATCH = 2
# slice k: the sequence-parallel ranks, two processes on the one card
# (gloo: NCCL refuses two ranks on one device); the SP training step's QTV
# and MMT attention dropout (the JAX gate routes only dropout-free
# attention to SP); forwards timed per configuration
SP_RANKS = 2
SP_TRAIN_ATTENTION_DROPOUT = 0.0
SP_REPS = 3


def joint_lengths(cfg, text_len: int = 20, dec_len: int = DEC_LEN):
    """(full, compact) joint-sequence rows with the decoder slots, padded to
    a multiple of 128 as the models pad them: [question | frames | OCR] and
    [question | top-k frames | top-k OCR slots of every frame]."""
    g = cfg["grounding"]
    full = text_len + g["frame_num"] + g["frame_num"] * g["ocr_frame_num"]
    compact = text_len + g["frame_topk"] + g["frame_num"] * g["ocr_topk"]
    pad = lambda n: -(-(n + dec_len) // 128) * 128
    return pad(full), pad(compact)


def expected_launches(cfg, batch: int, opts, full_eval: bool = False, text_len: int = 20,
                      dec_len: int = DEC_LEN) -> dict:
    """Kernel launches in one eval forward, derived from the port's gates.
    In each QTV and MMT encode layer: flash where the joint sequence has >=
    256 keys; where the rows reach the fused block's gate, the W8A8 block
    under Options.w8a8, else the fused block (the last QTV layer in its tanh
    form).  The MMT encodes the compact sequence under compact serving.
    Per decode step: with the int8 cache at batch <= the cap and no W8A8,
    the fused step and (not compact) the fused epilogue; else one decode
    attention per MMT layer (the bf16 one only at >= 256 keys).  With
    ``full_eval`` the teacher-forced pass at 2B over the full sequence, or
    under compact serving ref at B over it and neg at B over the compact
    one.  No training kernel, and no #11 / #12 (the decode keeps the
    separate quantize pass and bf16 pointer keys, as JAX does)."""
    from vitxtgqa_tpu_torch.models.common import TransformerConfig
    from vitxtgqa_tpu_torch.ops import fused_block as FB
    from vitxtgqa_tpu_torch.ops.attention import MIN_KV

    qtv = TransformerConfig.from_config(cfg["translayers"])
    mmt = TransformerConfig.from_config(cfg["mmt"])
    l_full, l_compact = joint_lengths(cfg, text_len, dec_len)
    l_mmt = l_compact if opts.compact_serving else l_full
    out = {name: 0 for name in REPLACES}

    def encode(tc, rows, seq, tanh_last):
        n = tc.num_hidden_layers
        if seq >= MIN_KV:
            out["flash_attention_merged"] += n
        if FB.kernel_ok(tc.hidden_size, tc.intermediate_size, rows * seq):
            if opts.w8a8:
                out["fused_block_w8a8"] += n
            else:
                out["fused_block"] += n - tanh_last
                out["fused_block_tanh"] += tanh_last

    encode(qtv, batch, l_full, 1)
    encode(mmt, batch, l_mmt, 0)
    fused = (opts.fused_decode and opts.kv_cache_int8 and not opts.w8a8
             and batch <= opts.fused_decode_max_batch)
    if fused:
        out["fused_decode_step"] += dec_len
        out["fused_epilogue"] += 0 if opts.compact_serving else dec_len
    elif opts.kv_cache_int8:
        out["decode_attention_int8"] += mmt.num_hidden_layers * dec_len
    elif l_mmt >= MIN_KV:
        out["decode_attention"] += mmt.num_hidden_layers * dec_len
    if full_eval and opts.compact_serving:
        encode(mmt, batch, l_full, 0)
        encode(mmt, batch, l_compact, 0)
    elif full_eval:
        encode(mmt, 2 * batch, l_full, 0)
    return out


def expected_train_launches(cfg, opts) -> dict:
    """Kernel launches in one training step: per flash-route layer (QTV,
    and MMT in each of the ref / pos / neg passes) the flash forward and
    backward; per layer (text BERT too) the block forward, once more in the
    backward with remat "attn", and the block backward; no eval kernel."""
    n_text = cfg["text_bert"]["num_hidden_layers"]
    n_qtv = cfg["translayers"]["num_hidden_layers"]
    n_mmt = cfg["mmt"]["num_hidden_layers"]
    flash = n_qtv + 3 * n_mmt
    blocks = n_text + n_qtv + 3 * n_mmt
    out = {name: 0 for name in REPLACES}
    out.update(flash_attention_merged=flash, flash_attention_merged_bwd=flash,
               block_train_fwd=blocks * (2 if opts.remat == "attn" else 1),
               block_train_bwd=blocks)
    return out


def expected_sp_launches(cfg, batch: int, opts, sp: int = SP_RANKS, full_eval: bool = False,
                         train: bool = False, text_len: int = 20, dec_len: int = DEC_LEN) -> dict:
    """Kernel launches per rank of one forward (expected_launches) or one
    training step (expected_train_launches) under sequence parallelism over
    ``sp`` ranks: the split-head flash #10 (and in training its backward
    #10b) in #1's (and #1b's) place wherever the SP gate holds, the joint
    sequence divisible by the ranks and, in training, the stack's attention
    dropout 0; every other kernel as without SP, on all rows (activations
    are replicated)."""
    from vitxtgqa_tpu_torch.models.common import TransformerConfig

    l_full, l_compact = joint_lengths(cfg, text_len, dec_len)
    if train:
        out = expected_train_launches(cfg, opts)
        for sect, passes in (("translayers", 1), ("mmt", 3)):
            tc = TransformerConfig.from_config(cfg[sect])
            if tc.attention_probs_dropout_prob == 0.0 and l_full % sp == 0:
                n = passes * tc.num_hidden_layers
                for merged, split in (("flash_attention_merged", "flash_attention"),
                                      ("flash_attention_merged_bwd", "flash_attention_bwd")):
                    out[merged] -= n
                    out[split] += n
        return out
    if l_full % sp or l_compact % sp:
        raise ValueError(f"joint sequences {l_full} / {l_compact} over {sp} ranks")
    out = expected_launches(cfg, batch, opts, full_eval, text_len, dec_len)
    out["flash_attention"], out["flash_attention_merged"] = out["flash_attention_merged"], 0
    return out


def expected_vit_launches(cfg, batch: int) -> dict:
    """Kernel launches in one ViT forward over ``batch`` frames, derived
    from the port's gates: in every layer the fused FFN where the rows
    (frames x tokens) reach its gate, the bias-tensor attention where the
    tokens reach MIN_KV; no other kernel."""
    from vitxtgqa_tpu_torch.ops.attention import MIN_KV
    from vitxtgqa_tpu_torch.ops.ffn import ffn_kernel_ok

    tokens = cfg.num_patches + 1
    out = {name: 0 for name in REPLACES}
    if ffn_kernel_ok(cfg.hidden_size, cfg.mlp_dim, batch * tokens):
        out["fused_ffn"] = cfg.num_layers
    if tokens >= MIN_KV:
        out["fused_attention"] = cfg.num_layers
    return out


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def worst_of(rel: dict):
    """The key of the largest value of ``rel``, a NaN counting as the largest."""
    return max(rel, key=lambda k: math.inf if math.isnan(rel[k]) else rel[k])


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


def decode_step_cache(x_t, stacks, mask, step, gen, num_heads=12, write_offset=WRITE_OFFSET):
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
    pos = write_offset + step
    slot = torch.arange(l, device=dev)
    allowed = (mask > 0) | ((slot >= write_offset) & (slot < pos))[None, :]
    target = torch.full((b, l), BACKGROUND, device=dev)
    target[~allowed] = TRAP
    for row in range(b):
        enc = allowed[row, :write_offset].nonzero()[:, 0]
        target[row, enc[0]], target[row, enc[len(enc) // 2]] = PLANTED[:2]
        if step:
            target[row, pos - 1] = PLANTED[2]
    kv8 = torch.randint(-127, 128, (n_layers, b, l, 2 * d), generator=gen, device=dev,
                        dtype=torch.int8)
    kvs = torch.full((n_layers, b, 2, l), 0.02, device=dev)
    for li in range(n_layers):
        x_l = x_t if li == 0 else DS.fused_decode_step_plain(
            x_t, {k: v[:li] for k, v in stacks.items()}, kv8[:li], kvs[:li], mask, step,
            write_offset, num_heads)[0]
        q = (x_l[:, 0].float() @ stacks["wq"][li].float().t()
             + stacks["bq"][li].float()).reshape(b, num_heads, hd)
        unit = q / q.abs().amax(-1, keepdim=True)
        gain = (unit * q).sum(-1) / hd ** 0.5     # [B, H]: score of `unit` at scale 1
        g_min = gain.amin(-1, keepdim=True)
        key = torch.round(127 * (g_min / gain)[..., None] * unit).reshape(b, 1, d)
        kv8[li, :, :, :d] = torch.where(target[..., None] < 0, -key, key).to(torch.int8)
        kvs[li, :, 0] = target.abs() / (127 * g_min)
    return kv8, kvs


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound_of(n_bytes: float, flops: float, peak: float = PEAK_FLOPS):
    """(least ms the card could take, what bounds it): the bytes the
    function must move over HBM bandwidth, or its operations over the peak
    of their type (default: the bf16 tensor cores), whichever is larger."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attn_pairs(key_mask, dec_len: int, off: int = 0, rows=None) -> int:
    """Allowed (query row, key) pairs of one head, summed over the batch,
    for the ``rows`` query rows from global row ``off`` (default: all):
    the keys a flash call must visit (a masked key tile can be skipped;
    the dropout's zeros are elementwise on a dense product and count)."""
    from vitxtgqa_tpu_torch.ops import flash_attention as FA

    l = key_mask.shape[1]
    rows = l if rows is None else rows
    allowed = FA._allowed(key_mask, l, dec_len, off, rows)
    return int(allowed.sum().item()) * (rows if allowed.shape[2] == 1 else 1)


def flash_bound(q, key_mask, dec_len: int, lse: bool = False):
    """q, k, v read, out (and the lse) written; 2 products of 2*HD per
    allowed pair."""
    b, l, hd = q.shape
    return bound_of(4 * nbytes(q) + nbytes(key_mask) + (b * 12 * l * 4 if lse else 0),
                    4 * hd * attn_pairs(key_mask, dec_len))


def flash_bwd_bound(q, key_mask, dec_len: int):
    """q, k, v, out, dO and the lse read, dq, dk, dv written; 5 products
    (S, dP, dV, dQ, dK) of 2*HD per allowed pair."""
    b, l, hd = q.shape
    return bound_of(8 * nbytes(q) + nbytes(key_mask) + b * 12 * l * 4,
                    10 * hd * attn_pairs(key_mask, dec_len))


def block_bound(rows: int, d: int, m: int, n_in: int, n_out: int, weight_bytes: int,
                vec_bytes: int, backward: bool = False, peak: float = PEAK_FLOPS):
    """A post-attention block over ``rows``: n_in / n_out activations of
    width d or m read / written (bytes given), the weights, 2*rows*(d^2 +
    2dm) operations forward and twice that backward, at ``peak``."""
    flops = 2 * rows * (d * d + 2 * d * m) * (2 if backward else 1)
    return bound_of(n_in + n_out + weight_bytes + vec_bytes, flops, peak)


def decode_keys(key_mask, step: int) -> int:
    """Cache slots one decode step must read, summed over the batch: the
    valid encoder keys and the decoder slots up to this step."""
    return int((key_mask > 0).sum().item()) + key_mask.shape[0] * (step + 1)


def decode_bound(q, key_mask, step: int, elem_bytes: int, scale_bytes: int):
    keys, hd = decode_keys(key_mask, step), q.shape[-1]
    return bound_of(2 * nbytes(q) + nbytes(key_mask) + keys * (2 * hd * elem_bytes + scale_bytes),
                    4 * hd * keys)


def sdpa_split(x, h: int):
    b, l, hd = x.shape
    return x.view(b, l, h, hd // h).transpose(1, 2)


def sdpa_mask(key_mask, dec_len: int):
    from vitxtgqa_tpu_torch.ops import flash_attention as FA

    return FA._allowed(key_mask, key_mask.shape[1], dec_len)


def edge_masks(key_mask, dec_len: int, tile: int = 64):
    """The key masks that the flash forward's tile walk can get wrong
    (csrc/flash_fwd.cuh), each a (label, [B, L] mask) from ``key_mask``
    with its last dec_len keys cleared: batch row 3 with no valid key (its
    encoder rows average V over every key and the block walks every tile),
    and every row's valid keys in one key tile, keys [2 * tile, 3 * tile),
    all valid (the other encoder tiles are skipped; a full tile keeps the
    averages of O(1) values, so the tolerance's bf16 ulps hold)."""
    l = key_mask.shape[1]
    none = key_mask.clone()
    none[3] = 0.0
    one = key_mask.new_zeros(key_mask.shape)
    one[:, 2 * tile:3 * tile] = 1.0
    out = []
    for label, km in (("batch row 3 with no valid key", none),
                      (f"valid keys in one {tile}-key tile", one)):
        if dec_len:
            km[:, l - dec_len:] = 0.0
        out.append((label, km.contiguous()))
    return out


def decode_sdpa_mask(key_mask, step: int):
    import torch

    slot = torch.arange(key_mask.shape[1], device=key_mask.device)
    dec = (slot >= WRITE_OFFSET) & (slot <= WRITE_OFFSET + step)
    return ((key_mask > 0) | dec[None, :])[:, None, None, :]


def keep_times(record, name, extra, ms, plain_ms, bound, library_ms=None):
    """Print the times of one call at the main path's shape and keep them
    as the kernel's record, with the bound of the same call."""
    rec = record.setdefault(name, {"max_abs_err": 0.0, "max_rel_err": None})
    rec.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound[0],
               bound_by=bound[1])
    lib = "null" if library_ms is None else f"{library_ms:.4f} ms"
    print(f"kernel {name}{extra}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib}, "
          f"bound {bound[0]:.4f} ms ({bound[1]})", flush=True)


def report(record, name, err, extra="", scale=None, **timed):
    """Print one check against its tolerance and keep its error; the
    gradient kernels are held scale-relative (err / scale).  ``timed``
    (keep_times' arguments): the call's times are the kernel's record."""
    tol = TOL[name]
    rec = record.setdefault(name, {"max_abs_err": 0.0, "max_rel_err": None})
    crit = err if scale is None else err / scale
    ok = crit <= tol  # False for a NaN error
    rec["max_abs_err"] = max(rec["max_abs_err"], err) if ok else err
    if scale is not None:
        rec["max_rel_err"] = max(rec["max_rel_err"] or 0.0, crit) if ok else crit
    what = "max|diff|/max|plain|" if scale is not None else "max|diff|"
    print(f"kernel {name}{extra}: {what} {crit:.3e} (tol {tol:.0e}) {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        fail(f"{name}{extra} disagrees with its plain version")
    if timed:
        keep_times(record, name, extra, **timed)


def check_decode_step(record, x_all, stacks, mask, gen, batches, write_offset: int,
                      keep: bool):
    """The decode step over 3 MMT layers at each batch, steps 0 and 11, its
    attention planted (decode_step_cache) over the cache length of
    ``mask``: y against the tolerance, the quantized rows within one int8
    step and 1% of the scale; the times at step 11, the batch-1 ones kept
    as the kernel's record when ``keep``."""
    import torch

    from vitxtgqa_tpu_torch.ops import decode_step as DS

    dev, h, lp = mask.device, 12, mask.shape[1]
    m, d = stacks["w1"].shape[1:]
    for step in (0, 11):
        kv8_all, kvs_all = decode_step_cache(x_all, stacks, mask, step, gen, h, write_offset)
        for b in batches:
            kv8, kvs = kv8_all[:, :b].contiguous(), kvs_all[:, :b].contiguous()
            x_t, km = x_all[:b].contiguous(), mask[:b].contiguous()
            buffers = DS.step_buffers(3, b, d, m, dev)
            sargs = (x_t, stacks, kv8, kvs, km, step, write_offset, h)
            got = DS.fused_decode_step(*sargs, buffers=buffers)
            want = DS.fused_decode_step_plain(*sargs)
            torch.cuda.synchronize()
            err = (got[0].float() - want[0].float()).abs().max().item()
            d8 = (got[1].int() - want[1].int()).abs().max().item()
            dsc = ((got[2] - want[2]).abs() / want[2].abs()).max().item()
            shape = f"[{b},1,768] x 3 layers, kv8 [3,{b},{lp},1536] step={step}"
            print(f"kernel fused_decode_step {shape}: row8 max|diff| {d8} (tol {ROW8_TOL}), "
                  f"rowsc max rel diff {dsc:.3e} (tol {ROWSC_REL_TOL})", flush=True)
            if not (d8 <= ROW8_TOL and dsc <= ROWSC_REL_TOL):
                fail(f"fused_decode_step quantized rows disagree at {shape}")
            timed = {}
            if step == 11:
                ms = cuda_time_ms(lambda: DS.fused_decode_step(*sargs, buffers=buffers))
                pms = cuda_time_ms(lambda: DS.fused_decode_step_plain(*sargs))
                keys = 3 * (decode_keys(km, step) - b)
                flops = 3 * 2 * b * (4 * d * d + 2 * d * m) + 4 * d * keys
                moved = nbytes(*stacks.values()) + nbytes(x_t, km, *got) + keys * (2 * d + 8)
                bound = bound_of(moved, flops)
                print(f"kernel fused_decode_step {shape}: kernel {ms:.4f} ms, plain {pms:.4f} ms, "
                      f"bound {bound[0]:.4f} ms ({bound[1]})", flush=True)
                if b == 1 and keep:  # the record's shape: the fused branch's batch-1 step
                    timed = dict(ms=ms, plain_ms=pms, bound=bound)
            report(record, "fused_decode_step", err, extra=" " + shape, **timed)


def check_kernels(dev, record):
    import torch
    import torch.nn.functional as F

    from vitxtgqa_tpu_torch.ops import decode_attention as DA
    from vitxtgqa_tpu_torch.ops import decode_step as DS
    from vitxtgqa_tpu_torch.ops import flash_attention as FA
    from vitxtgqa_tpu_torch.ops import fused_block as FB
    from vitxtgqa_tpu_torch.ops.attention import dequantize_kv, quantize_kv

    gen = torch.Generator(device=dev).manual_seed(1234)
    bf = torch.bfloat16
    rn = lambda *s, scale=1.0: (torch.randn(*s, generator=gen, device=dev) * scale).to(bf)
    h, l, d, m = 12, L_JOINT, 768, 3072
    mask, ocr_mask = serving_masks(dev)

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
        timed = {}
        if dec_len == 0:
            qh, kh, vh, am = (sdpa_split(q, h), sdpa_split(k, h), sdpa_split(v, h),
                              sdpa_mask(km, 0))
            timed = dict(
                ms=cuda_time_ms(lambda: FA.flash_attention_merged(q, k, v, km, dec_len, h)),
                plain_ms=cuda_time_ms(lambda: FA.flash_attention_merged_plain(q, k, v, km, dec_len, h)),
                library_ms=cuda_time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, am)),
                bound=flash_bound(q, km, 0))
        report(record, "flash_attention_merged", err, extra=f" [8,1152,768] dec_len={dec_len}",
               **timed)
    # the forward body's edge cases (edge_masks), every query row
    for dec_len in (0, 12):
        for label, km in edge_masks(mask, dec_len):
            got = FA.flash_attention_merged(q, k, v, km, dec_len, h)
            want = FA.flash_attention_merged_plain(q, k, v, km, dec_len, h)
            torch.cuda.synchronize()
            report(record, "flash_attention_merged", (got.float() - want.float()).abs().max().item(),
                   extra=f" [8,1152,768] dec_len={dec_len}, {label}")

    # 2. fused block and its tanh form, rows 9216, 768 -> 3072
    x_q, ctx, res = rn(BATCH, l, d), rn(BATCH, l, d, scale=0.5), rn(BATCH, l, d)
    wo, w1, w2 = rn(d, d, scale=0.02), rn(m, d, scale=0.02), rn(d, m, scale=0.02)
    vec = lambda n, base=0.0: (base + torch.randn(n, generator=gen, device=dev) * 0.05).float()
    pv = (wo, vec(d), vec(d, 1.0), vec(d), w1, vec(m), w2, vec(d), vec(d, 1.0), vec(d))
    args = (x_q, ctx) + pv
    rows = BATCH * l
    for name, fn, plain, a, n_in in (
        ("fused_block", FB.fused_block, FB.fused_block_plain, args, nbytes(x_q, ctx)),
        ("fused_block_tanh", FB.fused_block_tanh, FB.fused_block_tanh_plain, (res,) + args,
         nbytes(x_q, ctx, res)),
    ):
        got, want = fn(*a), plain(*a)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        report(record, name, err, " [9216,768]->3072", ms=cuda_time_ms(lambda: fn(*a)),
               plain_ms=cuda_time_ms(lambda: plain(*a)),
               bound=block_bound(rows, d, m, n_in, nbytes(got), nbytes(wo, w1, w2),
                                 nbytes(*pv[1:4], pv[5], *pv[7:])))

    # 3. int8 decode attention at steps 0 and 11, write_offset 1140
    qd = rn(BATCH, 1, d)
    (k8, ks), (v8, vs) = quantize_kv(rn(BATCH, l, d)), quantize_kv(rn(BATCH, l, d))
    kdq, vdq = dequantize_kv(k8, ks, bf), dequantize_kv(v8, vs, bf)
    for step in (0, 11):
        dargs = (qd, k8, ks, v8, vs, mask, step, WRITE_OFFSET, h)
        got, want = DA.decode_attention_int8(*dargs), DA.decode_attention_int8_plain(*dargs)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        timed = {}
        if step == 11:
            am = decode_sdpa_mask(mask, step)
            qh, kh, vh = sdpa_split(qd, h), sdpa_split(kdq, h), sdpa_split(vdq, h)
            timed = dict(ms=cuda_time_ms(lambda: DA.decode_attention_int8(*dargs)),
                         plain_ms=cuda_time_ms(lambda: DA.decode_attention_int8_plain(*dargs)),
                         library_ms=cuda_time_ms(
                             lambda: F.scaled_dot_product_attention(qh, kh, vh, am)),
                         bound=decode_bound(qd, mask, step, 1, 8))
        report(record, "decode_attention_int8", err,
               extra=f" [8,1,768] x [8,1152,768] step={step}", **timed)

    # 4. bf16 decode attention, same steps
    kb, vb = rn(BATCH, l, d), rn(BATCH, l, d)
    for step in (0, 11):
        dargs = (qd, kb, vb, mask, step, WRITE_OFFSET, h)
        got, want = DA.decode_attention(*dargs), DA.decode_attention_plain(*dargs)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        timed = {}
        if step == 11:
            am = decode_sdpa_mask(mask, step)
            qh, kh, vh = sdpa_split(qd, h), sdpa_split(kb, h), sdpa_split(vb, h)
            timed = dict(ms=cuda_time_ms(lambda: DA.decode_attention(*dargs)),
                         plain_ms=cuda_time_ms(lambda: DA.decode_attention_plain(*dargs)),
                         library_ms=cuda_time_ms(
                             lambda: F.scaled_dot_product_attention(qh, kh, vh, am)),
                         bound=decode_bound(qd, mask, step, 2, 0))
        report(record, "decode_attention", err,
               extra=f" [8,1,768] x bf16 [8,1152,768] step={step}", **timed)

    # 5. the single-kernel decode step over 3 MMT layers, batch 1 / 2 / 8,
    # its attention planted (decode_step_cache)
    x_all, stacks = decode_step_weights(dev, gen)
    check_decode_step(record, x_all, stacks, mask, gen, (1, 2, BATCH), WRITE_OFFSET, True)

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
        if not bool(tok_ok.all()) or not emb_err <= TOL["fused_epilogue"]:
            fail(f"fused_epilogue token or embedding disagrees at batch {b}")
        ms = cuda_time_ms(lambda: DS.fused_epilogue(*eargs))
        pms = cuda_time_ms(lambda: DS.fused_epilogue_plain(*eargs))
        timed = {}
        if b == 1:  # the record's shape: the fused branch's batch-1 step
            moved = (nbytes(eargs[0], cls_b[:v_fix], ptr_w, ptr_b, eargs[5], eargs[6], *got)
                     + v_fix * d * 4 + b * d * (2 + 2 + 4))  # classifier; gathered rows
            timed = dict(ms=ms, plain_ms=pms,
                         bound=bound_of(moved, 2 * b * d * (v_fix + d + n_ocr)))
        else:
            print(f"kernel fused_epilogue [{b}]: kernel {ms:.4f} ms, plain {pms:.4f} ms",
                  flush=True)
        report(record, "fused_epilogue", err, extra=f" [{b},1,768] -> [{b},1,{v_p + n_ocr}]",
               **timed)
    del q, k, v, x_q, ctx, res, kdq, vdq
    torch.cuda.empty_cache()


def compact_mask(dev):
    """An encoder key mask at the compact geometry [BATCH, 384]: the
    serving batch's question, 5 frames and 320 of its OCR slots, then the
    padding and decoder slots."""
    import torch
    import torch.nn.functional as F

    mask, ocr = serving_masks(dev)
    enc = torch.cat([mask[:, :25], ocr[:, :320]], dim=1)
    return F.pad(enc, (0, L_COMPACT - enc.shape[1])).contiguous()


def check_serving_mode_kernels(dev, record):
    """The serving modes' kernels against their twins: the W8A8 block (#8),
    the int8-emitting flash (#11), the int8 pointer scores (#12), then the
    decode attention (#4) and decode step (#5) at the compact cache
    length."""
    import torch

    from vitxtgqa_tpu_torch.ops import decode_attention as DA
    from vitxtgqa_tpu_torch.ops import flash_attention as FA
    from vitxtgqa_tpu_torch.ops import fused_block as FB
    from vitxtgqa_tpu_torch.ops import ptr_scores as PS
    from vitxtgqa_tpu_torch.ops.attention import quantize_kv

    gen = torch.Generator(device=dev).manual_seed(2468)
    bf = torch.bfloat16
    rn = lambda *s, scale=1.0: (torch.randn(*s, generator=gen, device=dev) * scale).to(bf)
    h, l, d, m = 12, L_JOINT, 768, 3072
    mask, ocr_mask = serving_masks(dev)

    # 12. the W8A8 block at 9,216 rows (a batch-8 encode) and 3,072 (the
    # compact MMT at batch 8), its weights quantized once; the bf16 block
    # timed on the same inputs
    wo, w1, w2 = rn(d, d, scale=0.02), rn(m, d, scale=0.02), rn(d, m, scale=0.02)
    wq = FB.quantize_block_weights(wo, w1, w2)
    vec = lambda n, base=0.0: (base + torch.randn(n, generator=gen, device=dev) * 0.05).float()
    bo, s1, g1, b1, b2, s2, g2 = vec(d), vec(d, 1.0), vec(d), vec(m), vec(d), vec(d, 1.0), vec(d)
    for rows in (BATCH * L_JOINT, BATCH * L_COMPACT):
        x_q, ctx = rn(rows, d), rn(rows, d, scale=0.5)
        args = (x_q, ctx, wq[0], wq[1], bo, s1, g1, wq[2], wq[3], b1, wq[4], wq[5], b2, s2, g2)
        got, c8, cs = FB.fused_block_w8a8(*args, return_ctx_q=True)
        want = FB.fused_block_w8a8_plain(*args)
        want8, want_s = FB.quant_rows(ctx)
        torch.cuda.synchronize()
        ctx_exact = bool(torch.equal(c8, want8) and torch.equal(cs, want_s[:, 0]))
        print(f"kernel fused_block_w8a8 [{rows},768]: quantized ctx rows and scales equal to "
              f"quant_rows: {ctx_exact}", flush=True)
        if not ctx_exact:
            fail(f"fused_block_w8a8 quantizes ctx otherwise than quant_rows at {rows} rows")
        err = (got.float() - want.float()).abs().max().item()
        ms = cuda_time_ms(lambda: FB.fused_block_w8a8(*args))
        pms = cuda_time_ms(lambda: FB.fused_block_w8a8_plain(*args), reps=3, warmup=1)
        bf_ms = cuda_time_ms(lambda: FB.fused_block(x_q, ctx, wo, bo, s1, g1, w1, b1, w2, b2,
                                                     s2, g2))
        bound = block_bound(rows, d, m, nbytes(x_q, ctx), nbytes(got), nbytes(*wq[::2]),
                            nbytes(*wq[1::2], bo, s1, g1, b1, b2, s2, g2), peak=PEAK_INT8_OPS)
        print(f"kernel fused_block_w8a8 [{rows},768]: the bf16 block (#2) on the same inputs "
              f"{bf_ms:.4f} ms", flush=True)
        timed = dict(ms=ms, plain_ms=pms, bound=bound) if rows == BATCH * L_JOINT else {}
        if not timed:
            print(f"kernel fused_block_w8a8 [{rows},768]: kernel {ms:.4f} ms, plain {pms:.4f} ms, "
                  f"bound {bound[0]:.4f} ms ({bound[1]})", flush=True)
        report(record, "fused_block_w8a8", err, f" [{rows},768]->3072", **timed)
        del x_q, ctx, got, want, c8, want8

    # 13. flash with the int8 cache emission at [8, 1152, 768], dec_len 12:
    # the output as the plain forward's and bit for bit #1's on the same
    # inputs, the cache bit for bit quantize_kv's; #1 and #1 + the separate
    # quantize pass timed beside it
    q, k, v = (rn(BATCH, l, d) for _ in range(3))
    km = mask.clone()
    km[:, l - DEC_LEN:] = 0.0
    out, (k8, ks), (v8, vs) = FA.flash_attention_merged_q8(q, k, v, km, DEC_LEN, h)
    want = FA.flash_attention_merged_plain(q, k, v, km, DEC_LEN, h)
    out1 = FA.flash_attention_merged(q, k, v, km, DEC_LEN, h)
    (wk8, wks), (wv8, wvs) = quantize_kv(k), quantize_kv(v)
    torch.cuda.synchronize()
    rows = km > 0
    rows[:, l - DEC_LEN:] = True
    err = (out.float() - want.float()).abs()[rows].max().item()
    cache_exact = all(torch.equal(a, b) for a, b in ((k8, wk8), (ks, wks), (v8, wv8), (vs, wvs)))
    same_as_1 = bool(torch.equal(out, out1))
    print(f"kernel flash_attention_merged_q8 [8,1152,768] dec_len=12: int8 cache and scales equal "
          f"to quantize_kv: {cache_exact}; output equal to #1's: {same_as_1}", flush=True)
    if not cache_exact or not same_as_1:
        fail("flash_attention_merged_q8's cache or output")
    fa_args = (q, k, v, km, DEC_LEN, h)
    ms1 = cuda_time_ms(lambda: FA.flash_attention_merged(*fa_args))
    ms_sep = cuda_time_ms(lambda: (FA.flash_attention_merged(*fa_args), quantize_kv(k),
                                   quantize_kv(v)))
    ms = cuda_time_ms(lambda: FA.flash_attention_merged_q8(*fa_args))
    print(f"kernel flash_attention_merged_q8 [8,1152,768]: #1 on the same inputs {ms1:.4f} ms, "
          f"#1 + two quantize_kv {ms_sep:.4f} ms", flush=True)
    report(record, "flash_attention_merged_q8", err, " [8,1152,768] dec_len=12", ms=ms,
           plain_ms=cuda_time_ms(lambda: FA.flash_attention_merged_q8_plain(*fa_args)),
           bound=bound_of(4 * nbytes(q) + nbytes(km, k8, ks, v8, vs),
                          4 * d * attn_pairs(km, DEC_LEN)))
    details = {"q8_flash_ms": ms, "flash_ms_same_inputs": ms1, "flash_plus_quantize_ms": ms_sep}
    del q, k, v, out, out1, want, k8, v8, wk8, wv8

    # 14. the int8 pointer scores at [8, 1, 768] x [8, 960, 768]
    qp = torch.randn(BATCH, 1, d, generator=gen, device=dev) * 0.5
    k8p, ksp = quantize_kv(rn(BATCH, 960, d))
    got = PS.ptr_scores_int8(qp, k8p, ksp, ocr_mask)
    want = PS.ptr_scores_int8_plain(qp, k8p, ksp, ocr_mask)
    torch.cuda.synchronize()
    report(record, "ptr_scores_int8", (got - want).abs().max().item(),
           " [8,1,768] x [8,960,768]", ms=cuda_time_ms(lambda: PS.ptr_scores_int8(
               qp, k8p, ksp, ocr_mask)),
           plain_ms=cuda_time_ms(lambda: PS.ptr_scores_int8_plain(qp, k8p, ksp, ocr_mask)),
           bound=bound_of(nbytes(qp, k8p, ksp, ocr_mask, got), 2 * k8p.numel(), PEAK_F32_FLOPS))

    # 15. #4 and #5 at the compact cache length 384 (write offset 372)
    cmask = compact_mask(dev)
    qd = rn(BATCH, 1, d)
    (k8, ks), (v8, vs) = quantize_kv(rn(BATCH, L_COMPACT, d)), quantize_kv(rn(BATCH, L_COMPACT, d))
    for step in (0, 11):
        dargs = (qd, k8, ks, v8, vs, cmask, step, COMPACT_OFFSET, h)
        got, want = DA.decode_attention_int8(*dargs), DA.decode_attention_int8_plain(*dargs)
        torch.cuda.synchronize()
        report(record, "decode_attention_int8", (got.float() - want.float()).abs().max().item(),
               extra=f" [8,1,768] x [8,384,768] step={step}")
    bound = decode_bound(qd, cmask, 11, 1, 8)
    print(f"kernel decode_attention_int8 [8,1,768] x [8,384,768] step=11: kernel "
          f"{cuda_time_ms(lambda: DA.decode_attention_int8(*dargs)):.4f} ms, plain "
          f"{cuda_time_ms(lambda: DA.decode_attention_int8_plain(*dargs)):.4f} ms, bound "
          f"{bound[0]:.4f} ms ({bound[1]})", flush=True)
    x_all, stacks = decode_step_weights(dev, gen)
    check_decode_step(record, x_all, stacks, cmask, gen, (1, 2), COMPACT_OFFSET, False)
    del x_all, stacks, k8, v8
    torch.cuda.empty_cache()
    return details


def check_vit_kernels(dev, record):
    """The ViT path's kernels against their twins: the fused FFN (#13) at
    ViT-L/16's chunk of 64 frames (12,608 rows, 1024 -> 4096 -> 1024) and
    ViT-B/32's (3,200 rows, 768 -> 3072 -> 768); the bias-tensor attention
    (#14) on split-head views of merged projections, with no bias at
    [8, 16, 577, 64] (ViT-L/16 at 384 px) and a random per-row bias there
    (the ragged last key tile and the bias tile of the ring meet), the
    key-mask bias at [8, 12,
    1152, 64] (the serving batch's mask) and the prefix-LM bias there
    (dec_len 12, one batch row with no valid key: fully masked rows), each
    timed beside F.scaled_dot_product_attention with the same additive
    mask.  The records keep the shapes of the ViT's own calls (12,608 rows;
    577 tokens, no bias); the other times go to the details."""
    import torch
    import torch.nn.functional as F

    from vitxtgqa_tpu_torch.ops import ffn as FFN
    from vitxtgqa_tpu_torch.ops import fused_attention as FAT
    from vitxtgqa_tpu_torch.ops.masks import prefix_lm_bias, self_attention_bias

    gen = torch.Generator(device=dev).manual_seed(97531)
    bf = torch.bfloat16
    rn = lambda *s, scale=1.0: (torch.randn(*s, generator=gen, device=dev) * scale).to(bf)
    vec = lambda n: (torch.randn(n, generator=gen, device=dev) * 0.05).float()
    details = {}

    # 16. the fused FFN
    for rows, d, m, label in ((64 * 197, 1024, 4096, "ViT-L/16"), (64 * 50, 768, 3072, "ViT-B/32")):
        x, w1, b1, w2, b2 = rn(rows, d), rn(m, d, scale=0.02), vec(m), rn(d, m, scale=0.02), vec(d)
        args = (x, w1, b1, w2, b2)
        got, want = FFN.fused_ffn(*args), FFN.fused_ffn_plain(*args)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ms = cuda_time_ms(lambda: FFN.fused_ffn(*args))
        pms = cuda_time_ms(lambda: FFN.fused_ffn_plain(*args))
        bound = bound_of(nbytes(x, w1, b1, w2, b2, got), 2 * rows * m * (d + d))
        shape = f" {label} [{rows},{d}]->{m}"
        details[f"fused_ffn{shape}"] = {"ms": ms, "plain_ms": pms, "bound_ms": bound[0],
                                        "max_abs_err": err}
        timed = dict(ms=ms, plain_ms=pms, bound=bound) if d == 1024 else {}
        if not timed:
            print(f"kernel fused_ffn{shape}: kernel {ms:.4f} ms, plain {pms:.4f} ms, bound "
                  f"{bound[0]:.4f} ms ({bound[1]})", flush=True)
        report(record, "fused_ffn", err, shape, **timed)
        del x, got, want

    # 17. the bias-tensor attention
    mask, _ = serving_masks(dev)
    enc = mask[:, :L_JOINT - DEC_LEN].clone()
    enc[3] = 0.0
    row_bias = torch.randn(BATCH, 1, 577, 577, generator=gen, device=dev) * 2.0
    forms = (("no bias", 16, 577, None),
             ("per-row bias", 16, 577, row_bias),
             ("key-mask bias", 12, L_JOINT, self_attention_bias(mask)),
             ("prefix-LM bias dec_len=12, batch row 3 fully masked", 12, L_JOINT,
              prefix_lm_bias(enc, DEC_LEN)))
    for form, h, l, bias in forms:
        q, k, v = (sdpa_split(rn(BATCH, l, h * 64), h) for _ in range(3))
        got, want = FAT.fused_attention(q, k, v, bias), FAT.fused_attention_plain(q, k, v, bias)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        am = None if bias is None else bias.to(bf)
        ms = cuda_time_ms(lambda: FAT.fused_attention(q, k, v, bias))
        pms = cuda_time_ms(lambda: FAT.fused_attention_plain(q, k, v, bias))
        lib = cuda_time_ms(lambda: F.scaled_dot_product_attention(q, k, v, am))
        bound = bound_of(4 * nbytes(q) + nbytes(bias), 4 * BATCH * h * l * l * 64)
        shape = f" [{BATCH},{h},{l},64] {form}"
        details[f"fused_attention{shape}"] = {"ms": ms, "plain_ms": pms, "library_ms": lib,
                                              "bound_ms": bound[0], "max_abs_err": err}
        timed = dict(ms=ms, plain_ms=pms, library_ms=lib, bound=bound) if bias is None else {}
        if not timed:
            print(f"kernel fused_attention{shape}: kernel {ms:.4f} ms, plain {pms:.4f} ms, "
                  f"library {lib:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]})", flush=True)
        report(record, "fused_attention", err, shape, **timed)
        del q, k, v, got, want
    torch.cuda.empty_cache()
    return details


def check_training_kernels(dev, record):
    """The training kernels at L 1152, 12 heads, batch TRAIN_CHECK_BATCH
    against their twins with the same seed-regenerated masks, the keep
    rate and stream equality of the in-kernel dropout, then the times at
    the training step's own shapes (batch TRAIN_BATCH)."""
    import torch
    import torch.nn.functional as F

    from vitxtgqa_tpu_torch.ops import block_train as BT
    from vitxtgqa_tpu_torch.ops import dropout as D
    from vitxtgqa_tpu_torch.ops import flash_attention as FA

    gen = torch.Generator(device=dev).manual_seed(4321)
    bf = torch.bfloat16
    rn = lambda *s, scale=1.0: (torch.randn(*s, generator=gen, device=dev) * scale).to(bf)
    h, l, d, m, b = 12, L_JOINT, 768, 3072, TRAIN_CHECK_BATCH
    serving_mask, _ = serving_masks(dev)
    seed = torch.tensor([20261016], dtype=torch.int64, device=dev)
    details = {}

    def mask_for(batch, dec_len):
        km = serving_mask[torch.arange(batch, device=dev) % BATCH].clone()
        if dec_len:
            km[:, l - dec_len:] = 0.0
        return km.contiguous()

    # 7. flash forward with dropout 0.1 and its lse, dec_len 0 (QTV) and 12
    # (MMT), against the twin on the same Philox mask
    q, k, v, g = (rn(b, l, d) for _ in range(4))
    for dec_len in (0, 12):
        km = mask_for(b, dec_len)
        got, lse = FA.flash_attention_merged(q, k, v, km, dec_len, h, RATE, seed, return_lse=True)
        want, want_lse = FA.flash_attention_merged_plain(q, k, v, km, dec_len, h, RATE, seed,
                                                         return_lse=True)
        torch.cuda.synchronize()
        rows = km > 0
        if dec_len:
            rows[:, l - dec_len:] = True
        err = (got.float() - want.float()).abs()[rows].max().item()
        lse_err = (lse - want_lse).abs()[rows[:, None, :].expand_as(lse)].max().item()
        report(record, "flash_attention_merged", err,
               extra=f" dropout {RATE} [{b},1152,768] dec_len={dec_len}; lse max|diff| "
                     f"{lse_err:.3e} (tol {LSE_TOL:.0e})")
        if not lse_err <= LSE_TOL:
            fail(f"flash_attention_merged lse disagrees at dec_len {dec_len}")
        # the dropout form on the forward body's edge cases, every row
        for label, km in edge_masks(mask_for(b, dec_len), dec_len):
            got, lse = FA.flash_attention_merged(q, k, v, km, dec_len, h, RATE, seed,
                                                 return_lse=True)
            want, want_lse = FA.flash_attention_merged_plain(q, k, v, km, dec_len, h, RATE, seed,
                                                             return_lse=True)
            torch.cuda.synchronize()
            lse_err = (lse - want_lse).abs().max().item()
            report(record, "flash_attention_merged", (got.float() - want.float()).abs().max().item(),
                   extra=f" dropout {RATE} [{b},1152,768] dec_len={dec_len}, {label}; lse "
                         f"max|diff| {lse_err:.3e} (tol {LSE_TOL:.0e})")
            if not lse_err <= LSE_TOL:
                fail(f"flash_attention_merged lse disagrees at dec_len {dec_len}, {label}")

    # 8. flash backward at rate 0 and 0.1, from the twin's out and lse, on
    # the serving mask and on a batch row with no valid key (edge_masks)
    for dec_len in (0, 12):
        none_label, none_km = edge_masks(mask_for(b, dec_len), dec_len)[0]
        for label, km in (("", mask_for(b, dec_len)), (", " + none_label, none_km)):
            for rate in (0.0, RATE):
                out, lse = FA.flash_attention_merged_plain(q, k, v, km, dec_len, h, rate, seed,
                                                           return_lse=True)
                got = FA.flash_attention_merged_bwd(q, k, v, km, out, lse, g, dec_len, h, rate,
                                                    seed)
                want = FA.flash_attention_merged_bwd_plain(q, k, v, km, out, lse, g, dec_len, h,
                                                           rate, seed)
                torch.cuda.synchronize()
                for name, a, w in zip(("dq", "dk", "dv"), got, want):
                    err = (a.float() - w.float()).abs().max().item()
                    report(record, "flash_attention_merged_bwd", err,
                           scale=w.float().abs().max().item(),
                           extra=f" {name} rate={rate} [{b},1152,768] dec_len={dec_len}{label}")

    # 9. the flash dropout on uniform attention (q = k = 0, every key
    # allowed): with v[key, head * 64 + c] = (key % 64 == c) the output
    # counts the kept keys of each (row, head, key class) exactly, over
    # B*H*L*L draws; with v[key, head * 64 + c] = (key == c) it shows the
    # forward's keep bit of every (row, key < 64), and the backward's dv
    # under dO[row, head * 64 + c] = (row == c) the backward's bit of every
    # (row < 64, key < 64): the two, and the twin's mask, must be equal.
    z = torch.zeros(b, l, d, dtype=bf, device=dev)
    ones = torch.ones(b, l, device=dev)
    key = torch.arange(l, device=dev)[:, None]
    col = torch.arange(d, device=dev)[None, :] % 64
    v_rate = (key % 64 == col).to(bf).expand(b, l, d).contiguous()
    counts = torch.round(FA.flash_attention_merged(z, z, v_rate, ones, 0, h, RATE, seed).float()
                         * l * (1 - RATE))
    draws = b * h * l * l
    keep_attn = counts.sum().item() / draws
    v_eq = (key == col).to(bf).expand(b, l, d).contiguous()
    out_eq, lse_eq = FA.flash_attention_merged(z, z, v_eq, ones, 0, h, RATE, seed, return_lse=True)
    d_o = (torch.arange(l, device=dev)[:, None] == col).to(bf).expand(b, l, d).contiguous()
    dv = FA.flash_attention_merged_bwd(z, z, v_eq, ones, out_eq, lse_eq, d_o, 0, h, RATE, seed)[2]
    fwd_keep = out_eq.view(b, l, h, 64)[:, :64] != 0                       # [b, row, h, key]
    bwd_keep = (dv.view(b, l, h, 64)[:, :64] != 0).permute(0, 3, 2, 1)     # [b, key, h, row]
    plain_keep = D.keep_mask(seed, D.STREAM_ATTN, (b, h, 64, 64), RATE).permute(0, 2, 1, 3)
    torch.cuda.synchronize()
    streams_equal = bool(torch.equal(fwd_keep, bwd_keep) and torch.equal(fwd_keep, plain_keep))
    print(f"dropout: flash keep share {keep_attn:.6f} over {draws} in-kernel draws (want "
          f"{1 - RATE} +- {KEEP_TOL}); forward / backward / twin keep bits equal on "
          f"{fwd_keep.numel()} entries: {streams_equal}", flush=True)
    if abs(keep_attn - (1 - RATE)) > KEEP_TOL or draws < MIN_DRAWS or not streams_equal:
        fail("the flash dropout's keep rate or its forward / backward streams")
    details["flash_keep_share"], details["flash_draws"] = keep_attn, draws

    # 10. the block forward (5 outputs, the emitted masks) and backward (12
    # gradients against autograd through block_train_plain), rows b * 1152
    rows = b * l
    vec = lambda n, base=0.0: base + torch.randn(n, generator=gen, device=dev) * 0.05
    x_q, ctx, gy = rn(rows, d), rn(rows, d), rn(rows, d)
    w32 = [torch.randn(*s, generator=gen, device=dev) * 0.02 for s in ((d, d), (m, d), (d, m))]
    vecs = [vec(d), vec(d, 1.0), vec(d), vec(m), vec(d), vec(d, 1.0), vec(d)]
    wo, w1, w2 = (w.to(bf) for w in w32)
    bo, s1, g1, b1, b2, s2, g2 = vecs
    wargs = (wo, bo, s1, g1, w1, b1, w2, b2, s2, g2)
    got = BT.block_train_fwd(x_q, ctx, *wargs, rate=RATE, seed=seed, emit_masks=True)
    ma, mf = BT.masks_from_seed(seed, rows, d, RATE, dev)
    twin = BT.block_train_fwd_plain(x_q, ctx, *wargs, mask_a=ma, mask_f=mf, rate=RATE)
    torch.cuda.synchronize()
    for name, a, w in zip(("y", "x1h", "pre1", "h", "x2h"), got, twin):
        report(record, "block_train_fwd", (a.float() - w.float()).abs().max().item(),
               extra=f" {name} rate={RATE} [{rows},768]->3072")
    masks_equal = bool(torch.equal(got[5].bool(), ma) and torch.equal(got[6].bool(), mf))
    keep_block = [mk.float().mean().item() for mk in got[5:]]
    print(f"dropout: block keep shares {keep_block[0]:.6f} / {keep_block[1]:.6f} over "
          f"{rows * d} draws each; emitted masks equal the twin's: {masks_equal}", flush=True)
    if not masks_equal or max(abs(kb - (1 - RATE)) for kb in keep_block) > KEEP_TOL:
        fail("the block dropout's masks or keep rate")
    details["block_keep_shares"] = keep_block

    # autograd through the twin: bf16 activations, f32 weights and vectors
    # (rounded to bf16 inside, as the model's bf16 parameters are)
    leaves = [x_q.clone().requires_grad_(), ctx.clone().requires_grad_()]
    params = [t.clone().requires_grad_()
              for t in (w32[0], bo, s1, g1, w32[1], b1, w32[2], b2, s2, g2)]
    BT.block_train_plain(*leaves, *params, mask_a=ma, mask_f=mf, rate=RATE).backward(gy)
    bwd_args = (gy, ctx, *twin[1:], wo, w1, w2, s1, g1, s2)
    got = BT.block_train_bwd(*bwd_args, rate=RATE, seed=seed)
    torch.cuda.synchronize()
    for name, a, t in zip(BT.GRAD_NAMES, got, leaves + params):
        w = t.grad.float()
        report(record, "block_train_bwd", (a.float() - w).abs().max().item(),
               scale=w.abs().max().item(), extra=f" d{name} rate={RATE} [{rows},768]->3072")

    # the backward's attention-output mask, element by element: with Wo = I
    # dctx = dlin1 = K_a du1 / (1 - rate), zero exactly where the forward
    # dropped
    eye = torch.eye(d, device=dev, dtype=bf)
    res = BT.block_train_fwd(x_q, ctx, eye, *wargs[1:], rate=RATE, seed=seed)
    dctx = BT.block_train_bwd(gy, ctx, *res[1:], eye, w1, w2, s1, g1, s2, rate=RATE, seed=seed)[1]
    torch.cuda.synchronize()
    block_equal = bool(torch.equal(dctx != 0, ma))
    print(f"dropout: block backward's attention-output keep bits equal the forward's on "
          f"{ma.numel()} entries: {block_equal}", flush=True)
    if not block_equal:
        fail("the block dropout's forward / backward streams")
    del q, k, v, g, z, v_rate, v_eq, d_o, dv, out_eq, got, twin, leaves, params, res, dctx
    torch.cuda.empty_cache()

    # 11. the training step's own shapes, each kernel against its twin on
    # the same seed's masks with the tolerances above, then timed: the flash
    # forward (dropout, lse) and backward at [48, 1152, 768] with the MMT
    # mask; the block at 55,296 rows (QTV, MMT) and at 960 rows (text BERT:
    # 48 x 20 question tokens).  The timed twins draw their masks from the
    # seed as they run.
    bt = TRAIN_BATCH
    km = mask_for(bt, 12)
    rows_ok = km > 0
    rows_ok[:, l - 12:] = True
    shape = f"[{bt},1152,768] dec_len=12"
    q, k, v, g = (rn(bt, l, d) for _ in range(4))
    out, lse = FA.flash_attention_merged(q, k, v, km, 12, h, RATE, seed, return_lse=True)
    want, want_lse = FA.flash_attention_merged_plain(q, k, v, km, 12, h, RATE, seed,
                                                     return_lse=True)
    torch.cuda.synchronize()
    err = (out.float() - want.float()).abs()[rows_ok].max().item()
    lse_err = (lse - want_lse).abs()[rows_ok[:, None, :].expand_as(lse)].max().item()
    report(record, "flash_attention_merged", err,
           extra=f" dropout {RATE} {shape}; lse max|diff| {lse_err:.3e} (tol {LSE_TOL:.0e})")
    if not lse_err <= LSE_TOL:
        fail(f"flash_attention_merged lse disagrees at {shape}")
    del want, want_lse
    got = FA.flash_attention_merged_bwd(q, k, v, km, out, lse, g, 12, h, RATE, seed)
    want = FA.flash_attention_merged_bwd_plain(q, k, v, km, out, lse, g, 12, h, RATE, seed)
    torch.cuda.synchronize()
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        report(record, "flash_attention_merged_bwd", (a.float() - w.float()).abs().max().item(),
               scale=w.float().abs().max().item(), extra=f" {name} rate={RATE} {shape}")
    del got, want
    torch.cuda.empty_cache()

    qh, kh, vh = (sdpa_split(t, h).detach().requires_grad_() for t in (q, k, v))
    am = sdpa_mask(km, 12)
    fwd_t = dict(ms=cuda_time_ms(lambda: FA.flash_attention_merged(
                     q, k, v, km, 12, h, RATE, seed, return_lse=True)),
                 plain_ms=cuda_time_ms(lambda: FA.flash_attention_merged_plain(
                     q, k, v, km, 12, h, RATE, seed, return_lse=True), reps=3, warmup=1),
                 library_ms=cuda_time_ms(lambda: F.scaled_dot_product_attention(
                     qh, kh, vh, am, dropout_p=RATE)),
                 bound=flash_bound(q, km, 12, lse=True))
    # the record of #1 stays at its serving shape (section 1); this is its
    # dropout form at the training shape, kept in the details
    train_rec = {}
    keep_times(train_rec, "flash_attention_merged", f" dropout {RATE} {shape}", **fwd_t)
    details["flash_attention_merged_train"] = train_rec["flash_attention_merged"]
    lib_out = F.scaled_dot_product_attention(qh, kh, vh, am, dropout_p=RATE)
    lib_g = torch.randn_like(lib_out)
    timed = dict(
        ms=cuda_time_ms(lambda: FA.flash_attention_merged_bwd(
            q, k, v, km, out, lse, g, 12, h, RATE, seed)),
        plain_ms=cuda_time_ms(lambda: FA.flash_attention_merged_bwd_plain(
            q, k, v, km, out, lse, g, 12, h, RATE, seed), reps=3, warmup=1),
        library_ms=cuda_time_ms(lambda: torch.autograd.grad(
            lib_out, (qh, kh, vh), lib_g, retain_graph=True)),
        bound=flash_bwd_bound(q, km, 12))
    keep_times(record, "flash_attention_merged_bwd", f" rate={RATE} {shape}", **timed)
    del q, k, v, g, out, lse, qh, kh, vh, am, lib_out, lib_g
    torch.cuda.empty_cache()

    wbytes, vbytes = nbytes(wo, w1, w2), nbytes(*vecs)
    for rows in (bt * l, bt * 20):
        x_q, ctx, gy = rn(rows, d), rn(rows, d), rn(rows, d)
        ma, mf = BT.masks_from_seed(seed, rows, d, RATE, dev)
        res = BT.block_train_fwd(x_q, ctx, *wargs, rate=RATE, seed=seed)
        twin = BT.block_train_fwd_plain(x_q, ctx, *wargs, ma, mf, rate=RATE)
        torch.cuda.synchronize()
        for name, a, w in zip(("y", "x1h", "pre1", "h", "x2h"), res, twin):
            report(record, "block_train_fwd", (a.float() - w.float()).abs().max().item(),
                   extra=f" {name} rate={RATE} [{rows},768]->3072")
        del twin
        bwd_args = (gy, ctx, *res[1:], wo, w1, w2, s1, g1, s2)
        got = BT.block_train_bwd(*bwd_args, rate=RATE, seed=seed)
        want = BT.block_train_bwd_plain(*bwd_args, ma, mf, rate=RATE)
        torch.cuda.synchronize()
        for name, a, w in zip(BT.GRAD_NAMES, got, want):
            w = w.float()
            report(record, "block_train_bwd", (a.float() - w).abs().max().item(),
                   scale=w.abs().max().item(), extra=f" d{name} rate={RATE} [{rows},768]->3072")
        del got, want, ma, mf
        if rows == bt * l:
            twin_masks = lambda: BT.masks_from_seed(seed, rows, d, RATE, dev)
            act_d, act_m = rows * d * 2, rows * m * 2
            keep_times(record, "block_train_fwd", f" rate={RATE} [{rows},768]->3072",
                       ms=cuda_time_ms(lambda: BT.block_train_fwd(x_q, ctx, *wargs, rate=RATE,
                                                                  seed=seed)),
                       plain_ms=cuda_time_ms(lambda: BT.block_train_fwd_plain(
                           x_q, ctx, *wargs, *twin_masks(), rate=RATE), reps=3, warmup=1),
                       bound=block_bound(rows, d, m, 2 * act_d, 3 * act_d + 2 * act_m, wbytes,
                                         vbytes))
            keep_times(record, "block_train_bwd", f" rate={RATE} [{rows},768]->3072",
                       ms=cuda_time_ms(lambda: BT.block_train_bwd(*bwd_args, rate=RATE,
                                                                  seed=seed)),
                       plain_ms=cuda_time_ms(lambda: BT.block_train_bwd_plain(
                           *bwd_args, *twin_masks(), rate=RATE), reps=3, warmup=1),
                       bound=block_bound(rows, d, m, 4 * act_d + 2 * act_m,
                                         2 * act_d + 2 * wbytes, wbytes, vbytes, backward=True))
        del x_q, ctx, gy, res, bwd_args
        torch.cuda.empty_cache()
    return details


def split_flash_bound(qs, k, key_mask, dec_len: int, off: int, lse: bool = False):
    """#10: the shard's q read and out (and its lse) written, k and v read;
    2 products of 2 * 64 per allowed pair of each head."""
    b, h, rows, hd = qs.shape
    moved = 2 * nbytes(qs) + 2 * nbytes(k) + nbytes(key_mask) + (b * h * rows * 4 if lse else 0)
    return bound_of(moved, 4 * hd * h * attn_pairs(key_mask, dec_len, off, rows))


def split_flash_bwd_bound(qs, k, key_mask, dec_len: int, off: int):
    """#10b: q, out, dO and the lse read and dq written (the shard's rows),
    k and v read and the f32 dk, dv written; 5 products of 2 * 64 per
    allowed pair of each head."""
    b, h, rows, hd = qs.shape
    moved = 4 * nbytes(qs) + 2 * nbytes(k) + 4 * nbytes(k) + b * h * rows * 4 + nbytes(key_mask)
    return bound_of(moved, 10 * hd * h * attn_pairs(key_mask, dec_len, off, rows))


PAD_L = 577  # keys: not a multiple of 128, so round_up(PAD_L, 128) - PAD_L = 63 padded keys


def check_padded_keys(dev, record):
    """The flash kernels where a row of mask fills also counts the padded
    keys up to round_up(Lk, 128) (at 1152 keys there are none), at PAD_L
    keys, batch TRAIN_CHECK_BATCH, dec_len 0 and 12, on the masks of
    edge_masks (a batch row with no valid key: its encoder rows average V
    over 640 keys, and the backward weighs each of their keys 1 / 640), at
    rate 0 and at rate RATE (with the lse), every row against the twin: the
    forwards #1 and #10 (offsets 0 and 289 of the 577 rows) and the
    backwards #1b and #10b on the twin's out and lse (the last key tile of
    one key, #10b's last q tile of one row).  Then #14
    (check_padded_bias)."""
    import torch

    from vitxtgqa_tpu_torch.ops import flash_attention as FA

    gen = torch.Generator(device=dev).manual_seed(1357)
    h, l, b = 12, PAD_L, TRAIN_CHECK_BATCH
    serving_mask, _ = serving_masks(dev)
    seed = torch.tensor([20261018], dtype=torch.int64, device=dev)
    q, k, v, gm = (torch.randn(b, l, 768, generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(4))
    qh, kh, vh, gh = (sdpa_split(x, h) for x in (q, k, v, gm))
    shards = ((0, l // 2 + 1), (l // 2 + 1, l - l // 2 - 1))

    def check(name, kernel, twin, args, rate, extra):
        """kernel(*args) against twin(*args), with the lse at rate > 0."""
        s_ = seed if rate else None
        got = kernel(*args, rate, s_, rate > 0)
        want = twin(*args, rate, s_, rate > 0)
        torch.cuda.synchronize()
        if rate:
            (got, lse), (want, want_lse) = got, want
            lse_err = (lse - want_lse).abs().max().item()
            extra += f"; lse max|diff| {lse_err:.3e} (tol {LSE_TOL:.0e})"
        report(record, name, (got.float() - want.float()).abs().max().item(), extra)
        if rate and not lse_err <= LSE_TOL:
            fail(f"{name} lse disagrees at{extra}")

    def check_bwd(name, kernel, twin, fwd, args, g, rate, extra):
        """kernel's dq, dk, dv against twin's, scale-relative, from the
        forward twin's out and lse."""
        s_ = seed if rate else None
        out, lse = fwd(*args, rate, s_, True)
        got = kernel(*args[:4], out, lse, g, *args[4:], rate, s_)
        want = twin(*args[:4], out, lse, g, *args[4:], rate, s_)
        torch.cuda.synchronize()
        for grad, a, w in zip(("dq", "dk", "dv"), got, want):
            report(record, name, (a.float() - w.float()).abs().max().item(),
                   scale=w.float().abs().max().item(), extra=f" {grad}{extra}")

    for dec_len in (0, 12):
        km0 = serving_mask[:b, :l].clone()
        if dec_len:
            km0[:, l - dec_len:] = 0.0
        for label, km in edge_masks(km0, dec_len):
            for rate in (0.0, RATE):
                form = f" rate {rate} dec_len={dec_len}, {label}"
                check("flash_attention_merged", FA.flash_attention_merged,
                      FA.flash_attention_merged_plain, (q, k, v, km, dec_len, h), rate,
                      f" [{b},{l},768]{form}")
                for off, rows in shards:
                    check("flash_attention", FA.flash_attention, FA.flash_attention_plain,
                          (qh[:, :, off:off + rows], kh, vh, km, dec_len, off), rate,
                          f" [{b},{h},{rows},64] x [{b},{h},{l},64] row_offset={off}{form}")
            for rate in (0.0, RATE):
                form = f" rate={rate} dec_len={dec_len}, {label}"
                check_bwd("flash_attention_merged_bwd", FA.flash_attention_merged_bwd,
                          FA.flash_attention_merged_bwd_plain, FA.flash_attention_merged_plain,
                          (q, k, v, km, dec_len, h), gm, rate, f" [{b},{l},768]{form}")
                for off, rows in shards + ((l - 1, 1),):
                    check_bwd("flash_attention_bwd", FA.flash_attention_bwd,
                              FA.flash_attention_bwd_plain, FA.flash_attention_plain,
                              (qh[:, :, off:off + rows], kh, vh, km, dec_len, off),
                              gh[:, :, :rows], rate,
                              f" [{b},{h},{rows},64] x [{b},{h},{l},64] row_offset={off}{form}")

    del q, k, v, gm, qh, kh, vh, gh
    torch.cuda.empty_cache()
    check_padded_bias(dev, record)


def check_padded_bias(dev, record):
    """#14 at PAD_L keys, batch TRAIN_CHECK_BATCH, with -1e9 on every key of
    a row (the Pallas kernel's padded keys share that row), broadcast over
    the rows (batch row 1) and per row, against the twin.  V has mean 1: a
    row of -1e9 averaged over Lk keys instead of round_up(Lk, 128) is then
    off by about 63 / 640 ~ 0.1, above the tolerance (over zero-mean V the
    same fault moves it by ~1e-2 only)."""
    import torch

    from vitxtgqa_tpu_torch.ops import fused_attention as FAT

    gen = torch.Generator(device=dev).manual_seed(2468)
    h, l, b = 12, PAD_L, TRAIN_CHECK_BATCH
    q, k, v = (torch.randn(b, l, 768, generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    qh, kh, vh = sdpa_split(q, h), sdpa_split(k, h), sdpa_split(v + 1.0, h)
    key_bias = torch.zeros(b, 1, 1, l, device=dev)
    key_bias[0, ..., l // 2:] = -1e9
    key_bias[1] = -1e9
    row_bias = torch.randn(b, 1, l, l, generator=gen, device=dev) * 2.0
    row_bias[1, 0, :64] = -1e9
    row_bias[2, 0, l - 3:] = -1e9
    for label, bias in (("batch row 1 all -1e9", key_bias),
                        ("per-row bias, 67 rows all -1e9", row_bias)):
        got = FAT.fused_attention(qh, kh, vh, bias)
        want = FAT.fused_attention_plain(qh, kh, vh, bias)
        torch.cuda.synchronize()
        report(record, "fused_attention", (got.float() - want.float()).abs().max().item(),
               f" [{b},{h},{l},64] {label}, V + 1")
    del q, k, v, qh, kh, vh, key_bias, row_bias
    torch.cuda.empty_cache()


def check_split_bwd(record, q, k, v, g, key_mask, dec_len: int, rows: int, seed, label="",
                    autograd: bool = True):
    """#10b on the query shards of ``rows`` rows at offsets 0 and ``rows``
    of split-head q / k / v (g: the shard's cotangent), rates 0 and RATE,
    from the kernel forward's out and lse: against autograd through the
    forward twin in f32, or (``autograd`` False) against the backward twin
    on the same out and lse.  The second is the reference where a row has
    no allowed key (edge_masks' batch row 3): the forward twin's masked
    scores are constants, so autograd gives such a row no dq and its keys
    no dk from it, while the Pallas backward and its twin weigh each of
    its keys 1 / round_up(Lk, 128) (tests/test_torch_train_ops.py)."""
    import torch

    from vitxtgqa_tpu_torch.ops import flash_attention as FA

    b, h, l = k.shape[:3]
    for rate in (0.0, RATE):
        for off in (0, rows):
            s_ = seed if rate else None
            qs = q[:, :, off:off + rows]
            out, lse = FA.flash_attention(qs, k, v, key_mask, dec_len, off, rate, s_,
                                          return_lse=True)
            got = FA.flash_attention_bwd(qs, k, v, key_mask, out, lse, g, dec_len, off, rate, s_)
            if autograd:
                leaves = [t.detach().float().requires_grad_() for t in (qs, k, v)]
                FA.flash_attention_plain(*leaves, key_mask, dec_len, off, rate,
                                         s_).backward(g.float())
                want = [t.grad for t in leaves]
            else:
                want = [t.float() for t in FA.flash_attention_bwd_plain(
                    qs, k, v, key_mask, out, lse, g, dec_len, off, rate, s_)]
            torch.cuda.synchronize()
            for name, a, w in zip(("dq", "dk", "dv"), got, want):
                report(record, "flash_attention_bwd", (a.float() - w).abs().max().item(),
                       scale=w.abs().max().item(),
                       extra=f" {name} rate={rate} [{b},{h},{rows},64] x [{b},{h},{l},64] "
                             f"dec_len={dec_len} row_offset={off}{label}")


def check_sp_kernels(dev, record):
    """The split-head flash attention with a query-row offset (#10) and its
    backward (#10b), the kernels of sequence parallelism, on split-head
    views of [B, 1152, 768] projections (no copy), a rank's query shard of
    L / SP_RANKS = 576 rows against the 1,152 keys: #10 at batch 8 with
    row_offset 0 and 576, dec_len 0 and 12 under the serving batch's
    ragged mask, against its twin; with dropout 0.1 at offset 576, and the
    shards with dropout concatenated against the unsharded call, bit for
    bit; #10b at batch 4 (the SP training step's), rate 0 and 0.1, offsets 0
    and 576 with dec_len 12 against autograd through the forward twin in
    f32, and on edge_masks with dec_len 0 and 12 against the backward twin
    (check_split_bwd).  Timed: #10 at [8, 12, 576, 64] dec_len 0 (a QTV / MMT encode
    rank's call) and #10b at rate 0, offset 576, dec_len 12 (an MMT rank's
    rows across the decoder tail), each beside
    F.scaled_dot_product_attention with the same boolean rows (its backward
    for #10b)."""
    import torch
    import torch.nn.functional as F

    from vitxtgqa_tpu_torch.ops import flash_attention as FA

    gen = torch.Generator(device=dev).manual_seed(2468)
    bf = torch.bfloat16
    h, l, d, rows = 12, L_JOINT, 768, L_JOINT // SP_RANKS
    serving_mask, _ = serving_masks(dev)
    seed = torch.tensor([20261017], dtype=torch.int64, device=dev)
    rn = lambda *s: torch.randn(*s, generator=gen, device=dev).to(bf)
    details = {}

    def mask_for(batch, dec_len):
        km = serving_mask[torch.arange(batch, device=dev) % BATCH].clone()
        if dec_len:
            km[:, l - dec_len:] = 0.0
        return km.contiguous()

    # 18. #10 against its twin
    q, k, v = (sdpa_split(rn(BATCH, l, d), h) for _ in range(3))
    for dec_len in (0, 12):
        km = mask_for(BATCH, dec_len)
        for off in (0, rows):
            qs = q[:, :, off:off + rows]
            got = FA.flash_attention(qs, k, v, km, dec_len, off)
            want = FA.flash_attention_plain(qs, k, v, km, dec_len, off)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            shape = (f" [{BATCH},{h},{rows},64] x [{BATCH},{h},{l},64] dec_len={dec_len} "
                     f"row_offset={off}")
            timed = {}
            if dec_len == 0 and off == 0:
                am = FA._allowed(km, l, dec_len, off, rows)
                timed = dict(ms=cuda_time_ms(lambda: FA.flash_attention(qs, k, v, km, 0, 0)),
                             plain_ms=cuda_time_ms(lambda: FA.flash_attention_plain(
                                 qs, k, v, km, 0, 0)),
                             library_ms=cuda_time_ms(lambda: F.scaled_dot_product_attention(
                                 qs, k, v, am)),
                             bound=split_flash_bound(qs, k, km, 0, 0))
            report(record, "flash_attention", err, shape, **timed)
        # the forward body's edge cases (edge_masks) at both offsets
        for label, km in edge_masks(km, dec_len):
            for off in (0, rows):
                qs = q[:, :, off:off + rows]
                got = FA.flash_attention(qs, k, v, km, dec_len, off)
                want = FA.flash_attention_plain(qs, k, v, km, dec_len, off)
                torch.cuda.synchronize()
                report(record, "flash_attention", (got.float() - want.float()).abs().max().item(),
                       f" [{BATCH},{h},{rows},64] x [{BATCH},{h},{l},64] dec_len={dec_len} "
                       f"row_offset={off}, {label}")
    km = mask_for(BATCH, 12)
    qs = q[:, :, rows:]
    got = FA.flash_attention(qs, k, v, km, 12, rows, RATE, seed)
    want = FA.flash_attention_plain(qs, k, v, km, 12, rows, RATE, seed)
    full = FA.flash_attention(q, k, v, km, 12, 0, RATE, seed)
    shards = torch.cat([FA.flash_attention(q[:, :, o:o + rows], k, v, km, 12, o, RATE, seed)
                        for o in range(0, l, rows)], dim=2)
    torch.cuda.synchronize()
    report(record, "flash_attention", (got.float() - want.float()).abs().max().item(),
           f" dropout {RATE} [{BATCH},{h},{rows},64] dec_len=12 row_offset={rows}")
    same = bool(torch.equal(shards, full))
    print(f"kernel flash_attention: dropout {RATE}, the {SP_RANKS} shards concatenated equal the "
          f"unsharded call's rows bit for bit: {same}", flush=True)
    if not same:
        fail("flash_attention: a shard's dropout rows differ from the unsharded call's")
    del got, want, full, shards

    # 19. #10b against autograd through the twin on the serving mask, then
    # the backward body's tile walk on edge_masks (a batch row with no valid
    # key: its encoder rows weigh every key; valid keys in one key tile)
    # against the backward twin
    b = TRAIN_CHECK_BATCH
    q4, k4, v4 = q[:b], k[:b], v[:b]
    g = sdpa_split(rn(b, rows, d), h)
    km = mask_for(b, 12)
    check_split_bwd(record, q4, k4, v4, g, km, 12, rows, seed)
    for dec_len in (0, 12):
        for label, edge in edge_masks(mask_for(b, dec_len), dec_len):
            check_split_bwd(record, q4, k4, v4, g, edge, dec_len, rows, seed, ", " + label,
                            autograd=False)
    qs = q4[:, :, rows:]
    out, lse = FA.flash_attention(qs, k4, v4, km, 12, rows, return_lse=True)
    lib_q, lib_k, lib_v = (t.detach().requires_grad_() for t in (qs, k4, v4))
    lib_out = F.scaled_dot_product_attention(lib_q, lib_k, lib_v,
                                             FA._allowed(km, l, 12, rows, rows))
    keep_times(record, "flash_attention_bwd", f" rate=0 [{b},{h},{rows},64] dec_len=12 "
               f"row_offset={rows}",
               ms=cuda_time_ms(lambda: FA.flash_attention_bwd(qs, k4, v4, km, out, lse, g, 12,
                                                              rows)),
               plain_ms=cuda_time_ms(lambda: FA.flash_attention_bwd_plain(
                   qs, k4, v4, km, out, lse, g, 12, rows)),
               library_ms=cuda_time_ms(lambda: torch.autograd.grad(
                   lib_out, (lib_q, lib_k, lib_v), g, retain_graph=True)),
               bound=split_flash_bwd_bound(qs, k4, km, 12, rows))
    details["flash_attention_fwd_dropout_shards_equal"] = same
    del q, k, v, q4, k4, v4, g, out, lse, lib_out
    torch.cuda.empty_cache()
    return details


class Slices:
    """Production-width T2S models that share one set of random weights."""

    def __init__(self, dev, quiet: bool = False):
        from vitxtgqa_tpu_torch.models.t2s import PRODUCTION_NUM_FINAL_OUTPUTS, t2s_production_config

        self.dev, self.cfg, self.nf = dev, t2s_production_config(), PRODUCTION_NUM_FINAL_OUTPUTS
        import torch

        t0 = time.perf_counter()
        self.state = self._new(kv_cache_int8=True).init_weights(0).state_dict()
        torch.cuda.synchronize()
        self.n_params = sum(v.numel() for v in self.state.values())
        if not quiet:
            print(f"slices: T2S production width, {self.n_params / 1e6:.1f}M params, bf16, "
                  f"random weights from seed 0, built in {time.perf_counter() - t0:.1f} s",
                  flush=True)

    def with_cfg(self, cfg):
        """These weights under another model config of the same shapes."""
        import copy

        other = copy.copy(self)
        other.cfg = cfg
        return other

    def _new(self, inference_only=True, **opts):
        import torch

        from vitxtgqa_tpu_torch import Options
        from vitxtgqa_tpu_torch.models.t2s import T2S

        return T2S(self.cfg, self.nf, bos_idx=2, inference_only=inference_only,
                   opts=Options(device=self.dev, dtype=torch.bfloat16, **opts))

    def model(self, inference_only=True, **opts):
        """A T2S with these Options fields, bf16 on the card, holding the
        shared weights (``inference_only=False``: full-eval)."""
        m = self._new(inference_only, **opts)
        m.load_state_dict(self.state)
        return m


def count_launches(name, record, counts, want):
    """Fail unless ``counts`` are ``want``; add them to the record."""
    for k, v in want.items():
        if counts[k] != v:
            fail(f"{name}: {k} launched {counts[k]} times, expected {v}")
        record.setdefault(k, {}).setdefault("launches", 0)
        record[k]["launches"] += counts[k]


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
            print(f"slice {name}: launches in one served forward at batch {n} "
                  + json.dumps(counts), flush=True)
            count_launches(f"slice {name}, a batch-{n} forward", record, counts,
                           expected_launches(sl.cfg, n, model.opts))
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
            if not diff0 <= STEP0_TOL or agree < MIN_TOKEN_AGREEMENT:
                fail(f"slice {name}: the kernels disagree with the plain versions")
            summary["groups"].append({
                "batch": n, "launches": counts, "pos_scores_max_abs_diff": diff_all,
                "step0_max_abs_diff": diff0, "token_agreement": agree,
                "ground_frame_agreement": gf})
    del plain_model
    return model, summary


def full_eval_slice(sl: Slices, record, card, compact: bool = False):
    """d. full-eval at batch 8, int8 cache: the pos decode, then ref / neg
    from one teacher-forced pass at 2B (h., ``compact``: the pos decode and
    the neg pass on the kept rows, ref over the full sequence at B); the
    same batch, weights and noise through the plain versions."""
    import numpy as np
    import torch

    from vitxtgqa_tpu_torch.ops import _build
    from vitxtgqa_tpu_torch.serving.engine import group_generator, to_device
    from vitxtgqa_tpu_torch.utils.synthetic import synthetic_batch

    name = "compact_full_eval_b8" if compact else "full_eval_b8"
    opts = dict(kv_cache_int8=True, compact_serving=compact)
    model = sl.model(inference_only=False, **opts)
    plain = sl.model(inference_only=False, plain=True, **opts)
    batch = synthetic_batch(batch=BATCH, num_final_outputs=sl.nf, seed=1)
    tb = to_device(batch, sl.dev)
    forward_ms(model, batch, sl.dev, reps=1)  # warm-up
    _build.reset_launch_counts()
    with torch.inference_mode():
        kern = model(tb, group_generator(0, 0, sl.dev))
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    print(f"slice {name}: launches in one full-eval forward at batch 8 " + json.dumps(counts),
          flush=True)
    count_launches(f"slice {name}", record, counts,
                   expected_launches(sl.cfg, BATCH, model.opts, full_eval=True))
    with torch.inference_mode():
        ref = plain(tb, group_generator(0, 0, sl.dev))
    out = {k: v.float().cpu().numpy() for k, v in kern.items() if torch.is_tensor(v)}
    want = {k: v.float().cpu().numpy() for k, v in ref.items() if torch.is_tensor(v)}
    for k in ("ref_scores", "pos_scores", "neg_scores"):
        if out[k].shape != (BATCH, DEC_LEN, sl.nf) or not np.isfinite(out[k]).all():
            fail(f"slice {name}: {k} {out[k].shape}, finite {np.isfinite(out[k]).all()}")
    tok, tok_p = out["pos_scores"].argmax(-1), want["pos_scores"].argmax(-1)
    agree = float((tok == tok_p).mean())
    same = (tok == tok_p).all(-1)
    diffs = {k: float(np.abs(out[k][same] - want[k][same]).max()) if same.any() else None
             for k in ("ref_scores", "neg_scores")}
    lat = forward_ms(model, batch, sl.dev, reps=3)
    print(f"slice {name}: kernels vs plain on the card: greedy-token agreement {agree:.4f} "
          f"(min {MIN_TOKEN_AGREEMENT}); on the {int(same.sum())} rows with equal tokens max|d "
          f"ref_scores| {diffs['ref_scores']}, max|d neg_scores| {diffs['neg_scores']} (tol "
          f"{REFNEG_TOL}); forward median {statistics.median(lat):.2f} ms; card {card}", flush=True)
    if (agree < MIN_TOKEN_AGREEMENT or not same.any()
            or not all(d <= REFNEG_TOL for d in diffs.values())):
        fail(f"slice {name}: the kernels disagree with the plain versions")
    del model, plain
    return {"launches": counts, "token_agreement": agree, "rows_equal_tokens": int(same.sum()),
            "max_abs_diff": diffs, "forward_ms_all": lat}


def module_entry_slice(sl: Slices, record):
    """i. The int8 kernels' module entry points at production width: the
    MMT encoder's encode_with_cache(quantize=True) over a batch-8 joint
    sequence (#11 in each layer), whose cache must equal quantize_cache of
    the plain encode's K/V bit for bit, and whose per-layer greedy decode
    must give the tokens of that cache's; OcrPtrNet.scores_from_keys over
    int8 keys (#12) against its twin.  Launches counted around each."""
    import torch

    from vitxtgqa_tpu_torch.ops import _build
    from vitxtgqa_tpu_torch.ops import ptr_scores as PS
    from vitxtgqa_tpu_torch.ops.attention import quantize_kv
    from vitxtgqa_tpu_torch.ops.masks import DecodeStepSpec, MaskSpec

    dev, bf = sl.dev, torch.bfloat16
    model = sl.model(kv_cache_int8=True)
    enc, ppe = model.mmt.encoder, model.mmt.prev_pred_embeddings
    gen = torch.Generator(device=dev).manual_seed(1357)
    mask, ocr_mask = serving_masks(dev)
    x = torch.randn(BATCH, L_JOINT, 768, generator=gen, device=dev).to(bf)
    ocr = torch.randn(BATCH, 960, 768, generator=gen, device=dev).to(bf)
    spec = MaskSpec(key_mask=mask)
    only = lambda **kw: {**{k: 0 for k in REPLACES}, **kw}
    with torch.inference_mode():
        _build.reset_launch_counts()
        _, emitted = enc.encode_with_cache(x, spec, quantize=True)
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        count_launches("slice module_entries, encode_with_cache(quantize=True)", record, counts,
                       only(flash_attention_merged_q8=3, fused_block=3))
        separate = enc.quantize_cache(enc.encode_with_cache(x, spec)[1])
        cache_equal = all(torch.equal(a, b) for layer_e, layer_s in zip(emitted, separate)
                          for pair_e, pair_s in zip(layer_e, layer_s)
                          for a, b in zip(pair_e, pair_s))
        ans_tbl, ocr_tbl = ppe.tables(model.classifier.table(), ocr)
        tokens = []
        for cache in (emitted, separate):
            prev = torch.full((BATCH,), model.bos_idx, dtype=torch.long, device=dev)
            steps = []
            for t in range(DEC_LEN):
                x_t = ppe.embed(ans_tbl, ocr_tbl, prev[:, None], position_offset=t)
                step = DecodeStepSpec(key_mask=mask, step=t, write_offset=WRITE_OFFSET)
                y, cache = enc.decode_step(x_t, cache, t, step, WRITE_OFFSET)
                prev = model.classifier(y)[:, 0].argmax(-1)
                steps.append(prev)
            tokens.append(torch.stack(steps, dim=1))
        same_tokens = bool(torch.equal(*tokens))
        print(f"slice module_entries: MMT encode_with_cache(quantize=True) at [8,1152,768]: cache "
              f"equal to quantize_cache's: {cache_equal}; the per-layer decode from both gives "
              f"equal tokens: {same_tokens} ({tokens[0][0].tolist()} ...)", flush=True)
        if not cache_equal or not same_tokens:
            fail("slice module_entries: encode_with_cache(quantize=True)")

        ptr = model.ocr_ptr_net
        y = torch.randn(BATCH, 1, 768, generator=gen, device=dev).to(bf)
        keys = quantize_kv(ptr.keys(ocr))
        _build.reset_launch_counts()
        got = ptr.scores_from_keys(y, keys, ocr_mask)
        torch.cuda.synchronize()
        count_launches("slice module_entries, scores_from_keys((k8, ks))", record,
                       _build.launch_counts(), only(ptr_scores_int8=1))
        want = PS.ptr_scores_int8_plain(ptr.query(y), *keys, ocr_mask)
    report(record, "ptr_scores_int8", (got - want).abs().max().item(),
           " OcrPtrNet.scores_from_keys over int8 keys [8,1,768] x [8,960,768]")
    del model, emitted, separate
    return {"encode_launches": counts, "cache_equal": cache_equal, "tokens_equal": same_tokens}


def vit_request(feats, nf: int):
    """One T2S request (batch 1) around the 64 frame features [64, D]: the
    synthetic batch's question and OCR, with video_feat the features,
    every frame valid (frame ids 1-64), and mid_img_feat the last frame's
    feature, the reference's "middle frame" as vitxtgqa_tpu/data/dataset.py
    resolves it."""
    import numpy as np

    from vitxtgqa_tpu_torch.utils.synthetic import synthetic_batch

    n, d = feats.shape
    batch = synthetic_batch(batch=1, frames=n, video_feat_dim=d, num_final_outputs=nf, seed=5)
    ocr_pf = batch["temporal_id"].shape[1] // n
    batch.update(video_feat=feats[None].astype(np.float32),
                 mid_img_feat=feats[None, -1:].astype(np.float32),
                 frame_id=np.arange(1, n + 1, dtype=np.int32)[None],
                 frame_mask=np.ones((1, n), np.float32), frame_num=np.array([n], np.int64),
                 temporal_id=np.repeat(np.arange(1, n + 1, dtype=np.int32), ocr_pf)[None],
                 middel_frame_id=np.array([[n]], np.int64),
                 middel_frame_idx=np.array([[n]], np.int64))
    return batch


def vit_slice(sl: Slices, record, card):
    """j. Frames to answer: VIT_FRAMES uint8 frames at 240 x 320 from a seed
    through preprocess_frames (the antialiased resize) and ViT-L/16 at 224
    px, bf16, random weights from seed 0 -> CLS [64, 1024], against the
    same frames through Options(plain=True); the launches at batch 64 (#13
    in all 24 layers) and at batch 8 (1,576 rows, below the gate: none);
    frames/s over VIT_REPS forwards at batch 64 and the device ms; then the
    64 features as one T2S request at batch 1 with the int8 cache, served
    through a ServingEngine, its greedy tokens against the plain path end to
    end (plain features through the plain T2S)."""
    import torch

    from vitxtgqa_tpu_torch import Options
    from vitxtgqa_tpu_torch.models.vit import VIT_L_16, make_feature_extractor
    from vitxtgqa_tpu_torch.ops import _build
    from vitxtgqa_tpu_torch.serving.engine import ServingEngine, group_generator, to_device
    from vitxtgqa_tpu_torch.utils.synthetic import synthetic_frames

    dev, bf = sl.dev, torch.bfloat16
    cfg = VIT_L_16
    t0 = time.perf_counter()
    extract, vit = make_feature_extractor(cfg, None, Options(device=dev, dtype=bf))
    extract_plain, _ = make_feature_extractor(cfg, vit.state_dict(),
                                              Options(device=dev, dtype=bf, plain=True))
    frames = torch.from_numpy(synthetic_frames(VIT_FRAMES, 240, 320, seed=0)).to(dev)
    n_params = sum(p.numel() for p in vit.parameters())
    print(f"slice vit_l16: ViT-L/16 at {cfg.image_size} px, {n_params / 1e6:.1f}M params, bf16, "
          f"random weights from seed 0, built in {time.perf_counter() - t0:.1f} s; frames "
          f"{tuple(frames.shape)} uint8", flush=True)
    extract(frames)  # warm-up
    summary = {"params_m": n_params / 1e6, "launches": {}}
    for b in (VIT_FRAMES, 8):
        _build.reset_launch_counts()
        feats = extract(frames[:b])
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        print(f"slice vit_l16: launches in one forward at batch {b} " + json.dumps(counts),
              flush=True)
        count_launches(f"slice vit_l16, a batch-{b} forward", record, counts,
                       expected_vit_launches(cfg, b))
        summary["launches"][b] = counts
    feats = extract(frames)
    feats_plain = extract_plain(frames)
    err, rel = feature_agreement(feats, feats_plain)
    ok = feats.shape == (VIT_FRAMES, cfg.hidden_size) and bool(torch.isfinite(feats).all())
    print(f"slice vit_l16: CLS {tuple(feats.shape)} {feats.dtype}, finite {ok}; kernels vs plain on "
          f"the card: max|diff| {err:.4e}, largest per-frame relative L2 difference {rel:.4e} "
          f"(limit {VIT_FEAT_REL_TOL})", flush=True)
    if not ok or not rel <= VIT_FEAT_REL_TOL:
        fail("slice vit_l16: the CLS features disagree with the plain versions")

    lat = []
    for _ in range(VIT_REPS):
        t = time.perf_counter()
        extract(frames)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t) * 1e3)
    med = statistics.median(lat)
    device_ms = cuda_time_ms(lambda: extract(frames), reps=VIT_REPS, warmup=1)
    print(f"slice vit_l16: batch {VIT_FRAMES} forward ms {[round(x, 2) for x in lat]}, median "
          f"{med:.2f} ms, {VIT_FRAMES / med * 1e3:.1f} frames/s; device {device_ms:.2f} ms per "
          f"forward (CUDA events, queued); card {card}", flush=True)
    summary.update(cls_max_abs_diff=err, cls_max_rel_l2=rel, forward_ms_all=lat,
                   forward_ms_median=med, frames_per_s=VIT_FRAMES / med * 1e3,
                   device_ms=device_ms)

    # the 64 features as one T2S request, int8 cache, batch 1
    opts = dict(kv_cache_int8=True)
    model, plain_model = sl.model(**opts), sl.model(plain=True, **opts)
    req = vit_request(feats.cpu().numpy(), sl.nf)
    req_plain = vit_request(feats_plain.cpu().numpy(), sl.nf)
    sample = {k: v[0] for k, v in req.items()}
    with ServingEngine(model, buckets=(1,), max_wait_ms=300, rng_seed=0) as eng:
        eng.warmup(sample)
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        out = eng.submit(sample).result(timeout=600)
        torch.cuda.synchronize()
    counts = _build.launch_counts()
    count_launches("slice vit_l16, the T2S request", record, counts,
                   expected_launches(sl.cfg, 1, model.opts))
    check_outputs([out], sl.nf)
    with torch.inference_mode():
        want = plain_model(to_device(req_plain, dev), group_generator(0, 0, dev))
    tok = out["pos_scores"].argmax(-1)
    tok_plain = want["pos_scores"][0].float().cpu().numpy().argmax(-1)
    agree = float((tok == tok_plain).mean())
    print(f"slice vit_l16: the 64 features as a T2S request (int8 cache, batch 1): greedy tokens "
          f"{tok.tolist()}, plain end to end {tok_plain.tolist()}, agreement {agree:.4f} (min "
          f"{MIN_TOKEN_AGREEMENT})", flush=True)
    if agree < MIN_TOKEN_AGREEMENT:
        fail("slice vit_l16: the request's tokens disagree with the plain path")
    summary.update(request_launches=counts, request_token_agreement=agree)
    del model, plain_model, extract, extract_plain, vit
    torch.cuda.empty_cache()
    return summary


def feature_agreement(got, want):
    """(max |diff|, the largest per-row relative L2 difference) of two
    feature matrices [N, D]."""
    diff = (got.float() - want.float())
    rel = diff.norm(dim=-1) / want.float().norm(dim=-1)
    return diff.abs().max().item(), rel.max().item()


def vit_module_entry(dev, record):
    """The ViT layer stack at 384 px (577 tokens, ViT-L/16's published
    fine-tuning size) for one forward at batch 8: the bias-tensor attention
    (#14) and the fused FFN (#13, 4,616 rows) in all 24 layers, against
    the same forward through the plain versions; its device time (CUDA
    events over VIT_REPS forwards)."""
    import dataclasses

    import torch

    from vitxtgqa_tpu_torch import Options
    from vitxtgqa_tpu_torch.models.vit import VIT_L_16, ViT, preprocess_frames
    from vitxtgqa_tpu_torch.ops import _build
    from vitxtgqa_tpu_torch.utils.synthetic import synthetic_frames

    bf = torch.bfloat16
    cfg = dataclasses.replace(VIT_L_16, image_size=384)
    vit = ViT(cfg, Options(device=dev, dtype=bf)).init_weights(1).eval()
    plain = ViT(cfg, Options(device=dev, dtype=bf, plain=True)).eval()
    plain.load_state_dict(vit.state_dict())
    frames = torch.from_numpy(synthetic_frames(BATCH, 240, 320, seed=3)).to(dev)
    with torch.inference_mode():
        images = preprocess_frames(frames, cfg.image_size)
        _build.reset_launch_counts()
        cls = vit(images)[0]
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        count_launches("slice vit_l16_384, a batch-8 forward", record, counts,
                       expected_vit_launches(cfg, BATCH))
        cls_plain = plain(images)[0]
        ms = cuda_time_ms(lambda: vit(images), reps=VIT_REPS, warmup=1)
    err, rel = feature_agreement(cls, cls_plain)
    print(f"slice vit_l16_384: launches in one forward at batch {BATCH} (577 tokens) "
          + json.dumps(counts) + f"; CLS kernels vs plain: max|diff| {err:.4e}, largest "
          f"per-frame relative L2 difference {rel:.4e} (limit {VIT_FEAT_REL_TOL}); one "
          f"forward {ms:.3f} ms (CUDA events)", flush=True)
    if not rel <= VIT_FEAT_REL_TOL or not bool(torch.isfinite(cls).all()):
        fail("slice vit_l16_384: the CLS features disagree with the plain versions")
    del vit, plain
    torch.cuda.empty_cache()
    return {"launches": counts, "cls_max_abs_diff": err, "cls_max_rel_l2": rel, "forward_ms": ms}


@contextlib.contextmanager
def planted_fault(name, model):
    """Run the plain step with one fault a block kernel could have, in one
    layer, by wrapping ops/block_train's plain versions for the duration:
    "db2_dropped": the backward of MMT layer 2 returns db2 = 0 (in each of
    the ref / pos / neg passes); "keep_scale_1": the block of text-BERT
    layer 0 scales kept entries by 1 instead of 1 / (1 - rate), forward and
    backward alike."""
    import torch

    from vitxtgqa_tpu_torch.ops import block_train as BT

    # wo: the third operand of the forward, the seventh of the backward;
    # the rate: the fifteenth of either (after the two masks)
    fwd, bwd = BT.block_train_fwd_plain, BT.block_train_bwd_plain
    if name == "db2_dropped":
        wo = model.get_parameter("mmt.encoder.layer.2.attention.output.dense.weight")

        def bwd_fault(*a, **kw):
            grads = bwd(*a, **kw)
            if a[6].data_ptr() == wo.data_ptr():
                grads = grads[:9] + (torch.zeros_like(grads[9]),) + grads[10:]
            return grads

        patches = {"block_train_bwd_plain": bwd_fault}
    else:
        wo = model.get_parameter("text_bert.encoder.layer.0.attention.output.dense.weight")

        def unscaled(fn, at):
            def call(*a, **kw):
                if a[at].data_ptr() == wo.data_ptr():
                    a = a[:14] + (1e-9,) + a[15:]   # same masks, scale 1 / (1 - 1e-9)
                return fn(*a, **kw)
            return call

        patches = {"block_train_fwd_plain": unscaled(fwd, 2),
                   "block_train_bwd_plain": unscaled(bwd, 6)}
    for k, v in patches.items():
        setattr(BT, k, v)
    try:
        yield
    finally:
        BT.block_train_fwd_plain, BT.block_train_bwd_plain = fwd, bwd


PLANTED_FAULTS = ("db2_dropped", "keep_scale_1")


def train_check_step(sl, tb, losses, plain, fault=None, **opts):
    """One training step at batch TRAIN_CHECK_BATCH from the shared weights
    and generators, with these further Options fields: (loss, global
    gradient norm, {parameter: f32 gradient}, launch counts)."""
    import torch

    from vitxtgqa_tpu_torch.ops import _build
    from vitxtgqa_tpu_torch.training.step import step_generators

    model = sl.model(plain=plain, **opts)
    _build.reset_launch_counts()
    dropout_gen, gumbel_gen = step_generators(7, 0, sl.dev)
    with planted_fault(fault, model) if fault else contextlib.nullcontext():
        out = model(tb, gumbel_gen, train=True, dropout_gen=dropout_gen)
        total = losses.total(tb, out)[0]
        total.backward()
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    grads = {k: p.grad.float().flatten() for k, p in model.named_parameters()
             if p.grad is not None}
    norm = torch.linalg.vector_norm(torch.cat(list(grads.values()))).item()
    return total.item(), norm, grads, counts


def step_agreement(run, ref):
    """(loss relative difference, gradient-norm relative difference,
    (largest per-parameter gradient relative difference |g - g_ref| /
    |g_ref|, its parameter), parameters compared, whether all three are
    within their limits) of ``run`` against ``ref``."""
    (loss, norm, grads, _), (loss_r, norm_r, grads_r, _) = run, ref
    if sorted(grads) != sorted(grads_r):
        fail("slice train: two steps reach different parameters")
    rel = {}
    for k, w in grads_r.items():
        # a key projection's bias moves every score of a query alike, which
        # the softmax ignores: its gradient is 0 but for rounding, and is
        # left out
        nw = w.norm()
        if nw > 0 and not k.endswith("attention.self.key.bias"):
            rel[k] = float((grads[k] - w).norm() / nw)
    worst = worst_of(rel)
    loss_rel, norm_rel = abs(loss - loss_r) / abs(loss_r), abs(norm - norm_r) / norm_r
    ok = loss_rel <= LOSS_REL_TOL and norm_rel <= GNORM_REL_TOL and rel[worst] <= GRAD_REL_TOL
    return loss_rel, norm_rel, (rel[worst], worst), len(rel), ok


def train_slice(sl: Slices, record, card):
    """e. (i) one training step at batch TRAIN_CHECK_BATCH through the
    kernels and through the plain versions, from the same weights, batch,
    gumbel noise and dropout generator, and the plain step with each
    planted fault; (ii) TRAIN_STEPS Adam steps at batch TRAIN_BATCH
    through the kernels, remat "attn"."""
    import torch

    from vitxtgqa_tpu_torch import Options
    from vitxtgqa_tpu_torch.losses import Losses
    from vitxtgqa_tpu_torch.ops import _build
    from vitxtgqa_tpu_torch.serving.engine import to_device
    from vitxtgqa_tpu_torch.training.optim import build_optimizer
    from vitxtgqa_tpu_torch.training.step import step_generators, train_step
    from vitxtgqa_tpu_torch.utils.synthetic import synthetic_batch

    dev, losses = sl.dev, Losses(sl.cfg["losses"])
    tb = to_device(synthetic_batch(batch=TRAIN_CHECK_BATCH, num_final_outputs=sl.nf, seed=2), dev)
    kern = train_check_step(sl, tb, losses, plain=False)
    print(f"slice train: launches in one batch-{TRAIN_CHECK_BATCH} step " + json.dumps(kern[3]),
          flush=True)
    count_launches("slice train", record, kern[3],
                   expected_train_launches(sl.cfg, Options(device=dev)))
    plain = train_check_step(sl, tb, losses, plain=True)
    if any(plain[3].values()):
        fail(f"slice train: the plain step launched kernels {plain[3]}")
    limits = (f"(limits: loss {LOSS_REL_TOL}, norm {GNORM_REL_TOL}, parameter {GRAD_REL_TOL}, "
              f"relative to the plain step)")
    summary = {"check": {"batch": TRAIN_CHECK_BATCH, "loss": [kern[0], plain[0]],
                         "grad_norm": [kern[1], plain[1]]}, "planted": {}}
    for name, run in [("kernels", kern)] + [(f, None) for f in PLANTED_FAULTS]:
        if run is None:
            run = train_check_step(sl, tb, losses, plain=True, fault=name)
        loss_rel, norm_rel, (grad_rel, worst), n, ok = step_agreement(run, plain)
        print(f"slice train: batch {TRAIN_CHECK_BATCH}, {name} vs plain: loss {run[0]:.6f} vs "
              f"{plain[0]:.6f} (rel {loss_rel:.3e}), gradient norm {run[1]:.5f} vs {plain[1]:.5f} "
              f"(rel {norm_rel:.3e}), per-parameter gradient rel diff max {grad_rel:.3e} "
              f"({worst}) over {n} parameters {limits}: {'within' if ok else 'outside'}",
              flush=True)
        reading = {"loss_rel": loss_rel, "grad_norm_rel": norm_rel, "max_grad_rel": grad_rel,
                   "max_grad_rel_param": worst}
        if name == "kernels":
            summary["check"].update(reading)
            if not ok:
                fail("slice train: the kernel step disagrees with the plain step")
        else:
            summary["planted"][name] = reading
            if ok:
                fail(f"slice train: the planted fault {name} passes the limits")
        del run
    del kern, plain
    torch.cuda.empty_cache()

    # (ii) batch 48 through the kernels
    model = sl.model()
    opt = build_optimizer(model, model_config=sl.cfg)
    batch = to_device(synthetic_batch(batch=TRAIN_BATCH, num_final_outputs=sl.nf, seed=3), dev)
    watch = {k: p.detach().clone() for k, p in model.named_parameters()
             if k in ("text_bert.encoder.layer.0.attention.self.query.weight",
                      "mmt.encoder.layer.2.output.dense.weight", "classifier.module.weight")}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses_seen = [], []
    for step in range(TRAIN_STEPS):
        _build.reset_launch_counts()
        t = time.perf_counter()
        r = train_step(model, losses, opt, batch, step_generators(0, step, dev))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        count_launches(f"slice train, batch-{TRAIN_BATCH} step {step}", record,
                       _build.launch_counts(), expected_train_launches(sl.cfg, model.opts))
        losses_seen.append(float(r["loss"]))
        if not r["applied"]:
            fail(f"slice train: batch-{TRAIN_BATCH} step {step} had a non-finite loss or "
                 f"gradient (loss {losses_seen[-1]}, norm {float(r['grad_norm'])})")
    peak = torch.cuda.max_memory_allocated()
    moved = {k: float((p.detach() - watch[k]).abs().max()) for k, p in model.named_parameters()
             if k in watch}
    med = statistics.median(times[1:])
    print(f"slice train: batch {TRAIN_BATCH}, remat {model.opts.remat}, {TRAIN_STEPS} Adam steps "
          f"through the kernels: losses {losses_seen}; step ms {[round(x, 2) for x in times]} "
          f"(the first warms up); median {med:.2f} ms, {TRAIN_BATCH / med * 1e3:.2f} videos/s; "
          f"max_memory_allocated {peak / 2**30:.2f} GiB; parameters moved {moved}; card {card}",
          flush=True)
    if min(moved.values()) <= 0.0:
        fail("slice train: the Adam steps left a parameter unchanged")
    summary["batch48"] = {"step_ms_all": times, "step_ms_median": med,
                          "videos_per_s": TRAIN_BATCH / med * 1e3, "losses": losses_seen,
                          "max_memory_allocated": peak, "param_max_abs_change": moved}
    del model, opt, batch
    torch.cuda.empty_cache()
    return summary


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


def vit_backward_check(dev, record):
    """The 384-px ViT-L/16 stack's backward at batch VIT_BWD_BATCH through
    the bias-tensor attention (#14, whose output is a FusedAttentionFn
    node) against the plain stack's, from the same weights and frames:
    every parameter's gradient within GRAD_REL_TOL relative (a key
    projection's bias left out, as in the training step: its gradient is 0
    but for rounding)."""
    import dataclasses

    import torch

    from vitxtgqa_tpu_torch import Options
    from vitxtgqa_tpu_torch.models.vit import VIT_L_16, ViT, preprocess_frames
    from vitxtgqa_tpu_torch.ops import _build
    from vitxtgqa_tpu_torch.utils.synthetic import synthetic_frames

    cfg = dataclasses.replace(VIT_L_16, image_size=384)
    frames = torch.from_numpy(synthetic_frames(VIT_BWD_BATCH, 240, 320, seed=4)).to(dev)
    images = preprocess_frames(frames, cfg.image_size)
    gen = torch.Generator(device=dev).manual_seed(6)
    g = torch.randn(VIT_BWD_BATCH, cfg.hidden_size, generator=gen, device=dev)
    state, grads, counts = None, [], None
    for plain in (False, True):
        vit = ViT(cfg, Options(device=dev, plain=plain))
        if state is None:
            state = vit.init_weights(2).state_dict()
        else:
            vit.load_state_dict(state)
        _build.reset_launch_counts()
        (vit(images)[0].float() * g).sum().backward()
        torch.cuda.synchronize()
        if not plain:
            counts = _build.launch_counts()
        grads.append({k: p.grad.float() for k, p in vit.named_parameters() if p.grad is not None})
        del vit
    kern, ref = grads
    if counts["fused_attention"] != cfg.num_layers or sorted(kern) != sorted(ref):
        fail(f"vit_l16_384 backward: {counts['fused_attention']} #14 launches, "
             f"{len(kern)} / {len(ref)} gradients")
    rel = {k: float((kern[k] - w).norm() / w.norm()) for k, w in ref.items()
           if w.norm() > 0 and not k.endswith("key.bias")}
    worst = worst_of(rel)
    print(f"slice vit_l16_384: backward at batch {VIT_BWD_BATCH} through #14 "
          f"({counts['fused_attention']} launches) vs the plain stack: per-parameter gradient rel diff max {rel[worst]:.3e} "
          f"({worst}) over {len(rel)} parameters (limit {GRAD_REL_TOL})", flush=True)
    if not rel[worst] <= GRAD_REL_TOL:
        fail("vit_l16_384 backward: the gradients through #14 disagree with the plain stack's")
    del grads, kern, ref
    torch.cuda.empty_cache()
    return {"launches": counts, "max_grad_rel": rel[worst], "max_grad_rel_param": worst,
            "params": len(rel)}


def sp_forward(sl, sp, rank: int, name: str, opts: dict, inference_only: bool, card):
    """A forward at batch BATCH under sequence parallelism, on every rank:
    its launches against expected_sp_launches, the tokens equal across the
    ranks, and (on rank 0) against the unsharded plain forward from the
    same weights, batch and gumbel noise: greedy-token agreement, and for
    full-eval the ref / neg scores on the rows with equal tokens.  Serving
    also times the SP forward against the unsharded kernel forward, in
    turns, and one all-gather of a rank's rows."""
    import numpy as np
    import torch

    from vitxtgqa_tpu_torch.ops import _build
    from vitxtgqa_tpu_torch.parallel import collectives as C
    from vitxtgqa_tpu_torch.serving.engine import group_generator, to_device
    from vitxtgqa_tpu_torch.utils.synthetic import synthetic_batch

    dev = sl.dev
    model = sl.model(inference_only, sp=sp, **opts)
    batch = synthetic_batch(batch=BATCH, num_final_outputs=sl.nf, seed=0 if inference_only else 1)
    tb = to_device(batch, dev)
    forward_ms(model, batch, dev, reps=1)  # warm-up
    _build.reset_launch_counts()
    with torch.inference_mode():
        out = model(tb, group_generator(0, 0, dev))
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    want = expected_sp_launches(sl.cfg, BATCH, model.opts, full_eval=not inference_only)
    if counts != want:
        fail(f"slice {name}, rank {rank}: launches {counts}, expected {want}")
    scores = {k: v.float().cpu().numpy() for k, v in out.items()
              if k in ("ref_scores", "pos_scores", "neg_scores")}
    tok = scores["pos_scores"].argmax(-1)
    every = C.gather_objects(tok.tolist())
    if any(t != every[0] for t in every):
        fail(f"slice {name}: the ranks' tokens differ")
    summary = {"launches": counts, "expected": want}
    if rank == 0:
        for k, v in scores.items():
            if v.shape != (BATCH, DEC_LEN, sl.nf) or not np.isfinite(v).all():
                fail(f"slice {name}: {k} {v.shape}, finite {np.isfinite(v).all()}")
        plain = sl.model(inference_only, plain=True, **opts)
        with torch.inference_mode():
            ref = plain(tb, group_generator(0, 0, dev))
        del plain
        want_s = {k: v.float().cpu().numpy() for k, v in ref.items() if k in scores}
        tok_p = want_s["pos_scores"].argmax(-1)
        agree = float((tok == tok_p).mean())
        same = (tok == tok_p).all(-1)
        diffs = {k: float(np.abs(scores[k][same] - want_s[k][same]).max()) if same.any() else None
                 for k in ("ref_scores", "neg_scores") if k in scores}
        print(f"slice {name}: {SP_RANKS} ranks on one card, launches per rank " + json.dumps(
            {k: v for k, v in counts.items() if v}) + f" (as derived); tokens equal across ranks; "
              f"SP kernels vs unsharded plain: greedy-token agreement {agree:.4f} (min "
              f"{MIN_TOKEN_AGREEMENT})" + (f"; on the {int(same.sum())} rows with equal tokens "
              f"max|d ref/neg scores| {diffs} (tol {REFNEG_TOL})" if diffs else ""), flush=True)
        if agree < MIN_TOKEN_AGREEMENT or (diffs and (
                not same.any() or not all(d <= REFNEG_TOL for d in diffs.values()))):
            fail(f"slice {name}: the SP kernels disagree with the unsharded plain versions")
        summary.update(token_agreement=agree, refneg_max_abs_diff=diffs)
    if inference_only:
        sp1 = forward_ms(model, batch, dev, reps=SP_REPS)
        un = []
        if rank == 0:
            unsharded = sl.model(inference_only, **opts)
            forward_ms(unsharded, batch, dev, reps=1)
            un = forward_ms(unsharded, batch, dev, reps=2 * SP_REPS)
            del unsharded
        C.synchronize()
        sp2 = forward_ms(model, batch, dev, reps=SP_REPS)
        rows = torch.randn(BATCH, L_JOINT // SP_RANKS, 12, 64, device=dev).to(torch.bfloat16)
        gather = []
        for _ in range(5):
            torch.cuda.synchronize()
            t = time.perf_counter()
            C.all_gather(rows, sp.group, dim=1)
            torch.cuda.synchronize()
            gather.append((time.perf_counter() - t) * 1e3)
        if rank == 0:
            print(f"slice {name}: forward latency at batch {BATCH}: SP over {SP_RANKS} ranks "
                  f"median {statistics.median(sp1 + sp2):.2f} ms (all "
                  f"{[round(x, 2) for x in sp1 + sp2]}), "
                  f"unsharded kernels median {statistics.median(un):.2f} ms; one all-gather of "
                  f"a rank's [{BATCH}, {L_JOINT // SP_RANKS}, 12, 64] bf16 rows median "
                  f"{statistics.median(gather):.3f} ms; card {card}", flush=True)
            summary.update(sp_forward_ms_all=sp1 + sp2, unsharded_forward_ms_all=un,
                           all_gather_ms_all=gather)
    del model
    torch.cuda.empty_cache()
    return summary


def sp_train(sl, sp, rank: int, card):
    """k(iii). One training step at batch TRAIN_CHECK_BATCH with the QTV and
    MMT attention dropout at SP_TRAIN_ATTENTION_DROPOUT (the model config;
    hidden dropout stays), remat "attn", under sequence parallelism on every
    rank: its launches, the loss and gradient norm equal across the ranks,
    and (rank 0) against the unsharded plain step from the same weights,
    batch, gumbel noise and dropout generator: loss, gradient norm and every
    parameter's gradient within the training step's limits."""
    import copy

    import torch

    from vitxtgqa_tpu_torch import Options
    from vitxtgqa_tpu_torch.losses import Losses
    from vitxtgqa_tpu_torch.parallel import collectives as C
    from vitxtgqa_tpu_torch.serving.engine import to_device
    from vitxtgqa_tpu_torch.utils.synthetic import synthetic_batch

    cfg = copy.deepcopy(sl.cfg)
    for sect in ("translayers", "mmt"):
        cfg[sect]["attention_probs_dropout_prob"] = SP_TRAIN_ATTENTION_DROPOUT
    slt = sl.with_cfg(cfg)
    losses = Losses(cfg["losses"])
    batch = synthetic_batch(batch=TRAIN_CHECK_BATCH, num_final_outputs=sl.nf, seed=2)
    tb = to_device(batch, sl.dev)
    kern = train_check_step(slt, tb, losses, plain=False, sp=sp)
    want = expected_sp_launches(cfg, TRAIN_CHECK_BATCH, Options(device=sl.dev), train=True)
    if kern[3] != want:
        fail(f"slice k(iii), rank {rank}: launches {kern[3]}, expected {want}")
    every = C.gather_objects([kern[0], kern[1]])
    if any(e != every[0] for e in every):
        fail(f"slice k(iii): the ranks' loss and gradient norm differ: {every}")
    summary = {"launches": kern[3], "expected": want}
    if rank == 0:
        plain = train_check_step(slt, tb, losses, plain=True)
        loss_rel, norm_rel, (grad_rel, worst), n, ok = step_agreement(kern, plain)
        print(f"slice k(iii): a batch-{TRAIN_CHECK_BATCH} step over {SP_RANKS} ranks, launches per "
              "rank " + json.dumps({k: v for k, v in kern[3].items() if v}) + " (as derived); "
              f"loss {kern[0]:.6f} vs unsharded plain {plain[0]:.6f} (rel {loss_rel:.3e}), "
              f"gradient norm rel {norm_rel:.3e}, per-parameter gradient rel diff max "
              f"{grad_rel:.3e} ({worst}) over {n} parameters (limits {LOSS_REL_TOL}, "
              f"{GNORM_REL_TOL}, {GRAD_REL_TOL}); card {card}", flush=True)
        if not ok:
            fail("slice k(iii): the SP step disagrees with the unsharded plain step")
        summary.update(loss=[kern[0], plain[0]], loss_rel=loss_rel, grad_norm_rel=norm_rel,
                       max_grad_rel=grad_rel, max_grad_rel_param=worst)
        del plain
    del kern
    torch.cuda.empty_cache()
    return summary


def sp_rank(rank: int, directory: str, card: str):
    """One rank of slice k (torch.multiprocessing.spawn's target): joins the
    gloo group (a file:// rendezvous in ``directory``) on cuda:0, builds
    the shared weights and runs k(i)-(iii) with every other rank; rank 0
    writes its summary to ``directory``."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from vitxtgqa_tpu_torch.parallel.mesh import build_sp_group

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{directory}/rendezvous", rank=rank,
                            world_size=SP_RANKS)
    try:
        sp = build_sp_group(SP_RANKS)
        sl = Slices(dev, quiet=True)
        out = {"k_i_serving_int8_b8": sp_forward(sl, sp, rank, "k(i) sp_serving_int8_b8",
                                                 dict(kv_cache_int8=True), True, card),
               "k_ii_full_eval_int8_b8": sp_forward(sl, sp, rank, "k(ii) sp_full_eval_int8_b8",
                                                    dict(kv_cache_int8=True), False, card),
               "k_iii_train_b4": sp_train(sl, sp, rank, card)}
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(os.path.join(directory, "rank0.json"), "w") as f:
            json.dump(out, f)


def sp_slice(record, card):
    """k. Sequence parallelism: SP_RANKS ranks (torch.multiprocessing.spawn,
    gloo, both on cuda:0) run k(i) serving and k(ii) full-eval with the int8
    cache at batch 8, and k(iii) a training step at batch 4 (sp_rank); a
    failing rank fails the script.  The launches of rank 0 go to the
    record."""
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as directory:
        t0 = time.perf_counter()
        mp.spawn(sp_rank, args=(directory, card), nprocs=SP_RANKS, join=True)
        with open(os.path.join(directory, "rank0.json")) as f:
            out = json.load(f)
    for name, summary in out.items():
        count_launches(f"slice {name}", record, summary["launches"], summary["expected"])
    out["wall_s"] = time.perf_counter() - t0
    print(f"slice k: {SP_RANKS} ranks done in {out['wall_s']:.1f} s", flush=True)
    return out


def default_options_check(sl, model, batch, record):
    """A serving forward at batch BATCH from a model built with
    Options(kv_cache_int8=True) and nothing else (the card and, by default
    there, bf16) equals slice a's forward on the same batch and noise."""
    import torch

    from vitxtgqa_tpu_torch import Options
    from vitxtgqa_tpu_torch.models.t2s import T2S
    from vitxtgqa_tpu_torch.ops import _build
    from vitxtgqa_tpu_torch.serving.engine import group_generator, to_device

    default = T2S(sl.cfg, sl.nf, bos_idx=2, opts=Options(kv_cache_int8=True))
    default.load_state_dict(sl.state)
    tb = to_device(batch, sl.dev)
    _build.reset_launch_counts()
    with torch.inference_mode():
        got = default(tb, group_generator(0, 0, sl.dev))["pos_scores"]
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        want = model(tb, group_generator(0, 0, sl.dev))["pos_scores"]
    count_launches("slice int8_b8, default Options", record, counts,
                   expected_launches(sl.cfg, BATCH, default.opts))
    equal = bool(torch.equal(got, want))
    print(f"slice int8_b8: a model built with Options(kv_cache_int8=True) alone runs in "
          f"{default.opts.dtype} on {default.opts.device}; its batch-{BATCH} scores equal slice "
          f"a's bit for bit: {equal}", flush=True)
    if not equal:
        fail("the default Options' forward differs from slice a's")
    return {"dtype": str(default.opts.dtype), "launches": counts, "scores_equal": equal}


def run_slices(dev, record, card):
    import torch

    from vitxtgqa_tpu_torch.serving.engine import ServingEngine, group_generator, to_device
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
    details["int8_b8_default_options"] = default_options_check(sl, model, batch, record)
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

    # f. the serving preset (int8 cache + compact serving): batch 8 (per-layer
    # decode), buckets (1, 2) (the step kernel, epilogue in PyTorch); batch-1
    # latency against the exact geometry, in turns
    preset = dict(kv_cache_int8=True, compact_serving=True)
    model, details["serving_preset_b8"] = serve_slice("serving_preset_b8", sl, record, preset,
                                                      [BATCH])
    del model
    compact, details["serving_preset_b1_b2"] = serve_slice("serving_preset_b1_b2", sl, record,
                                                           preset, [1, 2])
    exact = sl.model(kv_cache_int8=True)
    sub = {k: v[:1] for k, v in batch.items()}
    forward_ms(compact, sub, dev, reps=2)  # warm-up
    forward_ms(exact, sub, dev, reps=2)
    c1, e1 = forward_ms(compact, sub, dev), forward_ms(exact, sub, dev)
    e2, c2 = forward_ms(exact, sub, dev), forward_ms(compact, sub, dev)
    cm, em = statistics.median(c1 + c2), statistics.median(e1 + e2)
    print(f"slice serving_preset_b1_b2: forward latency at batch 1: compact median {cm:.2f} ms "
          f"(min {min(c1 + c2):.2f}), exact median {em:.2f} ms (min {min(e1 + e2):.2f}); "
          f"card {card}", flush=True)
    details["serving_preset_b1_b2"]["latency_b1"] = {
        "compact_ms_all": c1 + c2, "exact_ms_all": e1 + e2, "compact_ms_median": cm,
        "exact_ms_median": em}
    del compact, exact

    # g. W8A8 at batch 8: int8 cache, bf16 cache, and int8 + compact; its
    # greedy tokens against the bf16 block's on the same batch (random
    # weights: printed)
    tb = to_device(batch, dev)
    for name, opts in (("w8a8_b8", dict(kv_cache_int8=True)), ("w8a8_bf16_cache_b8", {}),
                       ("w8a8_compact_b8", dict(kv_cache_int8=True, compact_serving=True))):
        model, details[name] = serve_slice(name, sl, record, dict(w8a8=True, **opts), [BATCH])
        bf16_block = sl.model(**opts)
        with torch.inference_mode():
            tok = model(tb, group_generator(0, 0, dev))["pos_scores"].argmax(-1)
            tok_bf = bf16_block(tb, group_generator(0, 0, dev))["pos_scores"].argmax(-1)
        agree = (tok == tok_bf).float().mean().item()
        lat, lat_bf = forward_ms(model, batch, dev), forward_ms(bf16_block, batch, dev)
        print(f"slice {name}: greedy-token agreement with the bf16 block {agree:.4f} (no limit: "
              f"random weights); forward median {statistics.median(lat):.2f} ms, bf16 block "
              f"{statistics.median(lat_bf):.2f} ms; card {card}", flush=True)
        details[name].update(bf16_block_token_agreement=agree, forward_ms_all=lat,
                             bf16_block_forward_ms_all=lat_bf)
        del model, bf16_block
    torch.cuda.empty_cache()

    details["full_eval_b8"] = full_eval_slice(sl, record, card)
    # h. compact full-eval
    details["compact_full_eval_b8"] = full_eval_slice(sl, record, card, compact=True)
    # i. the int8 kernels' module entry points
    details["module_entries"] = module_entry_slice(sl, record)
    torch.cuda.empty_cache()
    # j. frames to answer through ViT-L/16, and the ViT at 384 px
    details["vit_l16"] = vit_slice(sl, record, card)
    details["vit_l16_384"] = vit_module_entry(dev, record)
    details["vit_l16_384_backward"] = vit_backward_check(dev, record)
    details["train"] = train_slice(sl, record, card)
    del sl
    torch.cuda.empty_cache()
    # k. sequence parallelism, on SP_RANKS processes
    details["sp"] = sp_slice(record, card)
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
    print("build: the flash backward body (csrc/flash_bwd.cuh): " + "; ".join(
        f"{name} {regs} registers, spill stores / loads {st} / {ld} bytes"
        for name, regs, st, ld in _build.ptxas_kernels(log, "flash_attention_bwd.cu")),
        flush=True)

    record = {}
    check_kernels(dev, record)
    details = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
               "build_s": build_s, "kernels": record}
    details["serving_mode_kernels"] = check_serving_mode_kernels(dev, record)
    details["vit_kernels"] = check_vit_kernels(dev, record)
    details["training_kernels"] = check_training_kernels(dev, record)
    details["sp_kernels"] = check_sp_kernels(dev, record)
    check_padded_keys(dev, record)
    details["slices"] = run_slices(dev, record, card)
    out_dir = argv[argv.index("--out") + 1] if "--out" in argv else os.path.join(ROOT, "build")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(details, f, indent=1)

    kernels = [
        {"name": name, "route": "cuda", "source": SOURCE[name], "replaces": REPLACES[name],
         **{key: record[name].get(key) for key in ("launches", "max_abs_err", "ms", "plain_ms",
                                                   "bound_ms", "bound_by", "library_ms")}}
        for name in REPLACES
    ]
    for k in kernels:
        if not k["launches"]:
            fail(f"{k['name']} was never launched on the driven paths")
        if k["ms"] is None or k["bound_ms"] is None:
            fail(f"{k['name']} has no time or bound")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
