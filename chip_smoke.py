#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's T2S serving, full-eval and training paths,
its ViT frame-feature path, its sequence-parallel path, its runtime
(train, validate, checkpoint, resume, predict), the zoo's T2S-family
models, its selector baselines (TranSTR, MIST), its data parallelism, its
serving demo and raw-video pipeline, and the legacy image-VQA zoo once on
one NVIDIA GPU.

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
     CUDA-event times of both.  The decode attention (#4 int8, #7 bf16
     cache; check_decode_attention) at batch 1, 8 and 64 over 1152 keys,
     the compact [8, 384] and a ragged [8, 300], steps 0 and 11, each on
     the serving mask and with a batch row whose only allowed keys are the
     decoder slots; at [8, 1152] step 11 warm and cold (caches in turn, so
     none is left in the L2), with SDPA beside each, and its launch plan's
     cudaOccupancyMaxActiveClusters.  The decode step's attention is planted
     (PLANTED / BACKGROUND / TRAP) so that reading a slot it must not read
     moves its output by far more than the tolerance.  The training
     kernels at L 1152, 12 heads, batch 4 (rows 4608): the flash forward
     with dropout 0.1 (dec_len 0 and 12) and its backward (rate 0 and
     0.1), the block forward (5 outputs) and backward (12 gradients,
     against autograd through block_train_plain), all with the same
     seed-regenerated masks as their twins; the in-kernel keep rate over
     >= 10^7 draws and the forward / backward stream equality; then again
     at the training step's own shapes: the flash pair at [48, 1152, 768]
     with the MMT mask; the block pair (check_block_kernels) at 4,608,
     55,296 rows (QTV, MMT), 960 (text BERT) and the ragged 1,000 and
     9,000, rate 0 and 0.1, against the twins on the same inputs, its
     emitted masks equal to the twin's and two backward calls equal bit
     for bit, timed at 55,296 and 960, and again at the FFN width 3,200
     (narrow GEMM tiles) at 4,608 and 1,000 rows.  The eval block and its
     tanh form (check_eval_block: EVAL_BLOCK_CASES) at 9,216, 2,304,
     3,072 and the ragged 2,100 rows, at the FFN width 3,200, with an
     LN1 output at 64 + O(1) that an f32 second residual must keep, and at
     the 55,296 rows of a forward at batch 48 (slice p).  The serving
     modes' kernels: the W8A8 block (check_w8a8_block: W8A8_CASES, 9,216,
     3,072, 2,304 and the ragged 2,100 rows; its ctx quantization bit for
     bit, its h8 bit for bit the twin's from its own x8, its s8 products
     alone bit for bit the exact sums at S8_PRODUCT_CASES; the bf16 block
     timed on the same inputs), the int8-emitting flash forward at [8,
     1152, 768] (its int8 cache and scales bit for bit, #1 timed on the
     same inputs), the int8 pointer scores (check_ptr_scores: PTR_CASES,
     batch 1, 8 and 576 over 960 slots and batch 1 and 8 over 961; on
     integer q bit for bit; timed warm and cold beside the bf16-key
     einsum, a yardstick; its SASS holds no I2F: check_no_i2f), and the
     decode step again at the compact cache length 384 (batch 1
     and 2; at 1,152 keys batch 1, 2 and 8; steps 0 and 11; timed warm
     and cold).  The fused epilogue first at batch 2, 1, 2, 8, 3, 8 in
     turn (check_epilogue_batch_order: each instantiation at its largest
     batch after a smaller one), then (check_fused_epilogue) at batch 1, 2
     and 8, random and with a planted tie of two classifier rows in two
     blocks' shares (the lower must win) and a planted OCR row, its pad
     lanes exactly -1e30, timed warm and cold beside its two GEMVs as
     torch.matmul (a yardstick).  The
     ViT's kernels: the fused FFN (check_ffn: FFN_CASES) at ViT-L/16's
     12,608 rows, ViT-B/32's 3,200, ViT-L/16 384 px's 4,616 and at widths
     of 1,152, the bias-tensor attention on split-head
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
     row at 577 keys.  The decode kernels at the zoo's geometries
     (check_zoo_geometries, zoo_masks): #4 and #7 at batch 8 over M4C's
     1,024 slots (the question, the middle frame, its <= 15 OCR slots: ~36
     allowed keys) and wo_sg's compact 128, steps 0 and 11, with a row whose
     only keys are the decoder slots; #5 at batch 1 and 2 over both, its
     attention planted; each timed at step 11.  The same at the selector
     baselines' geometries (selector_masks): TranSTR's 1,024 slots, where
     an encoder row has 2 allowed keys (the fused frame and one grounded
     OCR slot, row 0's in the last 64-key tile; a row with 1), and MIST's
     1,152 with a frame-mask entry of 2.0 (a frame picked twice), with #1
     (rate 0 and 0.1) and #1b at batch 4 on both (check_selector_flash);
     on MIST's, each of #1, #1b, #4, #7 and #5 also against itself on the
     mask clipped to 1 (an entry > 0 is one allowed key).  Each kernel's
     bound (bytes over 3.35 TB/s or operations over the peak of their
     type: 989 TFLOP/s bf16, 1,979 TOP/s int8, 67 TFLOP/s f32) is
     computed from the inputs of its timed call, and one
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
          the unsharded one and one all-gather's time;
       l. the runtime (vitxtgqa_tpu_torch.run) on a fixture tree written at
          run time (4 train, 2 val, 2 test videos of 1,024-d ViT features,
          3 questions each), configs/t2s_abinet.yml's model and worker
          processes, batch 2, bf16: (i) run() trains 3 steps with a
          validation probe each, the snapshot's and the final validation,
          ckpt/best and ckpt/final, the six val/ metrics in [0, 1]; (ii)
          the trainer's first step through the kernels against the plain
          versions from the same weights, batch and generators (the loss
          and the gradient norm, RUNTIME_LOSS_REL_TOL /
          RUNTIME_GNORM_REL_TOL, and every parameter's gradient, the
          training step's limit), the plain step with each planted fault
          outside those limits, and each form's distance from the float32
          step printed (RUNTIME_STEP_FORMS: also the kernels with #1 / #1b
          or #9a / #9b run through their twins); (iii) a resume from
          ckpt/best: iteration, epoch position and parameters restored bit
          for bit, one more step; (iv) predictions on the test split with
          configs/t2s_serving.yml at batch 2 and 6, the EvalAI JSON's
          schema; (v) the recompute decode oracle at production width,
          serving and full-eval, its tokens and scores against the cached
          decode's; each part's launches as derived, and the host-clock ms
          of every iteration and validation pass and the data-wait share
          printed.
       m. the zoo's T2S-family models (wo_tg, wo_sg, M4C, T5-ViteVQA, GT-box)
          at their shipped configs' model blocks, bf16, random weights: (i)
          each served at batch 2 (int8: #5 / #6) and 8 (int8: #4; bf16:
          #7) against the plain versions (M4C's, T5's and GT-box's grounding
          bit for bit), its forward latency at 2 and 8; (ii) the serving
          preset on the ablations on a batch with a 2-frame row (wo_sg's
          gather list -1-padded, through the trash-slot scatter; compact
          over 128 slots at 2 and 8, held against the exact geometry; wo_tg
          falls back to the full decode); (iii) the ablations' full-eval at
          2; (iv) M4C's training step at batch 4 against the plain step at
          slice e's limits, then a timed step at 48; (v) run() on fixtures
          (no worker processes): M4C train+val 2 iterations, GT-box val on
          the annotations; (vi) M4C's recompute oracle at batch 2;
       n. the selector baselines TranSTR (configs/transtr_abinet.yml: the
          MMT over 1,024 rows with no question rows) and MIST
          (configs/mist_abinet.yml: 1,152 rows, its frame mask summed over
          gumbel picks with replacement), bf16, random weights: (i) each
          served at batch 2 (int8: #5 / #6) and 8 (int8: #4; bf16: #7)
          against the plain versions, the grounding bit for bit, its
          forward latency at 2 and 8; (ii) its training step at batch 4
          against the plain step at slice e's limits, then one at 48 (#1's
          dropout form, #1b, #9a, #9b); (iii) its recompute oracle at
          batch 2; (iv) run() train+val for both, 2 iterations each;
       o. data parallelism over 2 ranks (torch.multiprocessing.spawn,
          gloo, both on the one card; the kernels built before the ranks
          start), the production T2S at the global batch 48, 24 rows a
          rank: (i) one step with every dropout 0 and the gumbel draws of
          the step's shared generator (each rank its rows of the global
          draw) against the one-process step at 48 from the same weights
          and batch (odd rows with one active decode step: the ranks'
          loss-mask counts differ) at slice e's limits, loss, gradient
          norm and every parameter's applied gradient, the ranks'
          parameters after the update equal, each rank's launches as
          derived; the same step with each planted fault (DP_FAULTS)
          outside the limits; (ii) 4 steps with the config's dropout:
          each rank's ms a step, ms of one all-reduce of the float32
          gradients (gloo: through the host, a capability) and peak
          memory; (iii) ``python -m torch.distributed.run --standalone
          --nproc_per_node 2 -m vitxtgqa_tpu_torch.run ...
          training_parameters.distributed_init=True`` on slice l's
          fixtures (3 iterations at global batch 4, validation,
          predictions, dropout 0) against run() in this process: each
          iteration's loss within slice l's limit, rank 0's one log file
          and checkpoints, each test question predicted once, no process
          left (dp_cli_faults); (iv) (i) on NCCL with a card a rank where
          the machine has 2 cards, else a line saying why it did not run;
       p. serving as users run it (the production T2S, bf16, random weights
          from seed 0): (i) the engine at the serve demo's largest bucket,
          int8 cache: 48 requests as one group, then 8 as one, each
          group's responses its direct forward's rows bit for bit
          (engine_row_faults) and that forward against the plain versions
          at slice a's limits, save at most 2 rows of 48 (none of 8) whose
          OCR top-k flipped on a near tie, each held at those limits
          against plain on the kernels' grounding and its margins printed
          (near_tie_faults, swap_margins); each forward's latency at 48
          and 8 and its peak memory; (ii) ``python -m vitxtgqa_tpu_torch.serve``'s
          serve() at the JAX tool's defaults (buckets 8, 48; 8 client
          threads, 96 requests): as many responses as requests, each
          finite and of its shape, the group sizes adding up to the
          requests and none above 48 (serve_demo_faults), the launches
          derived from the groups, the JSON line and the share of the
          features' host-to-device copy; (iii) ``python -m
          vitxtgqa_tpu_torch.e2e_pipeline``'s stages on two videos of 64
          frames at 1280 x 720 with 15 OCR detections a frame and 3
          questions each (pipeline_slice): stage 1 where cv2 imports, on
          clips cv2 writes (else a line saying so, and Pillow's jpgs);
          stage 2 on the card against the plain path (slice j's limit);
          stage 3; stage 4 with configs/t2s_abinet.yml (its worker
          processes) and configs/t2s_serving.yml, every question once in
          the EvalAI schema (prediction_faults) and the answers against the
          plain versions on the trainer's weights (>= 0.8); use_pallas=false
          raising on the card; stage 4 from a reference .pth (dead names
          planted, {"model": ...}, ``module.`` prefixes, ``classifier.*``)
          equal bit for bit to stage 4 from the port's torch file of the
          same weights; each stage's seconds;
       q. the legacy image-VQA zoo (pythia and its question-only /
          image-only ablations, LoRRA, BAN, top-down bottom-up; plain
          PyTorch, no kernel may launch) at configs/pythia_vqa2.yml's /
          lorra_textvqa.yml's widths (vocab 100,000 x embed 300, hidden
          1,024), 14 question tokens, batch 128, MMF's features (VQA2's 100
          fc6 boxes and 196 resnet152 cells of 2,048; TextVQA's 137 boxes,
          50 OCR tokens of 300), 3,129 / 8,000 + 50 answers: (i) each
          model's eval forward and a training step with dropout off in
          bf16 against the same weights in float32 (the argmax agreement
          printed; the loss, the gradient norm and every non-scalar
          parameter's relative gradient difference at LEGACY_*_REL_TOL),
          each planted fault (LEGACY_FAULTS: LSTM / GRU gates swapped,
          weight norm over rows, a dropped bias gradient) outside the
          limits and every limit catching one; (iii) 4 Adamax steps timed
          (the config's optimizer and schedule, dropout on), the eval
          forward's ms and the peak memory; (ii) run() on synthetic VQA2 /
          VizWiz / TextVQA trees it writes (utils/legacy_fixtures, 8
          worker processes): pythia on vqa2 and LoRRA on textvqa (3
          iterations, validation, EvalAI records of val and test), pythia
          on vqa2,vizwiz (6 iterations), its dataset schedule against the
          port's MultiDataset on the same seed.
     a-c, f-g, m, n and p serve behind a ServingEngine; each slice checks its
     launch counts (derived from the gates), the outputs' shapes and finiteness,
     and the same inputs through the plain versions on the card.
The line before the last is the kernels' JSON record, the one before it the
card's name and power limit, the last line ``{"ok": true, "device":
{...}}``.  Details go to DIR/chip_smoke.json (default DIR: build/).
Without a CUDA device it exits 2 and prints no result.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
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
# a cache length no decode launch plan splits evenly (the JAX wrapper pads
# it to 384); the H100's L2, which the cold decode timings overflow
RAGGED_L, L2_BYTES = 300, 50 * 2 ** 20

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
# ... and at most half of the 64 values of any head's K or V slice of a
# quantized row moved (the kernel on the H100 read at most 11 at batch 8;
# a whole head moved is a kernel fault, not rounding)
ROW8_HEAD_MOVED = 32
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
# the block kernels (#9a, #9b) are also held at two ragged row counts:
# 1,000 (a last 128-row tile of 104 rows, one split of the weight
# gradients' reduction) and 9,000 (a last tile of 40 rows; four splits of
# the rows, the last of 2,088: ops/block_train.launch_plan)
BLOCK_RAGGED_ROWS = (1000, 9000)
# ... and at the FFN width 3,200, no multiple of 256: every product of a
# launch over it takes the narrow 128-column tile (ops/gemm_sm90.py)
BLOCK_NARROW_M, BLOCK_NARROW_ROWS = 3200, (4608, 1000)
# the eval block (#2, #3), (rows, FFN width, LN1 shift): the serving
# batch's 9,216 rows (the kernels' record), batch 2's 2,304, the compact
# MMT's 3,072 (384 rows a video at batch 8), a ragged 2,100 (a last
# 128-row tile of 52 rows) at the FFN width 3,200 (narrow tiles), and
# 2,100 rows whose LN1 output sits at 64 + O(1) under a weak FFN (W2 at a
# tenth of the scale): there a kernel that rounded x to bf16 before the
# second residual, where the Pallas kernel keeps it in f32, would move the
# output by up to half a bf16 step at 64 (0.25) over an O(1) spread; and
# before it the 55,296 rows of a forward at the serve demo's bucket 48
# (slice p)
EVAL_BLOCK_CASES = ((9216, 3072, 0.0), (2304, 3072, 0.0), (3072, 3072, 0.0), (2100, 3200, 0.0),
                    (48 * 1152, 3072, 0.0), (2100, 3072, 64.0))
# the W8A8 block (#8), (rows, FFN width): the serving batch's 9,216 rows (the
# kernel's record), the compact MMT's 3,072, batch 2's 2,304 and a ragged
# 2,100 (a last 128-row tile of 52 rows); its s8 products alone, (M, N, K),
# bit for bit against exact integer sums: every product shape of the path,
# ragged M, K = 3,072
W8A8_CASES = ((9216, 3072), (3072, 3072), (2304, 3072), (2100, 3072))
S8_PRODUCT_CASES = ((9216, 768, 768), (9216, 3072, 768), (9216, 768, 3072), (2100, 768, 3072),
                    (300, 3072, 3072))
# the ViT FFN (#13), (rows, d, m, d2, label): ViT-L/16's chunk of 64
# frames at 224 px (the kernel's record), ViT-B/32's, ViT-L/16 at 384 px
# and batch 8 (4,616 rows: a last 128-row tile of 8), and ragged rows at
# FFN and output widths of 1,152, no multiple of 256 (narrow tiles)
FFN_CASES = ((64 * 197, 1024, 4096, 1024, "ViT-L/16"), (64 * 50, 768, 3072, 768, "ViT-B/32"),
             (8 * 577, 1024, 4096, 1024, "ViT-L/16 384 px"), (2100, 768, 1152, 1152, "narrow"))
# the fused epilogue (#6): the classifier's 5,050 answers padded to 5,120
# lanes, 960 OCR slots, hidden and pointer width 768, at batch 1, 2 and 8;
# each batch also with a planted tie: two classifier rows with the same
# weights and a bias of EPI_TIE_BIAS, above every other score, in
# different blocks' shares of the work, of which the lower index must win
# in every batch row but row 1, where a key planted along q scores
# EPI_OCR_SCORE, so that the gather of an OCR row is held too
EPI_V_FIX, EPI_V_P, EPI_N = 5050, 5120, 960
EPI_BATCHES = (1, 2, BATCH)
EPI_TIE_BIAS, EPI_OCR_SCORE = 50.0, 100.0
# check_epilogue_batch_order: a serving process that alternates its buckets
# launches each instantiation of #6 (batch <= 2, batch <= 8) at its largest
# batch, then a smaller one, then the largest again
EPI_ORDER = (2, 1, 2, BATCH, 3, BATCH)
# the int8 pointer scores (#12), (batch, OCR slots): batch 1, the serving
# batch 8 (the kernel's record) and the JAX bench's 576 (425 MB of keys),
# and 961 slots at batch 1 and 8, no multiple of either tile form's keys
# (ops/ptr_scores.launch_plan: 4 and 32), so the last tile holds one key
PTR_CASES = ((1, 960), (8, 960), (576, 960), (1, 961), (8, 961))
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
# slice l: the runtime's batch (the fixtures hold 12 train and 6 val
# questions) and its training steps
RUNTIME_BATCH, RUNTIME_STEPS = 2, 3
# ... and the limits of its first step through the kernels against the
# plain versions (bf16 both) on the fixture batch: the loss and the global
# gradient norm a few times beyond the readings on the H100 (loss 2.7e-5
# to 1.6e-3, norm 3.7e-4 to 2.6e-3; PERF.md lists each run's), every
# parameter's gradient at the training step's GRAD_REL_TOL.  At this batch
# the loss and the norm cannot tell a fault from bf16 rounding: the
# InfoNCE term (weight 1000, temperature 0.1) amplifies the rounding that
# hundreds of identical padded OCR slots make coherent, so every bf16 form
# of the step (RUNTIME_STEP_FORMS) lands up to ~1.6e-3 from the float32
# step, kernels and twins alike, and ~1.4e9 of the norm is one bias's
# gradient (the OCR bbox LayerNorm's constant padded rows).  The
# per-parameter gradients tell them apart (the kernels' largest ~1.5e-2,
# each planted fault's 0.1 or more), and the check rejects each planted
# fault in the run; a step in another precision launches no kernel, which
# the launch check rejects.  Slice e's LOSS_REL_TOL / GNORM_REL_TOL were read on
# its synthetic batch, where random rows average the rounding out.
RUNTIME_LOSS_REL_TOL, RUNTIME_GNORM_REL_TOL = 5e-3, 1e-2
# slice m: the zoo's T2S-family models, each at its shipped config's model
# block (the ablations: configs/t2s_abinet.yml's, t2s_production_config);
# slice n: the selector baselines
ZOO = ("t2s_wo_tg", "t2s_wo_sg", "m4c", "t5vitevqa", "gt_box")
SELECTORS = ("transtr", "mist")
ZOO_CONFIGS = {"m4c": ("m4c_abinet.yml", "m4c"), "t5vitevqa": ("t5vitevqa_abinet.yml", "t5vitevqa"),
               "gt_box": ("gt_box_clipocr.yml", "gt_box"),
               "transtr": ("transtr_abinet.yml", "transtr"), "mist": ("mist_abinet.yml", "mist")}
# the models whose grounding heads see no kernel's output (one MMT pass;
# the 20-row text BERT, the projections and the selectors run no kernel in
# eval): their grounding is held bit for bit against the plain run
SINGLE_PASS = ("m4c", "t5vitevqa", "gt_box") + SELECTORS
# the zoo's new decode geometries: M4C's cache of 1,024 slots (20 question
# rows + 1 frame + 960 OCR slots + the 12 decoder slots, padded), whose
# allowed keys are the question, the frame and the middle frame's <= 15
# OCR slots; wo_sg's compact cache of 128 (20 + 5 frames + 75 OCR slots +
# 12, padded)
L_M4C, L_WO_SG = 1024, 128
# TranSTR's cache: no question rows, its one fused frame, 960 OCR slots and
# the 12 decoder slots, padded; an encoder row's allowed keys are the frame
# and its one grounded OCR slot (kf * ko = 1).  MIST's is T2S's 1,152.
L_TRANSTR = 1024
# the runtime's training steps (slices m (v), n (iv)); the forward
# latencies' repetitions
ZOO_RUNTIME_STEPS, ZOO_REPS = 2, 3
# run() on fixtures: (model, run type) of slice m (v) and slice n (iv)
ZOO_RUNTIME_RUNS = (("m4c", "train+val"), ("gt_box", "val"))
SELECTOR_RUNTIME_RUNS = (("transtr", "train+val"), ("mist", "train+val"))
# slice p: the serve demo's largest bucket (tools/serve.py's SERVE_BUCKETS
# 8,48); the raw-video pipeline's videos: two of 64 frames at 1280 x 720
# (10 fps), 15 OCR detections a frame, 3 questions a video; its stage-4
# configs (the JAX tool's default and the serving preset); the reference's
# dead parameters planted into its .pth (vitxtgqa_tpu/utils/torch_convert.py
# names them); at bucket 48, the rows whose grounding may differ from the
# plain versions' where bf16 noise flips a near tie in the OCR top-k (2 of
# 48 measured with seed 0 on the H100, PERF.md; none at 8), each held
# against plain on the kernels' grounding (near_tie_faults)
SERVE_BUCKET = 48
NEAR_TIE_ROWS = {48: 2, 8: 0}
PIPELINE = dict(videos=2, frames=64, width=1280, height=720, ocr_per_frame=15, questions=3,
                fps=10)
PIPELINE_CONFIGS = ("t2s_abinet.yml", "t2s_serving.yml")
DEAD_NAMES = {"Grounding_Module.frame_attn.weight": (4, 768),
              "spatial_enhance.weight_ih_l0": (32, 768)}


# the T2S family: the QTV, the contrastive variants, full-eval
T2S_FAMILY = ("t2s", "t2s_wo_tg", "t2s_wo_sg")


def encoder_rows(cfg, text_len: int = 20, model: str = "t2s") -> int:
    """The MMT's encoder rows of ``model``: [question | frames | OCR] (M4C:
    the one middle frame; TranSTR: no question, its frame_topk fused
    frames)."""
    g = cfg["grounding"]
    frames = {"m4c": 1, "transtr": g["frame_topk"]}.get(model, g["frame_num"])
    return (0 if model == "transtr" else text_len) + frames + g["frame_num"] * g["ocr_frame_num"]


def joint_lengths(cfg, text_len: int = 20, dec_len: int = DEC_LEN, model: str = "t2s"):
    """(full, compact) joint-sequence rows with the decoder slots, padded to
    a multiple of 128 as the models pad them: the encoder rows
    (encoder_rows) and the rows compact serving keeps, None where the
    model's grounding gives no gather list: T2S's [question | top-k frames
    | top-k OCR slots of every frame], wo_sg's [question | top-k frames |
    every OCR slot of those frames]."""
    g = cfg["grounding"]
    compact = {"t2s": g["frame_num"] * g["ocr_topk"],
               "t2s_wo_sg": g["frame_topk"] * g["ocr_frame_num"]}.get(model)
    pad = lambda n: -(-(n + dec_len) // 128) * 128
    return (pad(encoder_rows(cfg, text_len, model)),
            None if compact is None else pad(text_len + g["frame_topk"] + compact))


def zoo_config(key: str):
    """The model block of ``key`` at production width: T2S's (and its
    ablations') t2s_production_config, the others' from their shipped
    configs (ZOO_CONFIGS), as plain dicts."""
    from vitxtgqa_tpu_torch.models.t2s import t2s_production_config

    if key in T2S_FAMILY:
        return t2s_production_config()
    from vitxtgqa_tpu_torch.core.config import build_config

    config, block = ZOO_CONFIGS[key]
    return build_config(os.path.join(ROOT, "configs", config)).model_attributes[block].to_dict()


def model_class(key: str):
    """The port's registered model class of ``key``."""
    from vitxtgqa_tpu_torch.core.registry import registry
    from vitxtgqa_tpu_torch.run import setup_imports

    setup_imports()
    return registry.get_model_class(key)


def encode_launches(out: dict, opts, tc, batch: int, seq: int, tanh_last: int) -> None:
    """Add one eval encode's launches to ``out``: per layer of the stack
    ``tc`` over ``batch`` sequences of ``seq`` rows, flash where the keys
    reach MIN_KV; where the rows reach the fused block's gate, the W8A8
    block under Options.w8a8, else the fused block (the last layer in its
    tanh form if ``tanh_last``)."""
    from vitxtgqa_tpu_torch.ops import fused_block as FB
    from vitxtgqa_tpu_torch.ops.attention import MIN_KV

    n = tc.num_hidden_layers
    if seq >= MIN_KV:
        out["flash_attention_merged"] += n
    if FB.kernel_ok(tc.hidden_size, tc.intermediate_size, batch * seq):
        if opts.w8a8:
            out["fused_block_w8a8"] += n
        else:
            out["fused_block"] += n - tanh_last
            out["fused_block_tanh"] += tanh_last


def expected_launches(cfg, batch: int, opts, full_eval: bool = False, text_len: int = 20,
                      dec_len: int = DEC_LEN, model: str = "t2s") -> dict:
    """Kernel launches in one eval forward of ``model``, derived from the
    port's gates.  In each QTV (the T2S family only) and MMT encode layer:
    flash where the joint sequence has >= 256 keys; where the rows reach the
    fused block's gate, the W8A8 block under Options.w8a8, else the fused
    block (the last QTV layer in its tanh form).  The MMT encodes the
    compact sequence under compact serving where the model compacts
    (``_compact_ok``: T2S, wo_sg's serving decode).  Per decode step: with
    the int8 cache at batch <= the cap and no W8A8, the fused step and (not
    compact) the fused epilogue; else one decode attention per MMT layer
    (the bf16 one only at >= 256 keys).  With ``full_eval`` (the T2S
    family) the teacher-forced pass at 2B over the full sequence, or under
    compact full-eval (T2S only) ref at B over it and neg at B over the
    compact one.  No training kernel, and no #11 / #12 (the decode keeps
    the separate quantize pass and bf16 pointer keys, as JAX does)."""
    from vitxtgqa_tpu_torch.models.common import TransformerConfig
    from vitxtgqa_tpu_torch.ops.attention import MIN_KV

    mmt = TransformerConfig.from_config(cfg["mmt"])
    l_full, l_compact = joint_lengths(cfg, text_len, dec_len, model)
    compact = (opts.compact_serving and l_compact is not None
               and not (full_eval and model != "t2s"))
    l_mmt = l_compact if compact else l_full
    out = {name: 0 for name in REPLACES}
    encode = functools.partial(encode_launches, out, opts)
    if model in T2S_FAMILY:
        encode(TransformerConfig.from_config(cfg["translayers"]), batch, l_full, 1)
    encode(mmt, batch, l_mmt, 0)
    fused = (opts.fused_decode and opts.kv_cache_int8 and not opts.w8a8
             and batch <= opts.fused_decode_max_batch)
    if fused:
        out["fused_decode_step"] += dec_len
        out["fused_epilogue"] += 0 if compact else dec_len
    elif opts.kv_cache_int8:
        out["decode_attention_int8"] += mmt.num_hidden_layers * dec_len
    elif l_mmt >= MIN_KV:
        out["decode_attention"] += mmt.num_hidden_layers * dec_len
    if full_eval and compact:
        encode(mmt, batch, l_full, 0)
        encode(mmt, batch, l_compact, 0)
    elif full_eval:
        encode(mmt, 2 * batch, l_full, 0)
    return out


def expected_recompute_launches(cfg, batch: int, opts, full_eval: bool = False,
                                text_len: int = 20, dec_len: int = DEC_LEN,
                                model: str = "t2s") -> dict:
    """Kernel launches in one forward of the recompute decode oracle
    (``decode_recompute=True``): the QTV encode (the T2S family) over the
    joint sequence without decoder slots, then ``dec_len`` teacher-forced
    MMT passes over it with them, at B (serving, and the single-variant
    models) or 3B (full-eval: ref, pos and neg stacked); no decode
    kernel."""
    from vitxtgqa_tpu_torch.models.common import TransformerConfig

    l0 = encoder_rows(cfg, text_len, model)
    out = {name: 0 for name in REPLACES}
    if model in T2S_FAMILY:
        encode_launches(out, opts, TransformerConfig.from_config(cfg["translayers"]), batch,
                        -(-l0 // 128) * 128, 1)
    for _ in range(dec_len):
        encode_launches(out, opts, TransformerConfig.from_config(cfg["mmt"]),
                        3 * batch if full_eval else batch, -(-(l0 + dec_len) // 128) * 128, 0)
    return out


def expected_train_launches(cfg, opts, model: str = "t2s") -> dict:
    """Kernel launches in one training step: per flash-route layer (QTV,
    and MMT in each of the ref / pos / neg passes; the single-variant
    models: the MMT once) the flash forward and backward; per layer (text
    BERT too) the block forward, once more in the backward with remat
    "attn", and the block backward; no eval kernel."""
    family = model in T2S_FAMILY
    n_text = cfg["text_bert"]["num_hidden_layers"]
    n_qtv = cfg["translayers"]["num_hidden_layers"] if family else 0
    n_mmt = cfg["mmt"]["num_hidden_layers"] * (3 if family else 1)
    flash = n_qtv + n_mmt
    blocks = n_text + n_qtv + n_mmt
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


def child_processes() -> list:
    """(pid, command line) of each live process whose parent is this one."""
    me, out = os.getpid(), []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                # the fields after the command's closing parenthesis:
                # state, parent pid, ...
                state, ppid = f.read().rsplit(")", 1)[1].split()[:2]
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace").strip()
        except OSError:  # it ended meanwhile
            continue
        if int(ppid) == me and state != "Z":
            out.append((int(pid), cmd[:160]))
    return out


def stop_child_processes() -> None:
    """Stop the servers that slice l's worker pools and slice k's spawn
    started (the forkserver, the resource tracker), wait for them, and fail
    if any other process this script started is still running."""
    from vitxtgqa_tpu_torch.data.loader import stop_worker_servers

    stop_worker_servers()
    left = child_processes()
    if left:
        fail(f"processes still running at the end: {left}")
    print("processes: none of those this script started is still running", flush=True)


def sync(dev) -> None:
    """Wait for the card (no-op for the CPU of a dry run)."""
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


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


def decode_sdpa_mask(key_mask, step: int, write_offset: int = WRITE_OFFSET):
    import torch

    slot = torch.arange(key_mask.shape[1], device=key_mask.device)
    dec = (slot >= write_offset) & (slot <= write_offset + step)
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


def row8_head_moved(got, want, num_heads: int = 12) -> int:
    """The most values that moved in any one head's K or V slice of a
    quantized row (row8 [L, B, 1, 2*H*D])."""
    moved = (got.int() != want.int()).reshape(*got.shape[:2], 2 * num_heads, -1)
    return int(moved.sum(-1).max().item())


def check_decode_step(record, x_all, stacks, mask, gen, batches, write_offset: int,
                      keep: bool, timed: bool = True):
    """The decode step over 3 MMT layers at each batch, steps 0 and 11, its
    attention planted (decode_step_cache) over the cache length of
    ``mask``: y against the tolerance, the quantized rows within one int8
    step and 1% of the scale, and at most ROW8_HEAD_MOVED values of any
    head's slice moved.  With ``timed``, at step 11 each batch's time warm
    (the same weights and cache every call) and cold (cold_copies sets of
    weight stacks and caches in turn, so none is left in the L2, as a
    forward's other kernels leave it), with its bound; the batch-1 ones
    kept as the kernel's record when ``keep``.  Returns {shape: times}."""
    import torch

    from vitxtgqa_tpu_torch.ops import decode_step as DS

    dev, h, lp = mask.device, 12, mask.shape[1]
    m, d = stacks["w1"].shape[1:]
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    times = {}
    for step in (0, 11):
        kv8_all, kvs_all = decode_step_cache(x_all, stacks, mask, step, gen, h, write_offset)
        for b in batches:
            kv8, kvs = kv8_all[:, :b].contiguous(), kvs_all[:, :b].contiguous()
            x_t, km = x_all[:b].contiguous(), mask[:b].contiguous()
            buffers = DS.step_buffers(3, b, d, m, dev)
            sargs = (x_t, stacks, kv8, kvs, km, step, write_offset, h)
            got = [t.clone() for t in DS.fused_decode_step(*sargs, buffers=buffers)]
            want = DS.fused_decode_step_plain(*sargs)
            sync()
            err = (got[0].float() - want[0].float()).abs().max().item()
            d8 = (got[1].int() - want[1].int()).abs().max().item()
            head = row8_head_moved(got[1], want[1], h)
            dsc = ((got[2] - want[2]).abs() / want[2].abs()).max().item()
            shape = f"[{b},1,768] x 3 layers, kv8 [3,{b},{lp},1536] step={step}"
            print(f"kernel fused_decode_step {shape}: row8 max|diff| {d8} (tol {ROW8_TOL}), most "
                  f"moved in one head {head} of 64 (tol {ROW8_HEAD_MOVED}), rowsc max rel diff "
                  f"{dsc:.3e} (tol {ROWSC_REL_TOL})", flush=True)
            if not (d8 <= ROW8_TOL and head <= ROW8_HEAD_MOVED and dsc <= ROWSC_REL_TOL):
                fail(f"fused_decode_step quantized rows disagree at {shape}")
            timed_rec = {}
            if timed and step == 11:
                ms = cuda_time_ms(lambda: DS.fused_decode_step(*sargs, buffers=buffers))
                pms = cuda_time_ms(lambda: DS.fused_decode_step_plain(*sargs))
                keys = 3 * (decode_keys(km, step) - b)
                flops = 3 * 2 * b * (4 * d * d + 2 * d * m) + 4 * d * keys
                moved = nbytes(*stacks.values()) + nbytes(x_t, km, *got) + keys * (2 * d + 8)
                bound = bound_of(moved, flops)
                copies = cold_copies(nbytes(*stacks.values(), kv8, kvs))
                sets = [(stacks, kv8, kvs)] + [({k: v.clone() for k, v in stacks.items()},
                                                kv8.clone(), kvs.clone()) for _ in range(copies - 1)]
                cold = cuda_time_cold_ms(lambda st, k8, ks: DS.fused_decode_step(
                    x_t, st, k8, ks, km, step, write_offset, h, buffers=buffers), sets)
                del sets
                print(f"kernel fused_decode_step {shape}: kernel {ms:.4f} ms warm, {cold:.4f} ms "
                      f"cold ({copies} sets in turn), plain {pms:.4f} ms, bound {bound[0]:.4f} ms "
                      f"({bound[1]})", flush=True)
                times[f"[{b},{lp}]"] = dict(warm_ms=ms, cold_ms=cold, plain_ms=pms,
                                            bound_ms=bound[0], cold_copies=copies)
                if b == 1 and keep:  # the record's shape: the fused branch's batch-1 step
                    timed_rec = dict(ms=ms, plain_ms=pms, bound=bound)
            report(record, "fused_decode_step", err, extra=" " + shape, **timed_rec)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return times


def decode_cases(dev):
    """(label, [B, L] encoder key mask, write_offset) of the decode
    attention checks: the serving batch's mask at batch 1, 8 and 64 (its
    rows repeated) over the joint sequence, the compact mask at 384 keys,
    and a ragged cache of RAGGED_L keys (the serving mask's first encoder
    keys, then the decoder slots), which no launch plan splits evenly."""
    import torch
    import torch.nn.functional as F

    mask, _ = serving_masks(dev)
    rows64 = torch.arange(64, device=dev) % BATCH
    ragged = F.pad(mask[:, :RAGGED_L - DEC_LEN], (0, DEC_LEN)).contiguous()
    return [("[1,1152]", mask[:1].contiguous(), WRITE_OFFSET),
            ("[8,1152]", mask, WRITE_OFFSET),
            ("[64,1152]", mask[rows64].contiguous(), WRITE_OFFSET),
            ("[8,384]", compact_mask(dev), COMPACT_OFFSET),
            (f"[8,{RAGGED_L}]", ragged, RAGGED_L - DEC_LEN)]


def decode_edge_masks(key_mask):
    """The key masks the decode kernel's compaction can get wrong, each a
    (label, mask): the mask itself, and batch row 3 (row 0 at batch 1) with
    every encoder key masked, so that its only allowed keys are the decoder
    slots (one at step 0)."""
    none = key_mask.clone()
    row = min(3, key_mask.shape[0] - 1)
    none[row] = 0.0
    return [("the serving mask", key_mask),
            (f"batch row {row} with no valid encoder key", none.contiguous())]


def cold_copies(n_bytes: int) -> int:
    """Copies of an input set of n_bytes that, visited in turn, leave none
    of a call's inputs in the L2 from its last visit."""
    return max(1, -(-3 * L2_BYTES // n_bytes))


def cuda_time_cold_ms(fn, sets, reps: int = 20) -> float:
    """cuda_time_ms of fn(*s) over ``sets`` taken in turn (each set's
    inputs evicted from the L2 by the others), as a forward's blocks evict
    the decode cache between its calls."""
    turn = itertools.count()
    return cuda_time_ms(lambda: fn(*sets[next(turn) % len(sets)]), reps=reps)


def decode_inputs(gen, b: int, l: int, int8: bool, copies: int = 1, d: int = 768):
    """q [b, 1, d], ``copies`` caches [b, l, d] (int8: (k8, ks, v8, vs),
    quantize_kv of normal values; else (k, v) in bf16) and each one's (k,
    v) for SDPA (the int8 cache dequantized)."""
    import torch

    from vitxtgqa_tpu_torch.ops.attention import dequantize_kv, quantize_kv

    dev, bf = gen.device, torch.bfloat16
    rn = lambda *s: torch.randn(*s, generator=gen, device=dev).to(bf)
    q, caches, kv = rn(b, 1, d), [], []
    for _ in range(copies):
        k, v = rn(b, l, d), rn(b, l, d)
        if int8:
            (k8, ks), (v8, vs) = quantize_kv(k), quantize_kv(v)
            caches.append((k8, ks, v8, vs))
            k, v = dequantize_kv(k8, ks, bf), dequantize_kv(v8, vs, bf)
        else:
            caches.append((k, v))
        kv.append((k, v))
    return q, caches, kv


def check_decode_attention(dev, record, timed: bool = True):
    """The decode attention (#4 int8, #7 bf16 cache) against its twins at
    steps 0 and 11 on every case of decode_cases and both masks of
    decode_edge_masks.  Then, on the card (``timed``), both forms at [8,
    1152] step 11 warm (the same cache each call: the record's time, as
    the kernel table has always kept it) and cold (cold_copies caches in turn),
    each with its bound (decode_bound: the allowed keys only) and SDPA on
    the same inputs (the dequantized cache for #4), #4 at the compact [8,
    384] too, and each plan's cudaOccupancyMaxActiveClusters."""
    import torch
    import torch.nn.functional as F

    from vitxtgqa_tpu_torch.ops import decode_attention as DA

    gen = torch.Generator(device=dev).manual_seed(1357)
    h, int8_name = 12, "decode_attention_int8"
    forms = {int8_name: (DA.decode_attention_int8, DA.decode_attention_int8_plain),
             "decode_attention": (DA.decode_attention, DA.decode_attention_plain)}
    for label, base, wo in decode_cases(dev):
        b, l = base.shape
        for name, (fn, plain) in forms.items():
            q, (cache,), _ = decode_inputs(gen, b, l, name == int8_name)
            for mlabel, km in decode_edge_masks(base):
                for step in (0, 11):
                    args = (q, *cache, km, step, wo, h)
                    got, want = fn(*args), plain(*args)
                    torch.cuda.synchronize()
                    report(record, name, (got.float() - want.float()).abs().max().item(),
                           extra=f" [{b},1,768] x {label} step={step}, {mlabel}")
            del q, cache
    if not timed:
        return {}

    details = {}
    for name in forms:
        int8 = name == int8_name
        plan = DA.launch_plan(BATCH, L_JOINT, h, 1 if int8 else 2)
        occ = DA.max_active_clusters(BATCH, L_JOINT, h, int8)
        print(f"kernel {name} [8,1152]: plan {plan._asdict()}, "
              f"cudaOccupancyMaxActiveClusters {occ}", flush=True)
        details[name] = {"plan": plan._asdict(), "max_active_clusters": occ}
    mask, _ = serving_masks(dev)
    for name, label, km, wo in ((int8_name, "[8,1152]", mask, WRITE_OFFSET),
                                ("decode_attention", "[8,1152]", mask, WRITE_OFFSET),
                                (int8_name, "[8,384]", compact_mask(dev), COMPACT_OFFSET)):
        (fn, plain), int8, (b, l) = forms[name], name == int8_name, km.shape
        copies = cold_copies(2 * b * l * 768 * (1 if int8 else 2))
        q, caches, kv = decode_inputs(gen, b, l, int8, copies)
        am = decode_sdpa_mask(km, 11, wo)
        run = lambda *c: fn(q, *c, km, 11, wo, h)
        sdpa = lambda k, v: F.scaled_dot_product_attention(sdpa_split(q, h), sdpa_split(k, h),
                                                           sdpa_split(v, h), am)
        warm = dict(ms=cuda_time_ms(lambda: run(*caches[0])),
                    plain_ms=cuda_time_ms(lambda: plain(q, *caches[0], km, 11, wo, h)),
                    library_ms=cuda_time_ms(lambda: sdpa(*kv[0])),
                    bound=decode_bound(q, km, 11, 1 if int8 else 2, 8 if int8 else 0))
        cold_ms, cold_sdpa = cuda_time_cold_ms(run, caches), cuda_time_cold_ms(sdpa, kv)
        extra = f" [{b},1,768] x {label} step=11"
        if label == "[8,1152]":
            keep_times(record, name, extra + " (warm)", **warm)
        else:
            print(f"kernel {name}{extra} (warm): kernel {warm['ms']:.4f} ms, plain "
                  f"{warm['plain_ms']:.4f} ms, library {warm['library_ms']:.4f} ms, bound "
                  f"{warm['bound'][0]:.4f} ms ({warm['bound'][1]})", flush=True)
        print(f"kernel {name}{extra} (cold, {copies} caches in turn): kernel {cold_ms:.4f} ms, "
              f"library {cold_sdpa:.4f} ms", flush=True)
        details[f"{name} {label}"] = dict(warm_ms=warm["ms"], plain_ms=warm["plain_ms"],
                                          sdpa_warm_ms=warm["library_ms"],
                                          bound_ms=warm["bound"][0], cold_ms=cold_ms,
                                          sdpa_cold_ms=cold_sdpa, cold_copies=copies)
        del q, caches, kv
    torch.cuda.empty_cache()
    return details


def zoo_masks(dev):
    """(label, [BATCH, L] encoder key mask, write_offset) of the zoo's new
    decode geometries, from the serving batch: M4C's 1,024-slot cache (the
    question, the middle frame's feature, the middle frame's valid OCR
    slots; ~36 allowed keys with the decoder slots) and wo_sg's compact
    128-slot cache (the question, 5 frames, their 75 OCR slots)."""
    import torch
    import torch.nn.functional as F

    from vitxtgqa_tpu_torch.utils.synthetic import synthetic_batch

    b = {k: torch.as_tensor(v) for k, v in synthetic_batch(batch=BATCH, seed=0).items()}
    txt = (torch.arange(20)[None, :] < b["text_len"][:, None]).float()
    mid = ((b["temporal_id"] == b["middel_frame_id"]) & (b["ocr_mask"] > 0)).float()
    m4c = torch.cat([txt, torch.ones(BATCH, 1), mid], dim=1)
    wo_sg = torch.cat([txt, b["frame_mask"][:, :5].float(), b["ocr_mask"][:, :75].float()], dim=1)
    pad = lambda m, l: F.pad(m, (0, l - m.shape[1])).to(dev).contiguous()
    return [(f"m4c [{BATCH},{L_M4C}]", pad(m4c, L_M4C), L_M4C - DEC_LEN),
            (f"wo_sg compact [{BATCH},{L_WO_SG}]", pad(wo_sg, L_WO_SG), L_WO_SG - DEC_LEN)]


def selector_masks(dev):
    """(label, [BATCH, L] encoder key mask, write_offset) of the selector
    baselines' geometries.  TranSTR's 1,024 slots: the fused frame and one
    grounded OCR slot a row, 2 allowed encoder keys (row 0's the last OCR
    slot, key 960, in the last 64-key tile with the decoder slots; row 1's
    masked by its OCR mask: 1 key).  MIST's 1,152: the question, the 5
    picks of 64 frames with replacement summed (a frame picked twice holds
    2.0, three times 3.0: row 0 picks its first frame twice), 25 OCR
    slots."""
    import torch
    import torch.nn.functional as F

    from vitxtgqa_tpu_torch.utils.synthetic import synthetic_batch

    gen, rows = torch.Generator().manual_seed(2468), torch.arange(BATCH)
    tr = torch.zeros(BATCH, L_TRANSTR)
    tr[:, 0] = 1.0
    slot = torch.randint(0, 960, (BATCH,), generator=gen)
    slot[0] = 959
    tr[rows, 1 + slot] = 1.0
    tr[1, 1 + slot[1]] = 0.0
    b = synthetic_batch(batch=BATCH, seed=0)
    txt = (torch.arange(20)[None, :] < torch.as_tensor(b["text_len"])[:, None]).float()
    picks = torch.randint(0, 64, (BATCH, 5), generator=gen)
    picks[0, 1] = picks[0, 0]
    frames = torch.zeros(BATCH, 64).scatter_add_(1, picks, torch.ones(BATCH, 5))
    ocr = torch.zeros(BATCH, 960).scatter_(
        1, torch.argsort(torch.rand(BATCH, 960, generator=gen), dim=1)[:, :25], 1.0)
    mist = F.pad(torch.cat([txt, frames, ocr], dim=1), (0, L_JOINT - 20 - 64 - 960))
    return [(f"transtr [{BATCH},{L_TRANSTR}]", tr.to(dev).contiguous(), L_TRANSTR - DEC_LEN),
            (f"mist [{BATCH},{L_JOINT}] with 2.0 entries", mist.to(dev).contiguous(),
             WRITE_OFFSET)]


CLIPPED = ", against itself on the mask clipped to 1"


def check_selector_flash(record, label, km, gen, batch: int):
    """#1 (rate 0, and its dropout form with the lse) and #1b on a selector
    mask's first ``batch`` rows (the MMT's joint mask: dec_len 12) against
    their twins; on a mask with entries above 1 each kernel also against
    itself on the mask clipped to 1 (an entry > 0 is one allowed key)."""
    import torch

    from vitxtgqa_tpu_torch.ops import flash_attention as FA

    dev, l, h = km.device, km.shape[1], 12
    km = km[:batch].contiguous()
    clipped = km.clamp(max=1.0).contiguous() if bool((km > 1).any()) else None
    q, k, v, g = (torch.randn(batch, l, 768, generator=gen, device=dev).to(torch.bfloat16)
                  for _ in range(4))
    seed = torch.tensor([20261019], dtype=torch.int64, device=dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    for rate in (0.0, RATE):
        s_, shape = (seed if rate else None), f" rate {rate} [{batch},{l},768] x {label}"
        fwd = lambda fn, m: fn(q, k, v, m, DEC_LEN, h, rate, s_, return_lse=True)
        (got, lse), (want, want_lse) = (fwd(FA.flash_attention_merged, km),
                                        fwd(FA.flash_attention_merged_plain, km))
        bwd = lambda fn, m: fn(q, k, v, m, want, want_lse, g, DEC_LEN, h, rate, s_)
        gb, wb = bwd(FA.flash_attention_merged_bwd, km), bwd(FA.flash_attention_merged_bwd_plain, km)
        sync()
        lse_err = (lse - want_lse).abs().max().item()
        report(record, "flash_attention_merged", (got.float() - want.float()).abs().max().item(),
               extra=f"{shape}; lse max|diff| {lse_err:.3e} (tol {LSE_TOL:.0e})")
        if not lse_err <= LSE_TOL:
            fail(f"flash_attention_merged lse disagrees at{shape}")
        for name, a, w in zip(("dq", "dk", "dv"), gb, wb):
            report(record, "flash_attention_merged_bwd", (a.float() - w.float()).abs().max().item(),
                   scale=w.float().abs().max().item(), extra=f" {name}{shape}")
        if clipped is None:
            continue
        c = fwd(FA.flash_attention_merged, clipped)[0]
        cb = bwd(FA.flash_attention_merged_bwd, clipped)
        sync()
        report(record, "flash_attention_merged", (got.float() - c.float()).abs().max().item(),
               extra=shape + CLIPPED)
        for name, a, w in zip(("dq", "dk", "dv"), gb, cb):
            report(record, "flash_attention_merged_bwd", (a.float() - w.float()).abs().max().item(),
                   scale=w.float().abs().max().item(), extra=f" {name}{shape}{CLIPPED}")


def check_step_clip(record, label, x_all, stacks, km, gen, batches, write_offset: int):
    """#5 (its attention planted, decode_step_cache) on a mask with entries
    above 1 against itself on the mask clipped to 1, steps 0 and 11."""
    import torch

    from vitxtgqa_tpu_torch.ops import decode_step as DS

    dev, clipped = km.device, km.clamp(max=1.0).contiguous()
    m, d = stacks["w1"].shape[1:]
    for step in (0, 11):
        kv8_all, kvs_all = decode_step_cache(x_all, stacks, km, step, gen, 12, write_offset)
        for b in batches:
            kv8, kvs = kv8_all[:, :b].contiguous(), kvs_all[:, :b].contiguous()
            buffers = DS.step_buffers(3, b, d, m, dev)
            y = [DS.fused_decode_step(x_all[:b].contiguous(), stacks, kv8, kvs,
                                      mk[:b].contiguous(), step, write_offset, 12,
                                      buffers=buffers)[0].clone() for mk in (km, clipped)]
            if dev.type == "cuda":
                torch.cuda.synchronize()
            report(record, "fused_decode_step", (y[0].float() - y[1].float()).abs().max().item(),
                   extra=f" [{b},1,768] x 3 layers over {label} step={step}{CLIPPED}")


def check_zoo_geometries(dev, record, timed: bool = True, flash_batch: int = TRAIN_CHECK_BATCH):
    """The decode kernels at the zoo's new geometries (zoo_masks and
    selector_masks), against their twins: #4 and #7 at batch 8, steps 0 and
    11, on the mask and with a batch row whose only allowed keys are the
    decoder slots; #5 at batch 1 and 2 (check_decode_step, its attention
    planted).  On the selector masks also #1 and #1b at batch
    ``flash_batch`` (check_selector_flash), and on MIST's, whose entries
    reach 2.0, each of #1, #1b, #4, #7 and #5 against itself on the mask
    clipped to 1.  With ``timed``, #4 and #7 at step 11 warm (kernel, twin,
    SDPA, bound) and #5's warm and cold times.  Returns the times."""
    import torch
    import torch.nn.functional as F

    from vitxtgqa_tpu_torch.ops import decode_attention as DA

    gen = torch.Generator(device=dev).manual_seed(97531)
    h, int8_name = 12, "decode_attention_int8"
    forms = {int8_name: (DA.decode_attention_int8, DA.decode_attention_int8_plain),
             "decode_attention": (DA.decode_attention, DA.decode_attention_plain)}
    details = {}
    for label, km, wo in zoo_masks(dev) + selector_masks(dev):
        b, l = km.shape
        allowed = int((km[:, :wo] > 0).sum(1).max().item())
        print(f"kernel geometry {label}: at most {allowed} allowed encoder keys a row of {wo}",
              flush=True)
        clipped = km.clamp(max=1.0).contiguous() if bool((km > 1).any()) else None
        for name, (fn, plain) in forms.items():
            int8 = name == int8_name
            q, (cache,), kv = decode_inputs(gen, b, l, int8)
            for mlabel, m in decode_edge_masks(km):
                for step in (0, 11):
                    args = (q, *cache, m, step, wo, h)
                    got, want = fn(*args), plain(*args)
                    if dev.type == "cuda":
                        torch.cuda.synchronize()
                    report(record, name, (got.float() - want.float()).abs().max().item(),
                           extra=f" [{b},1,768] x {label} step={step}, {mlabel}")
            if clipped is not None:
                for step in (0, 11):
                    got, c = fn(q, *cache, km, step, wo, h), fn(q, *cache, clipped, step, wo, h)
                    if dev.type == "cuda":
                        torch.cuda.synchronize()
                    report(record, name, (got.float() - c.float()).abs().max().item(),
                           extra=f" [{b},1,768] x {label} step={step}{CLIPPED}")
            if timed:
                am = decode_sdpa_mask(km, 11, wo)
                ms = cuda_time_ms(lambda: fn(q, *cache, km, 11, wo, h))
                pms = cuda_time_ms(lambda: plain(q, *cache, km, 11, wo, h))
                lib = cuda_time_ms(lambda: F.scaled_dot_product_attention(
                    sdpa_split(q, h), sdpa_split(kv[0][0], h), sdpa_split(kv[0][1], h), am))
                bound = decode_bound(q, km, 11, 1 if int8 else 2, 8 if int8 else 0)
                print(f"kernel {name} [{b},1,768] x {label} step=11 (warm): kernel {ms:.4f} ms, "
                      f"plain {pms:.4f} ms, library {lib:.4f} ms, bound {bound[0]:.4f} ms "
                      f"({bound[1]})", flush=True)
                details[f"{name} {label}"] = dict(warm_ms=ms, plain_ms=pms, sdpa_warm_ms=lib,
                                                  bound_ms=bound[0])
            del q, cache, kv
        x_all, stacks = decode_step_weights(dev, gen)
        details[f"fused_decode_step {label}"] = check_decode_step(
            record, x_all, stacks, km, gen, (1, 2), wo, False, timed=timed)
        if clipped is not None:
            check_step_clip(record, label, x_all, stacks, km, gen, (1, 2), wo)
        del x_all, stacks
    for label, km, _ in selector_masks(dev):
        check_selector_flash(record, label, km, gen, flash_batch)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return details


def check_kernels(dev, record):
    import torch
    import torch.nn.functional as F

    from vitxtgqa_tpu_torch.ops import flash_attention as FA
    gen = torch.Generator(device=dev).manual_seed(1234)
    bf = torch.bfloat16
    rn = lambda *s, scale=1.0: (torch.randn(*s, generator=gen, device=dev) * scale).to(bf)
    h, l, d = 12, L_JOINT, 768
    mask, _ = serving_masks(dev)

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

    # 2. fused block and its tanh form (check_eval_block)
    eval_block = check_eval_block(dev, record)

    # 3-4. the decode attention, int8 and bf16 cache (check_decode_attention)
    details = check_decode_attention(dev, record)
    details["eval_block"] = eval_block

    # 5. the single-kernel decode step over 3 MMT layers, batch 1 / 2 / 8,
    # its attention planted (decode_step_cache)
    x_all, stacks = decode_step_weights(dev, gen)
    details["decode_step"] = check_decode_step(record, x_all, stacks, mask, gen, (1, 2, BATCH),
                                               WRITE_OFFSET, True)

    # 6. the fused epilogue: first its batch order (check_epilogue_batch_order,
    # before any other launch of it in this process), then check_fused_epilogue
    check_epilogue_batch_order(dev, record)
    details["epilogue"] = check_fused_epilogue(dev, record)
    del q, k, v
    torch.cuda.empty_cache()
    return details


def epilogue_inputs(dev, gen, b: int, d: int = 768, keys=None):
    """The fused epilogue's arguments at batch b (fused_epilogue_plain's
    order, step 3 of DEC_LEN): random weights, tables and keys from gen,
    the serving batch's OCR mask (its rows repeated); ``keys`` replaces the
    pointer keys."""
    import torch

    _, ocr_mask = serving_masks(dev)
    bf = torch.bfloat16
    rn = lambda *s, scale=1.0: torch.randn(*s, generator=gen, device=dev) * scale
    cls_w = torch.zeros(EPI_V_P, d, device=dev)
    cls_w[:EPI_V_FIX] = rn(EPI_V_FIX, d, scale=0.05)
    cls_b = torch.full((EPI_V_P,), -1e30, device=dev)
    cls_b[:EPI_V_FIX] = rn(EPI_V_FIX, scale=0.01)
    ans = torch.zeros(EPI_V_P, d, device=dev, dtype=bf)
    ans[:EPI_V_FIX] = rn(EPI_V_FIX, d, scale=0.3).to(bf)
    ptr_w, ptr_b = rn(d, d, scale=0.05), rn(d, scale=0.01)
    keys = rn(b, EPI_N, d, scale=0.2) if keys is None else keys
    mask = ocr_mask[torch.arange(b, device=dev) % ocr_mask.shape[0]].contiguous()
    return [rn(b, 1, d).to(bf), cls_w, cls_b, ptr_w, ptr_b, keys, mask, ans,
            rn(b, EPI_N, d, scale=0.3).to(bf), rn(2 * DEC_LEN, d, scale=0.1), 3, EPI_V_FIX,
            1.0 / d ** 0.5, DEC_LEN]


def plant_epilogue(eargs, grid: int):
    """Plant the tie and the OCR row into epilogue_inputs' arguments (in
    place): classifier rows r1 = 3 and r2, the first row from EPI_V_FIX / 2
    whose item lies in another block's share of a grid of ``grid`` blocks
    (ops/decode_step.epilogue_block_of), get row 7's weights and the bias
    EPI_TIE_BIAS; at batch >= 2, row 1's key at its first valid OCR slot
    n1 is set along its q so that it scores EPI_OCR_SCORE.  Returns (r1,
    r2, n1 or None)."""
    import torch

    from vitxtgqa_tpu_torch.ops import decode_step as DS

    y, cls_w, cls_b, ptr_w, ptr_b, keys, mask = eargs[:7]
    qk = ptr_w.shape[0]
    owner = lambda r: DS.epilogue_block_of(qk + r, grid)
    r1 = 3
    r2 = next(r for r in range(EPI_V_FIX // 2, EPI_V_FIX) if owner(r) != owner(r1))
    cls_w[r1] = cls_w[r2] = cls_w[7]
    cls_b[r1] = cls_b[r2] = EPI_TIE_BIAS
    if y.shape[0] < 2:
        return r1, r2, None
    n1 = int(torch.nonzero(mask[1] > 0)[0, 0])
    q = y[1, 0].float() @ ptr_w.t() + ptr_b
    keys[1, n1] = q * ((EPI_OCR_SCORE - float(mask[1, n1])) / (float(q @ q) * eargs[12]))
    return r1, r2, n1


def check_no_i2f(opcodes: dict):
    """The int8 pointer scores' kernels (#12) convert their int8 keys with
    PRMT and FADD: fail on any I2F-family instruction (I2F, I2FP) in any of
    them but one rounded toward +inf (.RP), the reciprocal seed of an
    integer division (a block's first tile), which no value conversion
    uses (opcodes: ops/_build.sass, the built library's SASS by kernel)."""
    mine = {k: v for k, v in opcodes.items() if "ptr_scores_int8_kernel" in k}
    i2f = lambda op: op.startswith("I2F")
    conv = sorted({op for v in mine.values() for op in v if i2f(op) and ".RP" not in op})
    seeds = [sum(i2f(op) and ".RP" in op for op in v) for v in mine.values()]
    prmt = [sum(op.startswith("PRMT") for op in v) for v in mine.values()]
    print(f"build: SASS of the int8 pointer scores ({len(mine)} kernels): I2F-family conversions "
          f"{conv or 'none'}; division seeds (I2F .RP) per kernel {sorted(seeds)}; PRMT per "
          f"kernel {sorted(prmt)}", flush=True)
    if not mine or conv:
        fail("the int8 pointer scores' SASS is missing or holds an I2F conversion")


def check_epilogue_batch_order(dev, record, order=EPI_ORDER):
    """The fused epilogue (#6) at the batches of ``order`` in turn, each
    batch with its own inputs and one epilogue_buffers that all its calls
    share, against its twin: it launches at every one (a launch setup kept
    per batch, not per instantiation, leaves the kernel's shared-memory
    attribute at a smaller batch's after that batch, and the next launch
    at the larger one is refused) and agrees within the tolerance (the
    scores; the tokens where the twin's top two differ by more; the next
    embedding where the tokens agree).  Run it before any other launch of
    #6 in the process."""
    import torch

    from vitxtgqa_tpu_torch.ops import decode_step as DS

    gen = torch.Generator(device=dev).manual_seed(97531)
    tol = TOL["fused_epilogue"]
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    inputs = {}
    for b in dict.fromkeys(order):
        eargs = epilogue_inputs(dev, gen, b)
        inputs[b] = (eargs, DS.epilogue_buffers(b, eargs[3].shape[0], dev),
                     DS.fused_epilogue_plain(*eargs))
    for i, b in enumerate(order):
        eargs, buf, want = inputs[b]
        label = f" [{b},1,768], call {i + 1} of the batch order {list(order)}"
        try:
            got = DS.fused_epilogue(*eargs, buffers=buf)
            sync()
        except RuntimeError as e:
            fail(f"fused_epilogue did not launch at{label}: {e}")
        tok, wtok = got[1][:, 0, 0], want[1][:, 0, 0]
        top2 = want[0][:, 0].topk(2, dim=-1).values
        same = tok == wtok
        emb_err = (got[2] - want[2]).float().abs()[same].max().item() if same.any() else 0.0
        if not bool((same | ((top2[:, 0] - top2[:, 1]) <= tol)).all()) or not emb_err <= tol:
            fail(f"fused_epilogue token or embedding disagrees at{label}")
        report(record, "fused_epilogue", (got[0] - want[0]).abs().max().item(), extra=label)
    del inputs
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def check_fused_epilogue(dev, record, batches=EPI_BATCHES, timed: bool = True):
    """The fused epilogue (#6) against its twin at each batch, on random
    inputs and with the planted tie and OCR row (plant_epilogue): the
    scores within the tolerance and their pad lanes exactly -1e30, the
    tokens equal wherever the twin's top two differ by more than the
    tolerance, the next embedding within it where the tokens agree; with
    the plant, the lower tied row wins bit for bit (both rows' scores
    equal) in every batch row but row 1, whose planted OCR slot wins.  With
    ``timed``, each batch's time warm (the same inputs every call) and
    cold (cold_copies sets of classifier, pointer weights and keys in
    turn), the twin's, and its two GEMVs alone as float32 torch.matmul (a
    yardstick: no single call computes the epilogue); batch 1 warm is the
    kernel's record.  The launches share one epilogue_buffers, as a
    forward's do.  Returns {batch: times}."""
    import torch

    from vitxtgqa_tpu_torch.ops import decode_step as DS

    gen = torch.Generator(device=dev).manual_seed(1357)
    tol = TOL["fused_epilogue"]
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    times = {}
    for b in batches:
        eargs = epilogue_inputs(dev, gen, b)
        d, qk = eargs[0].shape[-1], eargs[3].shape[0]
        grid = (DS.epilogue_grid(b, d, qk) if dev.type == "cuda"
                else DS.EPILOGUE_BLOCKS_PER_SM * DS.H100_SMS)
        buf = DS.epilogue_buffers(b, qk, dev)
        for planted in (False, True):
            plant = plant_epilogue(eargs, grid) if planted else None
            got = DS.fused_epilogue(*eargs, buffers=buf)
            want = DS.fused_epilogue_plain(*eargs)
            sync()
            scores, tok, wtok = got[0][:, 0], got[1][:, 0, 0], want[1][:, 0, 0]
            err = (scores - want[0][:, 0]).abs().max().item()
            pads = bool((scores[:, EPI_V_FIX:EPI_V_P] == -1e30).all())
            top2 = want[0][:, 0].topk(2, dim=-1).values
            tok_ok = (tok == wtok) | ((top2[:, 0] - top2[:, 1]) <= tol)
            same = tok == wtok
            emb_err = (got[2] - want[2]).float().abs()[same].max().item() if same.any() else 0.0
            label = f" [{b},1,768] -> [{b},1,{EPI_V_P + EPI_N}]" + (" planted" if planted else "")
            print(f"kernel fused_epilogue{label}: tokens {tok.tolist()} vs plain {wtok.tolist()}; "
                  f"next-embedding max|diff| {emb_err:.3e}; pad lanes -1e30: {pads}", flush=True)
            if not bool(tok_ok.all()) or not emb_err <= tol or not pads:
                fail(f"fused_epilogue token, embedding or pad lanes disagree at{label}")
            if planted:
                r1, r2, n1 = plant
                want_tok = torch.full_like(tok, r1)
                if n1 is not None:
                    want_tok[1] = EPI_V_P + n1
                tied = bool(torch.equal(scores[:, r1], scores[:, r2]))
                print(f"kernel fused_epilogue{label}: rows {r1} and {r2} (blocks "
                      f"{DS.epilogue_block_of(qk + r1, grid)} and "
                      f"{DS.epilogue_block_of(qk + r2, grid)} of {grid}) tie: {tied}; tokens "
                      f"{tok.tolist()}, expected {want_tok.tolist()}", flush=True)
                if not tied or not torch.equal(tok, want_tok):
                    fail(f"fused_epilogue's planted tie or OCR row at{label}")
            timed_rec = {}
            if timed and not planted:
                run = lambda cls_w, ptr_w, keys: DS.fused_epilogue(
                    eargs[0], cls_w, eargs[2], ptr_w, eargs[4], keys, *eargs[6:], buffers=buf)
                first = (eargs[1], eargs[3], eargs[5])
                copies = cold_copies(nbytes(*first))
                sets = [first] + [tuple(t.clone() for t in first) for _ in range(copies - 1)]
                turn = itertools.count()
                ms = cuda_time_ms(lambda: run(*first))
                cold = cuda_time_ms(lambda: run(*sets[next(turn) % copies]))
                pms = cuda_time_ms(lambda: DS.fused_epilogue_plain(*eargs))
                y32 = eargs[0][:, 0].float()
                gemv = cuda_time_ms(lambda: (y32 @ eargs[1].t(), y32 @ eargs[3].t()))
                del sets
                moved = (nbytes(eargs[0], eargs[2][:EPI_V_FIX], *eargs[3:7], *got)
                         + EPI_V_FIX * d * 4 + b * d * (2 + 2 + 4))  # classifier; gathered rows
                bound = bound_of(moved, 2 * b * d * (EPI_V_FIX + qk + EPI_N), PEAK_F32_FLOPS)
                print(f"kernel fused_epilogue [{b}]: kernel {ms:.4f} ms warm, {cold:.4f} ms cold "
                      f"({copies} sets in turn), plain {pms:.4f} ms, yardstick (its two GEMVs "
                      f"as torch.matmul) {gemv:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]})",
                      flush=True)
                times[b] = dict(warm_ms=ms, cold_ms=cold, plain_ms=pms, yardstick_ms=gemv,
                                bound_ms=bound[0], cold_copies=copies)
                if b == 1:  # the record's shape: the fused branch's batch-1 step
                    timed_rec = dict(ms=ms, plain_ms=pms, bound=bound)
            report(record, "fused_epilogue", err, extra=label, **timed_rec)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return times


def check_ptr_scores(dev, record, cases=PTR_CASES, d: int = 768, timed: bool = True):
    """The int8 pointer scores (#12) against their twin at each (batch,
    slots) of ``cases``, on the serving batch's OCR mask (its rows
    repeated; a 961st slot valid): random q within the tolerance, and q of
    small integers bit for bit (the dot is then exact in any order, so the
    scale's order, acc * (ks * scale) + mask, decides every bit).  With
    ``timed``, each case's time warm (the same keys every call) and cold
    (cold_copies sets of keys in turn), the twin's, and the bf16-key
    einsum that the JAX package's default decode takes instead
    (OcrPtrNet.scores_from_keys on bf16 keys: a yardstick, it reads twice
    the bytes); batch 8 warm is the kernel's record.  Returns {case:
    times}."""
    import torch
    import torch.nn.functional as F

    from vitxtgqa_tpu_torch.ops import ptr_scores as PS
    from vitxtgqa_tpu_torch.ops.attention import quantize_kv

    gen = torch.Generator(device=dev).manual_seed(2468)
    _, ocr_mask = serving_masks(dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    times = {}
    for b, n in cases:
        mask = F.pad(ocr_mask, (0, max(0, n - ocr_mask.shape[1])), value=1.0)[:, :n]
        mask = mask[torch.arange(b, device=dev) % mask.shape[0]].contiguous()
        kb = torch.randn(b, n, d, generator=gen, device=dev).to(torch.bfloat16)
        k8, ks = quantize_kv(kb)
        q = torch.randn(b, 1, d, generator=gen, device=dev) * 0.5
        qi = torch.randint(-2, 3, (b, 1, d), generator=gen, device=dev).float()
        got, want = PS.ptr_scores_int8(q, k8, ks, mask), PS.ptr_scores_int8_plain(q, k8, ks, mask)
        got_i = PS.ptr_scores_int8(qi, k8, ks, mask)
        exact = bool(torch.equal(got_i, PS.ptr_scores_int8_plain(qi, k8, ks, mask)))
        sync()
        label = f" [{b},1,{d}] x [{b},{n},{d}]"
        print(f"kernel ptr_scores_int8{label}: integer q bit for bit: {exact}", flush=True)
        if not exact:
            fail(f"ptr_scores_int8 on integer q is not the twin's bit for bit at{label}")
        timed_rec = {}
        if timed:
            copies = cold_copies(nbytes(k8, ks))
            sets = [(k8, ks)] + [quantize_kv(torch.randn(b, n, d, generator=gen, device=dev)
                                             .to(torch.bfloat16)) for _ in range(copies - 1)]
            turn = itertools.count()
            ms = cuda_time_ms(lambda: PS.ptr_scores_int8(q, k8, ks, mask))
            cold = cuda_time_ms(lambda: PS.ptr_scores_int8(q, *sets[next(turn) % copies], mask))
            pms = cuda_time_ms(lambda: PS.ptr_scores_int8_plain(q, k8, ks, mask))
            yard = cuda_time_ms(lambda: torch.einsum("bsd,bnd->bsn", q, kb.float()) / d ** 0.5
                                + mask[:, None, :])
            del sets
            bound = bound_of(nbytes(q, k8, ks, mask, got), 2 * k8.numel(), PEAK_F32_FLOPS)
            print(f"kernel ptr_scores_int8{label}: kernel {ms:.4f} ms warm, {cold:.4f} ms cold "
                  f"({copies} sets in turn), plain {pms:.4f} ms, yardstick (the bf16-key einsum) "
                  f"{yard:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]})", flush=True)
            times[f"[{b},{n}]"] = dict(warm_ms=ms, cold_ms=cold, plain_ms=pms, yardstick_ms=yard,
                                       bound_ms=bound[0], cold_copies=copies)
            if (b, n) == (BATCH, 960):
                timed_rec = dict(ms=ms, plain_ms=pms, bound=bound)
        report(record, "ptr_scores_int8", (got - want).abs().max().item(), label, **timed_rec)
        del kb, k8, ks, got, want, got_i
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return times


def check_eval_block(dev, record, cases=EVAL_BLOCK_CASES, d: int = 768, timed: bool = True):
    """The eval block (#2) and its tanh form (#3) against their twins at
    each (rows, FFN width, LN1 shift) of ``cases`` (EVAL_BLOCK_CASES), the
    weights and inputs from one seed; with ``timed``, each case's kernel
    and twin times and bound, the first case's kept as the kernels'
    record.  Returns {case: {kernel: times}}."""
    import torch

    from vitxtgqa_tpu_torch.ops import fused_block as FB

    gen = torch.Generator(device=dev).manual_seed(1234)
    bf = torch.bfloat16
    rn = lambda *s, scale=1.0: (torch.randn(*s, generator=gen, device=dev) * scale).to(bf)
    vec = lambda n, base=0.0: (base + torch.randn(n, generator=gen, device=dev) * 0.05).float()
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    times = {}
    for i, (rows, m, shift) in enumerate(cases):
        x_q, ctx, res = rn(rows, d), rn(rows, d, scale=0.5), rn(rows, d)
        wo, w1 = rn(d, d, scale=0.02), rn(m, d, scale=0.02)
        w2 = rn(d, m, scale=0.002 if shift else 0.02)
        pv = (wo, vec(d), vec(d, 1.0), vec(d, shift), w1, vec(m), w2, vec(d), vec(d, 1.0), vec(d))
        args = (x_q, ctx) + pv
        label = f" [{rows},{d}]->{m}" + (f", LN1 shift {shift:g}" if shift else "")
        for name, fn, plain, a, n_in in (
            ("fused_block", FB.fused_block, FB.fused_block_plain, args, nbytes(x_q, ctx)),
            ("fused_block_tanh", FB.fused_block_tanh, FB.fused_block_tanh_plain, (res,) + args,
             nbytes(x_q, ctx, res)),
        ):
            got, want = fn(*a), plain(*a)
            sync()
            err = (got.float() - want.float()).abs().max().item()
            timed_case = {}
            if timed:
                timed_case = dict(
                    ms=cuda_time_ms(lambda: fn(*a)), plain_ms=cuda_time_ms(lambda: plain(*a)),
                    bound=block_bound(rows, d, m, n_in, nbytes(got), nbytes(wo, w1, w2),
                                      nbytes(*pv[1:4], pv[5], *pv[7:])))
                times.setdefault(label.strip(), {})[name] = {
                    "ms": timed_case["ms"], "plain_ms": timed_case["plain_ms"],
                    "bound_ms": timed_case["bound"][0], "max_abs_err": err}
                if i:
                    print(f"kernel {name}{label}: kernel {timed_case['ms']:.4f} ms, plain "
                          f"{timed_case['plain_ms']:.4f} ms, bound {timed_case['bound'][0]:.4f} "
                          f"ms ({timed_case['bound'][1]})", flush=True)
            report(record, name, err, label, **(timed_case if i == 0 else {}))
            del got, want
        del x_q, ctx, res, args, pv
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return times


def check_w8a8_block(dev, record, cases=W8A8_CASES, d: int = 768, timed: bool = True,
                     s8_cases=S8_PRODUCT_CASES):
    """The W8A8 block (#8) against its twin at each (rows, FFN width) of
    ``cases``, its weights quantized once per width: the output within
    the tolerance, its quantization of ctx bit for bit quant_rows', and its
    h8 and h scales bit for bit the twin's h quantized from the kernel's own
    x8 (h_quant_from_x8: the int8 sums are exact, and the kernel keeps the
    twin's f32 operations and their order, so only the LayerNorm's sums may
    differ, and they lie before x8).  First, the s8 products alone
    (s8_products) at each (M, N, K) of ``s8_cases``, bit for bit the exact
    sums.  With ``timed``, each case's kernel, twin and bf16 block (#2, the
    bf16 weights on the same inputs) times and bound, the first case's
    kept as the kernel's record.  Returns {case: times}."""
    import torch

    from vitxtgqa_tpu_torch.ops import fused_block as FB

    gen = torch.Generator(device=dev).manual_seed(2468)
    bf = torch.bfloat16
    rn = lambda *s, scale=1.0: (torch.randn(*s, generator=gen, device=dev) * scale).to(bf)
    vec = lambda n, base=0.0: (base + torch.randn(n, generator=gen, device=dev) * 0.05).float()
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    for m_, n_, k_ in s8_cases:
        a8, b8 = (torch.randint(-127, 128, s_, generator=gen, device=dev, dtype=torch.int8)
                  for s_ in ((m_, k_), (n_, k_)))
        a8[0], b8[0] = 127, 127  # the largest sum, 127^2 K
        same = bool(torch.equal(FB.s8_products(a8, b8), FB.s8_products_plain(a8, b8)))
        sync()
        print(f"kernel fused_block_w8a8: s8 products [{m_},{k_}] x [{n_},{k_}]^T equal to the "
              f"exact sums: {same}", flush=True)
        if not same:
            fail(f"fused_block_w8a8's s8 products disagree with the exact sums at {(m_, n_, k_)}")
        del a8, b8
    times, weights = {}, {}
    for i, (rows, m) in enumerate(cases):
        if m not in weights:
            wo, w1, w2 = rn(d, d, scale=0.02), rn(m, d, scale=0.02), rn(d, m, scale=0.02)
            pv = (wo, vec(d), vec(d, 1.0), vec(d), w1, vec(m), w2, vec(d), vec(d, 1.0), vec(d))
            weights[m] = (pv, FB.quantize_block_weights(wo, w1, w2))
        pv, q8 = weights[m]
        bo, s1, g1, b1, b2, s2, g2 = (pv[j] for j in (1, 2, 3, 5, 7, 8, 9))
        x_q, ctx = rn(rows, d), rn(rows, d, scale=0.5)
        args = (x_q, ctx, q8[0], q8[1], bo, s1, g1, q8[2], q8[3], b1, q8[4], q8[5], b2, s2, g2)
        got, (c8, cs), (x8, xs), (h8, hs) = FB.fused_block_w8a8(*args, return_quant=True)
        want = FB.fused_block_w8a8_plain(*args)
        want8, want_s = FB.quant_rows(ctx)
        h8_want, hs_want = FB.h_quant_from_x8(x8, xs, q8[2], q8[3], b1)
        sync()
        label = f" [{rows},{d}]->{m}"
        ctx_exact = bool(torch.equal(c8, want8) and torch.equal(cs, want_s[:, 0]))
        h_exact = bool(torch.equal(h8, h8_want) and torch.equal(hs, hs_want))
        print(f"kernel fused_block_w8a8{label}: quantized ctx rows and scales equal to quant_rows: "
              f"{ctx_exact}; h8 and its scales equal to the twin's from the kernel's x8: "
              f"{h_exact} ({int((h8 != h8_want).sum().item())} values differ)", flush=True)
        if not ctx_exact:
            fail(f"fused_block_w8a8 quantizes ctx otherwise than quant_rows at {rows} rows")
        if not h_exact:
            fail(f"fused_block_w8a8 forms or quantizes h otherwise than its twin at {rows} rows")
        err = (got.float() - want.float()).abs().max().item()
        timed_case = {}
        if timed:
            ms = cuda_time_ms(lambda: FB.fused_block_w8a8(*args))
            pms = cuda_time_ms(lambda: FB.fused_block_w8a8_plain(*args), reps=3, warmup=1)
            bf_ms = cuda_time_ms(lambda: FB.fused_block(x_q, ctx, *pv))
            bound = block_bound(rows, d, m, nbytes(x_q, ctx), nbytes(got), nbytes(*q8[::2]),
                                nbytes(*q8[1::2], bo, s1, g1, b1, b2, s2, g2), peak=PEAK_INT8_OPS)
            print(f"kernel fused_block_w8a8{label}: kernel {ms:.4f} ms, plain {pms:.4f} ms, the bf16 "
                  f"block (#2) on the same inputs {bf_ms:.4f} ms, bound {bound[0]:.4f} ms "
                  f"({bound[1]})", flush=True)
            times[label.strip()] = {"ms": ms, "plain_ms": pms, "bf16_block_ms": bf_ms,
                                    "bound_ms": bound[0], "max_abs_err": err}
            if i == 0:
                timed_case = dict(ms=ms, plain_ms=pms, bound=bound)
        report(record, "fused_block_w8a8", err, label, **timed_case)
        del x_q, ctx, got, want, c8, want8, x8, h8, h8_want
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return times


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
    decode step (#5) at the compact cache length."""
    import torch

    from vitxtgqa_tpu_torch.ops import flash_attention as FA
    from vitxtgqa_tpu_torch.ops.attention import quantize_kv

    gen = torch.Generator(device=dev).manual_seed(2468)
    bf = torch.bfloat16
    rn = lambda *s, scale=1.0: (torch.randn(*s, generator=gen, device=dev) * scale).to(bf)
    h, l, d = 12, L_JOINT, 768
    mask, _ = serving_masks(dev)

    # 12. the W8A8 block (check_w8a8_block)
    w8a8 = check_w8a8_block(dev, record)

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
    details = {"q8_flash_ms": ms, "flash_ms_same_inputs": ms1, "flash_plus_quantize_ms": ms_sep,
               "w8a8": w8a8}
    del q, k, v, out, out1, want, k8, v8, wk8, wv8

    # 14. the int8 pointer scores (check_ptr_scores)
    details["ptr_scores"] = check_ptr_scores(dev, record)

    # 15. #5 at the compact cache length 384 (write offset 372; #4 there:
    # check_decode_attention)
    cmask = compact_mask(dev)
    x_all, stacks = decode_step_weights(dev, gen)
    details["decode_step_compact"] = check_decode_step(record, x_all, stacks, cmask, gen, (1, 2),
                                                       COMPACT_OFFSET, False)
    del x_all, stacks
    torch.cuda.empty_cache()
    return details


def check_vit_kernels(dev, record):
    """The ViT path's kernels against their twins: the fused FFN (#13,
    check_ffn) at ViT-L/16's chunk of 64 frames (12,608 rows, 1024 -> 4096
    -> 1024), ViT-B/32's (3,200 rows, 768 -> 3072 -> 768), ViT-L/16 at 384
    px (4,616 rows) and at widths of 1,152; the bias-tensor attention
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

    from vitxtgqa_tpu_torch.ops import fused_attention as FAT
    from vitxtgqa_tpu_torch.ops.masks import prefix_lm_bias, self_attention_bias

    gen = torch.Generator(device=dev).manual_seed(97531)
    bf = torch.bfloat16
    rn = lambda *s, scale=1.0: (torch.randn(*s, generator=gen, device=dev) * scale).to(bf)
    details = {}

    # 16. the fused FFN
    details.update(check_ffn(dev, record))

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


def check_ffn(dev, record, cases=FFN_CASES, timed: bool = True):
    """The fused FFN (#13) against its twin at each (rows, d, m, d2,
    label) of ``cases`` (FFN_CASES); with ``timed``, each case's kernel and
    twin times and bound, the first case's kept as the kernel's record.
    Returns {case: times}."""
    import torch

    from vitxtgqa_tpu_torch.ops import ffn as FFN

    gen = torch.Generator(device=dev).manual_seed(97531)
    rn = lambda *s, scale=1.0: (torch.randn(*s, generator=gen, device=dev) * scale).to(
        torch.bfloat16)
    vec = lambda n: (torch.randn(n, generator=gen, device=dev) * 0.05).float()
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    details = {}
    for i, (rows, d, m, d2, label) in enumerate(cases):
        x, w1, b1, w2, b2 = rn(rows, d), rn(m, d, scale=0.02), vec(m), rn(d2, m, scale=0.02), vec(d2)
        args = (x, w1, b1, w2, b2)
        got, want = FFN.fused_ffn(*args), FFN.fused_ffn_plain(*args)
        sync()
        err = (got.float() - want.float()).abs().max().item()
        shape = f" {label} [{rows},{d}]->{m}->{d2}"
        timed_case = {}
        if timed:
            ms = cuda_time_ms(lambda: FFN.fused_ffn(*args))
            pms = cuda_time_ms(lambda: FFN.fused_ffn_plain(*args))
            bound = bound_of(nbytes(x, w1, b1, w2, b2, got), 2 * rows * m * (d + d2))
            details[f"fused_ffn{shape}"] = {"ms": ms, "plain_ms": pms, "bound_ms": bound[0],
                                            "max_abs_err": err}
            timed_case = dict(ms=ms, plain_ms=pms, bound=bound)
            if i:
                print(f"kernel fused_ffn{shape}: kernel {ms:.4f} ms, plain {pms:.4f} ms, bound "
                      f"{bound[0]:.4f} ms ({bound[1]})", flush=True)
        report(record, "fused_ffn", err, shape, **(timed_case if i == 0 else {}))
        del x, got, want
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

    details["block_times"] = check_block_kernels(
        dev, record, (b * l, bt * l, bt * 20) + BLOCK_RAGGED_ROWS, timed_rows=(bt * l, bt * 20))
    details["block_times"].update(check_block_kernels(
        dev, record, BLOCK_NARROW_ROWS, m=BLOCK_NARROW_M, timed_rows=BLOCK_NARROW_ROWS[:1],
        keep=False))
    return details


def check_block_kernels(dev, record, cases, d: int = 768, m: int = 3072, timed_rows=(),
                        keep: bool = True):
    """The block kernels (#9a, #9b) against their twins on the same seed's
    masks, at each row count of ``cases`` with rate 0 and RATE: the
    forward's five outputs (with dropout, also its emitted masks, equal to
    the twin's), the backward's 12 gradients scale-relative, and a second
    backward call equal to the first bit for bit on all 12 (the kernels sum
    in a fixed order).  For the rows of ``timed_rows`` both kernels are then
    timed at RATE with their twins and bounds; with ``keep``, the first is
    the kernels' record.  Returns {"rows x m": {kernel: ms}}."""
    import torch

    from vitxtgqa_tpu_torch.ops import block_train as BT

    gen = torch.Generator(device=dev).manual_seed(2718)
    bf = torch.bfloat16
    rn = lambda *s: torch.randn(*s, generator=gen, device=dev).to(bf)
    vec = lambda n, base=0.0: base + torch.randn(n, generator=gen, device=dev) * 0.05
    seed = torch.tensor([20261017], dtype=torch.int64, device=dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    wo, w1, w2 = ((torch.randn(*s, generator=gen, device=dev) * 0.02).to(bf)
                  for s in ((d, d), (m, d), (d, m)))
    vecs = [vec(d), vec(d, 1.0), vec(d), vec(m), vec(d), vec(d, 1.0), vec(d)]
    bo, s1, g1, b1, b2, s2, g2 = vecs
    wargs = (wo, bo, s1, g1, w1, b1, w2, b2, s2, g2)
    times = {}
    for rows in cases:
        x_q, ctx, gy = rn(rows, d), rn(rows, d), rn(rows, d)
        for rate in (0.0, RATE):
            kw = dict(rate=rate, seed=seed if rate else None)
            label = f" rate={rate} [{rows},{d}]->{m}"
            ma, mf = BT.seed_masks(seed, rows, d, rate, dev)
            got = BT.block_train_fwd(x_q, ctx, *wargs, emit_masks=rate > 0, **kw)
            twin = BT.block_train_fwd_plain(x_q, ctx, *wargs, ma, mf, rate=rate)
            sync()
            for name, a, w in zip(("y", "x1h", "pre1", "h", "x2h"), got, twin):
                report(record, "block_train_fwd", (a.float() - w.float()).abs().max().item(),
                       extra=f" {name}{label}")
            if rate and not (torch.equal(got[5].bool(), ma) and torch.equal(got[6].bool(), mf)):
                fail(f"block_train_fwd{label}: the masks it drew differ from the twin's")
            bwd_args = (gy, ctx, *twin[1:], wo, w1, w2, s1, g1, s2)
            del got, twin
            grads = BT.block_train_bwd(*bwd_args, **kw)
            again = BT.block_train_bwd(*bwd_args, **kw)
            want = BT.block_train_bwd_plain(*bwd_args, ma, mf, rate=rate)
            sync()
            for name, a, w in zip(BT.GRAD_NAMES, grads, want):
                w = w.float()
                report(record, "block_train_bwd", (a.float() - w).abs().max().item(),
                       scale=w.abs().max().item(), extra=f" d{name}{label}")
            differ = [name for name, a, b in zip(BT.GRAD_NAMES, grads, again)
                      if not torch.equal(a, b)]
            print(f"kernel block_train_bwd{label}: a second call bit-identical on all 12 outputs: "
                  f"{not differ}", flush=True)
            if differ:
                fail(f"block_train_bwd{label}: two calls differ in d{', d'.join(differ)}")
            del grads, again, want, ma, mf
            if rate and rows in timed_rows:
                keep_here = keep and rows == timed_rows[0]
                times[f"{rows} x {m}"] = block_times(record if keep_here else {}, rows, d, m,
                                                     x_q, ctx, wargs, bwd_args, seed, vecs)
            del bwd_args
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    return times


def block_times(record, rows, d, m, x_q, ctx, wargs, bwd_args, seed, vecs):
    """#9a and #9b at RATE on one row count: kernel, twin (its masks drawn
    from the seed as it runs) and bound, kept in ``record``."""
    from vitxtgqa_tpu_torch.ops import block_train as BT

    wo, w1, w2 = wargs[0], wargs[4], wargs[6]
    wbytes, vbytes = nbytes(wo, w1, w2), nbytes(*vecs)
    masks = lambda: BT.masks_from_seed(seed, rows, d, RATE, x_q.device)
    act_d, act_m = rows * d * 2, rows * m * 2
    extra = f" rate={RATE} [{rows},{d}]->{m}"
    keep_times(record, "block_train_fwd", extra,
               ms=cuda_time_ms(lambda: BT.block_train_fwd(x_q, ctx, *wargs, rate=RATE, seed=seed)),
               plain_ms=cuda_time_ms(lambda: BT.block_train_fwd_plain(
                   x_q, ctx, *wargs, *masks(), rate=RATE), reps=3, warmup=1),
               bound=block_bound(rows, d, m, 2 * act_d, 3 * act_d + 2 * act_m, wbytes, vbytes))
    keep_times(record, "block_train_bwd", extra,
               ms=cuda_time_ms(lambda: BT.block_train_bwd(*bwd_args, rate=RATE, seed=seed)),
               plain_ms=cuda_time_ms(lambda: BT.block_train_bwd_plain(
                   *bwd_args, *masks(), rate=RATE), reps=3, warmup=1),
               bound=block_bound(rows, d, m, 4 * act_d + 2 * act_m, 2 * act_d + 2 * wbytes,
                                 wbytes, vbytes, backward=True))
    return {name: record[name]["ms"] for name in ("block_train_fwd", "block_train_bwd")}


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
    """Production-width models of one registered key (T2S by default; slice
    m: the zoo's) that share one set of random weights."""

    def __init__(self, dev, quiet: bool = False, key: str = "t2s", cfg=None, nf=None,
                 dtype=None):
        """``cfg``, ``nf`` and ``dtype`` (default: the key's production
        config, its answers and bf16) let a dry run on the CPU build a tiny
        model in float32."""
        import torch

        from vitxtgqa_tpu_torch.models.t2s import PRODUCTION_NUM_FINAL_OUTPUTS

        self.dev, self.key = dev, key
        self.nf = PRODUCTION_NUM_FINAL_OUTPUTS if nf is None else nf
        self.cfg = zoo_config(key) if cfg is None else cfg
        self.dtype = torch.bfloat16 if dtype is None else dtype
        t0 = time.perf_counter()
        self.state = self._new(kv_cache_int8=True).init_weights(0).state_dict()
        sync(dev)
        self.n_params = sum(v.numel() for v in self.state.values())
        if not quiet:
            print(f"slices: {key} production width, {self.n_params / 1e6:.1f}M params, bf16, "
                  f"random weights from seed 0, built in {time.perf_counter() - t0:.1f} s",
                  flush=True)

    def with_cfg(self, cfg):
        """These weights under another model config of the same shapes."""
        import copy

        other = copy.copy(self)
        other.cfg = cfg
        return other

    def _new(self, inference_only=True, decode_recompute=False, **opts):
        import inspect

        import torch

        from vitxtgqa_tpu_torch import Options

        cls = model_class(self.key)
        kw = ({"inference_only": inference_only}
              if "inference_only" in inspect.signature(cls).parameters else {})
        return cls(self.cfg, self.nf, bos_idx=2, decode_recompute=decode_recompute,
                   opts=Options(device=self.dev, dtype=self.dtype, **opts), **kw)

    def model(self, inference_only=True, **opts):
        """A model with these Options fields, bf16 on the card, holding the
        shared weights (``inference_only=False``: full-eval)."""
        m = self._new(inference_only, **opts)
        m.load_state_dict(self.state)
        return m

    def batch(self, b: int, seed: int):
        """The synthetic batch at production dims (with the GT-box fields
        for gt_box)."""
        from vitxtgqa_tpu_torch.utils.synthetic import synthetic_batch

        return synthetic_batch(batch=b, num_final_outputs=self.nf, seed=seed,
                               gt_box=self.key == "gt_box")

    def grounding_shapes(self):
        """(ground_frame, ground_box) shapes of one row of the outputs."""
        g = self.cfg["grounding"]
        f, k, ft, ot = g["frame_num"], g["ocr_frame_num"], g["frame_topk"], g["ocr_topk"]
        return {"t2s": ((ft,), (f * ot, 4)), "t2s_wo_tg": ((ft,), (f * min(ft * ot, k), 4)),
                "t2s_wo_sg": ((ft,), (ft * k, 4)), "m4c": ((1,), (ot, 4)),
                "t5vitevqa": ((f,), (ft * ot, 4)), "gt_box": ((f,), (f * k, 4)),
                "transtr": ((ft,), (ft * ot, 4)), "mist": ((ft,), (min(25, f * k), 4))}[self.key]


def count_launches(name, record, counts, want):
    """Fail unless ``counts`` are ``want``; add them to the record."""
    for k, v in want.items():
        if counts[k] != v:
            fail(f"{name}: {k} launched {counts[k]} times, expected {v}")
        record.setdefault(k, {}).setdefault("launches", 0)
        record[k]["launches"] += counts[k]


def check_outputs(outs, nf, shapes=((5,), (64 * 5, 4))):
    import numpy as np

    for o in outs:
        if o["pos_scores"].shape != (DEC_LEN, nf) or o["pos_scores"].dtype != np.float32:
            fail(f"pos_scores {o['pos_scores'].shape} {o['pos_scores'].dtype}")
        if (o["ground_frame"].shape, o["ground_box"].shape) != shapes:
            fail(f"grounding shapes {o['ground_frame'].shape} {o['ground_box'].shape}, "
                 f"expected {shapes}")
        for k in ("pos_scores", "ground_box"):
            if not np.isfinite(o[k]).all():
                fail(f"non-finite {k}")


def serve_slice(name, sl: Slices, record, opts: dict, groups, rng_seed=0, batch=None,
                near_ties=None):
    """Serve ``groups`` (one request count per group, each filling its own
    bucket) through a ServingEngine over the kernels; check the launch
    counts of every group's forward, that the engine's rows equal a direct
    forward, and the direct forward against the plain versions on the same
    batch (``sl.batch(max(groups), 0)`` unless given), weights and gumbel
    noise; the grounding of the models whose heads see no kernel output
    (SINGLE_PASS) equal bit for bit.  ``near_ties`` ({batch: rows}): at
    most that many rows of a group may take another grounding than
    plain's, each then held against plain run on the kernels' grounding
    (near_tie_faults), with the two picks' margins printed (swap_margins).
    Returns (model, summary)."""
    import numpy as np
    import torch

    from vitxtgqa_tpu_torch.ops import _build
    from vitxtgqa_tpu_torch.serving.engine import ServingEngine, group_generator, to_device

    model, plain_model = sl.model(**opts), sl.model(plain=True, **opts)
    buckets = tuple(sorted(set(groups)))
    nb = max(buckets)
    batch = sl.batch(nb, 0) if batch is None else batch
    samples = [{k: v[i] for k, v in batch.items()} for i in range(nb)]
    summary = {"opts": {k: str(v) for k, v in opts.items()}, "groups": []}
    with ServingEngine(model, buckets=buckets, max_wait_ms=300, rng_seed=rng_seed) as eng:
        eng.warmup(samples[0])
        torch.cuda.synchronize()
        for gid, n in enumerate(groups):
            _build.reset_launch_counts()
            before = eng._group_counter
            outs = [f.result(timeout=600) for f in [eng.submit(s) for s in samples[:n]]]
            torch.cuda.synchronize()
            counts = _build.launch_counts()
            if eng._group_counter != before + 1:
                fail(f"slice {name}: {n} requests were dispatched as "
                     f"{eng._group_counter - before} groups")
            print(f"slice {name}: launches in one served forward at batch {n} "
                  + json.dumps(counts), flush=True)
            count_launches(f"slice {name}, a batch-{n} forward", record, counts,
                           expected_launches(sl.cfg, n, model.opts, model=sl.key))
            check_outputs(outs, sl.nf, sl.grounding_shapes())

            sub = {k: v[:n] for k, v in batch.items()}
            tb = to_device(sub, sl.dev)
            probes = [GroundingProbe(m) if near_ties is not None else None
                      for m in (model, plain_model)]
            with torch.inference_mode():
                kern = model(tb, group_generator(rng_seed, gid, sl.dev))
                plain = plain_model(tb, group_generator(rng_seed, gid, sl.dev))
            kp, pp = kern["pos_scores"].cpu().numpy(), plain["pos_scores"].cpu().numpy()
            wrong = engine_row_faults(outs, {k: v.float().cpu().numpy() if v.is_floating_point()
                                             else v.cpu().numpy() for k, v in kern.items()
                                             if torch.is_tensor(v) and v.ndim})
            if wrong:
                fail(f"slice {name}: the engine's rows {wrong} differ from a direct forward on "
                     "the same batch")
            diff_all = float(np.abs(kp - pp).max())
            diff0 = float(np.abs(kp[:, 0] - pp[:, 0]).max())
            agree = float((kp.argmax(-1) == pp.argmax(-1)).mean())
            gf = float((kern["ground_frame"] == plain["ground_frame"]).float().mean().item())
            print(f"slice {name}: batch {n} kernels vs plain on the card: max|d pos_scores| "
                  f"{diff_all:.4e} (step 0: {diff0:.4e}, tol {STEP0_TOL}), greedy-token "
                  f"agreement {agree:.4f} (min {MIN_TOKEN_AGREEMENT}), ground_frame agreement "
                  f"{gf:.4f}", flush=True)
            group = {"batch": n, "launches": counts, "pos_scores_max_abs_diff": diff_all,
                     "step0_max_abs_diff": diff0, "token_agreement": agree,
                     "ground_frame_agreement": gf}
            if near_ties is not None:
                for p in probes:
                    p.remove()
                same = np.asarray([all(torch.equal(kern[k][r], plain[k][r])
                                       for k in ("ground_frame", "ground_box")) for r in range(n)])
                forced = None
                if not same.all():
                    # plain again, with the kernels' grounding in place of its own
                    force = GroundingProbe(plain_model, force=probes[0].out)
                    with torch.inference_mode():
                        forced = plain_model(tb, group_generator(rng_seed, gid, sl.dev))
                    force.remove()
                    forced = forced["pos_scores"].cpu().numpy()
                    swaps = swap_margins(probes[0], probes[1], np.flatnonzero(~same))
                    for s in swaps:
                        print(f"slice {name}: batch {n} row {s['row']}: the kernels pick "
                              f"{s['kind']} slot {s['kernel_pick']} where plain picks "
                              f"{s['plain_pick']}: plain's margin {s['plain_margin']:.4e} "
                              f"({s['plain_margin_ulps']:.2f} bf16 ulps at {s['plain_score']:.4e})"
                              f", the kernels' {s['kernel_margin']:.4e}; the row's largest "
                              f"|d {s['kind']} score| {s['row_score_diff']:.4e}, the batch's "
                              f"on rows of equal grounding {s['batch_score_diff']:.4e}; in "
                              f"log-scores plain's margin {s['plain_log_margin']:.4e} "
                              f"({s['plain_log_margin_ulps']:.3f} bf16 ulps at "
                              f"{np.log(s['plain_score']):.2f}), the row's median |d| "
                              f"{s['row_log_score_diff']:.4e}", flush=True)
                    group["near_ties"] = swaps
                faults, exempt0 = near_tie_faults(kp, pp, forced, same, near_ties.get(n, 0))
                print(f"slice {name}: batch {n}: {int((~same).sum())} rows whose grounding "
                      f"differs from plain's (at most {near_ties.get(n, 0)}); step 0 with each "
                      f"such row against plain on the kernels' grounding: {exempt0:.4e} (tol "
                      f"{STEP0_TOL})", flush=True)
                if faults:
                    fail(f"slice {name}: " + "; ".join(faults))
                group.update(grounding_agreement=float(same.mean()), near_tie_step0=exempt0)
                diff0 = exempt0
            if not diff0 <= STEP0_TOL or agree < MIN_TOKEN_AGREEMENT:
                fail(f"slice {name}: the kernels disagree with the plain versions")
            if sl.key in SINGLE_PASS and not all(torch.equal(kern[k], plain[k]) for k in (
                    "ground_frame", "ground_box")):
                fail(f"slice {name}: the grounding differs from the plain versions'")
            summary["groups"].append(group)
    del plain_model
    return model, summary


class GroundingProbe:
    """A forward hook on a T2S-family model's Grounding_Module: keeps the
    module's output (``out``) and the attention scores its top-k ranks,
    the frames' [B, F] and the OCR slots' [B, N] (``scores``); with
    ``force`` (another probe's ``out``) the module's output is replaced by
    it, so that the rest of the forward runs on that grounding."""

    def __init__(self, model, force=None):
        self.module, self.force = model.Grounding_Module, force
        self.out, self.scores = None, None
        self.handle = self.module.register_forward_hook(self)

    def __call__(self, module, args, out):
        from vitxtgqa_tpu_torch.models.grounding import attention_score, frames_to_ocr_mask

        q_feat, q_mask, frame_feat, frame_mask, _, ocr_feat, _, _, temporal_id = args[:9]
        q_global = module.pool_question(q_feat, q_mask)
        self.out = out
        self.scores = {
            "frame": attention_score(q_global, frame_feat, frame_mask),
            "ocr": attention_score(q_global, ocr_feat,
                                   frames_to_ocr_mask(out["ground_frame"], temporal_id))}
        return self.force

    def remove(self):
        self.handle.remove()


def bf16_ulp(x: float) -> float:
    """The spacing of bfloat16 numbers (8 significant bits) at ``x``."""
    import math

    return 2.0 ** (math.floor(math.log2(abs(x))) - 7) if x else 2.0 ** -133


def swap_margins(kern, plain, rows) -> list:
    """For each row of ``rows`` and each frame or OCR slot the kernels'
    grounding picks where plain's picks another (paired in slot order, an
    OCR slot with one of its own frame, where the top-k is taken):
    plain's own margin between its pick and the kernels' (how near the tie
    was on plain's scores, also in bf16 ulps at plain's score), the
    kernels' margin the other way, the row's largest |kernel - plain|
    difference of those scores and the batch's over the rows whose
    grounding is equal.  The scores are softmax probabilities, which
    random weights push far below 1 off the top slots; there a margin
    reads better as one of log-scores (the logits up to a row constant):
    plain's log margin, also in bf16 ulps at plain's log-score, and the
    row's median |kernel - plain| log-score difference over the slots
    both runs score (NaN where a score is not positive).  ``kern`` /
    ``plain``: GroundingProbes."""
    import numpy as np

    def log(x):
        return np.log(x) if x > 0 else float("nan")

    out = []
    per_frame = kern.module.ocr_frame_num
    for kind, key in (("frame", "pos_obj_idx"), ("ocr", "pos_ocr_idx")):
        group = (lambda slot: 0) if kind == "frame" else (lambda slot: slot // per_frame)
        ks, ps = (p.scores[kind].float().cpu().numpy() for p in (kern, plain))
        ki, pi = (p.out[key].cpu().numpy() for p in (kern, plain))
        d = np.abs(ks - ps)
        valid = ps > -1000.0  # -10000 marks a masked slot
        rest = np.setdiff1d(np.arange(len(ks)), rows)
        batch_diff = float(np.where(valid, d, 0.0)[rest].max()) if len(rest) else float("nan")
        both = (ks > 0) & (ps > 0)
        log_d = np.abs(np.log(np.where(both, ks, 1.0)) - np.log(np.where(both, ps, 1.0)))
        for r in rows:
            k_only = sorted(set(ki[r].tolist()) - set(pi[r].tolist()))
            p_only = sorted(set(pi[r].tolist()) - set(ki[r].tolist()))
            pairs = [(a, b) for g in sorted({group(x) for x in k_only + p_only})
                     for a, b in zip([x for x in k_only if group(x) == g],
                                     [x for x in p_only if group(x) == g])]
            for a, b in pairs:
                out.append({
                    "row": int(r), "kind": kind, "kernel_pick": int(a), "plain_pick": int(b),
                    "plain_score": float(ps[r, b]), "plain_margin": float(ps[r, b] - ps[r, a]),
                    "plain_margin_ulps": float((ps[r, b] - ps[r, a]) / bf16_ulp(ps[r, b])),
                    "kernel_margin": float(ks[r, a] - ks[r, b]),
                    "row_score_diff": float(np.where(valid[r], d[r], 0.0).max()),
                    "batch_score_diff": batch_diff,
                    "plain_log_margin": float(log(ps[r, b]) - log(ps[r, a])),
                    "plain_log_margin_ulps": float(
                        (log(ps[r, b]) - log(ps[r, a])) / bf16_ulp(log(ps[r, b])))
                    if ps[r, b] > 0 else float("nan"),
                    "row_log_score_diff": float(np.median(log_d[r][both[r]]))
                    if both[r].any() else float("nan")})
    return out


def near_tie_faults(kp, pp, forced, same, cap: int):
    """The step-0 check of a group whose grounding may differ from plain's
    in a few rows: the grounding's top-k is hard, and where bf16 noise
    flips a near tie between two OCR slots the copy scores of both slots
    move by ~1 while the rest of the row agrees.  Such a row is held
    against ``forced``, the plain versions run again with the kernels'
    grounding in place of their own; every other row against ``pp`` as
    before.  Returns (faults: more such rows than ``cap``; the step-0 max
    |diff| on these terms; ``forced`` missing where a row needs it)."""
    import numpy as np

    same = np.asarray(same)
    flipped = np.flatnonzero(~same)
    faults = []
    if len(flipped) > cap:
        faults.append(f"{len(flipped)} rows (rows {flipped.tolist()}) whose grounding differs "
                      f"from the plain versions', at most {cap}")
    d0 = np.abs(kp[:, 0] - pp[:, 0])
    if len(flipped):
        if forced is None:
            faults.append(f"rows {flipped.tolist()} have no run on the kernels' grounding")
        else:
            d0[flipped] = np.abs(kp[flipped, 0] - forced[flipped, 0])
    step0 = float(d0.max())
    if not step0 <= STEP0_TOL:
        faults.append(f"step 0 max|d| {step0:.4e} (tol {STEP0_TOL})")
    return faults, step0


def full_eval_slice(sl: Slices, record, card, compact: bool = False, batch_size: int = BATCH):
    """d. full-eval at batch 8, int8 cache: the pos decode, then ref / neg
    from one teacher-forced pass at 2B (h., ``compact``: the pos decode and
    the neg pass on the kept rows, ref over the full sequence at B); the
    same batch, weights and noise through the plain versions.  Slice m:
    the ablations at batch 2."""
    import numpy as np
    import torch

    from vitxtgqa_tpu_torch.ops import _build
    from vitxtgqa_tpu_torch.serving.engine import group_generator, to_device

    name = f"{'compact_' if compact else ''}full_eval_b{batch_size}"
    if sl.key != "t2s":
        name = f"{sl.key}_{name}"
    opts = dict(kv_cache_int8=True, compact_serving=compact)
    model = sl.model(inference_only=False, **opts)
    plain = sl.model(inference_only=False, plain=True, **opts)
    batch = sl.batch(batch_size, 1)
    tb = to_device(batch, sl.dev)
    forward_ms(model, batch, sl.dev, reps=1)  # warm-up
    _build.reset_launch_counts()
    with torch.inference_mode():
        kern = model(tb, group_generator(0, 0, sl.dev))
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    print(f"slice {name}: launches in one full-eval forward at batch {batch_size} "
          + json.dumps(counts), flush=True)
    count_launches(f"slice {name}", record, counts,
                   expected_launches(sl.cfg, batch_size, model.opts, full_eval=True, model=sl.key))
    with torch.inference_mode():
        ref = plain(tb, group_generator(0, 0, sl.dev))
    out = {k: v.float().cpu().numpy() for k, v in kern.items() if torch.is_tensor(v)}
    want = {k: v.float().cpu().numpy() for k, v in ref.items() if torch.is_tensor(v)}
    for k in ("ref_scores", "pos_scores", "neg_scores"):
        if out[k].shape != (batch_size, DEC_LEN, sl.nf) or not np.isfinite(out[k]).all():
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


def step_agreement(run, ref, loss_tol=LOSS_REL_TOL, norm_tol=GNORM_REL_TOL,
                   noise=("attention.self.key.bias", "k_lin.bias")):
    """(loss relative difference, gradient-norm relative difference,
    (largest per-parameter gradient relative difference |g - g_ref| /
    |g_ref|, its parameter), parameters compared, whether all three are
    within their limits: ``loss_tol``, ``norm_tol``, GRAD_REL_TOL) of
    ``run`` against ``ref``, each (loss, norm, {parameter: gradient},
    ...).  ``noise``: the name endings of parameters left out, whose
    gradient is 0 but for rounding."""
    (loss, norm, grads, *_), (loss_r, norm_r, grads_r, *_) = run, ref
    if sorted(grads) != sorted(grads_r):
        fail("slice train: two steps reach different parameters")
    rel = {}
    for k, w in grads_r.items():
        # a key projection's bias (the BERT layers', the DETR layers') moves
        # every score of a query alike, which the softmax ignores: its
        # gradient is 0 but for rounding, and is left out
        nw = w.norm()
        if nw > 0 and not k.endswith(tuple(noise)):
            rel[k] = float((grads[k] - w).norm() / nw)
    worst = worst_of(rel)
    loss_rel, norm_rel = abs(loss - loss_r) / abs(loss_r), abs(norm - norm_r) / norm_r
    ok = loss_rel <= loss_tol and norm_rel <= norm_tol and rel[worst] <= GRAD_REL_TOL
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


def runtime_eval_forwards(iterations: int, log_interval: int, snapshot_interval: int,
                          val_batches: int, first: int = 1) -> int:
    """Eval forwards of the trainer over iterations ``first`` to
    ``iterations`` of a training run: a one-batch validation probe every
    ``log_interval``, a full validation (``val_batches`` forwards) every
    ``snapshot_interval`` and one more at the end (finalize)."""
    its = range(first, iterations + 1)
    snapshots = sum(i % snapshot_interval == 0 for i in its) + 1
    return sum(i % log_interval == 0 for i in its) + snapshots * val_batches


def runtime_launches(cfg, opts, steps: int, forwards: int, batch: int,
                     model: str = "t2s") -> dict:
    """Kernel launches of ``steps`` training steps and ``forwards`` eval
    forwards (full-eval in the T2S family) at ``batch``."""
    train = expected_train_launches(cfg, opts, model)
    val = expected_launches(cfg, batch, opts, full_eval=model in T2S_FAMILY, model=model)
    return {k: steps * train[k] + forwards * val[k] for k in REPLACES}


def runtime_argv(config: str, run_type: str, fixroot: str, save_dir: str, **tp) -> list:
    """``python -m vitxtgqa_tpu_torch.run`` arguments on the fixture tree:
    the config's model and switches (its worker processes too), these
    training_parameters."""
    return (["--config", os.path.join(ROOT, "configs", config), "--model", "t2s", "--datasets",
             "vtextgqa", "--run_type", run_type,
             f"dataset_attributes.vtextgqa.data_root_dir={fixroot}",
             f"training_parameters.save_dir={save_dir}", "training_parameters.seed=1"]
            + [f"training_parameters.{k}={v}" for k, v in tp.items()])


def write_fixtures(root: str) -> None:
    """The fixture tree of tools/make_fixtures.py (numpy only) under root."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_fixtures", os.path.join(ROOT, "tools", "make_fixtures.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    tool.main(root)


def runtime_trainer(argv):
    """A loaded trainer of these arguments (run()'s steps before train())."""
    from vitxtgqa_tpu_torch.core.config import build_config
    from vitxtgqa_tpu_torch.core.flags import get_parser
    from vitxtgqa_tpu_torch.run import setup_imports
    from vitxtgqa_tpu_torch.training.trainer import BaseTrainer

    setup_imports()
    args = get_parser().parse_args(argv)
    trainer = BaseTrainer(build_config(args.config, opts=args.opts, args=args))
    trainer.load()
    return trainer


def check_predictions(name, trainer):
    """The EvalAI JSON of a prediction run has the JAX trainer's schema, a
    row per test question."""
    reports = os.path.join(trainer.logger.save_dir, "reports")
    (report,) = os.listdir(reports)
    with open(os.path.join(reports, report)) as f:
        rows = json.load(f)
    g = trainer.model_cfg["grounding"]
    keys = ["answer", "grounded box", "grounded frame", "pred_source", "question_id", "video_id"]
    for row in rows:
        if (sorted(row) != keys or len(row["grounded frame"]) != g["frame_topk"]
                or [len(row["grounded box"]), len(row["grounded box"][0])]
                != [g["frame_num"] * g["ocr_topk"], 4]
                or not set(row["pred_source"]) <= {"OCR", "VOCAB"}
                or not isinstance(row["answer"], str)):
            fail(f"slice {name}: a prediction row off the schema: {row}")
    if len(rows) != len(trainer.datasets["test"]):
        fail(f"slice {name}: {len(rows)} predictions for {len(trainer.datasets['test'])} questions")
    return rows


@contextlib.contextmanager
def plain_family(name):
    """Run one kernel family's autograd node through its plain twins (its
    plain flag set) for the duration: "attention" (#1 / #1b, AttentionFn)
    or "block" (#9a / #9b, BlockTrainFn)."""
    from vitxtgqa_tpu_torch.ops import attention as A
    from vitxtgqa_tpu_torch.ops import block_train as BT

    cls = {"attention": A.AttentionFn, "block": BT.BlockTrainFn}[name]
    apply = cls.apply
    cls.apply = lambda *a: apply(*a[:-1], True)   # plain is the last argument
    try:
        yield
    finally:
        del cls.apply


# slice l's first step, each form from the trainer's weights, batch and
# generators: (options, the family run through its plain twins)
RUNTIME_STEP_FORMS = {
    "kernels": ({}, None),
    "plain": ({"plain": True}, None),
    "float32": ({"plain": True, "dtype": "float32"}, None),
    "plain_attention": ({}, "attention"),
    "plain_block": ({}, "block"),
}
FAMILY_KERNELS = {"attention": ("flash_attention_merged", "flash_attention_merged_bwd"),
                  "block": ("block_train_fwd", "block_train_bwd")}


def runtime_step(k, tensors, dev, form: str = "kernels", fault=None) -> dict:
    """The first training step of trainer ``k``'s model on ``tensors`` in
    one of RUNTIME_STEP_FORMS (a fresh model from the trainer's weights),
    with one of PLANTED_FAULTS where named: its loss and parts, every
    parameter's f32 gradient and their global norm, the launch counts and
    the grounded frames."""
    import dataclasses

    import torch

    from vitxtgqa_tpu_torch.ops import _build
    from vitxtgqa_tpu_torch.training.step import step_generators
    from vitxtgqa_tpu_torch.training.trainer import build_model

    fields, family = RUNTIME_STEP_FORMS[form]
    fields = {n: getattr(torch, v) if n == "dtype" else v for n, v in fields.items()}
    model = build_model("t2s", k.model_cfg, k.dataset_name, dataclasses.replace(k.opts, **fields))
    model.load_state_dict(k.model.state_dict())
    dropout_gen, gumbel_gen = step_generators(k.rng_seed, 1, dev)
    _build.reset_launch_counts()
    with contextlib.ExitStack() as stack:
        if family:
            stack.enter_context(plain_family(family))
        if fault:
            stack.enter_context(planted_fault(fault, model))
        out = model(tensors, gumbel_gen, train=True, dropout_gen=dropout_gen)
        total, parts = k.losses.total(tensors, out)
        total.backward()
    torch.cuda.synchronize()
    grads = {n: p.grad.float().flatten() for n, p in model.named_parameters()
             if p.grad is not None}
    return {"loss": total.item(), "parts": {n: float(v.detach()) for n, v in parts.items()},
            "grads": grads, "launches": _build.launch_counts(),
            "norm": torch.linalg.vector_norm(torch.cat(list(grads.values()))).item(),
            "ground_frame": out["ground_frame"].tolist()}


def runtime_agreement(run: dict, ref: dict):
    """step_agreement of two runtime_step results at slice l's limits,
    flat: (loss, norm, largest gradient relative difference, its
    parameter, parameters compared, within)."""
    flat = lambda r: (r["loss"], r["norm"], r["grads"])
    loss_rel, norm_rel, (grad_rel, worst), n, ok = step_agreement(
        flat(run), flat(ref), RUNTIME_LOSS_REL_TOL, RUNTIME_GNORM_REL_TOL)
    return loss_rel, norm_rel, grad_rel, worst, n, ok


def runtime_step_check(k, tensors, dev) -> dict:
    """Slice l (ii): the trainer's first step through the kernels against
    the plain versions (bf16 both) within RUNTIME_LOSS_REL_TOL /
    RUNTIME_GNORM_REL_TOL / GRAD_REL_TOL; the plain step with each planted
    fault outside them; each form's distance from the float32 step
    printed, the kernels with one family's plain twins swapped in among
    them.  Launches: the derived ones through the kernels, none of a
    family run plain."""
    steps = {form: runtime_step(k, tensors, dev, form) for form in RUNTIME_STEP_FORMS}
    train = expected_train_launches(k.model_cfg, k.opts)
    for form, (fields, family) in RUNTIME_STEP_FORMS.items():
        want = {n: 0 if fields or n in FAMILY_KERNELS.get(family, ()) else v
                for n, v in train.items()}
        if steps[form]["launches"] != want:
            fail(f"slice runtime_check: {form} launches {steps[form]['launches']} (want {want})")
    kern, plain, f32 = steps["kernels"], steps["plain"], steps["float32"]
    loss_rel, norm_rel, grad_rel, worst, n, ok = runtime_agreement(kern, plain)
    print(f"slice runtime_check: the trainer's first step, kernels vs plain (bf16): loss "
          f"{kern['loss']:.6f} vs {plain['loss']:.6f} (rel {loss_rel:.3e}, limit "
          f"{RUNTIME_LOSS_REL_TOL}; {kern['parts']} vs {plain['parts']}), gradient norm "
          f"{kern['norm']:.6g} vs {plain['norm']:.6g} (rel {norm_rel:.3e}, limit "
          f"{RUNTIME_GNORM_REL_TOL}), per-parameter gradient rel diff max {grad_rel:.3e} "
          f"({worst}) over {n} parameters (limit {GRAD_REL_TOL}); grounding equal "
          f"{kern['ground_frame'] == plain['ground_frame'] == f32['ground_frame']}", flush=True)
    summary = {"loss": {f: s["loss"] for f, s in steps.items()},
               "parts": {f: s["parts"] for f, s in steps.items()},
               "grad_norm": {f: s["norm"] for f, s in steps.items()},
               "against_plain": runtime_agreement(kern, plain)[:4], "against_float32": {},
               "faults": {}}
    for form in RUNTIME_STEP_FORMS:
        if form != "float32":
            yard = runtime_agreement(steps[form], f32)
            summary["against_float32"][form] = yard[:4]
            print(f"slice runtime_check: {form} against the float32 step: loss {yard[0]:.3e}, "
                  f"gradient norm {yard[1]:.3e}, parameter max {yard[2]:.3e} ({yard[3]})"
                  + ("" if form in ("kernels", "plain") else
                     "; against plain: loss {:.3e}, gradient norm {:.3e}, parameter max {:.3e} "
                     "({})".format(*runtime_agreement(steps[form], plain)[:4])), flush=True)
    del steps
    faults_ok = True
    for fault in PLANTED_FAULTS:
        run = runtime_agreement(runtime_step(k, tensors, dev, "plain", fault=fault), plain)
        summary["faults"][fault] = run[:4]
        faults_ok &= not run[5]
        print(f"slice runtime_check: the plain step with the planted fault {fault} against "
              f"plain: loss {run[0]:.3e}, gradient norm {run[1]:.3e}, parameter max "
              f"{run[2]:.3e} ({run[3]}): {'rejected' if not run[5] else 'PASSED the limits'}",
              flush=True)
    if not ok:
        fail("slice runtime_check: the kernel step disagrees with the plain step")
    if not faults_ok:
        fail("slice runtime_check: a planted fault passes the limits")
    return summary


def decode_agreement(out: dict, ref: dict):
    """(greedy-token agreement, max |d pos_scores| at step 0, {scores: max
    |d| on the rows whose tokens all agree, None if none do}) of a
    forward's outputs against another's: pos_scores, and ref / neg where
    both have them.  A NaN is never within a tolerance."""
    import numpy as np

    got = {k: v.float().cpu().numpy() for k, v in out.items()
           if k in ("pos_scores", "ref_scores", "neg_scores")}
    want = {k: ref[k].float().cpu().numpy() for k in got if k in ref}
    tok, tok_r = got["pos_scores"].argmax(-1), want["pos_scores"].argmax(-1)
    same = (tok == tok_r).all(-1)
    nan = lambda d: float("inf") if np.isnan(d) else float(d)
    diffs = {k: nan(np.abs(got[k][same] - want[k][same]).max()) if same.any() else None
             for k in want}
    diff0 = nan(np.abs(got["pos_scores"][:, 0] - want["pos_scores"][:, 0]).max())
    return float((tok == tok_r).mean()), diff0, diffs


def runtime_slice(dev, record, card):
    """l. The runtime on fixture data written at run time by
    tools/make_fixtures.py, configs/t2s_abinet.yml's model at its widths
    (the fixtures' answer vocabulary sets the classifier) and its worker
    processes, batch RUNTIME_BATCH, bf16: (i) run() trains RUNTIME_STEPS
    steps with its validations and checkpoints; (ii) runtime_step_check:
    the first step through the kernels against the plain versions, the
    planted faults, each form against float32; (iii) a resume from
    ckpt/best and one more step; (iv) predictions with
    configs/t2s_serving.yml at batch 2 (the fused decode step) and at 6
    (the int8 decode attention); (v) the recompute decode oracle at
    production width against the cached decode, serving and full-eval,
    tokens and scores.  Launches as derived in each; the host-clock times
    of each iteration and validation pass and the data-wait share
    printed."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from vitxtgqa_tpu_torch import Options
    from vitxtgqa_tpu_torch.data.loader import infinite_batches
    from vitxtgqa_tpu_torch.models.t2s import T2S
    from vitxtgqa_tpu_torch.ops import _build
    from vitxtgqa_tpu_torch.run import run
    from vitxtgqa_tpu_torch.serving.engine import group_generator, to_device
    from vitxtgqa_tpu_torch.utils.synthetic import synthetic_batch

    out = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_runtime_")
    try:
        fixroot = os.path.join(tmp, "data")
        write_fixtures(fixroot)
        train_tp = dict(batch_size=RUNTIME_BATCH, max_iterations=RUNTIME_STEPS,
                        warmup_iterations=2, snapshot_interval=RUNTIME_STEPS, log_interval=1)
        save = os.path.join(tmp, "train")

        # (i) train through run()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        trainer = run(runtime_argv("t2s_abinet.yml", "train", fixroot, save, **train_tp))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _build.launch_counts()
        cfg, opts = trainer.model_cfg, trainer.opts
        val_batches = len(trainer.loaders["val"])
        forwards = runtime_eval_forwards(RUNTIME_STEPS, 1, RUNTIME_STEPS, val_batches)
        print(f"slice runtime_train: classifier {trainer.model.classifier.module.weight.shape[0]} "
              f"answers + {cfg['classifier']['ocr_max_num']} OCR slots, {opts.dtype}, batch "
              f"{RUNTIME_BATCH}; launches in {RUNTIME_STEPS} steps and {forwards} full-eval "
              "forwards " + json.dumps(counts), flush=True)
        count_launches("slice runtime_train", record, counts,
                       runtime_launches(cfg, opts, RUNTIME_STEPS, forwards, RUNTIME_BATCH))
        losses = list(trainer.meter["train/total_loss"].series)
        if len(losses) != RUNTIME_STEPS or not all(np.isfinite(losses)):
            fail(f"slice runtime_train: losses {losses}")
        for d in ("best", "final"):
            if not os.path.exists(os.path.join(save, "ckpt", d, "state.pt")):
                fail(f"slice runtime_train: no ckpt/{d}")
        scalars = trainer.meter.get_scalar_dict()
        val = {t: scalars.get(f"val/vtextgqa/{t}") for t in (
            "textvqa_accuracy", "stvqa_anls", "IOU@0.3", "IOU@0.5", "GQA@0.3", "GQA@0.5")}
        if not all(v is not None and 0.0 <= v <= 1.0 for v in val.values()):
            fail(f"slice runtime_train: validation metrics {val}")
        it_ms, wait_ms, val_ms = (trainer.timings[k] for k in ("iteration_ms", "data_wait_ms",
                                                                "val_ms"))
        share, later = sum(wait_ms) / sum(it_ms), sum(wait_ms[1:]) / sum(it_ms[1:])
        print(f"slice runtime_train: losses {losses}; val {val}; iteration ms "
              f"{[round(x, 2) for x in it_ms]} (the first builds the step's state), data-wait "
              f"ms {[round(x, 2) for x in wait_ms]} ({trainer.loaders['train'].num_workers} "
              f"worker processes), data-wait share {share:.4f}, after the first iteration "
              f"{later:.4f}; validation "
              f"pass ms ({val_batches} batches) {[round(x, 2) for x in val_ms]}; run() wall "
              f"{wall:.1f} s; card {card}", flush=True)
        out["train"] = {"launches": counts, "losses": losses, "val": val, "iteration_ms": it_ms,
                        "data_wait_ms": wait_ms, "data_wait_share": share,
                        "data_wait_share_after_first": later, "val_ms": val_ms,
                        "wall_s": wall}
        del trainer

        # (ii) the first step in each form, and the plain step with each
        # planted fault
        k = runtime_trainer(runtime_argv("t2s_abinet.yml", "train", fixroot,
                                         os.path.join(tmp, "check"), **train_tp))
        tensors, _ = k._split_device_batch(next(infinite_batches(k.loaders["train"])))
        k.close()
        out["check"] = runtime_step_check(k, tensors, dev)
        del k, tensors
        torch.cuda.empty_cache()

        # (iii) resume from ckpt/best, one more step
        best = os.path.join(save, "ckpt", "best")
        with open(os.path.join(best, "meta.json")) as f:
            meta = json.load(f)
        r = runtime_trainer(runtime_argv("t2s_abinet.yml", "train", fixroot,
                                         os.path.join(tmp, "resume"),
                                         **{**train_tp, "max_iterations": RUNTIME_STEPS + 1})
                            + [f"training_parameters.resume_file={best}"])
        saved = torch.load(os.path.join(best, "state.pt"), map_location=dev)["model"]
        state = r.model.state_dict()
        equal = sorted(saved) == sorted(state) and all(torch.equal(state[n], saved[n])
                                                        for n in saved)
        where = (r.iteration, r.current_epoch, r.epoch_batch)
        if where != (meta["iteration"], meta["epoch"], meta["epoch_batch"]) or not equal:
            fail(f"slice runtime_resume: restored {where}, meta {meta['iteration']}, "
                 f"{meta['epoch']}, {meta['epoch_batch']}; parameters equal {equal}")
        del saved, state
        _build.reset_launch_counts()
        r.train()
        r.close()
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        forwards = runtime_eval_forwards(RUNTIME_STEPS + 1, 1, RUNTIME_STEPS, val_batches,
                                         first=RUNTIME_STEPS + 1)
        count_launches("slice runtime_resume", record, counts,
                       runtime_launches(r.model_cfg, r.opts, 1, forwards, RUNTIME_BATCH))
        losses = list(r.meter["train/total_loss"].series)
        if len(losses) != 1 or not np.isfinite(losses[0]):
            fail(f"slice runtime_resume: losses {losses}")
        print(f"slice runtime_resume: restored iteration {where[0]}, epoch {where[1]}, batch "
              f"{where[2]} of it, parameters bit for bit; step {RUNTIME_STEPS + 1} loss "
              f"{losses[0]:.6f}, {r.timings['iteration_ms'][0]:.2f} ms; launches "
              + json.dumps(counts), flush=True)
        out["resume"] = {"restored": where, "loss": losses[0], "launches": counts,
                         "iteration_ms": r.timings["iteration_ms"]}
        del r
        torch.cuda.empty_cache()

        # (iv) predictions with the serving preset
        for b in (2, 6):
            _build.reset_launch_counts()
            p = run(runtime_argv("t2s_serving.yml", "inference", fixroot,
                                 os.path.join(tmp, f"predict_b{b}"), batch_size=b)
                    + [f"training_parameters.resume_file={best}"])
            torch.cuda.synchronize()
            counts = _build.launch_counts()
            name = f"runtime_predict_b{b}"
            batches = len(p.loaders["test"])
            want = {n: batches * v for n, v in expected_launches(p.model_cfg, b, p.opts).items()}
            count_launches(f"slice {name}", record, counts, want)
            rows = check_predictions(name, p)
            print(f"slice {name}: {len(rows)} predictions in {batches} batches ({p.opts}); "
                  f"launches " + json.dumps(counts) + f"; first row {json.dumps(rows[0])[:200]}",
                  flush=True)
            out[name] = {"launches": counts, "rows": len(rows)}
            del p

        # (v) the recompute decode oracle at production width
        sl = Slices(dev, quiet=True)
        tb = to_device(synthetic_batch(batch=RUNTIME_BATCH, num_final_outputs=sl.nf, seed=4), dev)
        for full_eval in (False, True):
            name = "runtime_recompute" + ("_full_eval" if full_eval else "")
            models = []
            for recompute in (False, True):
                m = T2S(sl.cfg, sl.nf, bos_idx=2, inference_only=not full_eval,
                        decode_recompute=recompute, opts=Options(device=dev))
                m.load_state_dict(sl.state)
                models.append(m)
            with torch.inference_mode():
                cached = models[0](tb, group_generator(0, 0, dev))
                _build.reset_launch_counts()
                t0 = time.perf_counter()
                oracle = models[1](tb, group_generator(0, 0, dev))
                torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            counts = _build.launch_counts()
            count_launches(f"slice {name}", record, counts, expected_recompute_launches(
                sl.cfg, RUNTIME_BATCH, models[1].opts, full_eval=full_eval))
            agree, diff0, diffs = decode_agreement(oracle, cached)
            print(f"slice {name}: batch {RUNTIME_BATCH}, the recompute oracle against the cached "
                  f"decode: greedy-token agreement {agree:.4f} (min {MIN_TOKEN_AGREEMENT}), "
                  f"max|d pos_scores| at step 0 {diff0:.4e} (tol {STEP0_TOL}), on the rows with "
                  f"equal tokens {diffs} (tol {REFNEG_TOL}); the oracle's forward {ms:.2f} ms "
                  f"(the first, host clock); launches " + json.dumps(counts) + f"; card {card}",
                  flush=True)
            if not (agree >= MIN_TOKEN_AGREEMENT and diff0 <= STEP0_TOL
                    and all(d is not None and d <= REFNEG_TOL for d in diffs.values())):
                fail(f"slice {name}: the oracle disagrees with the cached decode")
            out[name] = {"token_agreement": agree, "step0_max_abs_diff": diff0,
                         "equal_rows_max_abs_diff": diffs, "forward_ms": ms, "launches": counts}
            del models, cached, oracle
        del sl
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def collapse_ground_ids(batch, row: int = 0, frames: int = 2, ocr_per_frame: int = 15):
    """Plant a row of ``frames`` real frames into ``batch`` (in place): its
    temporal top-k (k > frames) then takes padding frames, whose id 0 maps
    onto frame 1, so wo_sg's OCR gather list is -1-padded; its first OCR
    slot valid, which a padded entry scattered into slot 0 would clobber."""
    batch["frame_id"][row, frames:] = 0
    batch["frame_mask"][row, frames:] = 0.0
    batch["frame_num"][row] = frames
    batch["temporal_id"][row, frames * ocr_per_frame:] = 0
    batch["ocr_mask"][row, frames * ocr_per_frame:] = 0.0
    batch["ocr_mask"][row, 0] = 1.0
    return batch


@contextlib.contextmanager
def padded_scatter_probe(seen: list):
    """Record, for each compact scatter of copy scores, (whether its gather
    list held -1 entries, whether it took the trash-slot form)."""
    from vitxtgqa_tpu_torch.models.base import JointQAModel

    real = JointQAModel.__dict__["_scatter_dynamic"]

    def probe(dynamic, idx, full_n, may_pad):
        seen.append((bool((idx < 0).any()), bool(may_pad)))
        return real.__func__(dynamic, idx, full_n, may_pad)

    JointQAModel._scatter_dynamic = staticmethod(probe)
    try:
        yield
    finally:
        JointQAModel._scatter_dynamic = real


def compact_agreement(compact: dict, exact: dict, temporal_id, n_vocab: int):
    """(greedy-token agreement, max |d| at step 0 over the fixed vocabulary
    and the kept copy slots) of wo_sg's compact decode against its exact
    geometry on the same batch, weights and noise.  The kept slots are
    those of the grounded frames (frames_to_ocr_mask of the outputs'
    ground_frame, the pos mask's definition); every other copy slot is
    pinned to -1e4 by the compact decode and is left out."""
    import torch

    gf = compact["ground_frame"]
    t1 = torch.where(gf == 0, torch.ones_like(gf), gf)
    kept = (temporal_id[:, None, :] == t1[:, :, None]).any(1)
    cols = torch.cat([torch.ones_like(kept[:, :1]).expand(-1, n_vocab), kept], dim=1)
    c, e = compact["pos_scores"].float(), exact["pos_scores"].float()
    agree = float((c.argmax(-1) == e.argmax(-1)).float().mean())
    d0 = (c[:, 0] - e[:, 0]).abs()[cols]
    return agree, float("inf") if torch.isnan(d0).any() else float(d0.max())


def zoo_preset_slice(sl: Slices, record, card, groups):
    """m (ii). The serving preset (int8 cache + compact serving) on the
    zoo's ablation ``sl.key`` at each batch of ``groups``, through
    serve_slice (launches as derived: wo_sg on its 128-slot compact cache,
    wo_tg falling back to the full decode), on a batch whose row 0 has 2
    real frames (collapse_ground_ids).  For wo_sg: the -1-padded gather
    list reaches the trash-slot scatter, and the compact decode agrees
    with the exact geometry (compact_agreement, tokens under slice a's
    rule, step 0 within STEP0_TOL)."""
    import torch

    from vitxtgqa_tpu_torch.serving.engine import group_generator, to_device

    name = f"{sl.key}_serving_preset"
    batch = collapse_ground_ids(sl.batch(max(groups), 0))
    preset = dict(kv_cache_int8=True, compact_serving=True)
    seen = []
    with padded_scatter_probe(seen):
        model, summary = serve_slice(name, sl, record, preset, groups, batch=batch)
    if sl.key != "t2s_wo_sg":
        if seen:
            fail(f"slice {name}: {sl.key} has no gather list, yet its decode compacted")
        return summary
    if not any(neg and pad for neg, pad in seen):
        fail(f"slice {name}: no -1-padded gather list reached the trash-slot scatter")
    exact = sl.model(kv_cache_int8=True)
    for b in sorted(set(groups)):
        tb = to_device({k: v[:b] for k, v in batch.items()}, sl.dev)
        with torch.inference_mode():
            c = model(tb, group_generator(0, 0, sl.dev))
            e = exact(tb, group_generator(0, 0, sl.dev))
        agree, d0 = compact_agreement(c, e, tb["temporal_id"], sl.nf - sl.cfg["classifier"][
            "ocr_max_num"])
        lat = forward_ms(model, {k: v[:b] for k, v in batch.items()}, sl.dev, reps=ZOO_REPS)
        print(f"slice {name}: batch {b}, compact ({L_WO_SG} cache slots) against the exact "
              f"geometry: greedy-token agreement {agree:.4f} (min {MIN_TOKEN_AGREEMENT}), max|d| "
              f"at step 0 over the vocabulary and the kept slots {d0:.4e} (tol {STEP0_TOL}); "
              f"forward median {statistics.median(lat):.2f} ms; card {card}", flush=True)
        if agree < MIN_TOKEN_AGREEMENT or not d0 <= STEP0_TOL:
            fail(f"slice {name}: the compact decode disagrees with the exact geometry")
        summary[f"compact_vs_exact_b{b}"] = {"token_agreement": agree, "step0_max_abs_diff": d0,
                                              "forward_ms_all": lat}
    summary["padded_scatters"] = sum(neg for neg, _ in seen)
    del model, exact
    return summary


def zoo_train_slice(sl: Slices, record, card):
    """m (iv), n (ii). The training step of ``sl.key`` (M4C, TranSTR, MIST)
    at batch TRAIN_CHECK_BATCH through the kernels against the plain step
    from the same weights, batch and generators (loss, gradient norm, every
    parameter's gradient at slice e's limits), its launches as derived (#1,
    #1b, #9a, #9b at the model's geometry: 1,024 rows for M4C and TranSTR,
    1,152 for MIST); then one timed step at batch TRAIN_BATCH after a
    warm-up step."""
    import torch

    from vitxtgqa_tpu_torch import Options
    from vitxtgqa_tpu_torch.losses import Losses
    from vitxtgqa_tpu_torch.ops import _build
    from vitxtgqa_tpu_torch.serving.engine import to_device
    from vitxtgqa_tpu_torch.training.optim import build_optimizer
    from vitxtgqa_tpu_torch.training.step import step_generators, train_step

    dev, losses, name = sl.dev, Losses(sl.cfg["losses"]), f"{sl.key}_train"
    tb = to_device(sl.batch(TRAIN_CHECK_BATCH, 2), dev)
    kern = train_check_step(sl, tb, losses, plain=False)
    count_launches(f"slice {name}", record, kern[3],
                   expected_train_launches(sl.cfg, Options(device=dev), sl.key))
    plain = train_check_step(sl, tb, losses, plain=True)
    if any(plain[3].values()):
        fail(f"slice {name}: the plain step launched kernels {plain[3]}")
    loss_rel, norm_rel, (grad_rel, worst), n, ok = step_agreement(kern, plain)
    print(f"slice {name}: batch {TRAIN_CHECK_BATCH}, kernels vs plain: loss {kern[0]:.6f} vs "
          f"{plain[0]:.6f} (rel {loss_rel:.3e}, limit {LOSS_REL_TOL}), gradient norm "
          f"{kern[1]:.5f} vs {plain[1]:.5f} (rel {norm_rel:.3e}, limit {GNORM_REL_TOL}), "
          f"per-parameter gradient rel diff max {grad_rel:.3e} ({worst}) over {n} parameters "
          f"(limit {GRAD_REL_TOL}); launches " + json.dumps(kern[3]), flush=True)
    if not ok:
        fail(f"slice {name}: the kernel step disagrees with the plain step")
    summary = {"loss_rel": loss_rel, "grad_norm_rel": norm_rel, "max_grad_rel": grad_rel,
               "max_grad_rel_param": worst, "launches": kern[3]}
    del kern, plain
    torch.cuda.empty_cache()

    model = sl.model()
    opt = build_optimizer(model, model_config=sl.cfg)
    batch = to_device(sl.batch(TRAIN_BATCH, 3), dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for step in range(2):
        _build.reset_launch_counts()
        t = time.perf_counter()
        r = train_step(model, losses, opt, batch, step_generators(0, step, dev))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        count_launches(f"slice {name}, batch-{TRAIN_BATCH} step {step}", record,
                       _build.launch_counts(), expected_train_launches(sl.cfg, model.opts, sl.key))
        if not r["applied"]:
            fail(f"slice {name}: batch-{TRAIN_BATCH} step {step} had a non-finite loss or "
                 f"gradient")
    peak = torch.cuda.max_memory_allocated()
    print(f"slice {name}: batch {TRAIN_BATCH}, remat {model.opts.remat}: step ms "
          f"{[round(x, 2) for x in times]} (the first warms up), "
          f"{TRAIN_BATCH / times[-1] * 1e3:.2f} videos/s; max_memory_allocated "
          f"{peak / 2**30:.2f} GiB; card {card}", flush=True)
    summary["batch48"] = {"step_ms_all": times, "max_memory_allocated": peak}
    del model, opt, batch
    torch.cuda.empty_cache()
    return summary


def zoo_runtime_argv(model: str, run_type: str, fixroot: str, save_dir: str, **tp) -> list:
    """runtime_argv for a zoo model on its shipped config (ZOO_CONFIGS) and
    dataset, no worker processes."""
    config, block = ZOO_CONFIGS[model]
    dataset = "gt_box" if model == "gt_box" else "vtextgqa"
    return (["--config", os.path.join(ROOT, "configs", config), "--model", model, "--datasets",
             dataset, "--run_type", run_type,
             f"dataset_attributes.{dataset}.data_root_dir={fixroot}",
             f"training_parameters.save_dir={save_dir}", "training_parameters.seed=1",
             "training_parameters.num_workers=0"]
            + [f"training_parameters.{k}={v}" for k, v in tp.items()])


def zoo_runtime_slice(dev, record, card, runs=ZOO_RUNTIME_RUNS):
    """m (v), n (iv). run() on a fixture tree written at run time (with
    fps10_ocr_detection_ClipOCR linked to its OCR directory, the GT-box
    config's), bf16, no worker processes, each (model, run type) of
    ``runs``: train+val for ZOO_RUNTIME_STEPS iterations (a validation
    probe each, the snapshot's and the final validation; slice m: M4C,
    slice n: TranSTR and MIST), val alone (GT-box on the fixtures'
    annotations); launches as derived from the gates, losses finite, the
    six val/ metrics in [0, 1]."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from vitxtgqa_tpu_torch.ops import _build
    from vitxtgqa_tpu_torch.run import run
    from vitxtgqa_tpu_torch.training.trainer import BaseTrainer

    out = {}
    evaluate = BaseTrainer.evaluate
    passes = []  # (split, loss averages, metric averages) of every validation pass

    def recorded(self, split):
        passes.append((split, *evaluate(self, split)))
        return passes[-1][1:]

    BaseTrainer.evaluate = recorded
    tmp = tempfile.mkdtemp(prefix="chip_smoke_zoo_")
    try:
        fixroot = os.path.join(tmp, "data")
        write_fixtures(fixroot)
        os.symlink("fps10_ocr_detection", os.path.join(fixroot, "fps10_ocr_detection_ClipOCR"))
        train_tp = dict(batch_size=RUNTIME_BATCH, max_iterations=ZOO_RUNTIME_STEPS,
                        warmup_iterations=1, log_interval=1, snapshot_interval=ZOO_RUNTIME_STEPS)
        for model, run_type in runs:
            tp = train_tp if "train" in run_type else dict(batch_size=RUNTIME_BATCH)
            name = f"{model}_runtime"
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            trainer = run(zoo_runtime_argv(model, run_type, fixroot, os.path.join(tmp, model),
                                           **tp))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = _build.launch_counts()
            val_batches = len(trainer.loaders["val"])
            steps = trainer.iteration
            forwards = (runtime_eval_forwards(steps, 1, steps, val_batches) if steps
                        else val_batches)
            count_launches(f"slice {name}", record, counts, runtime_launches(
                trainer.model_cfg, trainer.opts, steps, forwards, RUNTIME_BATCH, model))
            losses = list(trainer.meter["train/total_loss"].series) if steps else []
            if len(losses) != (ZOO_RUNTIME_STEPS if "train" in run_type else 0) or not all(
                    np.isfinite(losses)):
                fail(f"slice {name}: losses {losses}")
            split, _, metrics = passes[-1]
            val = {t: metrics.get(f"{trainer.dataset_name}/{t}") for t in (
                "textvqa_accuracy", "stvqa_anls", "IOU@0.3", "IOU@0.5", "GQA@0.3", "GQA@0.5")}
            if split != "val" or not all(v is not None and 0.0 <= v <= 1.0 for v in val.values()):
                fail(f"slice {name}: validation metrics {val}")
            print(f"slice {name}: {steps} steps and {forwards} eval forwards at batch "
                  f"{RUNTIME_BATCH} ({trainer.opts.dtype}); losses {losses}; val {val}; "
                  f"iteration ms {[round(x, 2) for x in trainer.timings['iteration_ms']]}, "
                  f"validation pass ms {[round(x, 2) for x in trainer.timings['val_ms']]}; run() "
                  f"wall {wall:.1f} s; launches " + json.dumps(counts) + f"; card {card}",
                  flush=True)
            out[name] = {"launches": counts, "losses": losses, "val": val, "wall_s": wall,
                         "iteration_ms": trainer.timings["iteration_ms"],
                         "val_ms": trainer.timings["val_ms"]}
            del trainer
        torch.cuda.empty_cache()
    finally:
        BaseTrainer.evaluate = evaluate
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def zoo_recompute_slice(sl: Slices, record, card):
    """m (vi), n (iii). The recompute decode oracle of ``sl.key`` at batch
    RUNTIME_BATCH against the cached decode (bf16 cache), as slice l (v)
    holds T2S's: tokens under the tie rule, step 0 and the rows with equal
    tokens within the slices' tolerances; its launches as derived."""
    import torch

    from vitxtgqa_tpu_torch.ops import _build
    from vitxtgqa_tpu_torch.serving.engine import group_generator, to_device

    name = f"{sl.key}_recompute"
    tb = to_device(sl.batch(RUNTIME_BATCH, 4), sl.dev)
    cached, oracle = sl.model(), sl._new(decode_recompute=True)
    oracle.load_state_dict(sl.state)
    with torch.inference_mode():
        want = cached(tb, group_generator(0, 0, sl.dev))
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        got = oracle(tb, group_generator(0, 0, sl.dev))
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = _build.launch_counts()
    count_launches(f"slice {name}", record, counts, expected_recompute_launches(
        sl.cfg, RUNTIME_BATCH, oracle.opts, model=sl.key))
    agree, diff0, diffs = decode_agreement(got, want)
    print(f"slice {name}: batch {RUNTIME_BATCH}, the recompute oracle against the cached decode: "
          f"greedy-token agreement {agree:.4f} (min {MIN_TOKEN_AGREEMENT}), max|d pos_scores| at "
          f"step 0 {diff0:.4e} (tol {STEP0_TOL}), on the rows with equal tokens {diffs} (tol "
          f"{REFNEG_TOL}); the oracle's forward {ms:.2f} ms; launches " + json.dumps(counts)
          + f"; card {card}", flush=True)
    if not (agree >= MIN_TOKEN_AGREEMENT and diff0 <= STEP0_TOL
            and all(d is not None and d <= REFNEG_TOL for d in diffs.values())):
        fail(f"slice {name}: the oracle disagrees with the cached decode")
    return {"token_agreement": agree, "step0_max_abs_diff": diff0,
            "equal_rows_max_abs_diff": diffs, "forward_ms": ms, "launches": counts}


def zoo_serve(sl: Slices, record, card, slice_name: str = "m") -> dict:
    """m (i), n (i). ``sl.key`` served through the kernels at batch 2 (int8
    cache: #5 / #6) and 8 (int8: #4), and at 8 over the bf16 cache (#7),
    against the plain versions (serve_slice), and its forward latency at 2
    and 8."""
    rec = {}
    key, dev = sl.key, sl.dev
    _, rec["int8_b2_b8"] = serve_slice(f"{key}_int8_b2_b8", sl, record,
                                       dict(kv_cache_int8=True), [2, BATCH])
    _, rec["bf16_b8"] = serve_slice(f"{key}_bf16_b8", sl, record, {}, [BATCH])
    model = sl.model(kv_cache_int8=True)
    lat = {}
    for b in (2, BATCH):
        sub = sl.batch(b, 0)
        forward_ms(model, sub, dev, reps=1)  # warm-up
        lat[b] = forward_ms(model, sub, dev, reps=ZOO_REPS)
    del model
    launches = {f"{g}_b{grp['batch']}": {k: v for k, v in grp["launches"].items() if v}
                for g in rec for grp in rec[g]["groups"]}
    med = {b: statistics.median(v) for b, v in lat.items()}
    print(f"slice {slice_name} {key}: {sl.n_params / 1e6:.1f}M params; kernel launches per "
          "forward " + json.dumps(launches) + f"; int8-cache forward median {med[2]:.2f} ms at "
          f"batch 2, {med[BATCH]:.2f} ms at batch {BATCH}; card {card}", flush=True)
    rec["forward_ms_all"] = lat
    return rec


def zoo_slice(dev, record, card):
    """m. The zoo's T2S-family models at production width, bf16, random
    weights from seed 0: (i) each served (zoo_serve); (ii) the serving
    preset on the ablations (zoo_preset_slice: wo_sg compact over 128 slots
    at 2 and 8, a -1-padded gather list; wo_tg's fallback); (iii) the
    ablations' full-eval at 2; (iv) M4C's training step (zoo_train_slice);
    (v) the runtime (zoo_runtime_slice); (vi) M4C's recompute oracle."""
    out = {}
    for key in ZOO:
        sl = Slices(dev, key=key)
        rec = zoo_serve(sl, record, card)
        if key in ("t2s_wo_tg", "t2s_wo_sg"):
            rec["serving_preset"] = zoo_preset_slice(
                sl, record, card, [2, BATCH] if key == "t2s_wo_sg" else [2])
            rec["full_eval_b2"] = full_eval_slice(sl, record, card, batch_size=2)
        if key == "m4c":
            rec["train"] = zoo_train_slice(sl, record, card)
            rec["recompute"] = zoo_recompute_slice(sl, record, card)
        out[key] = rec
        del sl
    out["runtime"] = zoo_runtime_slice(dev, record, card)
    return out


def selector_slice(dev, record, card):
    """n. The selector baselines, TranSTR (its MMT over 1,024 rows, an
    encoder row's allowed keys the fused frame and one grounded OCR slot)
    and MIST (1,152 rows, its frame mask summed over picks with
    replacement), at their shipped configs' model blocks, bf16, random
    weights from seed 0: (i) each served (zoo_serve), its grounding bit for
    bit against the plain run; (ii) its training step at batch 4 against
    the plain step, then at 48 (zoo_train_slice); (iii) its recompute
    oracle at batch 2 (zoo_recompute_slice); (iv) run() train+val for both
    (zoo_runtime_slice)."""
    import torch

    out = {}
    for key in SELECTORS:
        sl = Slices(dev, key=key)
        rec = zoo_serve(sl, record, card, slice_name="n")
        rec["train"] = zoo_train_slice(sl, record, card)
        rec["recompute"] = zoo_recompute_slice(sl, record, card)
        out[key] = rec
        del sl
        torch.cuda.empty_cache()
    out["runtime"] = zoo_runtime_slice(dev, record, card, runs=SELECTOR_RUNTIME_RUNS)
    return out


# slice o: data parallelism over DP_RANKS ranks, gloo with both on the one
# card (NCCL refuses two ranks on one device) or, where the machine has a
# card for every rank, NCCL with a card a rank; the production step at the
# global batch TRAIN_BATCH, TRAIN_BATCH / DP_RANKS rows a rank
DP_RANKS = 2
# the planted faults of the data-parallel step (dp_fault), each of which
# the parity limits must reject: every rank divides its losses by its own
# counts (the ranks' losses sum to a sum of their ratios, not the global
# ratio), nothing is summed over the ranks (neither the gradients nor the
# losses), or every rank takes the first rows of the global gumbel draws
# instead of its own
DP_FAULTS = ("local_counts", "unreduced", "first_rows")
# the CLI phase: slice l's fixtures at a global batch of 4 (2 a rank), the
# data assembled in 2 worker processes a rank
DP_CLI_BATCH, DP_CLI_WORKERS = 4, 2
# a dry run's global batch (the CPU, tiny widths)
DP_DRY_BATCH = 4


def dp_rows(sl) -> int:
    """Slice o's global batch: TRAIN_BATCH on the card, DP_DRY_BATCH in a
    dry run."""
    return TRAIN_BATCH if sl.dev.type == "cuda" else DP_DRY_BATCH


@contextlib.contextmanager
def dp_fault(name):
    """Plant one of DP_FAULTS for the duration (module docstring of slice
    o): "local_counts" skips the losses' all-reduce of their denominators,
    "unreduced" the optimizer's all-reduce of the gradients and losses,
    "first_rows" makes RankRows hand every rank rows 0..B of the draw."""
    from vitxtgqa_tpu_torch import losses as L
    from vitxtgqa_tpu_torch.ops import gumbel as G
    from vitxtgqa_tpu_torch.training import optim as O

    saved = [(L, "all_reduce", L.all_reduce), (O, "all_reduce_flat_", O.all_reduce_flat_),
             (G.RankRows, "__call__", G.RankRows.__call__)]
    if name == "local_counts":
        L.all_reduce = lambda t, group=None: t
    elif name == "unreduced":
        O.all_reduce_flat_ = lambda tensors, group=None: None
    else:
        def first_rows(self, shape, kind):
            shape = tuple(int(s) for s in shape)
            dev = self.source.device if hasattr(self.source, "device") else None
            return G.sample(self.source, (shape[0] * self.size,) + shape[1:], kind,
                            dev)[:shape[0]].contiguous()
        G.RankRows.__call__ = first_rows
    try:
        yield
    finally:
        for owner, attr, value in saved:
            setattr(owner, attr, value)


def dp_step(sl, tensors, group=None, fault=None) -> dict:
    """entry.data_parallel_step of the shared weights on ``tensors`` (a
    rank's rows with a DataGroup ``group``, else the global batch in one
    process), with a planted fault where named (the ranks' parameters
    after the update then not checked equal), and its launch counts."""
    from vitxtgqa_tpu_torch.entry import data_parallel_step
    from vitxtgqa_tpu_torch.ops import _build

    model = sl.model()
    sync(sl.dev)
    _build.reset_launch_counts()
    with dp_fault(fault) if fault else contextlib.nullcontext():
        out = data_parallel_step(model, sl.cfg, tensors, group, check_replicas=fault is None)
    sync(sl.dev)
    return {**out, "launches": _build.launch_counts(), "model_opts": model.opts}


def dp_parity(sl, group, rank: int, card: str) -> dict:
    """o(i). The step on this rank's rows of the global batch
    (entry.dryrun_model_and_batch's), then with each planted fault; rank 0
    holds each against the one-process step on the global batch at slice
    e's limits (loss, gradient norm, every parameter's applied gradient:
    entry.step_gaps); the launches of the rank."""
    from vitxtgqa_tpu_torch.entry import dryrun_model_and_batch, step_gaps, within
    from vitxtgqa_tpu_torch.parallel import collectives as C
    from vitxtgqa_tpu_torch.serving.engine import to_device

    g = dp_rows(sl)
    _, _, batch = dryrun_model_and_batch(sl.dev, g)
    rows = to_device({k: v[rank::DP_RANKS] for k, v in batch.items()}, sl.dev)
    kern = dp_step(sl, rows, group)
    want = ({n: 0 for n in REPLACES} if sl.dev.type == "cpu"
            else expected_train_launches(sl.cfg, kern["model_opts"]))
    if kern["launches"] != want:
        fail(f"slice o(i), rank {rank}: launches {kern['launches']}, expected {want}")
    every = C.gather_objects([kern["loss"], kern["norm"]])
    if any(e != every[0] for e in every):
        fail(f"slice o(i): the ranks' global loss and gradient norm differ: {every}")
    faults = {f: dp_step(sl, rows, group, fault=f) for f in DP_FAULTS}
    C.synchronize()
    summary = {"launches": kern["launches"], "expected": want}
    if rank != 0:
        return summary
    del rows
    ref = dp_step(sl, to_device(batch, sl.dev))
    limits = (LOSS_REL_TOL, GNORM_REL_TOL, GRAD_REL_TOL, None)
    for name, run in [("kernels", kern)] + list(faults.items()):
        gaps = step_gaps(run, ref)
        ok = within(gaps, limits)
        (grad_rel, worst), (up_rel, up_worst) = gaps["grad_rel"], gaps["update_rel"]
        print(f"slice o(i): {'the step' if name == 'kernels' else 'planted fault ' + name} on "
              f"{DP_RANKS} ranks of {g // DP_RANKS} rows vs one process at {g}: loss "
              f"{run['loss']:.6f} vs {ref['loss']:.6f} (rel {gaps['loss_rel']:.3e}), gradient "
              f"norm rel {gaps['norm_rel']:.3e}, applied gradient rel max {grad_rel:.3e} "
              f"({worst}) over {len(ref['grads'])} parameters (limits: loss {LOSS_REL_TOL}, "
              f"norm {GNORM_REL_TOL}, parameter {GRAD_REL_TOL}): "
              f"{'within' if ok else 'outside'}; update rel max {up_rel:.3e} ({up_worst}); "
              f"card {card}", flush=True)
        reading = {"loss": run["loss"], "loss_rel": gaps["loss_rel"],
                   "grad_norm_rel": gaps["norm_rel"], "max_grad_rel": grad_rel,
                   "max_grad_rel_param": worst, "max_update_rel": up_rel}
        if name == "kernels":
            summary.update(reading, loss_one_process=ref["loss"])
            if not ok:
                fail("slice o(i): the data-parallel step disagrees with the one-process step")
        else:
            summary.setdefault("planted", {})[name] = reading
            if ok:
                fail(f"slice o(i): the planted fault {name} passes the limits")
    return summary


def dp_timing(sl, group, rank: int, card: str) -> dict:
    """o(ii). The production step with the config's dropout at the global
    batch TRAIN_BATCH over the ranks (entry.dryrun_model_and_batch's model
    and batch with dropout), TRAIN_STEPS steps (the first warms up): each
    rank's ms a step; the ms of the step's all-reduce of the float32
    gradients and losses (the optimizer's all_reduce_flat_ inside
    train_step, host clock from a synchronize before it to one after; gloo
    moves them through the host); the device memory allocated when the
    steps start, after a garbage collection (o(i)'s optimizers linger in
    reference cycles until one runs, one more on rank 0), and its peak
    over them."""
    import gc

    import torch
    import torch.distributed as dist

    from vitxtgqa_tpu_torch.entry import dryrun_model_and_batch
    from vitxtgqa_tpu_torch.losses import Losses
    from vitxtgqa_tpu_torch.ops import _build
    from vitxtgqa_tpu_torch.parallel import collectives as C
    from vitxtgqa_tpu_torch.serving.engine import to_device
    from vitxtgqa_tpu_torch.training import optim as O
    from vitxtgqa_tpu_torch.training.step import step_generators, train_step

    cuda = sl.dev.type == "cuda"
    g = dp_rows(sl)
    cfg, _, batch = dryrun_model_and_batch(sl.dev, g, dropout=True)
    sl = sl.with_cfg(cfg)
    model = sl.model()
    opt = O.build_optimizer(model, model_config=sl.cfg, group=group)
    losses = Losses(sl.cfg["losses"], group=group)
    rows = to_device({k: v[rank::DP_RANKS] for k, v in batch.items()}, sl.dev)
    real, reduce_ms, reduce_bytes = O.all_reduce_flat_, [], []

    def timed_all_reduce(tensors, group=None):
        sync(sl.dev)
        t = time.perf_counter()
        real(tensors, group)
        sync(sl.dev)
        reduce_ms.append((time.perf_counter() - t) * 1e3)
        reduce_bytes.append(sum(x.numel() * x.element_size() for x in tensors))

    gc.collect()
    base = torch.cuda.memory_allocated() if cuda else None
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    times, seen = [], []
    O.all_reduce_flat_ = timed_all_reduce
    try:
        for step in range(TRAIN_STEPS if cuda else 2):
            sync(sl.dev)
            _build.reset_launch_counts()
            t = time.perf_counter()
            r = train_step(model, losses, opt, rows, step_generators(0, step, sl.dev, group))
            sync(sl.dev)
            times.append((time.perf_counter() - t) * 1e3)
            counts = _build.launch_counts()
            want = (expected_train_launches(sl.cfg, model.opts) if cuda
                    else {n: 0 for n in REPLACES})
            if counts != want:
                fail(f"slice o(ii), rank {rank}, step {step}: launches {counts}, expected {want}")
            seen.append(float(r["loss"]))
            if not r["applied"]:
                fail(f"slice o(ii): step {step} was skipped (loss {seen[-1]})")
    finally:
        O.all_reduce_flat_ = real
    peak = torch.cuda.max_memory_allocated() if cuda else None
    mine = {"rank": rank, "step_ms_all": times, "step_ms_median": statistics.median(times[1:]),
            "allreduce_ms_all": reduce_ms, "allreduce_ms_median": statistics.median(reduce_ms[1:]),
            "allreduce_bytes": reduce_bytes[-1], "memory_allocated_at_start": base,
            "max_memory_allocated": peak, "losses": seen, "launches_a_step": counts}
    every = C.gather_objects(mine)
    if rank == 0:
        for e in every:
            mem = "not on the card" if e["max_memory_allocated"] is None else (
                f"{e['memory_allocated_at_start'] / 2**30:.2f} GiB at the start, peak "
                f"{e['max_memory_allocated'] / 2**30:.2f} GiB")
            print(f"slice o(ii): rank {e['rank']}, {g // DP_RANKS} rows a step of "
                  f"global batch {g} with the config's dropout: step ms "
                  f"{[round(x, 2) for x in e['step_ms_all']]} (the first warms up), median "
                  f"{e['step_ms_median']:.2f}; of it the all-reduce of the "
                  f"{e['allreduce_bytes'] / 2**20:.1f} MiB of float32 gradients and losses "
                  f"{[round(x, 2) for x in e['allreduce_ms_all']]} ms (median "
                  f"{e['allreduce_ms_median']:.2f}; {dist.get_backend()} through the host: "
                  f"a capability, not a data-parallel rate); device memory allocated {mem}; "
                  f"losses {e['losses']}; card {card}", flush=True)
    del model, opt
    return {"ranks": every}


def dp_rank(rank: int, directory: str, card: str, cards: int, dry: bool):
    """One rank of slice o (torch.multiprocessing.spawn's target): takes
    its backend and card from parallel/mesh.rank_device over ``cards``
    cards (1: gloo, both ranks on card 0; DP_RANKS: NCCL, a card a rank),
    or the CPU at a tiny width (``dry``: gloo, float32), joins the process
    group (a file:// rendezvous in ``directory``), builds the shared
    weights of entry.dryrun_model_and_batch's model (every dropout 0) and
    runs o(i), then (not for NCCL's repeat) o(ii); rank 0 writes the
    summary to ``directory``."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from vitxtgqa_tpu_torch.entry import dryrun_model_and_batch
    from vitxtgqa_tpu_torch.parallel.mesh import build_data_group, rank_device

    if dry:
        torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    backend, dev = rank_device(rank, DP_RANKS, not dry, cards)
    cfg, nf, _ = dryrun_model_and_batch(dev, 1)
    dist.init_process_group(backend, init_method=f"file://{directory}/rendezvous", rank=rank,
                            world_size=DP_RANKS)
    try:
        sl = Slices(dev, quiet=True, cfg=cfg, nf=nf, dtype=torch.float32 if dry else None)
        group = build_data_group(DP_RANKS, batch_size=dp_rows(sl))
        out = {"parity": dp_parity(sl, group, rank, card)}
        if backend == "gloo":
            out["timing"] = dp_timing(sl, group, rank, card)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(os.path.join(directory, "rank0.json"), "w") as f:
            json.dump(out, f)


def dp_spawn(card: str, cards: int, dry: bool = False) -> dict:
    """Run dp_rank on DP_RANKS spawned processes over ``cards`` cards;
    rank 0's summary."""
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as directory:
        mp.spawn(dp_rank, args=(directory, card, cards, dry), nprocs=DP_RANKS, join=True)
        with open(os.path.join(directory, "rank0.json")) as f:
            return json.load(f)


def dp_dropout_opts() -> list:
    """CLI options setting every dropout of the t2s config to 0."""
    return ([f"model_attributes.t2s.{sect}.{k}=0.0" for sect in ("text_bert", "translayers", "mmt")
             for k in ("hidden_dropout_prob", "attention_probs_dropout_prob")]
            + [f"model_attributes.t2s.{sect}.dropout_prob=0.0" for sect in ("obj", "ocr")])


def tagged_processes(tag: str) -> list:
    """(pid, command line) of each live process whose environment holds
    ``CHIP_SMOKE_DP_TAG=tag``."""
    out = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/environ", "rb") as f:
                env = f.read().split(b"\0")
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace").strip()
        except OSError:
            continue
        if f"CHIP_SMOKE_DP_TAG={tag}".encode() in env:
            out.append((int(pid), cmd[:160]))
    return out


def dp_cli(card: str, extra=(), timeout: float = 600.0) -> dict:
    """o(iii). ``python -m torch.distributed.run --standalone --nproc_per_node
    DP_RANKS -m vitxtgqa_tpu_torch.run ... training_parameters.
    distributed_init=True`` on slice l's fixtures: configs/t2s_abinet.yml,
    train+inference with EvalAI predictions, RUNTIME_STEPS iterations at
    the global batch DP_CLI_BATCH, every dropout 0, DP_CLI_WORKERS worker
    processes a rank (``extra``: more options, a dry run's); the same
    through run() in this process.  Each iteration's loss within
    RUNTIME_LOSS_REL_TOL of the one-process run's; one log file, ckpt/best
    and ckpt/final written by a world of DP_RANKS; the test report lists
    each test question once; no process of the run left behind."""
    import shutil
    import tempfile
    import uuid

    from vitxtgqa_tpu_torch.run import run

    tmp = tempfile.mkdtemp(prefix="chip_smoke_dp_cli_")
    try:
        fixroot = os.path.join(tmp, "data")
        write_fixtures(fixroot)
        tp = dict(batch_size=DP_CLI_BATCH, max_iterations=RUNTIME_STEPS, warmup_iterations=2,
                  snapshot_interval=RUNTIME_STEPS, log_interval=1, num_workers=DP_CLI_WORKERS,
                  evalai_inference=True)
        argv = lambda save: (runtime_argv("t2s_abinet.yml", "train+inference", fixroot,
                                          os.path.join(tmp, save), **tp)
                             + dp_dropout_opts() + list(extra))
        one = run(argv("one"))
        want = list(one.meter["train/total_loss"].series)
        questions = len(one.datasets["test"])
        del one
        tag = uuid.uuid4().hex
        env = dict(os.environ, CHIP_SMOKE_DP_TAG=tag,
                   PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
        cmd = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node", str(DP_RANKS), "-m", "vitxtgqa_tpu_torch.run"]
               + argv("dp") + ["training_parameters.distributed_init=True"])
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                              timeout=timeout)
        wall = time.perf_counter() - t0
        if proc.returncode:
            fail(f"slice o(iii): the torchrun command exited {proc.returncode}:\n"
                 f"{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
        left = tagged_processes(tag)
        save = os.path.join(tmp, "dp")
        with open(os.path.join(save, "scalars.jsonl")) as f:
            got = [r["train/total_loss"] for r in map(json.loads, f) if "train/total_loss" in r]
        with open(os.path.join(save, "ckpt", "final", "meta.json")) as f:
            meta = json.load(f)
        logs = [n for n in os.listdir(save) if n.endswith(".log")]
        reports = os.path.join(save, "reports")
        (test,) = [n for n in os.listdir(reports) if "_test_" in n]
        with open(os.path.join(reports, test)) as f:
            qids = [row["question_id"] for row in json.load(f)]
        facts = {"losses": got, "losses_one_process": want,
                 "checkpoints": all(os.path.exists(os.path.join(save, "ckpt", d, "state.pt"))
                                    for d in ("best", "final")),
                 "world_size": meta.get("world_size"), "log_files": logs,
                 "predictions": qids, "questions": questions, "left": left}
        rel = [abs(g - w) / abs(w) for g, w in zip(got, want)]
        print(f"slice o(iii): torchrun with {DP_RANKS} processes, global batch {DP_CLI_BATCH}, "
              f"{RUNTIME_STEPS} iterations: losses {got} vs one process {want} (rel "
              f"{[f'{x:.3e}' for x in rel]}, limit {RUNTIME_LOSS_REL_TOL}); checkpoints of a "
              f"world of {meta.get('world_size')}: best and final {facts['checkpoints']}; log "
              f"files {len(logs)}; {len(qids)} test predictions for {questions} questions "
              f"({len(set(qids))} distinct); processes left {left}; {wall:.1f} s; card {card}",
              flush=True)
        faults = dp_cli_faults(facts)
        if faults:
            fail("slice o(iii): " + "; ".join(faults))
        return {"losses": got, "losses_one_process": want, "loss_rel": rel, "wall_s": wall,
                "predictions": len(qids), "world_size": meta.get("world_size")}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def dp_cli_faults(facts: dict) -> list:
    """What o(iii)'s run got wrong, from its facts: each iteration's loss
    against the one-process run's (RUNTIME_LOSS_REL_TOL), the checkpoints
    (best and final, of a world of DP_RANKS, one log file: rank 0's), each
    test question predicted once, no process left."""
    got, want = facts["losses"], facts["losses_one_process"]
    out = []
    if len(got) != RUNTIME_STEPS or len(want) != RUNTIME_STEPS or not all(
            abs(g - w) <= RUNTIME_LOSS_REL_TOL * abs(w) for g, w in zip(got, want)):
        out.append(f"losses {got} against the one-process run's {want}")
    if (not facts["checkpoints"] or facts["world_size"] != DP_RANKS
            or len(facts["log_files"]) != 1):
        out.append(f"checkpoints {facts['checkpoints']}, world {facts['world_size']}, log "
                   f"files {facts['log_files']}")
    qids, n = facts["predictions"], facts["questions"]
    if len(qids) != n or len(set(qids)) != n:
        out.append(f"{len(qids)} predictions ({len(set(qids))} distinct) for {n} test questions")
    if facts["left"]:
        out.append(f"processes left running: {facts['left']}")
    return out


def dp_slice(record, card, dry: bool = False) -> dict:
    """o. Data parallelism: (i) parity and (ii) timing on DP_RANKS gloo
    ranks (dp_spawn; both on the card, or on the CPU for a dry run), rank
    0's launches into the record; (iii) the torchrun CLI (dp_cli; a dry
    run calls it itself); (iv) (i) again on NCCL with a card a rank where
    the machine has DP_RANKS cards, else a line saying why not."""
    import torch

    t0 = time.perf_counter()
    out = dp_spawn(card, 1, dry)
    count_launches("slice o(i)", record, out["parity"]["launches"], out["parity"]["expected"])
    if not dry:
        out["cli"] = dp_cli(card)
        cards = torch.cuda.device_count()
        if cards >= DP_RANKS:
            out["nccl"] = dp_spawn(card, DP_RANKS)
        else:
            print(f"slice o(iv): not run: NCCL with a card a rank needs {DP_RANKS} cards and "
                  f"this machine has {cards} (gloo ran both ranks on the one card)", flush=True)
            out["nccl"] = None
    out["wall_s"] = time.perf_counter() - t0
    print(f"slice o: done in {out['wall_s']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# slice p: the engine at bucket 48, the serve demo, the raw-video pipeline
# ---------------------------------------------------------------------------


def engine_row_faults(outs, direct: dict) -> list:
    """The rows of a group whose engine responses ``outs`` (in submission
    order) differ from the direct forward ``direct`` of the same padded
    batch and generator (host arrays), bit for bit."""
    import numpy as np

    return [i for i, o in enumerate(outs)
            if not all(np.array_equal(o[k], direct[k][i])
                       for k in ("pos_scores", "ground_frame", "ground_box"))]


def serve_bucket_slice(sl: Slices, record, card) -> dict:
    """p(i). The engine at the serve demo's largest bucket, int8 cache: 48
    requests submitted together under a 300 ms window form one group of 48,
    then 8 a group of 8 (serve_slice: each group's launches as derived, its
    responses its direct forward's rows bit for bit, that forward against
    the plain versions at slice a's limits, a row whose grounding flipped
    on a near tie against plain on the kernels' grounding, at most
    NEAR_TIE_ROWS of them); then the forward's latency at 48 and 8 and the
    peak memory of a forward at each."""
    import torch

    model, out = serve_slice("int8_b48", sl, record, dict(kv_cache_int8=True),
                             [SERVE_BUCKET, BATCH], near_ties=NEAR_TIE_ROWS)
    batch = sl.batch(SERVE_BUCKET, 0)
    for b in (SERVE_BUCKET, BATCH):
        sub = {k: v[:b] for k, v in batch.items()}
        forward_ms(model, sub, sl.dev, reps=1)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        lat = forward_ms(model, sub, sl.dev, reps=5)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        med = statistics.median(lat)
        print(f"slice int8_b48: forward at batch {b}: ms {[round(x, 2) for x in lat]}, median "
              f"{med:.2f}, {b / med * 1e3:.1f} videos/s; peak memory {peak:.2f} GiB "
              f"(weights included); card {card}", flush=True)
        out[f"forward_b{b}"] = {"ms_all": lat, "ms_median": med, "videos_per_s": b / med * 1e3,
                                "peak_gib": peak}
    del model
    torch.cuda.empty_cache()
    return out


def serve_demo_launches(cfg, opts, buckets, group_sizes, **geometry) -> dict:
    """Kernel launches of the serve demo: the warm-up's forward at each
    bucket, then one forward a group at the bucket that holds it
    (``geometry``: expected_launches' text_len and dec_len)."""
    out = {name: 0 for name in REPLACES}
    bucket = lambda n: next((b for b in buckets if n <= b), buckets[-1])
    for b in list(buckets) + [bucket(n) for n in group_sizes]:
        for k, v in expected_launches(cfg, b, opts, **geometry).items():
            out[k] += v
    return out


def serve_demo_faults(report, details, knobs, score_shape, grounding_shapes) -> list:
    """What the serve demo's run got wrong: the responses, their shapes
    and finiteness, the group sizes (they add up to the requests, none
    above the largest bucket) and the report's counts."""
    import numpy as np

    faults = []
    sizes, responses = details["group_sizes"], details["responses"]
    want = knobs.requests // knobs.clients * knobs.clients
    if len(responses) != want or report["requests"] != want:
        faults.append(f"{len(responses)} responses, report {report['requests']}, for {want} "
                      "requests")
    if sum(sizes) != want or not sizes or max(sizes) > max(knobs.buckets):
        faults.append(f"group sizes {sizes} for {want} requests, buckets {knobs.buckets}")
    if report["groups"] != len(sizes):
        faults.append(f"report groups {report['groups']}, {len(sizes)} dispatched")
    for _, _, row in responses:
        shapes = (row["pos_scores"].shape, row["ground_frame"].shape, row["ground_box"].shape)
        if (shapes != (tuple(score_shape),) + tuple(grounding_shapes)
                or not all(np.isfinite(row[k]).all() for k in ("pos_scores", "ground_box"))):
            faults.append(f"a response of shapes {shapes}, finite "
                          f"{np.isfinite(row['pos_scores']).all()}")
            break
    return faults


def serve_demo_slice(record, card, knobs=None, **serve_kw) -> dict:
    """p(ii). ``python -m vitxtgqa_tpu_torch.serve``'s serve() at the JAX
    tool's defaults (SERVE_BUCKETS 8,48, 5 ms window, 8 clients, 96
    requests at 50 a second a client, int8 cache, no compact serving):
    its launches as derived from the groups it dispatched, the responses
    (serve_demo_faults), the JSON line with the card's name and power
    limit beside it.  ``knobs`` / ``serve_kw``: a dry run's."""
    import torch

    from vitxtgqa_tpu_torch import serve as S
    from vitxtgqa_tpu_torch.models.t2s import t2s_production_config
    from vitxtgqa_tpu_torch.ops import _build
    from vitxtgqa_tpu_torch.options import Options

    knobs = S.Knobs() if knobs is None else knobs
    cfg = serve_kw.get("model_config") or t2s_production_config()
    nf = serve_kw.get("num_final_outputs", S.PRODUCTION_NUM_FINAL_OUTPUTS)
    dev = serve_kw.pop("device", "cuda")
    _build.reset_launch_counts()
    report, details = S.serve(device=dev, knobs=knobs, **serve_kw)
    if dev != "cpu":
        torch.cuda.synchronize()
    counts = _build.launch_counts()
    opts = Options(device=dev, kv_cache_int8=knobs.kv_cache_int8,
                   compact_serving=knobs.compact_serving)
    sizes = details["group_sizes"]
    g = cfg["grounding"]
    batch_kw = serve_kw.get("batch_kw") or {}
    fused = min(knobs.buckets) <= opts.fused_decode_max_batch
    print(f"slice serve_demo: {len(sizes)} groups of {sizes}; launches in the warm-up and the "
          "groups " + json.dumps(counts) + ("" if fused else " (#5 / #6 run only at batch <= "
                                             f"{opts.fused_decode_max_batch}: no bucket reaches "
                                             "them)"), flush=True)
    count_launches("slice serve_demo", record, counts, serve_demo_launches(
        cfg, opts, knobs.buckets, sizes, text_len=batch_kw.get("text_len", 20),
        dec_len=batch_kw.get("dec_steps", DEC_LEN)))
    faults = serve_demo_faults(report, details, knobs, (batch_kw.get("dec_steps", DEC_LEN), nf),
                               ((g["frame_topk"],), (g["frame_num"] * g["ocr_topk"], 4)))
    if faults:
        fail("slice serve_demo: " + "; ".join(faults))
    share = details["h2d_share"]
    print(f"slice serve_demo: host-to-device copies {sum(details['h2d_bytes']) / 1e6:.1f} MB in "
          f"{sum(details['h2d_ms']):.2f} ms of device time, a share of "
          f"{'not measured' if share is None else f'{share:.4f}'} of the "
          f"{details['wall_s']:.3f} s wall; card {card}", flush=True)
    print(json.dumps(report), flush=True)
    return {"report": report, "group_sizes": sizes, "launches": counts,
            "latencies_ms": details["latencies_ms"], "h2d_ms": details["h2d_ms"],
            "h2d_bytes": details["h2d_bytes"], "h2d_share": share, "wall_s": details["wall_s"]}


def prediction_faults(rows, question_ids, g) -> list:
    """What a stage-4 EvalAI JSON got wrong: a row off the schema, a
    question predicted twice or not at all."""
    faults = []
    keys = ["answer", "grounded box", "grounded frame", "pred_source", "question_id", "video_id"]
    for row in rows:
        if (sorted(row) != keys or len(row["grounded frame"]) != g["frame_topk"]
                or [len(row["grounded box"]), len(row["grounded box"][0])]
                != [g["frame_num"] * g["ocr_topk"], 4]
                or not set(row["pred_source"]) <= {"OCR", "VOCAB"}
                or not isinstance(row["answer"], str)):
            faults.append(f"a row off the schema: {json.dumps(row)[:200]}")
    got = sorted(row["question_id"] for row in rows)
    if got != sorted(question_ids):
        faults.append(f"questions predicted {got}, asked {sorted(question_ids)}")
    return faults


def pipeline_inputs(root: str, geo: dict, cv2_video: bool) -> dict:
    """p(iii)'s inputs under ``root``: the videos' frames (written by cv2
    as mp4 clips for stage 1 where ``cv2_video``, else by Pillow as the
    jpgs stage 1 would write), each frame's OCR detections in the
    reference's npy format, the questions JSON.  Returns the paths and,
    without stage 1, the frames' meta."""
    import numpy as np

    from vitxtgqa_tpu_torch.utils.synthetic import synthetic_frames

    n, w, h = geo["frames"], geo["width"], geo["height"]
    videos = [f"clip{v + 1:02d}" for v in range(geo["videos"])]
    out = {"videos": os.path.join(root, "videos"), "frames": os.path.join(root, "frames"),
           "ocr": os.path.join(root, "ocr"), "questions": os.path.join(root, "questions.json"),
           "meta": None}
    for d in ("videos", "frames", "ocr"):
        os.makedirs(out[d], exist_ok=True)
    if cv2_video:
        import cv2

        for vi, vid in enumerate(videos):
            writer = cv2.VideoWriter(os.path.join(out["videos"], f"{vid}.mp4"),
                                     cv2.VideoWriter_fourcc(*"mp4v"), geo["fps"], (w, h))
            for frame in synthetic_frames(batch=n, h=h, w=w, seed=vi):
                writer.write(frame)
            writer.release()
    else:
        from PIL import Image

        for vi, vid in enumerate(videos):
            os.makedirs(os.path.join(out["frames"], vid))
            for i, frame in enumerate(synthetic_frames(batch=n, h=h, w=w, seed=vi)):
                Image.fromarray(frame).save(os.path.join(out["frames"], vid, f"{i + 1}.jpg"))
        out["meta"] = {vid: (n, w, h) for vid in videos}
    rng = np.random.default_rng(7)
    words = ("stop", "exit", "open", "sale", "cafe", "hotel", "bank", "taxi")
    k, bw, bh = geo["ocr_per_frame"], w // 16, h // 24
    for vid in videos:
        info = {}
        for f in range(1, n + 1):
            dets = []
            for j in range(k):
                x0, y0 = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
                dets.append({"points": [x0, y0, x0 + bw, y0, x0 + bw, y0 + bh, x0, y0 + bh],
                             "ocr": words[int(rng.integers(0, len(words)))], "ID": j + 1})
            info[str(f)] = dets
        np.save(os.path.join(out["ocr"], f"{vid}.npy"), np.array(info, dtype=object),
                allow_pickle=True)
    questions = [{"question_id": 100 * vi + q, "video_id": vid,
                  "question": f"what does sign {q + 1} say?", "answers": ["stop"]}
                 for vi, vid in enumerate(videos) for q in range(geo["questions"])]
    with open(out["questions"], "w") as f:
        json.dump(questions, f)
    out["question_ids"] = [q["question_id"] for q in questions]
    return out


def write_reference_pth(state: dict, path: str, dead: dict, drop=()) -> str:
    """The weights ``state`` as the reference saves a checkpoint: float32,
    {"model": ...} with DataParallel's ``module.`` prefixes, the classifier
    as ``classifier.*``, the ``dead`` parameters planted (zeros of their
    shapes); ``drop``: live names left out (a planted fault)."""
    import torch

    ref = {f"module.{k.replace('classifier.module.', 'classifier.')}": v.float().cpu()
           for k, v in state.items() if k not in drop}
    ref.update({f"module.{k}": torch.zeros(shape) for k, shape in dead.items()})
    torch.save({"model": ref, "best_iteration": 1}, path)
    return path


def stage4(P, workdir, config, ckpt=None, extra=()) -> list:
    """Stage 4 (run_inference at the JAX tool's batch 8): its rows; an
    exception from it fails the slice."""
    try:
        path = P.run_inference(workdir, config, "t2s", ckpt=ckpt, extra_opts=list(extra))
    except (KeyError, ValueError, RuntimeError) as e:
        fail(f"slice pipeline: stage 4 with {os.path.basename(config)} and ckpt {ckpt} "
             f"raised {type(e).__name__}: {e}")
    with open(path) as f:
        return json.load(f)


def pipeline_plain_rows(P, workdir, config, extra=()) -> tuple:
    """Stage 4's trainer on the same arguments, its model replaced by the
    plain versions on the same weights: its predictions' rows, the
    trainer's model config, kernel options, test batches and weights."""
    import dataclasses

    from vitxtgqa_tpu_torch.training.trainer import build_model

    k = runtime_trainer(P.inference_argv(workdir, config, "t2s", extra_opts=list(extra)))
    try:
        state = k.model.state_dict()
        plain = build_model("t2s", k.model_cfg, k.dataset_name,
                            dataclasses.replace(k.opts, plain=True), inference_only=True)
        plain.load_state_dict(state)
        kernel_opts, k.model = k.opts, plain
        with open(k.predict_for_evalai("test")) as f:
            rows = json.load(f)
    finally:
        k.close()
    return rows, k.model_cfg, kernel_opts, len(k.loaders["test"]), state


def pipeline_slice(dev, record, card, geo=None, vit_cfg=None, extra=(), cv2_video=None) -> dict:
    """p(iii). ``python -m vitxtgqa_tpu_torch.e2e_pipeline``'s stages on
    PIPELINE's videos: stage 1 where cv2 imports (on clips cv2 writes),
    else the frames written by Pillow and a line saying so; stage 2 on the
    card (ViT-L/16 at 224 px, chunks of 64), its features against the plain
    path at slice j's limit; stage 3; stage 4 with configs/t2s_abinet.yml
    (the config's worker processes) and configs/t2s_serving.yml: every
    question once in the EvalAI schema, the answers against the plain
    versions on the trainer's weights and batches (>= 0.8 of the
    questions), the launches as derived; use_pallas=false raising on the
    card; then --ckpt a port torch file of those weights and a reference
    .pth of them (dead names planted), the predictions equal bit for bit.
    Each stage's seconds.  ``geo``, ``vit_cfg``, ``extra`` (stage 4's
    options), ``cv2_video``: a dry run's."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from vitxtgqa_tpu_torch import e2e_pipeline as P
    from vitxtgqa_tpu_torch.models.vit import VIT_L_16, make_feature_extractor
    from vitxtgqa_tpu_torch.ops import _build
    from vitxtgqa_tpu_torch.options import Options
    from vitxtgqa_tpu_torch.video_feat import iter_videos, write_features

    geo = PIPELINE if geo is None else geo
    vit_cfg = VIT_L_16 if vit_cfg is None else vit_cfg
    cuda = torch.device(dev).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cv2_video is None:
        try:
            import cv2  # noqa: F401

            cv2_video = True
        except ImportError:
            cv2_video = False
    out, secs = {"cv2": cv2_video}, {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pipeline_")
    try:
        t = time.perf_counter()
        inp = pipeline_inputs(tmp, geo, cv2_video)
        secs["inputs"] = time.perf_counter() - t
        if cv2_video:
            t = time.perf_counter()
            meta = P.decode_videos(inp["videos"], inp["frames"], geo["fps"])
            secs["stage1"] = time.perf_counter() - t
            if meta != {v: (geo["frames"], geo["width"], geo["height"]) for v in meta}:
                fail(f"slice pipeline: stage 1 decoded {meta}")
        else:
            meta = inp["meta"]
            print("slice pipeline: cv2 does not import on this machine: stage 1 (OpenCV decode) "
                  "not run; the frames are Pillow's jpgs", flush=True)

        # stage 2 through the kernels, then the plain path on the same
        # weights and frames
        feats = os.path.join(tmp, "vit_feats")
        _build.reset_launch_counts()
        t = time.perf_counter()
        n = P.extract_features(inp["frames"], feats, cfg=vit_cfg, device=dev)
        sync()
        secs["stage2"] = time.perf_counter() - t
        counts = _build.launch_counts()
        chunk = 64
        want = {name: 0 for name in REPLACES}
        for _, _, frames in iter_videos(inp["frames"]):
            for s in range(0, len(frames), chunk):
                for k, v in expected_vit_launches(vit_cfg, len(frames[s:s + chunk])).items():
                    want[k] += v
        print(f"slice pipeline: stage 2, {n} frames; launches " + json.dumps(counts), flush=True)
        count_launches("slice pipeline, stage 2", record, counts, want)
        _, vit = make_feature_extractor(vit_cfg, None, Options(device=dev))
        plain, _ = make_feature_extractor(vit_cfg, vit.state_dict(),
                                          Options(device=dev, plain=True))
        size = (vit_cfg.image_size, vit_cfg.image_size)

        def load_frame(path):
            from PIL import Image

            return np.asarray(Image.open(path).convert("RGB").resize(size), dtype=np.uint8)

        write_features(inp["frames"], os.path.join(tmp, "plain_feats"), plain, load_frame, chunk)
        del vit, plain
        rel = 0.0
        for vid, _, frames in iter_videos(inp["frames"]):
            for f in frames:
                name = os.path.join(vid, os.path.splitext(f)[0] + ".npy")
                a = torch.from_numpy(np.load(os.path.join(feats, name)))
                b = torch.from_numpy(np.load(os.path.join(tmp, "plain_feats", name)))
                if a.shape != (1, vit_cfg.hidden_size) or not torch.isfinite(a).all():
                    fail(f"slice pipeline: stage 2 feature {name} {tuple(a.shape)}")
                rel = max(rel, feature_agreement(a, b)[1])
        print(f"slice pipeline: stage 2 kernels vs plain on the card: largest per-frame relative "
              f"L2 difference {rel:.4e} (limit {VIT_FEAT_REL_TOL}); {n} frames in "
              f"{secs['stage2']:.2f} s, {n / secs['stage2']:.1f} frames/s with the jpg reads",
              flush=True)
        if not rel <= VIT_FEAT_REL_TOL:
            fail("slice pipeline: stage 2's features disagree with the plain path")
        out["stage2"] = {"frames": n, "launches": counts, "max_rel_l2": rel}

        t = time.perf_counter()
        work = os.path.join(tmp, "work")
        os.makedirs(work)
        P.assemble_data_root(work, inp["questions"], inp["ocr"], feats, meta)
        secs["stage3"] = time.perf_counter() - t

        state = None
        no_workers = ["training_parameters.num_workers=0"]
        for i, config in enumerate(PIPELINE_CONFIGS):
            path = os.path.join(ROOT, "configs", config)
            # the first run with the config's worker processes, as a user runs it
            opts = list(extra) + ([] if i == 0 else no_workers)
            _build.reset_launch_counts()
            t = time.perf_counter()
            rows = stage4(P, work, path, extra=opts)
            sync()
            secs[f"stage4_{config}"] = time.perf_counter() - t
            counts = _build.launch_counts()
            plain_rows, cfg, opts_k, batches, weights = pipeline_plain_rows(
                P, work, path, extra=list(extra) + no_workers)
            if state is None:
                state, first = weights, (cfg, opts_k, batches)
            # run() predicts the split once, run_inference once more
            want = {k: 2 * batches * v for k, v in expected_launches(cfg, 8, opts_k).items()}
            print(f"slice pipeline: stage 4 with {config} (int8 cache {opts_k.kv_cache_int8}, "
                  f"compact {opts_k.compact_serving}, {batches} batch of 8, predicted twice) in "
                  f"{secs[f'stage4_{config}']:.2f} s; launches " + json.dumps(counts), flush=True)
            count_launches(f"slice pipeline, stage 4 with {config}", record, counts, want)
            faults = prediction_faults(rows, inp["question_ids"], cfg["grounding"])
            if faults:
                fail(f"slice pipeline: stage 4 with {config}: " + "; ".join(faults))
            by_q = {r["question_id"]: r["answer"] for r in plain_rows}
            agree = float(np.mean([by_q.get(r["question_id"]) == r["answer"] for r in rows]))
            print(f"slice pipeline: stage 4 with {config}: {len(rows)} predictions, answers "
                  f"against the plain versions {agree:.4f} (min {MIN_TOKEN_AGREEMENT}); first "
                  f"{json.dumps(rows[0])[:160]}", flush=True)
            if agree < MIN_TOKEN_AGREEMENT:
                fail(f"slice pipeline: stage 4 with {config} disagrees with the plain versions")
            out[f"stage4_{config}"] = {"launches": counts, "answer_agreement": agree,
                                       "rows": len(rows), "predictions": rows}
        if cuda:
            try:
                P.run_inference(work, os.path.join(ROOT, "configs", PIPELINE_CONFIGS[0]), "t2s",
                                extra_opts=["training_parameters.tpu.use_pallas=False"])
                fail("slice pipeline: run() with use_pallas=false ran on the card")
            except ValueError as e:
                print(f"slice pipeline: use_pallas=false on the card raises: {e}", flush=True)

        # --ckpt: a port torch file of the first config's weights, and the
        # reference's .pth of them
        config = os.path.join(ROOT, "configs", PIPELINE_CONFIGS[0])
        port_file = os.path.join(tmp, "weights.pt")
        torch.save({k: v.float().cpu() for k, v in state.items()}, port_file)
        ref = write_reference_pth(state, os.path.join(tmp, "reference.pth"), DEAD_NAMES)
        extra_ckpt = list(extra) + no_workers
        _build.reset_launch_counts()
        t = time.perf_counter()
        rows_port = stage4(P, work, config, ckpt=port_file, extra=extra_ckpt)
        rows_ref = stage4(P, work, config, ckpt=ref, extra=extra_ckpt)
        sync()
        secs["stage4_ckpt"] = time.perf_counter() - t
        cfg, opts_k, batches = first
        count_launches("slice pipeline, stage 4 from --ckpt", record, _build.launch_counts(),
                       {k: 4 * batches * v for k, v in expected_launches(cfg, 8, opts_k).items()})
        same = rows_ref == rows_port
        print(f"slice pipeline: stage 4 from a reference .pth ({len(DEAD_NAMES)} dead names, "
              f"{{'model': ...}}, module. prefixes, classifier.*) equals stage 4 from the port's "
              f"torch file of the same weights bit for bit: {same}", flush=True)
        if not same or prediction_faults(rows_ref, inp["question_ids"], cfg["grounding"]):
            fail("slice pipeline: the reference .pth predicts otherwise than its weights")
        out["ckpt_equal"] = same
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("slice pipeline: seconds " + json.dumps({k: round(v, 2) for k, v in secs.items()})
          + f"; card {card}", flush=True)
    out["seconds"] = secs
    return out


def serving_slice(dev, record, card) -> dict:
    """p. Serving under concurrent clients up to bucket 48, the serve demo
    and the raw-video pipeline."""
    import torch

    out = {}
    t0 = time.perf_counter()
    sl = Slices(dev, quiet=True)
    out["bucket_48"] = serve_bucket_slice(sl, record, card)
    del sl
    torch.cuda.empty_cache()
    out["serve_demo"] = serve_demo_slice(record, card)
    torch.cuda.empty_cache()
    out["pipeline"] = pipeline_slice(dev, record, card)
    out["wall_s"] = time.perf_counter() - t0
    print(f"slice p: done in {out['wall_s']:.1f} s", flush=True)
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


# ---------------------------------------------------------------------------
# slice q: the legacy image-VQA zoo
# ---------------------------------------------------------------------------

# the six legacy models (models/legacy_vqa.py) and the config whose model
# block each runs (ban and top_down_bottom_up have no shipped config: they
# take pythia's widths, from which the JAX models synthesize their sections)
LEGACY = ("pythia", "pythia_question_only", "pythia_image_only", "lorra", "ban",
          "top_down_bottom_up")
LEGACY_CONFIGS = {"lorra": ("lorra_textvqa.yml", "lorra", "textvqa")}
# the configs' widths (vocab 100,000 x embed 300, hidden 1,024), 14 question
# tokens (the vqa defaults' max_length), batch 128; MMF's features: VQA2's
# detectron fc6 (100 boxes) and resnet152 (196 cells) of 2,048, TextVQA's
# 137 boxes and 50 OCR tokens of 300 (+ 50-d order vectors); the answer
# spaces VQA2's 3,129 and TextVQA's 8,000 + 50 copy slots
LEGACY_GEOMETRY = dict(batch=128, text_len=14, vocab=100_000, embed=300, hidden=1024,
                       feat=2048, boxes={"vqa2": 100, "textvqa": 137}, grid=196, ocr=50,
                       context=300, answers={"vqa2": 3129, "textvqa": 8000})
# bf16 against float32 from the same weights and batch, dropout off: the
# loss, the gradient norm and every parameter's relative gradient difference
# (legacy_agreement), a few times what an H100 reads (700 W: up to 4.4e-7
# and 1.1e-4 on the loss and the norm; gradients below)
LEGACY_LOSS_REL_TOL, LEGACY_GNORM_REL_TOL, LEGACY_GRAD_REL_TOL = 5e-6, 5e-4, 2.5e-1
# a parameter's gradient difference is relative to its gradient or to this
# share of the global gradient norm, whichever is larger: the weight-norm
# scales of the top-down attentions (the attention's temperature) read
# 1e-10 to 4e-9 of the norm, sums that cancel to 5e-5 of their layer's
# weight gradient, so that bf16's rounding of the features moves them by
# 0.07-0.61 of themselves (3e-5 of that layer's gradient)
LEGACY_GRAD_FLOOR = 1e-6
# gradients that are float rounding alone: the bias before a softmax over
# the locations (top-down attention), over the question tokens (the
# attention text embedding's conv2) and over BAN's glimpse grid
LEGACY_NOISE = ("image_attention_model.module.transform.bias", "conv2.bias",
                "logits_net.h_bias")
# planted faults (legacy_fault), the model each runs on
LEGACY_FAULTS = {"lstm_gates_swapped": "pythia", "gru_gates_swapped": "ban",
                 "wn_row_norm": "top_down_bottom_up", "bias_grad_dropped": "lorra"}
LEGACY_STEPS = 4          # Adamax steps timed (the first warms up)
LEGACY_RUNTIME_STEPS = 3  # run()'s iterations at batch 128; the two-dataset run twice that


def legacy_config(key: str, geo=LEGACY_GEOMETRY) -> dict:
    """The model block ``key`` runs: its shipped config's (pythia's for
    ban / top_down_bottom_up), at the geometry's widths."""
    from vitxtgqa_tpu_torch.core.config import build_config

    config, block, _ = LEGACY_CONFIGS.get(key, ("pythia_vqa2.yml", "pythia", "vqa2"))
    cfg = build_config(os.path.join(ROOT, "configs", config)).model_attributes[block].to_dict()
    cfg.update(vocab_size=geo["vocab"], embed_dim=geo["embed"], hidden_dim=geo["hidden"])
    return cfg


def legacy_batch(key: str, geo=LEGACY_GEOMETRY, seed: int = 0) -> dict:
    """A batch of ``key``'s dataset (TextVQA's for lorra, VQA2's else) at
    the geometry: padded box rows zeroed past each image's count, OCR rows
    and order vectors past each question's, sparse soft targets."""
    import numpy as np

    ds = LEGACY_CONFIGS.get(key, (None, None, "vqa2"))[2]
    r = np.random.default_rng(seed)
    b, t, k = geo["batch"], geo["text_len"], geo["boxes"][ds]
    nout = geo["answers"][ds] + (geo["ocr"] if ds == "textvqa" else 0)
    boxes = r.integers(k // 4, k + 1, b)
    feat0 = r.standard_normal((b, k, geo["feat"]), dtype=np.float32)
    feat0[np.arange(k)[None, :] >= boxes[:, None]] = 0.0
    targets = np.zeros((b, nout), np.float32)
    for i in range(b):
        targets[i, r.integers(0, nout, 3)] = (0.3, 0.6, 1.0)
    batch = {"text": r.integers(1, geo["vocab"], (b, t)), "text_len": r.integers(3, t + 1, b),
             "image_feature_0": feat0, "image_info_0_max_features": boxes,
             "image_feature_1": r.standard_normal((b, geo["grid"], geo["feat"]),
                                                  dtype=np.float32),
             "targets": targets}
    if ds == "textvqa":
        n = r.integers(1, geo["ocr"] + 1, b)
        live = np.arange(geo["ocr"])[None, :] < n[:, None]
        ctx = r.standard_normal((b, geo["ocr"], geo["context"]), dtype=np.float32)
        ctx[~live] = 0.0
        order = np.eye(geo["ocr"], dtype=np.float32)[None].repeat(b, 0)
        order[~live] = 0.0
        batch.update(context_feature_0=ctx, context_info_0_max_features=n, order_vectors=order)
    return batch


def legacy_models(key: str, dev, geo=LEGACY_GEOMETRY, dtype=None, ref_dtype=None, seed=0):
    """(the model in ``dtype`` (bf16), the same weights in ``ref_dtype``
    (float32; the plain versions' Options on the card), the batch on the
    device, the answer count).  The weights are the seeded init's with
    each weight-norm scale redrawn (legacy_scales): JAX's g = 1 shrinks
    every weight-normed output by its ||v||, which leaves the scores near 0
    and the loss flat at a random init, where no fault can move it."""
    import torch

    from vitxtgqa_tpu_torch import Options
    from vitxtgqa_tpu_torch.run import setup_imports
    from vitxtgqa_tpu_torch.serving.engine import to_device

    setup_imports()
    dtype = torch.bfloat16 if dtype is None else dtype
    ref_dtype = torch.float32 if ref_dtype is None else ref_dtype
    cls, cfg = model_class(key), legacy_config(key, geo)
    tb = to_device(legacy_batch(key, geo, seed), dev)
    nout = tb["targets"].shape[1]
    opts = lambda d: Options(device=dev, dtype=d, plain=dev.type == "cuda" and d == torch.float32)
    model = legacy_scales(cls(cfg, nout, opts=opts(dtype), example=tb).init_weights(seed), seed)
    ref = cls(cfg, nout, opts=opts(ref_dtype), example=tb)
    ref.load_state_dict(model.state_dict())
    return model, ref, tb, nout


def legacy_scales(model, seed: int):
    """Each weight-norm scale (g, h_mat_g) redrawn to ||v|| * U(0.5, 2) from
    ``seed``: the gain of an unnormalised layer, as a trained model's, in
    place of the init's 1."""
    import torch

    gen = torch.Generator().manual_seed(int(seed))
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name, p in params.items():
            if name.endswith((".g", ".h_mat_g")):
                u = 0.5 + 1.5 * torch.rand((), generator=gen).item()
                p.fill_(u * torch.linalg.vector_norm(params[name[:-1] + "v"]).item())
    return model


@contextlib.contextmanager
def legacy_fault(name, model):
    """A fault the legacy path could have, for the duration:
    "lstm_gates_swapped" / "gru_gates_swapped": the cell reads its cell and
    output gates (LSTM: g, o) or its update and candidate gates (GRU: z, n)
    swapped, a tanh gate for a sigmoid one (a swap of two sigmoid gates,
    both near 0.5 at a random init, moves little);
    "wn_row_norm": weight norm over each output row instead of the whole
    matrix; "bias_grad_dropped": the classifier's last bias gets no
    gradient."""
    import torch

    from vitxtgqa_tpu_torch.models import embeddings as E
    from vitxtgqa_tpu_torch.models import layers as L

    saved = (E.lstm_step, E.gru_step, L.wn_weight)
    hook = None
    def reorder(x, n, order, dim):
        parts = x.chunk(n, dim=dim)
        return torch.cat([parts[i] for i in order], dim=dim)

    if name == "lstm_gates_swapped":
        def lstm(gx, h, c, w_hh):
            order = (0, 1, 3, 2)
            return saved[0](reorder(gx, 4, order, -1), h, c, reorder(w_hh, 4, order, 0))
        E.lstm_step = lstm
    elif name == "gru_gates_swapped":
        def gru(gx, h, w_hh, b_hn):
            order = (0, 2, 1)
            return saved[1](reorder(gx, 3, order, -1), h, reorder(w_hh, 3, order, 0), b_hn)
        E.gru_step = gru
    elif name == "wn_row_norm":
        def wn(v, g):
            v32 = v.float()
            return (v32 / torch.linalg.vector_norm(v32, dim=-1, keepdim=True).clamp_min(1e-12)
                    * g.float()).to(v.dtype)
        L.wn_weight = wn
    else:
        bias = [p for n, p in model.named_parameters() if n.startswith("classifier")][-1]
        hook = bias.register_hook(torch.zeros_like)
    try:
        yield
    finally:
        E.lstm_step, E.gru_step, L.wn_weight = saved
        if hook is not None:
            hook.remove()


def legacy_step(model, tb, losses, fault=None):
    """A training forward with dropout off, the logit_bce loss and its
    backward: (loss, global gradient norm, {parameter: f32 gradient})."""
    import torch

    with legacy_fault(fault, model) if fault else contextlib.nullcontext():
        out = model(tb, None, train=True, dropout_gen=None)
        total = losses.total(tb, out)[0]
        total.backward()
    grads = {k: p.grad.float().flatten() for k, p in model.named_parameters()
             if p.grad is not None}
    norm = torch.linalg.vector_norm(torch.cat(list(grads.values()))).item()
    model.zero_grad(set_to_none=True)
    return total.item(), norm, grads


def legacy_agreement(run, want, noise):
    """(loss rel, norm rel, (gradient rel, its parameter), parameters
    compared, (the weight-norm scales' largest gradient rel, its
    parameter)) of ``run`` against ``want``, each (loss, norm, {parameter:
    gradient}).  A parameter's gradient rel is |g - g_ref| over the larger
    of |g_ref| and LEGACY_GRAD_FLOOR of the global gradient norm; every
    parameter counts but the ``noise`` endings, whose gradient is 0 but for
    rounding."""
    (loss, norm, grads), (loss_r, norm_r, grads_r) = run, want
    if sorted(grads) != sorted(grads_r):
        fail("slice legacy: two steps reach different parameters")
    floor = LEGACY_GRAD_FLOOR * norm_r
    rel = {k: float((grads[k] - w).norm()) / max(float(w.norm()), floor)
           for k, w in grads_r.items() if not k.endswith(tuple(noise))}
    worst = worst_of(rel)
    scales = {k: v for k, v in rel.items() if k.endswith((".g", ".h_mat_g"))}
    top = worst_of(scales) if scales else None
    return (abs(loss - loss_r) / abs(loss_r), abs(norm - norm_r) / norm_r, (rel[worst], worst),
            len(rel), (scales.get(top, 0.0), top))


def legacy_broken(loss_rel, norm_rel, grad_rel, limits):
    """The limits (loss, norm, gradient) a reading is outside of."""
    return [name for name, v, lim in zip(("loss", "norm", "gradient"),
                                         (loss_rel, norm_rel, grad_rel), limits) if not v <= lim]


def legacy_check(dev, geo=LEGACY_GEOMETRY, dtype=None, ref_dtype=None, models=LEGACY,
                 limits=None, faults=LEGACY_FAULTS, timed=True, card=""):
    """q (i) and (iii).  Each model at the geometry in ``dtype`` (bf16)
    against itself in ``ref_dtype`` (float32) from the same weights and
    batch: the eval forward's argmax agreement (printed), a training step
    with dropout off at the limits (loss, gradient norm, every parameter's
    relative gradient difference), each planted fault (LEGACY_FAULTS, in
    the ``dtype`` step) outside them and every limit broken by some fault;
    then, ``timed``, LEGACY_STEPS Adamax steps in ``dtype`` with dropout
    (legacy_times).  No kernel may launch.  Returns the readings."""
    import torch

    from vitxtgqa_tpu_torch.losses import Losses
    from vitxtgqa_tpu_torch.ops import _build

    limits = limits or (LEGACY_LOSS_REL_TOL, LEGACY_GNORM_REL_TOL, LEGACY_GRAD_REL_TOL)
    noise = LEGACY_NOISE
    out, broken_by = {}, {}
    _build.reset_launch_counts()
    for key in models:
        model, ref, tb, nout = legacy_models(key, dev, geo, dtype, ref_dtype)
        losses = Losses([{"type": "logit_bce"}], "vqa2")
        n_params = sum(p.numel() for p in model.parameters())
        with torch.inference_mode():
            scores, scores_ref = model(tb)["scores"], ref(tb)["scores"]
        if scores.shape != (geo["batch"], nout) or not torch.isfinite(scores).all():
            fail(f"slice legacy {key}: scores {tuple(scores.shape)}, finite "
                 f"{bool(torch.isfinite(scores).all())}")
        agree = (scores.argmax(-1) == scores_ref.argmax(-1)).float().mean().item()
        want = legacy_step(ref, tb, losses)
        del ref
        run = legacy_step(model, tb, losses)
        loss_rel, norm_rel, (grad_rel, worst), n, (sc_rel, sc_worst) = legacy_agreement(
            run, want, noise)
        broken = legacy_broken(loss_rel, norm_rel, grad_rel, limits)
        print(f"slice legacy {key}: {n_params / 1e6:.1f}M params, batch {geo['batch']}, "
              f"{model.opts.dtype} vs float32: argmax agreement {agree:.4f} (printed: random "
              f"weights); loss {run[0]:.6f} vs {want[0]:.6f} (rel {loss_rel:.3e}), gradient "
              f"norm {run[1]:.5f} vs {want[1]:.5f} (rel {norm_rel:.3e}), per-parameter gradient "
              f"rel diff max {grad_rel:.3e} ({worst}) over {n} parameters (limits: loss, norm, "
              f"gradient {limits}): {'outside ' + str(broken) if broken else 'within'}; of "
              f"these the weight-norm scales' rel max {sc_rel:.3e} ({sc_worst})",
              flush=True)
        rec = {"params_m": n_params / 1e6, "argmax_agreement": agree, "loss": [run[0], want[0]],
               "grad_norm": [run[1], want[1]], "loss_rel": loss_rel, "grad_norm_rel": norm_rel,
               "max_grad_rel": grad_rel, "max_grad_rel_param": worst, "outside": broken,
               "max_scalar_grad_rel": sc_rel, "max_scalar_grad_rel_param": sc_worst,
               "planted": {}}
        del run
        for fault in [f for f, m in faults.items() if m == key]:
            bad = legacy_step(model, tb, losses, fault=fault)
            f_loss, f_norm, (f_grad, f_worst), _, _ = legacy_agreement(bad, want, noise)
            hit = legacy_broken(f_loss, f_norm, f_grad, limits)
            print(f"slice legacy {key}: planted {fault}: loss rel {f_loss:.3e}, norm rel "
                  f"{f_norm:.3e}, gradient rel max {f_grad:.3e} ({f_worst}): outside the limits "
                  f"{hit}", flush=True)
            rec["planted"][fault] = {"loss_rel": f_loss, "grad_norm_rel": f_norm,
                                     "max_grad_rel": f_grad, "outside": hit}
            broken_by[fault] = hit
            del bad
        del want
        if timed:
            rec.update(legacy_times(key, model, tb, losses, dev, card))
        out[key] = rec
        del model, tb
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    launched = {k: v for k, v in _build.launch_counts().items() if v}
    if launched:
        fail(f"slice legacy: the legacy models launched kernels {launched}")
    for key, rec in out.items():
        if rec["outside"]:
            fail(f"slice legacy {key}: the step disagrees with float32 outside the limits "
                 f"{rec['outside']}")
    for fault, hit in broken_by.items():
        if not hit:
            fail(f"slice legacy: the planted fault {fault} passes the limits")
    caught = {lim for hit in broken_by.values() for lim in hit}
    if faults and caught != {"loss", "norm", "gradient"}:
        fail(f"slice legacy: only the limits {sorted(caught)} caught a planted fault")
    return out


def legacy_times(key, model, tb, losses, dev, card):
    """LEGACY_STEPS Adamax steps (the config's optimizer_attributes and
    schedule, dropout from the step's generator): each step's ms, the
    median after the first, the peak memory, parameters moved; then the
    eval forward's ms (median of 5 after one warm-up)."""
    import torch

    from vitxtgqa_tpu_torch.core.config import build_config
    from vitxtgqa_tpu_torch.training.optim import build_optimizer
    from vitxtgqa_tpu_torch.training.step import step_generators, train_step

    config = LEGACY_CONFIGS.get(key, ("pythia_vqa2.yml",))[0]
    full = build_config(os.path.join(ROOT, "configs", config))
    opt = build_optimizer(model, full.optimizer_attributes, full.training_parameters)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    before_names = list(before)
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    times, seen = [], []
    for step in range(LEGACY_STEPS):
        t = time.perf_counter()
        r = train_step(model, losses, opt, tb, step_generators(0, step, dev))
        sync(dev)
        times.append((time.perf_counter() - t) * 1e3)
        seen.append(float(r["loss"]))
        if not r["applied"]:
            fail(f"slice legacy {key}: Adamax step {step} had a non-finite loss or gradient")
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    moved = sum(bool((p.detach() != before[k]).any()) for k, p in model.named_parameters())
    if not moved:
        fail(f"slice legacy {key}: the Adamax steps left every parameter unchanged")
    del before
    fwd = []
    for i in range(6):
        t = time.perf_counter()
        with torch.inference_mode():
            model(tb)
        sync(dev)
        fwd.append((time.perf_counter() - t) * 1e3)
    step_ms, fwd_ms = statistics.median(times[1:]), statistics.median(fwd[1:])
    print(f"slice legacy {key}: {LEGACY_STEPS} Adamax steps at batch {tb['text'].shape[0]}, "
          f"{model.opts.dtype}: losses {seen}, {moved} of {len(before_names)} parameters moved "
          f"(the others get no gradient at the init), step ms {[round(x, 2) for x in times]} (the first "
          f"warms up), median {step_ms:.2f}; eval forward ms median {fwd_ms:.2f} (min "
          f"{min(fwd[1:]):.2f}); max_memory_allocated {peak / 2**30:.2f} GiB; card {card}",
          flush=True)
    return {"step_ms_all": times, "step_ms_median": step_ms, "forward_ms_all": fwd,
            "forward_ms_median": fwd_ms, "max_memory_allocated": peak, "adamax_losses": seen,
            "params_moved": moved}


def legacy_runtime(card, geo=LEGACY_GEOMETRY, extra=None, workers=None,
                   steps=LEGACY_RUNTIME_STEPS):
    """q (ii).  ``python -m vitxtgqa_tpu_torch.run``'s run() on synthetic
    VQA2 / VizWiz / TextVQA trees the port writes (utils/legacy_fixtures:
    3 batches of training questions, one of validation, half of test,
    8 questions an image, the geometry's features and answer spaces; the
    question vocabulary the models' 100,000 words): pythia on vqa2 and
    LoRRA on textvqa (``steps`` iterations, the snapshot's and the final
    validation, EvalAI predictions of val and test), then pythia on
    vqa2,vizwiz (VizWiz on VQA2's answer space, twice the steps), its
    schedule printed and held against the port's own MultiDataset on the
    same seed.  ``extra(model)``: more opts (the CPU dry run's); ``workers``:
    training_parameters.num_workers (None: the configs' 8).  No kernel may
    launch."""
    import json as _json
    import shutil
    import tempfile

    import numpy as np

    from vitxtgqa_tpu_torch.data.multi_dataset import MultiDataset
    from vitxtgqa_tpu_torch.ops import _build
    from vitxtgqa_tpu_torch.run import run
    from vitxtgqa_tpu_torch.utils.legacy_fixtures import write_tree

    b = geo["batch"]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_legacy_")
    out = {}
    try:
        root = os.path.join(tmp, "data")
        t0 = time.perf_counter()
        questions = {"train": 3 * b, "val": b, "test": max(1, b // 2)}
        write_tree(root, questions=questions, per_image=8, feat_dim=geo["feat"],
                   boxes=dict(geo["boxes"], vizwiz=geo["boxes"]["vqa2"]), grid=geo["grid"],
                   question_vocab=geo["vocab"] - 4, ocr_tokens=geo["ocr"],
                   text_len=geo["text_len"],
                   answers=dict(geo["answers"], vizwiz=geo["answers"]["vqa2"]))
        print(f"slice legacy runtime: wrote the VQA2 / VizWiz / TextVQA trees ({questions} "
              f"questions each) in {time.perf_counter() - t0:.1f} s", flush=True)
        two = os.path.join(tmp, "pythia_vqa2_vizwiz.yml")
        with open(two, "w") as f:
            f.write(f"includes:\n- {os.path.join(ROOT, 'configs', 'pythia_vqa2.yml')}\n"
                    "- common/defaults/configs/datasets/vqa/vizwiz.yml\n")
        runs = (("pythia_vqa2", "pythia_vqa2.yml", "pythia", ("vqa2",), steps),
                ("lorra_textvqa", "lorra_textvqa.yml", "lorra", ("textvqa",), steps),
                ("pythia_vqa2_vizwiz", two, "pythia", ("vqa2", "vizwiz"), 2 * steps))
        _build.reset_launch_counts()
        for name, config, model, datasets, n_steps in runs:
            save = os.path.join(tmp, name)
            argv = ["--config", config if os.path.isabs(config) else
                    os.path.join(ROOT, "configs", config), "--model", model, "--datasets",
                    ",".join(datasets), "--run_type",
                    "train" if len(datasets) > 1 else "train+inference",
                    f"training_parameters.save_dir={save}", "training_parameters.seed=1",
                    f"training_parameters.max_iterations={n_steps}",
                    "training_parameters.log_interval=1",
                    f"training_parameters.snapshot_interval={n_steps}",
                    "training_parameters.evalai_inference=True",
                    f"training_parameters.batch_size={b}"]
            argv += [f"dataset_attributes.{d}.data_root_dir={root}" for d in datasets]
            if len(datasets) > 1:
                argv += ["dataset_attributes.vizwiz.processors.answer_processor.params."
                         "vocab_file=vocabs/answers_vqa.txt"]
            if workers is not None:
                argv += [f"training_parameters.num_workers={workers}"]
            t0 = time.perf_counter()
            trainer = run(argv + (list(extra(model)) if extra else []))
            wall = time.perf_counter() - t0
            losses = list(trainer.meter["train/total_loss"].series)
            ds = datasets[0]
            acc = trainer.meter.get_scalar_dict().get(f"val/{ds}/vqa_accuracy")
            if (trainer.iteration != n_steps or len(losses) != n_steps
                    or not all(np.isfinite(losses)) or acc is None or not 0.0 <= acc <= 1.0):
                fail(f"slice legacy runtime {name}: iteration {trainer.iteration}, losses "
                     f"{losses}, val vqa_accuracy {acc}")
            rec = {"losses": losses, "val_vqa_accuracy": acc, "wall_s": wall,
                   "iteration_ms": trainer.timings["iteration_ms"],
                   "val_ms": trainer.timings["val_ms"], "dtype": str(trainer.opts.dtype)}
            if len(datasets) > 1:
                multi = trainer.multi_train
                own = MultiDataset(multi.loaders, proportional=True, seed=trainer.seed)
                want = [own.dataset_for_step(s) for s in range(n_steps)]
                print(f"slice legacy runtime {name}: schedule {trainer.datasets_drawn} (the "
                      f"port's MultiDataset on seed {trainer.seed}: {want})", flush=True)
                if trainer.datasets_drawn != want:
                    fail(f"slice legacy runtime {name}: the run drew {trainer.datasets_drawn}, "
                         f"the schedule is {want}")
                rec["schedule"] = want
            else:
                reports = os.path.join(save, "reports")
                rows = {f.rsplit("_", 1)[0]: _json.load(open(os.path.join(reports, f)))
                        for f in sorted(os.listdir(reports))}
                sizes = {k: len(v) for k, v in rows.items()}
                if sizes != {f"{ds}_val": questions["val"], f"{ds}_test": questions["test"]}:
                    fail(f"slice legacy runtime {name}: EvalAI records {sizes}")
                keys = {"question_id", "answer"} | (
                    {"actual_answers", "question_tokens", "image_id"} if ds == "vqa2" else set())
                if any(set(r) != keys or not isinstance(r["answer"], str)
                       for rs in rows.values() for r in rs):
                    fail(f"slice legacy runtime {name}: a record is not {sorted(keys)}")
                rec["records"] = sizes
            print(f"slice legacy runtime {name}: {n_steps} steps at batch {b} ("
                  f"{trainer.opts.dtype}), losses {[round(x, 5) for x in losses]}, val "
                  f"vqa_accuracy {acc:.4f}; iteration ms "
                  f"{[round(x, 2) for x in trainer.timings['iteration_ms']]}, validation pass "
                  f"ms {[round(x, 2) for x in trainer.timings['val_ms']]}; run() wall "
                  f"{wall:.1f} s; card {card}", flush=True)
            out[name] = rec
            del trainer
        launched = {k: v for k, v in _build.launch_counts().items() if v}
        if launched:
            fail(f"slice legacy runtime: kernels launched {launched}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def legacy_slice(dev, card) -> dict:
    """q. The legacy image-VQA zoo: the checks of legacy_check, then the
    runtime's runs (legacy_runtime)."""
    import torch

    out = {"check": legacy_check(dev, card=card)}
    torch.cuda.empty_cache()
    out["runtime"] = legacy_runtime(card)
    return out


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
    # l. the runtime: train, check, resume, predict; the recompute oracle
    details["runtime"] = runtime_slice(dev, record, card)
    # m. the zoo's T2S-family models
    details["zoo"] = zoo_slice(dev, record, card)
    # n. the selector baselines, TranSTR and MIST
    details["selectors"] = selector_slice(dev, record, card)
    # o. data parallelism over DP_RANKS ranks: parity, timing, the torchrun CLI
    details["dp"] = dp_slice(record, card)
    # p. serving at bucket 48, the serve demo, the raw-video pipeline
    details["serving"] = serving_slice(dev, record, card)
    # q. the legacy image-VQA zoo: bf16 against float32, Adamax steps, run()
    details["legacy"] = legacy_slice(dev, card)
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
    print("build: the decode attention body (csrc/decode_attention.cu): " + "; ".join(
        f"{name} {regs} registers, spill stores / loads {st} / {ld} bytes"
        for name, regs, st, ld in _build.ptxas_kernels(log, "decode_attention.cu")),
        flush=True)
    for source, what in (("block_train.cu", "the training block"),
                         ("fused_block.cu", "the eval block"), ("fused_ffn.cu", "the ViT FFN")):
        print(f"build: {what} (csrc/{source}, csrc/gemm_sm90.cuh): " + "; ".join(
            f"{name} {regs} registers, spill stores / loads {st} / {ld} bytes"
            for name, regs, st, ld in _build.ptxas_kernels(log, source)), flush=True)

    for source, what in (("fused_epilogue.cu", "the fused epilogue"),
                         ("ptr_scores.cu", "the int8 pointer scores")):
        print(f"build: {what} (csrc/{source}): " + "; ".join(
            f"{name} {regs} registers, spill stores / loads {st} / {ld} bytes"
            for name, regs, st, ld in _build.ptxas_kernels(log, source)), flush=True)
    check_no_i2f(_build.sass(lib_path))
    out_dir = argv[argv.index("--out") + 1] if "--out" in argv else os.path.join(ROOT, "build")
    os.makedirs(out_dir, exist_ok=True)

    record = {}
    decode = check_kernels(dev, record)
    details = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
               "build_s": build_s, "kernels": record, "decode_attention": decode}
    details["serving_mode_kernels"] = check_serving_mode_kernels(dev, record)
    details["vit_kernels"] = check_vit_kernels(dev, record)
    details["training_kernels"] = check_training_kernels(dev, record)
    details["sp_kernels"] = check_sp_kernels(dev, record)
    check_padded_keys(dev, record)
    details["zoo_geometries"] = check_zoo_geometries(dev, record)
    details["slices"] = run_slices(dev, record, card)
    stop_child_processes()
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
