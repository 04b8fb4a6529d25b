"""Single-query attention over the unified decode cache, int8 or bf16: the
kernel wrappers and their plain PyTorch versions.

Counterparts of vitxtgqa_tpu/ops/pallas_attention.py:decode_attention_int8
and decode_attention.  Both CUDA kernels are csrc/decode_attention.cu (one
template, with and without the scale folding): a thread block cluster per
(head group, batch row) whose blocks split the cache's keys into spans and
read only the allowed keys' rows; ``launch_plan`` picks the cluster size
and the head grouping.  Any head width a multiple of 8 up to 128: a thread
holds one chunk of a head row (``chunking``: 16 bytes at the main path's
64, else 8 elements), a head CPH chunks, the ones past D idle.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from vitxtgqa_tpu_torch.ops import _build
from vitxtgqa_tpu_torch.ops.flash_attention import check_head_width

NEG = -1e9

# the launch plan's constants: as csrc/decode_attention.cu has them, the
# threads a block, the largest (portable) cluster and the keys a thread
# tests in the compaction; then one wave of the H100's blocks, four on each
# of its 132 SMs (a block's 192 threads take ~80 registers each, so four
# fit an SM's 65,536, and their shared memory fits beside them up to
# SMEM_TARGET), and the fewest keys a block's span may hold
THREADS, MAX_CLUSTER, MAX_PER_THREAD = 192, 8, 32
WAVE, SMEM_TARGET, MIN_SPAN = 4 * 132, 56 * 1024, 32
SMEM_LIMIT = 227 * 1024  # shared memory a block may use on Hopper


class DecodePlan(NamedTuple):
    cluster: int          # blocks of a cluster: the key spans of one batch row
    head_groups: int      # clusters per batch row, one per group of heads
    heads_per_group: int
    span: int             # keys of a block (the last one may hold fewer)
    smem: int             # dynamic shared memory of a block, bytes
    blocks: int


def chunking(head_dim: int, elem_bytes: int):
    """(elements of a thread's chunk, chunks a head) of csrc/decode_attention.cu
    at this head width (its by_width): 16-byte chunks at 64, else chunks of
    8 elements, 4 a head up to 32, 8 up to 64, 16 up to 128."""
    if head_dim == 64:
        return 16 // elem_bytes, 64 * elem_bytes // 16
    return 8, (4 if head_dim <= 32 else 8 if head_dim <= 64 else 16)


def smem_bytes(span: int, heads_per_group: int, elem_bytes: int, head_dim: int = 64) -> int:
    """csrc/decode_attention.cu's smem_bytes: V partial sums [THREADS x the
    chunk's elements], the peers' (max, sum) pairs and partial outputs, the
    row's pairs, the scan's counts, and per key of the span its index, its
    vs and its scores."""
    per, _ = chunking(head_dim, elem_bytes)
    return 4 * (THREADS * per + (2 * MAX_CLUSTER + 2) * heads_per_group
                + heads_per_group * head_dim + MAX_CLUSTER + 8 + span * (2 + heads_per_group))


@functools.lru_cache(maxsize=256)
def launch_plan(batch: int, cache_len: int, num_heads: int, elem_bytes: int,
                head_dim: int = 64) -> DecodePlan:
    """The grid of one decode call, batch x head groups x cluster blocks:
    first the cluster grows (2, 4, 8 key spans of at least MIN_SPAN keys),
    then the heads split into more groups (a block holds the whole row
    segment of its heads, CPH chunks a head over THREADS threads), each while
    the grid stays within one WAVE.  A block whose shared memory would pass
    SMEM_TARGET splits its span further while the cluster may grow, and
    one that passes what shared memory or the compaction take must; a
    cache no plan fits raises."""
    check_head_width("decode attention", head_dim)
    _, cph = chunking(head_dim, elem_bytes)
    groups = [g for g in range(1, num_heads + 1)
              if num_heads % g == 0 and THREADS % (num_heads // g * cph) == 0]
    if not groups:
        raise NotImplementedError(f"decode attention: no head grouping of {num_heads} heads")
    gi, cluster = 0, 1
    blocks = lambda: batch * groups[gi] * cluster
    while (cluster < MAX_CLUSTER and 2 * blocks() <= WAVE
           and -(-cache_len // (2 * cluster)) >= MIN_SPAN):
        cluster *= 2
    while gi + 1 < len(groups) and batch * groups[gi + 1] * cluster <= WAVE:
        gi += 1
    hg = num_heads // groups[gi]
    span = -(-cache_len // cluster)
    smem = lambda: smem_bytes(span, hg, elem_bytes, head_dim)
    while smem() > SMEM_TARGET and cluster < MAX_CLUSTER:
        cluster *= 2
        span = -(-cache_len // cluster)
    while span > MAX_PER_THREAD * THREADS or smem() > SMEM_LIMIT:
        if cluster == MAX_CLUSTER:
            raise NotImplementedError(f"decode attention: a cache of {cache_len} keys")
        cluster *= 2
        span = -(-cache_len // cluster)
    return DecodePlan(cluster, groups[gi], hg, span, smem(), blocks())


def max_active_clusters(batch: int, cache_len: int, num_heads: int, int8: bool,
                        head_dim: int = 64) -> int:
    """cudaOccupancyMaxActiveClusters of the plan's launch on the current
    card (0 if the card cannot run one of its clusters)."""
    plan = launch_plan(batch, cache_len, num_heads, 1 if int8 else 2, head_dim)
    count = ctypes.c_int(0)
    err = _build.lib().vt_decode_attention_clusters(
        int(int8), batch, cache_len, num_heads, head_dim, plan.cluster, plan.head_groups,
        ctypes.addressof(count))
    _build.check(err, "decode_attention occupancy")
    return count.value


def _check_slots(l: int, step: int, write_offset: int) -> None:
    """The kernel reads only the allowed keys, so a row must have one: the
    decoder slot at write_offset."""
    if not (0 <= write_offset and 0 <= step and write_offset + step < l):
        raise ValueError(f"decode attention: decoder slots [{write_offset}, "
                         f"{write_offset + step}] outside the cache of {l} keys")


def _decoder_slots_ok(l, step, write_offset, device):
    cols = torch.arange(l, device=device)
    return (cols >= write_offset) & (cols <= write_offset + step)


def decode_attention_int8_plain(q, k8, ks, v8, vs, key_mask, step: int,
                                write_offset: int, num_heads: int):
    """q [B, 1, H*D]; k8/v8 [B, L, H*D] int8; ks/vs [B, L] f32 per-token
    scales.  Dequantization folds into scores and weights as in the Pallas
    kernel: s = (q . k8) * (ks / sqrt(D)); w = softmax(s) * vs, rounded to
    q's dtype; out = w . v8."""
    b, _, hd_total = q.shape
    l = k8.shape[1]
    d = hd_total // num_heads
    scale = 1.0 / d ** 0.5
    qh = q.reshape(b, num_heads, 1, d).float()
    kh = k8.to(q.dtype).reshape(b, l, num_heads, d).permute(0, 2, 3, 1).float()
    vh = v8.to(q.dtype).reshape(b, l, num_heads, d).transpose(1, 2).float()
    scores = torch.matmul(qh, kh) * (ks.float() * scale)[:, None, None, :]
    allowed = (key_mask > 0) | _decoder_slots_ok(l, step, write_offset, q.device)[None, :]
    scores = scores.masked_fill(~allowed[:, None, None, :], NEG)
    w = torch.softmax(scores, dim=-1) * vs.float()[:, None, None, :]
    out = torch.matmul(w.to(q.dtype).float(), vh)  # [B, H, 1, D]
    return out.reshape(b, 1, hd_total).to(q.dtype)


def decode_attention_plain(q, k, v, key_mask, step: int, write_offset: int,
                           num_heads: int):
    """q [B, 1, H*D]; k/v [B, L, H*D] in q's dtype.  As the Pallas kernel:
    s = (q . k) / sqrt(D) in f32, masked with -1e9; w = softmax(s) rounded
    to v's dtype; out = w . v with f32 accumulation."""
    b, _, hd_total = q.shape
    l = k.shape[1]
    d = hd_total // num_heads
    qh = q.reshape(b, num_heads, 1, d).float()
    kh = k.reshape(b, l, num_heads, d).permute(0, 2, 3, 1).float()
    vh = v.reshape(b, l, num_heads, d).transpose(1, 2).float()
    scores = torch.matmul(qh, kh) * (1.0 / d ** 0.5)
    allowed = (key_mask > 0) | _decoder_slots_ok(l, step, write_offset, q.device)[None, :]
    scores = scores.masked_fill(~allowed[:, None, None, :], NEG)
    w = torch.softmax(scores, dim=-1).to(v.dtype).float()
    return torch.matmul(w, vh).reshape(b, 1, hd_total).to(q.dtype)


def check_head_dim(name, hd_total, num_heads):
    """Raise unless ``hd_total`` columns are ``num_heads`` heads of a width
    the kernel takes (flash_attention.head_width_ok)."""
    if num_heads <= 0 or hd_total % num_heads:
        raise ValueError(f"{name}: {hd_total} columns are not {num_heads} heads")
    check_head_width(name, hd_total // num_heads)


def decode_attention(q, k, v, key_mask, step: int, write_offset: int,
                     num_heads: int):
    """One decode step over the bf16 cache; returns [B, 1, H*D]."""
    if not q.is_cuda:
        return decode_attention_plain(q, k, v, key_mask, step, write_offset,
                                      num_heads)
    b, _, hd_total = q.shape
    l = k.shape[1]
    check_head_dim("decode_attention", hd_total, num_heads)
    dev = q.device
    _build.require(q, "q", torch.bfloat16, (b, 1, hd_total), dev)
    for name, t in (("k", k), ("v", v)):
        _build.require(t, name, torch.bfloat16, (b, l, hd_total), dev)
    _build.require(key_mask, "key_mask", torch.float32, (b, l), dev)
    _check_slots(l, step, write_offset)
    plan = launch_plan(b, l, num_heads, 2, hd_total // num_heads)
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        err = _build.lib().vt_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), key_mask.data_ptr(),
            out.data_ptr(), b, l, num_heads, hd_total // num_heads, plan.cluster,
            plan.head_groups, int(step), int(write_offset), _build.stream_of(q),
        )
    _build.check(err, "decode_attention")
    _build.LAUNCHES["decode_attention"] += 1
    return out


def decode_attention_int8(q, k8, ks, v8, vs, key_mask, step: int,
                          write_offset: int, num_heads: int):
    """One decode step over the int8 cache; returns [B, 1, H*D]."""
    if not q.is_cuda:
        return decode_attention_int8_plain(q, k8, ks, v8, vs, key_mask, step,
                                           write_offset, num_heads)
    b, _, hd_total = q.shape
    l = k8.shape[1]
    check_head_dim("decode_attention_int8", hd_total, num_heads)
    dev = q.device
    _build.require(q, "q", torch.bfloat16, (b, 1, hd_total), dev)
    for name, t in (("k8", k8), ("v8", v8)):
        _build.require(t, name, torch.int8, (b, l, hd_total), dev)
    for name, t in (("ks", ks), ("vs", vs), ("key_mask", key_mask)):
        _build.require(t, name, torch.float32, (b, l), dev)
    _check_slots(l, step, write_offset)
    plan = launch_plan(b, l, num_heads, 1, hd_total // num_heads)
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        err = _build.lib().vt_decode_attention_int8(
            q.data_ptr(), k8.data_ptr(), ks.data_ptr(), v8.data_ptr(),
            vs.data_ptr(), key_mask.data_ptr(), out.data_ptr(), b, l,
            num_heads, hd_total // num_heads, plan.cluster, plan.head_groups,
            int(step), int(write_offset), _build.stream_of(q),
        )
    _build.check(err, "decode_attention_int8")
    _build.LAUNCHES["decode_attention_int8"] += 1
    return out
