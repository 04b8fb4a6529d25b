"""Single-kernel greedy-decode step and its fused epilogue: the kernel
wrappers and their plain PyTorch versions.

Counterpart of vitxtgqa_tpu/ops/pallas_decode_step.py: ``fused_decode_step``
runs one decode step through every MMT layer in one launch (QKV GEMVs, the
int8 quantization of the new K/V rows, attention over the packed int8
cache with the current token substituted, the post-attention block), and
``fused_epilogue`` turns its output into the step's scores, greedy token
and next decoder-slot embedding in a second launch.  The CUDA kernels are
csrc/fused_decode_step.cu and csrc/fused_epilogue.cu.  Each launch of either
holds at most GROUP_ROWS batch rows: a larger batch runs in groups of
GROUP_ROWS rows (the last one 1 to GROUP_ROWS, ``row_groups``), a launch
each, over the whole batch's cache and tables, so a step at batch B is
ceil(B / 8) launches of each kernel.

Layouts differ from the JAX functions in one respect: every weight keeps
torch's nn.Linear layout ``[out, in]`` (stacked over layers for the step:
``wq [L, D, D]``, ``w1 [L, M, D]``, ``w2 [L, D, M]``; the classifier as
``cls_w [Vp, D]`` and the pointer query as ``ptr_w [QK, D]``), where the JAX
functions take ``[in, out]``.  Biases and LayerNorm parameters are float32
``[L, 1, width]`` as in the JAX stacks.
"""

from __future__ import annotations

import ctypes

import torch

from vitxtgqa_tpu_torch.ops import _build
from vitxtgqa_tpu_torch.ops.attention import quantize_kv
from vitxtgqa_tpu_torch.ops.fused_block import fused_block_plain
from vitxtgqa_tpu_torch.ops.flash_attention import head_width_ok

NEG = -1e30  # pallas_decode_step.py _NEG
GROUP_ROWS = 8  # the batch rows of one launch of either kernel
# csrc/fused_decode_step.cuh kMaxD / kMaxM: the widest hidden and FFN widths
# of the step kernel (each a multiple of 128; the hidden width H x Dh, Dh a
# multiple of 8 up to 128)
MAX_STEP_HIDDEN, MAX_STEP_FFN = 2048, 8192
MAX_CACHE = 4096  # cache slots of one step kernel launch (kMaxLp)
MAX_SPANS = 16  # key spans of one (batch row, head) unit of the step kernel
# csrc/fused_epilogue.cu: (max, index) partials a batch row (kMaxGrid), warps
# a block, blocks an SM at most; the H100's SM count
EPILOGUE_MAX_GRID, EPILOGUE_WARPS, EPILOGUE_BLOCKS_PER_SM, H100_SMS = 1024, 8, 2, 132
STACK_NAMES = ("wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo", "s1", "g1",
               "w1", "b1", "w2", "b2", "s2", "g2")


def fused_decode_step_plain(x_t, stacks, kv8, kvs, key_mask, step: int,
                            write_offset: int, num_heads: int,
                            eps: float = 1e-12):
    """pallas_decode_step.fused_step_reference in torch.

    x_t [B, 1, D]; stacks: the weight stacks of fused_decode_prep (torch
    layout); kv8 [L, B, Lp, 2*H*Dh] int8 (K | V); kvs [L, B, 2, Lp] f32;
    key_mask [B, Lp].  Returns (y [B, 1, D], row8 [L, B, 1, 2*H*Dh] int8,
    rowsc [L, B, 2, 1] f32); the caller commits the rows at
    ``write_offset + step``, which this function never reads."""
    n_layers, b, l_p, two_hd = kv8.shape
    hd_total = two_hd // 2
    hd = hd_total // num_heads
    scale = 1.0 / hd ** 0.5
    pos = write_offset + int(step)
    cols = torch.arange(l_p, device=x_t.device)
    is_cur = (cols == pos)[None, None, :]
    allowed = (key_mask > 0) | ((cols >= write_offset) & (cols < pos))[None, :]
    xv = x_t[:, 0]
    dt = xv.dtype
    heads = lambda t: t.reshape(t.shape[0], -1, num_heads, hd)
    rows8, rowsc = [], []
    for l in range(n_layers):
        proj = lambda w, bias: (torch.matmul(xv.float(), stacks[w][l].to(dt).float().t())
                                + stacks[bias][l].float()).to(dt)
        q, k_t, v_t = proj("wq", "bq"), proj("wk", "bk"), proj("wv", "bv")
        k8_t, k_sc = quantize_kv(k_t)
        v8_t, v_sc = quantize_kv(v_t)
        rows8.append(torch.cat([k8_t, v8_t], dim=-1)[:, None, :])
        rowsc.append(torch.stack([k_sc, v_sc], dim=1)[:, :, None])

        kf = heads(kv8[l, :, :, :hd_total].to(dt).float())   # [B, Lp, H, hd]
        vf = heads(kv8[l, :, :, hd_total:].to(dt).float())
        ks_row, vs_row = kvs[l, :, 0], kvs[l, :, 1]          # [B, Lp]
        qh = q.float().reshape(b, num_heads, hd)
        scores = torch.einsum("bhd,blhd->bhl", qh, kf) * (ks_row * scale)[:, None, :]
        cur = torch.einsum("bhd,bhd->bh", qh, k8_t.to(dt).float().reshape(b, num_heads, hd))
        cur = cur * (k_sc * scale)[:, None]
        scores = scores.masked_fill(~allowed[:, None, :], NEG)
        scores = torch.where(is_cur, cur[:, :, None], scores)
        w = torch.softmax(scores, dim=-1)
        w_cur = w[:, :, pos]
        wv = torch.where(is_cur, 0.0, w * vs_row[:, None, :]).to(dt).float()
        v_cur = (v8_t.float() * v_sc[:, None]).reshape(b, num_heads, hd)
        ctx = torch.einsum("bhl,blhd->bhd", wv, vf) + w_cur[..., None] * v_cur
        ctx = ctx.reshape(b, hd_total).to(dt)
        xv = fused_block_plain(xv, ctx, *(stacks[n][l] for n in STACK_NAMES[6:]), eps=eps)
    return xv[:, None, :], torch.stack(rows8), torch.stack(rowsc)


def step_widths_ok(d: int, m: int) -> bool:
    """Whether the step kernel takes hidden width d and FFN width m:
    multiples of 128 up to MAX_STEP_HIDDEN / MAX_STEP_FFN."""
    return 0 < d <= MAX_STEP_HIDDEN and d % 128 == 0 and 0 < m <= MAX_STEP_FFN and m % 128 == 0


def row_groups(b: int) -> list:
    """The launches of one step of either kernel at batch b: (first row,
    rows) of each group, GROUP_ROWS rows each but the last."""
    return [(b0, min(GROUP_ROWS, b - b0)) for b0 in range(0, b, GROUP_ROWS)]


def check_step_shape(d: int, m: int, num_heads: int, hd_total: int, b: int, l_p: int) -> None:
    """Raise unless csrc/fused_decode_step.cu takes this step: H heads of
    a width head_width_ok takes making the hidden width (ROADMAP queue 2
    item 5 past 128), widths step_widths_ok takes and at most MAX_CACHE
    slots (ROADMAP queue 2 item 3), at any batch (row_groups)."""
    hd = hd_total // num_heads if num_heads > 0 and hd_total % num_heads == 0 else 0
    if (hd_total != d or not head_width_ok(hd) or not step_widths_ok(d, m) or b < 1
            or l_p > MAX_CACHE):
        raise NotImplementedError(
            f"fused_decode_step kernel: H heads of a multiple of 8 up to 128 (head widths "
            f"above 128: ROADMAP queue 2 item 5) == hidden, hidden and FFN widths multiples "
            f"of 128 up to {MAX_STEP_HIDDEN} / {MAX_STEP_FFN} and at most {MAX_CACHE} cache "
            f"slots (ROADMAP queue 2 item 3); got hidden {d}, H*D {hd_total} over "
            f"{num_heads} heads, FFN {m}, batch {b}, cache {l_p}")


def step_buffers(n_layers: int, b: int, d: int, m: int, device, num_heads: int) -> dict:
    """The outputs of one fused_decode_step at batch ``b`` over
    ``num_heads`` heads, and the scratch of one launch, which its groups'
    launches (row_groups) take in turn; allocate once per decode and pass
    to every step.  ``opart`` holds each head's f32 share of ctx Wo^T,
    ``apart`` each key span's f32 weighted V rows (a head row each), and
    ``arrive`` the span counters of the (row, head) units, zero here and
    left zero by every launch."""
    dev = torch.device(device)
    h, g = num_heads, min(b, GROUP_ROWS)
    e = lambda shape, dt: torch.empty(shape, dtype=dt, device=dev)
    return {
        "y": e((b, 1, d), torch.bfloat16),
        "row8": e((n_layers, b, 1, 2 * d), torch.int8),
        "rowsc": e((n_layers, b, 2, 1), torch.float32),
        "qkv": e((g, 3 * d), torch.bfloat16),
        "pre": e((g, d), torch.float32),
        "h": e((g, m), torch.bfloat16),
        "opart": e((h, g, d), torch.float32),
        "apart": e((g * h * MAX_SPANS, d // h), torch.float32),
        "arrive": torch.zeros((g * h,), dtype=torch.int32, device=dev),
    }


def fused_decode_step(x_t, stacks, kv8, kvs, key_mask, step: int,
                      write_offset: int, num_heads: int, eps: float = 1e-12,
                      buffers: dict | None = None):
    """One decode step over all layers, one launch a group of rows
    (row_groups); the arguments and returns of fused_decode_step_plain.
    ``buffers`` (step_buffers) holds the outputs and scratch; the returned
    tensors are its ``y``, ``row8`` and ``rowsc``, overwritten by the next
    call that shares them."""
    if not x_t.is_cuda:
        return fused_decode_step_plain(x_t, stacks, kv8, kvs, key_mask, step,
                                       write_offset, num_heads, eps)
    n_layers, b, l_p, two_hd = kv8.shape
    d = x_t.shape[-1]
    m = stacks["w1"].shape[1]
    check_step_shape(d, m, num_heads, two_hd // 2, b, l_p)
    if not 0 <= write_offset + int(step) < l_p:
        raise ValueError(f"decoder slot {write_offset + int(step)} outside the cache ({l_p})")
    dev = x_t.device
    w_shape = {"w1": (m, d), "w2": (d, m)}
    for name in STACK_NAMES:
        if name[0] == "w":
            _build.require(stacks[name], name, torch.bfloat16,
                           (n_layers,) + w_shape.get(name, (d, d)), dev)
        else:
            width = m if name == "b1" else d
            _build.require(stacks[name], name, torch.float32, (n_layers, 1, width), dev)
    _build.require(x_t, "x_t", torch.bfloat16, (b, 1, d), dev)
    _build.require(kv8, "kv8", torch.int8, (n_layers, b, l_p, 2 * d), dev)
    _build.require(kvs, "kvs", torch.float32, (n_layers, b, 2, l_p), dev)
    _build.require(key_mask, "key_mask", torch.float32, (b, l_p), dev)
    buf = buffers if buffers is not None else step_buffers(n_layers, b, d, m, dev, num_heads)
    for name, t in step_buffers(n_layers, b, d, m, "meta", num_heads).items():
        _build.require(buf[name], name, t.dtype, t.shape, dev)
    scratch = [buf[n] for n in ("qkv", "pre", "h", "opart", "apart", "arrive")]
    with torch.cuda.device(dev):
        for b0, rows in row_groups(b):
            # a group's pointers at its first row; the [L, B, ...] arrays
            # keep the whole batch's layer stride (the kernel's BS)
            ptrs = _build.pointers(
                x_t[b0:], *(stacks[n] for n in STACK_NAMES), kv8[:, b0], kvs[:, b0],
                key_mask[b0:], buf["y"][b0:], buf["row8"][:, b0], buf["rowsc"][:, b0], *scratch)
            err = _build.lib().vt_fused_decode_step(
                ptrs, n_layers, rows, b, l_p, d, m, num_heads, int(step),
                int(write_offset), float(eps), _build.stream_of(x_t),
            )
            _build.check(err, "fused_decode_step")
            _build.LAUNCHES["fused_decode_step"] += 1
    return buf["y"], buf["row8"], buf["rowsc"]


def fused_epilogue_plain(y, cls_w, cls_b, ptr_w, ptr_b, ptr_keys, ocr_mask,
                         ans_tbl, ocr_tbl, emb_rows, step: int, n_fixed: int,
                         qk_scale: float, dec_len: int):
    """The body of pallas_decode_step._fused_epilogue_kernel in torch.

    y [B, 1, D]; cls_w [Vp, D] (rows >= n_fixed zero) and cls_b [Vp] f32
    (pad entries -1e30); ptr_w [QK, D], ptr_b [QK]; ptr_keys [B, N, QK];
    ocr_mask [B, N] (the raw 0/1 mask, ADDED to the copy scores); ans_tbl
    [Vp, D] (pad rows zero); ocr_tbl [B, N, D]; emb_rows [2*dec_len, D]
    f32 with row 2*t + type.  Returns (scores [B, 1, Vp + N] f32, tok
    [B, 1, 1] int32 in padded space, next embedding [B, 1, D] in y's
    dtype).  The emb row is rounded to bf16 before the add, as the Pallas
    kernel's one-hot bf16 gather does."""
    y32 = y[:, 0].float()
    fixed = torch.matmul(y32, cls_w.float().t()) + cls_b.float()
    q = torch.matmul(y32, ptr_w.float().t()) + ptr_b.float()
    dyn = torch.einsum("bk,bnk->bn", q, ptr_keys.float()) * qk_scale + ocr_mask.float()
    scores = torch.cat([fixed, dyn], dim=-1)
    idx = scores.argmax(dim=-1)  # the first maximum, as jnp.argmax
    v_p, n = cls_w.shape[0], ocr_tbl.shape[1]
    is_ocr = idx >= v_p
    rows = torch.arange(y.shape[0], device=y.device)
    from_ocr = ocr_tbl[rows, (idx - v_p).clamp(0, n - 1)].float()
    from_ans = ans_tbl[idx.clamp(max=v_p - 1)].float()
    raw = torch.where(is_ocr[:, None], from_ocr, from_ans)
    t_next = min(int(step) + 1, dec_len - 1)
    emb = emb_rows[2 * t_next + is_ocr.long()].to(torch.bfloat16).float()
    nxt = (raw + emb).to(y.dtype)
    return scores[:, None, :], idx.to(torch.int32)[:, None, None], nxt[:, None, :]


def epilogue_buffers(b: int, qk: int, device) -> dict:
    """The scratch of one fused_epilogue launch at batch ``b``, which the
    launches of its groups (row_groups) share; allocate once per decode and
    pass to every step.  ``q`` holds the pointer query, each entry (launch
    tag << 32) | float32 bits, ``part_v`` / ``part_i`` each block's (max,
    index) per batch row, and ``sync`` the blocks' ticket and the last
    launch's tag; q and sync are zero here, and every launch leaves the
    ticket zero."""
    dev = torch.device(device)
    g = min(b, GROUP_ROWS)
    return {
        "q": torch.zeros((g, qk), dtype=torch.int64, device=dev),
        "part_v": torch.empty((g, EPILOGUE_MAX_GRID), dtype=torch.float32, device=dev),
        "part_i": torch.empty((g, EPILOGUE_MAX_GRID), dtype=torch.int32, device=dev),
        "sync": torch.zeros((2,), dtype=torch.int32, device=dev),
    }


def epilogue_block_of(item: int, grid: int) -> int:
    """The block of a grid of ``grid`` blocks whose warp scores work item
    ``item`` of csrc/fused_epilogue.cu: the items are the q rows, then the
    classifier rows, then the key rows; item i goes to warp i mod W of the
    grid's W = EPILOGUE_WARPS * grid warps, numbered block-minor (warp w is
    warp w // grid of block w mod grid)."""
    return item % (EPILOGUE_WARPS * grid) % grid


def epilogue_grid(b: int, d: int, qk: int) -> int:
    """The blocks of one fused_epilogue launch of ``b`` rows (at most
    GROUP_ROWS: a group) on the current CUDA device."""
    grid = ctypes.c_int(0)
    _build.check(_build.lib().vt_fused_epilogue_grid(b, d, qk, ctypes.byref(grid)),
                 "fused_epilogue_grid")
    return grid.value


def fused_epilogue(y, cls_w, cls_b, ptr_w, ptr_b, ptr_keys, ocr_mask, ans_tbl,
                   ocr_tbl, emb_rows, step: int, n_fixed: int, qk_scale: float,
                   dec_len: int, buffers: dict | None = None):
    """Decode-step epilogue, one launch a group of rows (row_groups); the
    arguments and returns of fused_epilogue_plain.  ``buffers``
    (epilogue_buffers) holds the launches' scratch; without it each call
    allocates its own."""
    if not y.is_cuda:
        return fused_epilogue_plain(y, cls_w, cls_b, ptr_w, ptr_b, ptr_keys,
                                    ocr_mask, ans_tbl, ocr_tbl, emb_rows, step,
                                    n_fixed, qk_scale, dec_len)
    b, _, d = y.shape
    v_p = cls_w.shape[0]
    n, qk = ptr_keys.shape[1], ptr_keys.shape[2]
    s2 = emb_rows.shape[0]
    if d % 128 or qk % 128 or s2 < 2 * dec_len:
        raise NotImplementedError(
            f"fused_epilogue kernel: hidden and pointer widths multiples of 128 (ROADMAP "
            f"queue 2 item 2); got batch {b}, hidden {d}, pointer {qk}"
        )
    dev = y.device
    f32, bf = torch.float32, torch.bfloat16
    for t, name, dt, shape in (
        (y, "y", bf, (b, 1, d)), (cls_w, "cls_w", f32, (v_p, d)),
        (cls_b, "cls_b", f32, (v_p,)), (ptr_w, "ptr_w", f32, (qk, d)),
        (ptr_b, "ptr_b", f32, (qk,)), (ptr_keys, "ptr_keys", f32, (b, n, qk)),
        (ocr_mask, "ocr_mask", f32, (b, n)), (ans_tbl, "ans_tbl", bf, (v_p, d)),
        (ocr_tbl, "ocr_tbl", bf, (b, n, d)), (emb_rows, "emb_rows", f32, (s2, d)),
    ):
        _build.require(t, name, dt, shape, dev)
    scores = torch.empty((b, 1, v_p + n), dtype=f32, device=dev)
    tok = torch.empty((b, 1, 1), dtype=torch.int32, device=dev)
    nxt = torch.empty((b, 1, d), dtype=bf, device=dev)
    if buffers is None:
        buf = epilogue_buffers(b, qk, dev)
    else:
        buf = buffers
        for name, t in epilogue_buffers(b, qk, "meta").items():
            _build.require(buf[name], name, t.dtype, t.shape, dev)
    scratch = [buf[n] for n in ("q", "part_v", "part_i", "sync")]
    with torch.cuda.device(dev):
        for b0, rows in row_groups(b):
            # a group's batch-major tensors at its first row; the launches
            # share the scratch (each its own q tag, the ticket zero between)
            ptrs = _build.pointers(y[b0:], cls_w, cls_b, ptr_w, ptr_b, ptr_keys[b0:],
                                   ocr_mask[b0:], ans_tbl, ocr_tbl[b0:], emb_rows, scores[b0:],
                                   tok[b0:], nxt[b0:], *scratch)
            err = _build.lib().vt_fused_epilogue(
                ptrs, rows, d, v_p, n, qk, s2, int(step), int(dec_len),
                float(qk_scale), _build.stream_of(y),
            )
            _build.check(err, "fused_epilogue")
            _build.LAUNCHES["fused_epilogue"] += 1
    return scores, tok, nxt
