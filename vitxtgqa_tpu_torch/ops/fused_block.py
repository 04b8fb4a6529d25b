"""Fused post-attention block (eval), plain, tanh-residual and W8A8 forms:
the kernel wrappers and their plain PyTorch versions.

Counterpart of vitxtgqa_tpu/ops/pallas_ffn.py:fused_block,
fused_block_tanh and fused_block_w8a8.  The CUDA kernels are
csrc/fused_block.cu (three wgmma GEMMs and two LayerNorm row passes,
``launch_plan``) and csrc/fused_block_w8a8.cu (three s8 wgmma GEMMs, three
row passes and the quantization of h, ``w8a8_launch_plan``).  Weights are in
nn.Linear layout ([out, in]); biases and LayerNorm parameters are taken in
float32 as the Pallas wrapper takes them.

W8A8 (the serving mode of Options.w8a8): the three products run int8 x
int8 with per-row activation scales (``quant_rows``) and per-output-channel
weight scales (``quantize_weight``, once per set of weights), x and h kept
in float32 before they are quantized, and the gelu in the Abramowitz-Stegun
form of the Pallas kernel (``gelu_as``).  The plain version sums the int8
products in float64, where every partial sum of at most 127^2 * 3072 terms
is an exact integer, so its int32 accumulators are the TPU kernel's.

Tensor parallelism (``fused_block_tp``, ``fused_block_tanh_tp``): the split
forms on a rank's shards (wo [d, d / model], w1 [m / model, d], b1, w2
[d, m / model]; parallel/tensor_parallel.py), the same five launches with
the model group's all-reduce of an f32 partial after the attention-output
and the FFN-out products (``tp_launch_plan``); the biases of those products
and the residuals are added to the sums in the row passes.  Each is a
generator of its steps (``fused_block_tp_steps``): it yields a partial and
takes the sum, so one rank's run sums over its group and a check runs
every rank's shards in one process (``tensor_parallel.drive``); its plain
twin is the same sequence in PyTorch.
"""

from __future__ import annotations

import torch

from vitxtgqa_tpu_torch.ops import _build
from vitxtgqa_tpu_torch.ops import gemm_sm90 as G
from vitxtgqa_tpu_torch.ops.attention import quantize_kv
from vitxtgqa_tpu_torch.parallel import tensor_parallel as TP

LANE = 128
MIN_ROWS = 2048  # the JAX gate (pallas_ffn.ffn_kernel_ok)
# csrc/row_ops.cuh kMaxRowGroups x 128: the widest row the blocks' LayerNorm
# row passes hold (one instantiation a multiple of 128 up to it)
MAX_HIDDEN = 2048


def kernel_ok(d: int, m: int, rows: int) -> bool:
    """Shapes that route to the fused block: lane-aligned widths and enough
    rows (the gate of pallas_ffn.ffn_kernel_ok)."""
    return d % LANE == 0 and m % LANE == 0 and rows >= MIN_ROWS


def gelu_erf(x: torch.Tensor) -> torch.Tensor:
    return x * 0.5 * (1.0 + torch.erf(x * 0.7071067811865476))


def _ln(x, scale, bias, eps):
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def _block_plain(x_q, ctx, wo, bo, s1, g1, w1, b1, w2, b2, s2, g2, eps, res):
    steps = _block_steps_plain(x_q, ctx, wo, bo, s1, g1, w1, b1, w2, b2, s2, g2, eps, res)
    return TP.drive([steps], TP.shard_sum)[0]


def _block_steps_plain(x_q, ctx, wo, bo, s1, g1, w1, b1, w2, b2, s2, g2, eps, res):
    """The block's plain version as steps: it yields the f32 products of
    the attention output and of the FFN out (a rank's partials under
    tensor parallelism) and takes their sums."""
    dt = x_q.dtype
    mm = lambda a, w: torch.matmul(a.to(dt).float(), w.to(dt).float().t())
    x = _ln(x_q.float() + ((yield mm(ctx, wo)) + bo.float()), s1.float(), g1.float(), eps)
    h = gelu_erf(mm(x, w1) + b1.float()).to(dt)
    out = _ln(x + ((yield mm(h, w2)) + b2.float()), s2.float(), g2.float(), eps)
    if res is None:
        return out.to(dt)
    return (res.float() + torch.tanh(out.to(dt).float())).to(dt)


def fused_block_plain(x_q, ctx, wo, bo, s1, g1, w1, b1, w2, b2, s2, g2,
                      eps: float = 1e-12):
    """LN2(x + gelu(x W1^T + b1) W2^T + b2), x = LN1(x_q + ctx Wo^T + bo):
    f32 LayerNorms and accumulation, matmul inputs in x_q's dtype."""
    return _block_plain(x_q, ctx, wo, bo, s1, g1, w1, b1, w2, b2, s2, g2, eps, None)


def fused_block_tanh_plain(res, x_q, ctx, wo, bo, s1, g1, w1, b1, w2, b2, s2,
                           g2, eps: float = 1e-12):
    """res + tanh(block), with the block output rounded to x_q's dtype
    before the tanh (as the model's unfused path does)."""
    return _block_plain(x_q, ctx, wo, bo, s1, g1, w1, b1, w2, b2, s2, g2, eps, res)


def check_hidden(name: str, d: int) -> None:
    """Raise unless the blocks' LayerNorm row passes take hidden width d: a
    multiple of 128 up to MAX_HIDDEN (beyond it, ROADMAP queue 2 item 2)."""
    if d <= 0 or d % LANE or d > MAX_HIDDEN:
        raise NotImplementedError(
            f"{name} kernel: a hidden width that is a multiple of {LANE} up to {MAX_HIDDEN} "
            f"(ROADMAP queue 2 item 2), got d={d}")


def check_widths(name: str, d: int, m: int) -> None:
    """Raise unless csrc/fused_block.cu (and csrc/fused_block_w8a8.cu) take
    these widths: what JAX's gate ffn_kernel_ok routes to its kernel, a
    lane-aligned hidden width (the LayerNorm row passes, up to MAX_HIDDEN)
    and a lane-aligned FFN width (the narrow GEMM tile's 128 columns)."""
    check_hidden(name, d)
    if m <= 0 or m % LANE:
        raise NotImplementedError(
            f"{name} kernel: a lane-aligned FFN width, got d={d}, m={m}")


def tp_launch_plan(rows: int, d: int, dl: int, ml: int):
    """The split form's three GEMM launches on a rank's shares (dl of the
    attention width, ml of the FFN): ctx_l Wo_l^T and h_l W2_l^T into f32
    [rows, d] partials, xb W1_l^T into h_l [rows, ml]; its two row passes
    take every row."""
    return (G.launch(G.problem(rows, d, dl)), G.launch(G.problem(rows, ml, d)),
            G.launch(G.problem(rows, d, ml)))


def launch_plan(rows: int, d: int, m: int):
    """csrc/fused_block.cu's three GEMM launches (ops/gemm_sm90.py): ctx
    Wo^T and h W2^T into the f32 [rows, d] pre-norm rows, xb W1^T into h
    [rows, m]; its two LayerNorm row passes take every row, a warp a
    row."""
    return (G.launch(G.problem(rows, d, d)), G.launch(G.problem(rows, m, d)),
            G.launch(G.problem(rows, d, m)))


def w8a8_launch_plan(rows: int, d: int, m: int):
    """csrc/fused_block_w8a8.cu's three GEMM launches on the body's s8 form
    (ops/gemm_sm90.py: 128-column tiles, K steps of 128 int8): c8 Wo8^T into
    the f32 [rows, d] pre-norm rows, x8 W18^T into h [rows, m] (f32, and its
    row amax), h8 W28^T into the pre-norm rows; its three row passes and
    the quantization of h take every row."""
    ln = lambda n, k: G.launch_s8(G.problem(rows, n, k))
    return (ln(d, d), ln(m, d), ln(d, m))


def _launch(name, res, x_q, ctx, wo, bo, s1, g1, w1, b1, w2, b2, s2, g2, eps):
    d = x_q.shape[-1]
    m = w1.shape[0]
    check_widths(name, d, m)
    dev = x_q.device
    x2 = x_q.reshape(-1, d)
    c2 = ctx.reshape(-1, d)
    rows = x2.shape[0]
    _build.require(x2, "x_q", torch.bfloat16, device=dev)
    _build.require(c2, "ctx", torch.bfloat16, (rows, d), dev)
    r2 = None
    if res is not None:
        r2 = res.reshape(-1, d)
        _build.require(r2, "res", torch.bfloat16, (rows, d), dev)
    _build.require(wo, "wo", torch.bfloat16, (d, d), dev)
    _build.require(w1, "w1", torch.bfloat16, (m, d), dev)
    _build.require(w2, "w2", torch.bfloat16, (d, m), dev)
    vec = [v.to(torch.float32).contiguous() for v in (bo, s1, g1, b1, b2, s2, g2)]
    for v, n in zip(vec, (d, d, d, m, d, d, d)):
        _build.require(v, "bias/LayerNorm vector", torch.float32, (n,), dev)
    bo, s1, g1, b1, b2, s2, g2 = vec
    x32 = torch.empty((rows, d), dtype=torch.float32, device=dev)
    xb = torch.empty((rows, d), dtype=torch.bfloat16, device=dev)
    h = torch.empty((rows, m), dtype=torch.bfloat16, device=dev)
    out = torch.empty((rows, d), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        err = _build.lib().vt_fused_block(
            x2.data_ptr(), c2.data_ptr(), wo.data_ptr(), bo.data_ptr(),
            s1.data_ptr(), g1.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), s2.data_ptr(), g2.data_ptr(),
            None if r2 is None else r2.data_ptr(), x32.data_ptr(),
            xb.data_ptr(), h.data_ptr(), out.data_ptr(), rows, d, m,
            float(eps), _build.stream_of(x2),
        )
    _build.check(err, name)
    _build.LAUNCHES[name] += 1
    return out.reshape(x_q.shape)


def fused_block(x_q, ctx, wo, bo, s1, g1, w1, b1, w2, b2, s2, g2,
                eps: float = 1e-12):
    """x_q/ctx [..., D] (pre-attention input and attention context)."""
    if not x_q.is_cuda:
        return fused_block_plain(x_q, ctx, wo, bo, s1, g1, w1, b1, w2, b2, s2, g2, eps)
    return _launch("fused_block", None, x_q, ctx, wo, bo, s1, g1, w1, b1, w2,
                   b2, s2, g2, eps)


def fused_block_tanh(res, x_q, ctx, wo, bo, s1, g1, w1, b1, w2, b2, s2, g2,
                     eps: float = 1e-12):
    """fused_block with the ``res + tanh(out)`` epilogue (T2S QTV joint
    residual)."""
    if not x_q.is_cuda:
        return fused_block_tanh_plain(res, x_q, ctx, wo, bo, s1, g1, w1, b1,
                                      w2, b2, s2, g2, eps)
    return _launch("fused_block_tanh", res, x_q, ctx, wo, bo, s1, g1, w1, b1,
                   w2, b2, s2, g2, eps)


# ---------------------------------------------------------------------------
# the split forms (tensor parallelism)
# ---------------------------------------------------------------------------


def check_tp_widths(name: str, d: int, dl: int, ml: int) -> None:
    """Raise unless the split form's launches take a rank's shares: a
    hidden width the row passes take (check_hidden) and shares of the
    attention and FFN widths that are multiples of the thin GEMM tile's 64
    columns (a share of 192, model 4 of 768, takes thin tiles)."""
    check_hidden(name, d)
    if dl <= 0 or dl % G.THIN_N or ml <= 0 or ml % G.THIN_N:
        raise NotImplementedError(
            f"{name} kernel: a rank's attention and FFN shares multiples of {G.THIN_N} only, "
            f"got d={d}, dl={dl}, ml={ml}")


def gemm_f32(a, w):
    """a w^T (f32 [M, N]) of a [M, K] and w [N, K] bf16 on the card: the
    split forms' row-parallel products (csrc/fused_block.cu vt_gemm_f32)."""
    (m, k), n = a.shape, w.shape[0]
    _build.require(a, "a", torch.bfloat16, (m, k), a.device)
    _build.require(w, "w", torch.bfloat16, (n, k), a.device)
    c = torch.empty((m, n), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        err = _build.lib().vt_gemm_f32(a.data_ptr(), k, w.data_ptr(), k, c.data_ptr(), m, n, k,
                                       _build.stream_of(a))
    _build.check(err, "gemm_f32")
    return c


def _block_steps_kernel(name, res, x_q, ctx, wo, bo, s1, g1, w1, b1, w2, b2, s2, g2, eps):
    d, dl, ml = x_q.shape[-1], wo.shape[1], w1.shape[0]
    check_tp_widths(name, d, dl, ml)
    dev = x_q.device
    x2, c2 = x_q.reshape(-1, d), ctx.reshape(-1, dl)
    rows = x2.shape[0]
    _build.require(x2, "x_q", torch.bfloat16, (rows, d), dev)
    _build.require(c2, "ctx", torch.bfloat16, (rows, dl), dev)
    _build.require(wo, "wo", torch.bfloat16, (d, dl), dev)
    _build.require(w1, "w1", torch.bfloat16, (ml, d), dev)
    _build.require(w2, "w2", torch.bfloat16, (d, ml), dev)
    r2 = None
    if res is not None:
        r2 = res.reshape(-1, d)
        _build.require(r2, "res", torch.bfloat16, (rows, d), dev)
    vec = [v.to(torch.float32).contiguous() for v in (bo, s1, g1, b1, b2, s2, g2)]
    for v, n in zip(vec, (d, d, d, ml, d, d, d)):
        _build.require(v, "bias/LayerNorm vector", torch.float32, (n,), dev)
    bo, s1, g1, b1, b2, s2, g2 = vec
    lib, st = _build.lib(), _build.stream_of(x2)
    total = yield gemm_f32(c2, wo)
    x32 = torch.empty((rows, d), dtype=torch.float32, device=dev)
    xb = torch.empty((rows, d), dtype=torch.bfloat16, device=dev)
    h = torch.empty((rows, ml), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        _build.check(lib.vt_fused_block_tp_ln1(total.data_ptr(), bo.data_ptr(), x2.data_ptr(),
                                               s1.data_ptr(), g1.data_ptr(), x32.data_ptr(),
                                               xb.data_ptr(), rows, d, float(eps), st), name)
        _build.check(lib.vt_fused_block_tp_ffn_in(xb.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                                                  h.data_ptr(), rows, d, ml, st), name)
    total = yield gemm_f32(h, w2)
    out = torch.empty((rows, d), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        _build.check(lib.vt_fused_block_tp_ln2(x32.data_ptr(), total.data_ptr(), b2.data_ptr(),
                                               s2.data_ptr(), g2.data_ptr(),
                                               None if r2 is None else r2.data_ptr(),
                                               out.data_ptr(), rows, d, float(eps), st), name)
    _build.LAUNCHES[name] += 1
    return out.reshape(x_q.shape)


def fused_block_tp_steps(x_q, ctx, wo, bo, s1, g1, w1, b1, w2, b2, s2, g2, eps: float = 1e-12,
                         res=None, plain: bool = False):
    """One rank's split form of fused_block (or, with ``res``,
    fused_block_tanh) on its shards (ctx [..., dl], wo [d, dl], w1 [ml, d],
    b1 [ml], w2 [d, ml]) as a generator of its steps: it yields the f32
    [rows, d] partials of the attention-output and FFN-out products and
    takes their sums over the model group (tensor_parallel.drive), then
    returns the block's output.  The kernels on a CUDA tensor, the plain
    twin (the same sequence in PyTorch) on a CPU one or with ``plain``."""
    if plain or not x_q.is_cuda:
        return _block_steps_plain(x_q, ctx, wo, bo, s1, g1, w1, b1, w2, b2, s2, g2, eps, res)
    name = "fused_block_tp" if res is None else "fused_block_tanh_tp"
    return _block_steps_kernel(name, res, x_q, ctx, wo, bo, s1, g1, w1, b1, w2, b2, s2, g2, eps)


def fused_block_tp(x_q, ctx, wo, bo, s1, g1, w1, b1, w2, b2, s2, g2, eps: float = 1e-12,
                   tp=None, plain: bool = False):
    """The split form of fused_block on this rank's shards, its partials
    summed over ``tp`` (a ModelGroup; None: no sum, the unsplit block)."""
    return TP.run_split(fused_block_tp_steps(x_q, ctx, wo, bo, s1, g1, w1, b1, w2, b2, s2, g2,
                                             eps, plain=plain), tp)


def fused_block_tanh_tp(res, x_q, ctx, wo, bo, s1, g1, w1, b1, w2, b2, s2, g2,
                        eps: float = 1e-12, tp=None, plain: bool = False):
    """fused_block_tp with the ``res + tanh(out)`` epilogue."""
    return TP.run_split(fused_block_tp_steps(x_q, ctx, wo, bo, s1, g1, w1, b1, w2, b2, s2, g2,
                                             eps, res=res, plain=plain), tp)


# ---------------------------------------------------------------------------
# W8A8
# ---------------------------------------------------------------------------


def erf_as(x: torch.Tensor) -> torch.Tensor:
    """Abramowitz-Stegun 7.1.26 erf (pallas_ffn._erf; max abs err 1.5e-7)."""
    a = x.abs()
    t = 1.0 / (1.0 + 0.3275911 * a)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (1.421413741
                + t * (-1.453152027 + t * 1.061405429))))
    return torch.sign(x) * (1.0 - poly * torch.exp(-a * a))


def gelu_as(x: torch.Tensor) -> torch.Tensor:
    return x * 0.5 * (1.0 + erf_as(x * 0.7071067811865476))


def quant_rows(x: torch.Tensor):
    """[R, D] -> (int8 [R, D], f32 scales [R, 1]): symmetric per row, the
    amax taken in x's dtype (pallas_ffn._quant_rows)."""
    q, scale = quantize_kv(x)
    return q, scale[..., None]


def quantize_weight(w: torch.Tensor):
    """nn.Linear weight [out, in] -> (int8 [out, in], f32 per-output-channel
    scales [out]) — pallas_ffn.quantize_weight, whose [in, out] kernel
    reduces over its axis 0: the rows of the [out, in] weight."""
    return quantize_kv(w.float())


def quantize_block_weights(wo, w1, w2):
    """(wo8, wos, w18, w1s, w28, w2s): the block's three weights quantized
    per output channel."""
    return (*quantize_weight(wo), *quantize_weight(w1), *quantize_weight(w2))


def _dot_w8a8(x, w8, w_scale):
    """pallas_ffn._dot_w8a8: quantize x per row, the int8 product (exact,
    in float64), then f32(acc) * x_scale * w_scale."""
    xq, xs = quant_rows(x)
    acc = torch.matmul(xq.double(), w8.double().t())
    return acc.float() * xs * w_scale.float()


def s8_products_plain(a8, b8):
    """f32(a8 b8^T) of int8 [M, K] and [N, K]: the exact integer sums (in
    float64), rounded once to f32 as the kernel stages them."""
    return torch.matmul(a8.double(), b8.double().t()).float()


def s8_products(a8, b8):
    """The s8 form of csrc/gemm_sm90.cuh's wgmma body alone, f32(a8 b8^T):
    the check of the W8A8 block's products against exact integer sums (N
    and K multiples of 128).  No model path calls it."""
    if not a8.is_cuda:
        return s8_products_plain(a8, b8)
    (m, k), n = a8.shape, b8.shape[0]
    if n % LANE or k % G.S8_K_STEP:
        raise NotImplementedError(f"s8_products: N and K multiples of 128, got {n}, {k}")
    _build.require(a8, "a8", torch.int8, device=a8.device)
    _build.require(b8, "b8", torch.int8, (n, k), a8.device)
    c = torch.empty((m, n), dtype=torch.float32, device=a8.device)
    with torch.cuda.device(a8.device):
        err = _build.lib().vt_gemm_s8(a8.data_ptr(), b8.data_ptr(), c.data_ptr(), m, n, k,
                                      _build.stream_of(a8))
    _build.check(err, "s8_products")
    return c


def fused_block_w8a8_plain(x_q, ctx, wo8, wos, bo, s1, g1, w18, w1s, b1, w28,
                           w2s, b2, s2, g2, eps: float = 1e-12):
    """pallas_ffn.block_w8a8_reference on quantized weights
    (quantize_block_weights): x = LN1(x_q + dot(ctx, Wo) + bo) and h =
    gelu_as(dot(x, W1) + b1) in f32, out = LN2(x + dot(h, W2) + b2) in
    x_q's dtype, each dot quantizing its left operand per row."""
    shape, d = x_q.shape, x_q.shape[-1]
    f = lambda t: t.float()
    c2 = ctx.reshape(-1, d).to(x_q.dtype)
    attn = _dot_w8a8(c2, wo8, wos) + f(bo)
    x = _ln(x_q.reshape(-1, d).float() + attn, f(s1), f(g1), eps)
    h = gelu_as(_dot_w8a8(x, w18, w1s) + f(b1))
    y = _dot_w8a8(h, w28, w2s) + f(b2)
    return _ln(x + y, f(s2), f(g2), eps).to(x_q.dtype).reshape(shape)


def h_quant_from_x8(x8, xs, w18, w1s, b1):
    """The twin's h and its per-row quantization from a given quantization
    of x (x8 int8 [R, D], xs f32 [R]): (h8 int8 [R, M], hs f32 [R]), as
    fused_block_w8a8_plain forms them (its second _dot_w8a8, then
    quant_rows); the check of a kernel's h8 from the kernel's own x8."""
    acc = torch.matmul(x8.double(), w18.double().t())
    h = gelu_as(acc.float() * xs[:, None] * w1s.float() + b1.float())
    h8, hs = quant_rows(h)
    return h8, hs[:, 0]


def _w8a8_stages_plain(x_q, ctx, wo8, wos, bo, s1, g1, w18, w1s, b1, w28, w2s, b2,
                       s2, g2, eps):
    """fused_block_w8a8_plain's output and its three quantizations
    ((c8, cs), (x8, xs), (h8, hs)), scales [R]."""
    d = x_q.shape[-1]
    f = lambda t: t.float()
    c2 = ctx.reshape(-1, d).to(x_q.dtype)
    c8, cs = quant_rows(c2)
    x = _ln(x_q.reshape(-1, d).float() + (_dot_w8a8(c2, wo8, wos) + f(bo)), f(s1), f(g1), eps)
    x8, xs = quant_rows(x)
    h = gelu_as(_dot_w8a8(x, w18, w1s) + f(b1))
    h8, hs = quant_rows(h)
    y = _dot_w8a8(h, w28, w2s) + f(b2)
    out = _ln(x + y, f(s2), f(g2), eps).to(x_q.dtype).reshape(x_q.shape)
    return out, (c8, cs[:, 0]), (x8, xs[:, 0]), (h8, hs[:, 0])


def fused_block_w8a8(x_q, ctx, wo8, wos, bo, s1, g1, w18, w1s, b1, w28, w2s,
                     b2, s2, g2, eps: float = 1e-12, return_quant: bool = False):
    """The W8A8 block on quantized weights; the arguments and return of
    fused_block_w8a8_plain.  ``return_quant`` also returns the block's three
    per-row quantizations, ((c8, cs), (x8, xs), (h8, hs)) of ctx, x and h
    (int8 [R, width], f32 scales [R]): the kernel's on a CUDA tensor, the
    twin's on a CPU one."""
    if not x_q.is_cuda:
        if return_quant:
            return _w8a8_stages_plain(x_q, ctx, wo8, wos, bo, s1, g1, w18, w1s, b1, w28,
                                      w2s, b2, s2, g2, eps)
        return fused_block_w8a8_plain(x_q, ctx, wo8, wos, bo, s1, g1, w18, w1s,
                                      b1, w28, w2s, b2, s2, g2, eps)
    d, m = x_q.shape[-1], w18.shape[0]
    check_widths("fused_block_w8a8", d, m)
    dev = x_q.device
    x2, c2 = x_q.reshape(-1, d), ctx.reshape(-1, d)
    rows = x2.shape[0]
    _build.require(x2, "x_q", torch.bfloat16, device=dev)
    _build.require(c2, "ctx", torch.bfloat16, (rows, d), dev)
    for t, name, shape in ((wo8, "wo8", (d, d)), (w18, "w18", (m, d)), (w28, "w28", (d, m))):
        _build.require(t, name, torch.int8, shape, dev)
    vecs = [v.to(torch.float32).contiguous() for v in (wos, bo, s1, g1, w1s, b1, w2s, b2, s2, g2)]
    for v, n in zip(vecs, (d, d, d, d, m, m, d, d, d, d)):
        _build.require(v, "scale/bias/LayerNorm vector", torch.float32, (n,), dev)
    wos, bo, s1, g1, w1s, b1, w2s, b2, s2, g2 = vecs
    e = lambda shape, dt: torch.empty(shape, dtype=dt, device=dev)
    c8, cs = e((rows, d), torch.int8), e((rows,), torch.float32)
    x32, x8, xs = e((rows, d), torch.float32), e((rows, d), torch.int8), e((rows,), torch.float32)
    hmax, h32, h8 = e((rows,), torch.float32), e((rows, m), torch.float32), e((rows, m), torch.int8)
    out = e((rows, d), torch.bfloat16)
    ptrs = _build.pointers(x2, c2, wo8, wos, bo, s1, g1, w18, w1s, b1, w28, w2s, b2, s2, g2,
                           c8, cs, x32, x8, xs, hmax, h32, h8, out)
    with torch.cuda.device(dev):
        err = _build.lib().vt_fused_block_w8a8(ptrs, rows, d, m, float(eps),
                                               _build.stream_of(x2))
    _build.check(err, "fused_block_w8a8")
    _build.LAUNCHES["fused_block_w8a8"] += 1
    out = out.reshape(x_q.shape)
    if not return_quant:
        return out
    hs = torch.clamp_min(hmax, 1e-6) / torch.full_like(hmax, 127.0)  # the kernel's scale of h
    return out, (c8, cs), (x8, xs), (h8, hs)
