"""Fused post-attention block (eval), plain and tanh-residual forms: the
kernel wrappers and their plain PyTorch versions.

Counterpart of vitxtgqa_tpu/ops/pallas_ffn.py:fused_block and
fused_block_tanh.  The CUDA kernels are csrc/fused_block.cu.  Weights are
in nn.Linear layout ([out, in]); biases and LayerNorm parameters are taken
in float32 as the Pallas wrapper takes them.
"""

from __future__ import annotations

import torch

from vitxtgqa_tpu_torch.ops import _build

LANE = 128
MIN_ROWS = 2048  # the JAX gate (pallas_ffn.ffn_kernel_ok)


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
    dt = x_q.dtype
    mm = lambda a, w: torch.matmul(a.to(dt).float(), w.to(dt).float().t())
    x = _ln(x_q.float() + (mm(ctx, wo) + bo.float()), s1.float(), g1.float(), eps)
    h = gelu_erf(mm(x, w1) + b1.float()).to(dt)
    out = _ln(x + (mm(h, w2) + b2.float()), s2.float(), g2.float(), eps)
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


def _launch(name, res, x_q, ctx, wo, bo, s1, g1, w1, b1, w2, b2, s2, g2, eps):
    d = x_q.shape[-1]
    m = w1.shape[0]
    if d != 768 or m % LANE:
        raise NotImplementedError(
            f"{name} kernel: hidden 768 and a lane-aligned FFN width only, "
            f"got d={d}, m={m}"
        )
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
