"""Transformer FFN gelu(x W1^T + b1) W2^T + b2 (eval): the kernel wrapper,
its plain PyTorch version and its autograd rule.

Counterpart of vitxtgqa_tpu/ops/pallas_ffn.py:fused_ffn, ffn_reference and
ffn_kernel_ok.  The CUDA kernel is csrc/fused_ffn.cu (two wgmma GEMMs,
``launch_plan``).  Weights are in nn.Linear layout (w1 [M, D], w2 [D2,
M]), as ops/fused_block.py takes them; the biases are taken in float32 as
the Pallas wrapper takes them.

On the card the kernel takes the gelu of the f32 pre-activation and rounds
it to bf16 (pallas_ffn._ffn_kernel); the plain version rounds the
pre-activation to x's dtype before the gelu (ffn_reference), so the two
differ at the bf16 level there and agree in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vitxtgqa_tpu_torch.ops import _build
from vitxtgqa_tpu_torch.ops import gemm_sm90 as G

LANE = 128
MIN_ROWS = 2048  # the JAX gate (pallas_ffn.ffn_kernel_ok)


def ffn_kernel_ok(d: int, m: int, rows: int) -> bool:
    """Shapes that route to the fused FFN: lane-aligned widths and enough
    rows (pallas_ffn.ffn_kernel_ok)."""
    return d % LANE == 0 and m % LANE == 0 and rows >= MIN_ROWS


def fused_ffn_plain(x, w1, b1, w2, b2):
    """pallas_ffn.ffn_reference: gelu (exact erf) of (x W1^T + b1) rounded
    to x's dtype, then (h W2^T + b2) in x's dtype."""
    dt = x.dtype
    h = F.gelu((torch.matmul(x, w1.to(dt).t()) + b1).to(dt))
    return (torch.matmul(h, w2.to(dt).t()) + b2).to(dt)


def check_widths(d: int, m: int, d2: int) -> None:
    """Raise unless the kernel takes these widths: lane-aligned (the
    narrow GEMM tile's 128 columns; d a multiple of the 64-deep K step)."""
    if d % LANE or m % LANE or d2 % LANE:
        raise NotImplementedError(
            f"fused_ffn kernel: lane-aligned widths only (multiples of {LANE}), got d={d}, "
            f"m={m}, d2={d2}")


def launch_plan(rows: int, d: int, m: int, d2: int):
    """csrc/fused_ffn.cu's two GEMM launches (ops/gemm_sm90.py): x W1^T
    into h [rows, m], then h W2^T into out [rows, d2]."""
    return G.launch(G.problem(rows, m, d)), G.launch(G.problem(rows, d2, m))


def _launch(x, w1, b1, w2, b2):
    d, m, d2 = x.shape[-1], w1.shape[0], w2.shape[0]
    check_widths(d, m, d2)
    dev = x.device
    x2 = x.reshape(-1, d)
    rows = x2.shape[0]
    _build.require(x2, "x", torch.bfloat16, device=dev)
    _build.require(w1, "w1", torch.bfloat16, (m, d), dev)
    _build.require(w2, "w2", torch.bfloat16, (d2, m), dev)
    b1, b2 = b1.to(torch.float32).contiguous(), b2.to(torch.float32).contiguous()
    _build.require(b1, "b1", torch.float32, (m,), dev)
    _build.require(b2, "b2", torch.float32, (d2,), dev)
    h = torch.empty((rows, m), dtype=torch.bfloat16, device=dev)
    out = torch.empty((rows, d2), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        err = _build.lib().vt_fused_ffn(
            x2.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            h.data_ptr(), out.data_ptr(), rows, d, m, d2, _build.stream_of(x2))
    _build.check(err, "fused_ffn")
    _build.LAUNCHES["fused_ffn"] += 1
    return out.reshape(*x.shape[:-1], d2)


class FusedFFNFn(torch.autograd.Function):
    """The FFN as one autograd node: the kernel forward (the plain version
    on CPU tensors), and a backward that recomputes through
    fused_ffn_plain, as the JAX custom_vjp differentiates ffn_reference
    (pallas_ffn._ffn_bwd): the gradients are the unfused graph's."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        if not x.is_cuda:
            return fused_ffn_plain(x, w1, b1, w2, b2)
        return _launch(x, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            out = fused_ffn_plain(*inputs)
        wanted = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, g))
        return tuple(next(grads) if t.requires_grad else None for t in inputs)


def fused_ffn(x, w1, b1, w2, b2):
    """x [..., D]; w1 [M, D]; b1 [M]; w2 [D2, M]; b2 [D2] -> [..., D2]:
    the kernel on CUDA tensors (bf16, lane-aligned widths; anything else
    raises), fused_ffn_plain on CPU tensors; differentiable (FusedFFNFn)."""
    return FusedFFNFn.apply(x, w1, b1, w2, b2)
