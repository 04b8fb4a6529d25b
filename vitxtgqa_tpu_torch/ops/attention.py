"""Multi-head attention core and its routing to the kernels.

Counterpart of vitxtgqa_tpu/ops/attention.py, with the same shape gates:
full-sequence attention with a MaskSpec goes to the flash kernel at key
length >= 256 (MIN_KV, the JAX _PALLAS_MIN_KV), so the 20-token text BERT
stays on the plain path; a decode step over an int8 cache always goes to
the int8 decode kernel, one over a bf16 cache to the bf16 decode kernel at
key length >= 256; split-head attention (``mha``) with an array bias or
none goes to the bias-tensor kernel at key length >= 256 with more than
one query row and no dropout (the ViT from 256 tokens).  Each kernel wrapper launches its kernel on CUDA
tensors and runs its plain version on CPU tensors; ``plain=True`` takes
the plain version on any device (the oracle mode of ``Options.plain``).

Sequence parallelism (``sp``, an SPGroup; the JAX set_sequence_parallel):
``mha`` sends full-sequence attention with no dropout to
parallel/sequence_parallel.sp_attention before any other gate, and
``mha_merged``, ``mha_merged_quantize`` and ``attention_train`` split the
heads and take it where the JAX gates do.  Decode steps (one query row)
never take it.

Tensor parallelism: the projections a layer passes are its rank's heads
(``num_heads`` of them); ``attention_draw(..., tp=)`` draws their part
of the whole layer's dropout masks.

Training: ``AttentionFn`` is the flash route as one autograd node — the
q/k/v projections, the flash forward (with its in-kernel dropout of the
probabilities) and, in the backward, the flash backward kernel and the
projections' gradients.  The 20-key text BERT stays on the plain path,
with ordinary dropout of the probabilities, a keep mask drawn from a
torch.Generator (``attention_draw``, then ``mha(..., dropout_rate,
keep=)``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from vitxtgqa_tpu_torch.ops import dropout as D
from vitxtgqa_tpu_torch.ops.decode_attention import (
    decode_attention,
    decode_attention_int8,
    decode_attention_int8_plain,
    decode_attention_plain,
)
from vitxtgqa_tpu_torch.ops.flash_attention import (
    flash_attention_merged,
    flash_attention_merged_bwd,
    flash_attention_merged_bwd_plain,
    flash_attention_merged_plain,
    flash_attention_merged_q8,
    flash_attention_merged_q8_plain,
)
from vitxtgqa_tpu_torch.ops.fused_attention import fused_attention, fused_attention_plain
from vitxtgqa_tpu_torch.ops.masks import DecodeStepSpec, MaskSpec

MIN_KV = 256


def quantize_kv(x: torch.Tensor):
    """[B, L, H*D] -> (int8 [B, L, H*D], scales [B, L] f32): symmetric
    per-token quantization.  The amax is taken in the input dtype, the
    divide in f32 — bit for bit the JAX quantize_kv.  Also the W8A8 row and
    weight quantizer (ops/fused_block.quant_rows, quantize_weight)."""
    amax = torch.clamp_min(x.abs().amax(dim=-1).float(), 1e-6)
    # a division by a tensor: on CUDA, PyTorch divides by a Python scalar as
    # a multiplication by its reciprocal, which can round the last bit
    # otherwise (the kernels and JAX divide)
    scale = amax / torch.full_like(amax, 127.0)
    q8 = torch.clamp(torch.round(x.float() / scale[..., None]), -127, 127)
    return q8.to(torch.int8), scale


def dequantize_kv(q8: torch.Tensor, scales: torch.Tensor,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q8.float() * scales[..., None]).to(dtype)


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, L, D] -> [B, H, L, D/H]."""
    b, l, d = x.shape
    return x.reshape(b, l, num_heads, d // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, L, Dh] -> [B, L, H*Dh]."""
    b, h, l, dh = x.shape
    return x.transpose(1, 2).reshape(b, l, h * dh)


def mha_reference(q, k, v, bias=None, dropout_rate: float = 0.0, gen=None, head_shard=None,
                  keep=None):
    """Scaled dot-product attention on [B, H, L, Dh]: f32 scores, the
    probabilities (dropped with flax nn.Dropout semantics when a generator
    is given) rounded to v's dtype, f32 accumulation.  ``head_shard``
    (rank, size): the heads are a tensor-parallel rank's, whose mask is
    their slice of the whole layer's draw.  ``keep``: the probabilities'
    keep mask drawn before (D.draw_keep), in place of a draw from ``gen``."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if bias is not None:
        scores = scores + bias.float()
    probs = torch.softmax(scores, dim=-1)
    if keep is not None:
        probs = D.apply_keep(probs, keep, dropout_rate)
    else:
        shard = None if head_shard is None else (1, *head_shard)
        probs = D.dropout(probs, dropout_rate, gen, shard)
    return torch.matmul(probs.to(v.dtype).float(), v.float()).to(v.dtype)


def fused_attention_ok(bias, len_q: int, len_k: int, dropout_rate: float) -> bool:
    """The JAX gate of the split-head bias-tensor route (attention.py mha):
    an array bias or none, more than one query row, >= MIN_KV keys and no
    dropout."""
    return (not isinstance(bias, MaskSpec) and len_q > 1 and len_k >= MIN_KV
            and dropout_rate == 0.0)


def sp_active(sp, length: int, dropout_rate: float = 0.0) -> bool:
    """The JAX gate of the sequence-parallel route: an ``sp`` group (the
    JAX set_sequence_parallel), no dropout and a sequence that the ranks
    divide."""
    return sp is not None and dropout_rate == 0.0 and length % sp.size == 0


def mha(q, k, v, bias=None, dropout_rate: float = 0.0, gen=None, plain: bool = False, sp=None,
        head_shard=None, keep=None):
    """[B, H, Lq, Dh] attention; ``bias`` is an additive bias array, None,
    or a spec.  Under ``sp`` (an SPGroup) full-sequence attention (Lq ==
    Lk) with no dropout is sequence-parallel (parallel/sequence_parallel.py,
    the flash kernel #10 for a MaskSpec at >= MIN_KV keys).  Otherwise a
    MaskSpec takes the plain path here (full sequences take mha_merged's
    flash route), and an array bias or none takes the bias-tensor kernel
    (#14) where fused_attention_ok holds, or its plain version with
    ``plain`` or on CPU tensors.  ``head_shard``, ``keep``: see
    mha_reference."""
    if isinstance(bias, DecodeStepSpec):
        bias = bias.to_bias()
    if q.shape[2] == k.shape[2] and sp_active(sp, q.shape[2], dropout_rate):
        from vitxtgqa_tpu_torch.parallel.sequence_parallel import sp_attention

        return sp_attention(q, k, v, bias, sp, plain)
    if isinstance(bias, MaskSpec):
        bias = bias.to_bias()
    elif fused_attention_ok(bias, q.shape[2], k.shape[2], dropout_rate):
        return (fused_attention_plain if plain else fused_attention)(q, k, v, bias)
    return mha_reference(q, k, v, bias, dropout_rate, gen, head_shard, keep)


def flash_ok(bias, num_keys: int) -> bool:
    """The JAX gate of the flash route: a MaskSpec and >= MIN_KV keys."""
    return isinstance(bias, MaskSpec) and num_keys >= MIN_KV


def mha_merged(q_raw, k_raw, v_raw, bias, num_heads: int, plain: bool = False, sp=None):
    """Full-sequence attention in merged-head layout; returns [B, L, H*D].
    Under ``sp`` (sp_active) the heads are split and ``mha`` takes the
    sequence-parallel route, as the JAX mha_merged does."""
    if flash_ok(bias, k_raw.shape[1]) and not sp_active(sp, q_raw.shape[1]):
        fn = flash_attention_merged_plain if plain else flash_attention_merged
        return fn(q_raw, k_raw, v_raw, bias.key_mask.float().contiguous(),
                  bias.dec_len, num_heads)
    ctx = mha(split_heads(q_raw, num_heads), split_heads(k_raw, num_heads),
              split_heads(v_raw, num_heads), bias, plain=plain, sp=sp)
    return merge_heads(ctx)


def mha_merged_quantize(q_raw, k_raw, v_raw, bias, num_heads: int, plain: bool = False,
                        sp=None):
    """mha_merged (eval) with this layer's int8 decode cache: (ctx, (k8,
    ks), (v8, vs)).  On the flash route one launch emits both
    (flash_attention_merged_q8); elsewhere, and under ``sp`` (the JAX gate,
    which has no dropout term here), mha_merged and quantize_kv, the same
    bits."""
    if flash_ok(bias, k_raw.shape[1]) and not sp_active(sp, q_raw.shape[1]):
        fn = flash_attention_merged_q8_plain if plain else flash_attention_merged_q8
        return fn(q_raw, k_raw, v_raw, bias.key_mask.float().contiguous(), bias.dec_len,
                  num_heads)
    ctx = mha_merged(q_raw, k_raw, v_raw, bias, num_heads, plain=plain, sp=sp)
    return ctx, quantize_kv(k_raw), quantize_kv(v_raw)


# what AttentionFn keeps for its backward under each remat mode: q/k/v
# (else recomputed from x), and the flash output with its row
# log-sum-exp (else #1's forward is relaunched on the saved seed)
KEEPS_QKV = ("none", "attn_qkv", "dots")
KEEPS_OUT = ("none", "attn", "attn_qkv")


def _projections(xw, wq, bq, wk, bk, wv, bv):
    return tuple(F.linear(xw, w, b).contiguous() for w, b in ((wq, bq), (wk, bk), (wv, bv)))


class AttentionFn(torch.autograd.Function):
    """Training attention on the flash route, from the layer input x:
    q/k/v = x W^T + b, then the flash forward with in-kernel dropout of the
    probabilities (rate, seed), returning the merged context.  The backward
    is the flash backward kernel, then the projections' gradients.
    ``plain`` runs the plain versions on any device.  Under tensor parallelism the weights are
    a rank's heads' (``num_heads`` of them, the first at global head
    ``head_offset``, whose dropout mask the kernels draw), and the input
    gradient is this rank's partial, summed over the model group by the
    caller's copy_to_model.

    What it keeps for the backward under each ``remat`` mode (the JAX
    policies of vitxtgqa_tpu/models/common.py:TransformerEncoder over the
    checkpoint names attn_q / attn_k / attn_v / attn_ctx), beside x, the
    weights, the key mask and the seed, and what the backward recomputes:

    ========  ======================  =================================
    mode      keeps                   the backward recomputes
    ========  ======================  =================================
    none      q, k, v, out, lse       nothing
    attn      out, lse                q, k, v (torch.matmul)
    attn_qkv  q, k, v, out, lse       nothing
    dots      q, k, v                 out, lse: #1's forward relaunched
    full      (x only)                q, k, v, and #1's forward
    ========  ======================  =================================

    Against JAX's saved residuals (jax.ad_checkpoint.print_saved_residuals
    on a training layer, tests/test_torch_remat.py): JAX's "attn" keeps
    attn_ctx beside the layer's input and its backward reruns no attention
    forward (set_remat's docstring); the port keeps the context's row
    log-sum-exp too, the flash backward's one other residual.  "attn_qkv"
    adds q, k, v in both.  Under "dots" JAX keeps every product's output
    (q, k, v and its block's products, the XLA attention's two products
    on the CPU) and nothing elementwise; a flash kernel's residuals (out,
    lse) are no products, so the port relaunches #1's forward for them, as
    JAX's policy would for its Pallas kernel's custom VJP.  "none" is JAX's
    remat off.  "full" is TransformerLayer's: the whole layer one
    recompute region (torch.utils.checkpoint; JAX keeps the arguments
    alone), inside which this function runs as "none"; the row is what
    the region amounts to.  The block's modes are
    ops/block_train.RECOMPUTES."""

    @staticmethod
    def forward(fctx, x, wq, bq, wk, bk, wv, bv, key_mask, dec_len, num_heads, rate, seed,
                remat, plain, head_offset=0):
        xw = x.to(wq.dtype)
        q, k, v = _projections(xw, wq, bq, wk, bk, wv, bv)
        fwd = flash_attention_merged_plain if plain else flash_attention_merged
        out, lse = fwd(q, k, v, key_mask, dec_len, num_heads, rate, seed, return_lse=True,
                       head_offset=head_offset)
        fctx.cfg = (dec_len, num_heads, rate, plain, x.dtype, head_offset)
        qkv = (q, k, v) if remat in KEEPS_QKV else (None, None, None)
        res = (out, lse) if remat in KEEPS_OUT else (None, None)
        fctx.save_for_backward(xw, wq, bq, wk, bk, wv, bv, key_mask, seed, *qkv, *res)
        return out

    @staticmethod
    def backward(fctx, g):
        dec_len, num_heads, rate, plain, x_dtype, head_offset = fctx.cfg
        xw, wq, bq, wk, bk, wv, bv, key_mask, seed, q, k, v, out, lse = fctx.saved_tensors
        if q is None:
            q, k, v = _projections(xw, wq, bq, wk, bk, wv, bv)
        if out is None:
            fwd = flash_attention_merged_plain if plain else flash_attention_merged
            out, lse = fwd(q, k, v, key_mask, dec_len, num_heads, rate, seed, return_lse=True,
                           head_offset=head_offset)
        bwd = flash_attention_merged_bwd_plain if plain else flash_attention_merged_bwd
        dq, dk, dv = bwd(q, k, v, key_mask, out, lse, g.to(out.dtype).contiguous(), dec_len,
                         num_heads, rate, seed, head_offset)
        x2 = xw.reshape(-1, xw.shape[-1])
        grads, dx = [], None
        for dy, w in ((dq, wq), (dk, wk), (dv, wv)):
            dy2 = dy.reshape(-1, dy.shape[-1])
            part = torch.matmul(dy2, w)
            dx = part if dx is None else dx + part
            grads += [torch.matmul(dy2.t(), x2), dy2.sum(0).to(w.dtype)]
        return (dx.reshape(xw.shape).to(x_dtype), *grads) + (None,) * 8


def attention_draw(x, bias, num_heads: int, rate: float, gen, sp=None, tp=None):
    """The dropout draw of attention_train on input x ([B, L, D]) from
    ``gen``: the flash route's seed, or the plain route's keep mask of the
    probabilities ([B, H, L, L]; under ``tp`` the rank's heads' slice of
    the whole layer's draw); None at rate 0, without a generator, or on
    the sequence-parallel route (no dropout)."""
    if gen is None or rate <= 0.0 or sp_active(sp, x.shape[1], rate):
        return None
    if flash_ok(bias, x.shape[1]):
        return D.draw_seed(gen, x.device)
    b, l = x.shape[:2]
    shard = None if tp is None else (1, tp.rank, tp.size)
    return D.draw_keep((b, num_heads, l, l), rate, gen, x.device, shard)


def attention_train(x, layer_q, layer_k, layer_v, bias, num_heads: int, rate: float, draw,
                    remat: str, plain: bool, sp=None, tp=None):
    """Training self-attention of one layer from its input x ([B, L, D]);
    returns the merged context [B, L, H*D].  Under ``sp`` at rate 0
    (sp_active) the projections run under autograd and the attention is
    sequence-parallel (SPAttentionFn: the #10 forward and backward on the
    flash route).  Otherwise, on the flash route the whole of it is
    AttentionFn, with one seed for the in-kernel dropout; elsewhere (the
    text BERT's 20 keys) the projections and the plain attention run under
    autograd, the probabilities dropped with a keep mask.  ``draw`` is
    that seed or mask, drawn before by attention_draw (None: no dropout),
    so that a layer that recomputes itself replays its draws.  Under
    tensor parallelism (``tp``, a ModelGroup) the projections are a rank's
    ``num_heads`` heads, the first at global head tp.rank * num_heads: the
    flash kernels' dropout coordinates; the plain route's mask is the
    rank's heads' slice of the whole layer's."""
    proj = lambda lin: split_heads(lin(x), num_heads)
    if sp_active(sp, x.shape[1], rate):
        ctx = mha(proj(layer_q), proj(layer_k), proj(layer_v), bias, plain=plain, sp=sp)
        return merge_heads(ctx)
    if flash_ok(bias, x.shape[1]):
        return AttentionFn.apply(x, layer_q.weight, layer_q.bias, layer_k.weight, layer_k.bias,
                                 layer_v.weight, layer_v.bias,
                                 bias.key_mask.float().contiguous(), bias.dec_len, num_heads,
                                 rate, draw, remat, plain,
                                 tp.rank * num_heads if tp is not None else 0)
    ctx = mha(proj(layer_q), proj(layer_k), proj(layer_v), bias, rate, keep=draw)
    return merge_heads(ctx)


def decode_mha(q_raw, k_raw, v_raw, spec: DecodeStepSpec, num_heads: int,
               plain: bool = False):
    """One cached decode step in merged-head layout; returns [B, 1, H*D].
    An int8 cache arrives as (values, scales) tuples (see quantize_kv)."""
    if isinstance(k_raw, tuple):
        fn = decode_attention_int8_plain if plain else decode_attention_int8
        return fn(q_raw, k_raw[0], k_raw[1], v_raw[0], v_raw[1],
                  spec.key_mask.float().contiguous(), spec.step,
                  spec.write_offset, num_heads)
    if k_raw.shape[1] >= MIN_KV:
        fn = decode_attention_plain if plain else decode_attention
        return fn(q_raw, k_raw, v_raw, spec.key_mask.float().contiguous(),
                  spec.step, spec.write_offset, num_heads)
    ctx = mha(split_heads(q_raw, num_heads), split_heads(k_raw, num_heads),
              split_heads(v_raw, num_heads), spec)
    return merge_heads(ctx)
