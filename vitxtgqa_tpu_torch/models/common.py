"""Shared transformer building blocks.

Counterpart of vitxtgqa_tpu/models/common.py.  Parameter names follow the
reference's torch state dict (BERT naming: ``attention.self.query``,
``attention.output.dense``, ``intermediate.dense``, ``output.LayerNorm``,
...), so ``utils/torch_convert.convert_t2s_like`` maps a port state dict
onto the JAX params with no new code.

dtype semantics follow flax: ``Linear`` computes in its parameters' dtype
(the input is cast, as flax Dense casts to its ``dtype``); ``LayerNorm``
normalises in float32 and returns its parameters' dtype.

Training (``train=True`` with a dropout ``gen``erator): a layer on the
flash route runs its attention as ops/attention.AttentionFn and its
post-attention block as ops/block_train.BlockTrainFn (the JAX
``_fused_block_bwd_ok`` path, gated on lane-aligned widths), each on one
dropout seed from ``gen``; the embeddings' and the 20-key text BERT's
attention dropouts draw their masks from ``gen``.  A layer draws its seeds
and masks before it computes, so that every Options.remat mode advances
``gen`` alike; under "full" the layer is one recompute region
(torch.utils.checkpoint) that replays them.  The eval fused block
(``_fused_block_ok``) never runs in training, as in JAX.

Sequence parallelism: every layer passes ``opts.sp`` to the attention
routing (ops/attention.py), which splits the query rows over the ranks
where the JAX gates do; the projections and the post-attention block run
on all rows on every rank.  Pipeline parallelism: a stack for which
``TransformerEncoder.pipelined`` holds runs its layers over the stages of
``opts.pp`` (parallel/pipeline.py), each stage's layers on their own
routes.

Tensor parallelism (``opts.tp``, a ModelGroup; parallel/tensor_parallel.py):
a layer whose heads and FFN width divide by the group holds its rank's
heads (Q/K/V column-parallel, the attention output row-parallel) and FFN
share (FFN-in column-, FFN-out row-parallel); its attention runs on those
heads, and its post-attention block sums the row-parallel products over
the group: the eval block's and the training block's split forms where
their gates hold, else the plain expression with the two all-reduces
between its products.  The attention's input gradient is summed over the
group (copy_to_model).  Beside sp a layer's attention splits its query
rows over the sp group on its own heads; beside pp each stage's layers
hold their shards.  The word embeddings (BertEmbeddings), the
fixed-vocabulary classifier with its answer table (FixedVocabClassifier,
PrevPredEmbeddings) and the OCR pointer (OcrPtrNet) are vocabulary- or
column-parallel where the group divides them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from vitxtgqa_tpu_torch.ops import block_train as BT
from vitxtgqa_tpu_torch.ops import decode_step as DS
from vitxtgqa_tpu_torch.ops import dropout as D
from vitxtgqa_tpu_torch.ops import fused_block as FB
from vitxtgqa_tpu_torch.ops import ptr_scores as PS
from vitxtgqa_tpu_torch.ops.attention import (
    attention_draw,
    attention_train,
    decode_mha,
    dequantize_kv,
    mha_merged,
    mha_merged_quantize,
    quantize_kv,
)
from vitxtgqa_tpu_torch.ops.masks import NEG_INF, DecodeStepSpec
from vitxtgqa_tpu_torch.options import Options
from vitxtgqa_tpu_torch.parallel import tensor_parallel as TP


def cfg_get(node: Any, key: str, default: Any = None) -> Any:
    """Key lookup on a mapping or an attribute container."""
    try:
        return node[key]
    except (KeyError, TypeError, IndexError):
        return getattr(node, key, default)


def derived_weights(owner: nn.Module, name: str, params, build):
    """``build()``, kept on ``owner`` until one of ``params`` is replaced or
    changed in place (``load_state_dict``, an optimizer step, ``.to``): the
    weight layouts the serving decode derives from frozen parameters are
    built once per model, not once per forward.  (Parameters made under
    ``torch.inference_mode`` track no version; their key is their
    identity and pointer.)"""
    key = tuple((id(p), p.data_ptr(), 0 if p.is_inference() else p._version)
                for p in params)
    memo = owner.__dict__.setdefault("_derived_weights", {})
    if name not in memo or memo[name][0] != key:
        with torch.no_grad():
            memo[name] = (key, build())
    return memo[name][1]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    hidden_size: int = 768
    num_hidden_layers: int = 3
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    layer_norm_eps: float = 1e-12
    vocab_size: int = 30522
    max_position_embeddings: int = 512
    type_vocab_size: int = 2

    @classmethod
    def from_config(cls, node: Any) -> "TransformerConfig":
        """Build from a BertConfig-style mapping (partial overrides)."""
        kwargs = {}
        for f in dataclasses.fields(cls):
            val = cfg_get(node, f.name)
            if val is not None:
                kwargs[f.name] = val
        return cls(**kwargs)


class Linear(nn.Linear):
    """nn.Linear that casts its input to the parameters' dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.weight.dtype), self.weight, self.bias)


class LayerNorm(nn.LayerNorm):
    """LayerNorm with float32 statistics, output in the parameters' dtype
    (``float32``: the float32 output before that rounding)."""

    def float32(self, x: torch.Tensor, tp=None) -> torch.Tensor:
        """``tp``: x is a model rank's rows (a vocabulary shard), so the
        scale's and shift's gradients are summed over the group."""
        w, b = self.weight, self.bias
        if tp is not None:
            w, b = TP.copy_to_model(w, tp), TP.copy_to_model(b, tp)
        return F.layer_norm(x.float(), self.normalized_shape, w.float(), b.float(), self.eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.float32(x).to(self.weight.dtype)


class TransformerLayer(nn.Module):
    """One post-LN BERT layer with KV export and cached decode.  Under
    ``opts.tp`` (where the heads and the FFN width divide by it) the layer
    holds its rank's shards: ``heads`` of the heads and 1 / tp.size of the
    FFN."""

    def __init__(self, cfg: TransformerConfig, opts: Options):
        super().__init__()
        self.cfg = cfg
        self.opts = opts
        d, m, eps = cfg.hidden_size, cfg.intermediate_size, cfg.layer_norm_eps
        tp = opts.tp
        self.tp = tp if tp is not None and TP.layer_splits(cfg.num_attention_heads, m,
                                                            tp.size) else None
        n = self.tp.size if self.tp else 1
        self.heads = cfg.num_attention_heads // n
        dl, ml = d // n, m // n
        self.attention = nn.ModuleDict({
            "self": nn.ModuleDict({
                "query": Linear(d, dl), "key": Linear(d, dl), "value": Linear(d, dl),
            }),
            "output": nn.ModuleDict({"dense": Linear(dl, d), "LayerNorm": LayerNorm(d, eps=eps)}),
        })
        self.intermediate = nn.ModuleDict({"dense": Linear(d, ml)})
        self.output = nn.ModuleDict({"dense": Linear(ml, d), "LayerNorm": LayerNorm(d, eps=eps)})
        if self.tp:
            for lin in (self.query, self.key, self.value, self.ffn_in):
                TP.mark(lin.weight, 0)
                TP.mark(lin.bias, 0)
            TP.mark(self.attn_out.weight, 1)
            TP.mark(self.ffn_out.weight, 1)

    # flax-side names of the sublayers
    query = property(lambda self: self.attention["self"]["query"])
    key = property(lambda self: self.attention["self"]["key"])
    value = property(lambda self: self.attention["self"]["value"])
    attn_out = property(lambda self: self.attention["output"]["dense"])
    attn_ln = property(lambda self: self.attention["output"]["LayerNorm"])
    ffn_in = property(lambda self: self.intermediate["dense"])
    ffn_out = property(lambda self: self.output["dense"])
    ffn_ln = property(lambda self: self.output["LayerNorm"])

    def _fused_block_ok(self, x: torch.Tensor) -> bool:
        """The gate of the JAX _fused_block_ok: lane-aligned widths and at
        least 2048 rows (eval only: training takes _finish_train)."""
        return (
            x.shape[-1] == self.cfg.hidden_size
            and FB.kernel_ok(x.shape[-1], self.cfg.intermediate_size,
                             x.numel() // x.shape[-1])
        )

    def _row_parallel(self, lin: Linear, x: torch.Tensor) -> torch.Tensor:
        """A row-parallel product's output in the compute dtype: the f32
        partials summed over the model group, then the bias (once)."""
        part = F.linear(x.to(lin.weight.dtype).float(), lin.weight.float())
        return (TP.reduce_from_model(part, self.tp) + lin.bias.float()).to(lin.weight.dtype)

    def _finish_tp(self, x_q, ctx, tanh_residual_base=None):
        """The eval block under tensor parallelism: the eval block's split
        form (#2 / #3) where the fused gate holds, else the plain
        expression with the two row-parallel sums."""
        if self._fused_block_ok(x_q):
            args = (x_q, ctx, self.attn_out.weight, self.attn_out.bias, self.attn_ln.weight,
                    self.attn_ln.bias, self.ffn_in.weight, self.ffn_in.bias,
                    self.ffn_out.weight, self.ffn_out.bias, self.ffn_ln.weight,
                    self.ffn_ln.bias)
            kw = dict(eps=self.cfg.layer_norm_eps, tp=self.tp, plain=self.opts.plain)
            if tanh_residual_base is not None:
                return FB.fused_block_tanh_tp(tanh_residual_base, *args, **kw)
            return FB.fused_block_tp(*args, **kw)
        x = self.attn_ln(x_q + self._row_parallel(self.attn_out, ctx))
        y = self.ffn_ln(x + self._row_parallel(self.ffn_out, F.gelu(self.ffn_in(x))))
        if tanh_residual_base is not None:
            y = tanh_residual_base + torch.tanh(y)
        return y

    def _finish(self, x_q, ctx, tanh_residual_base=None):
        eps = self.cfg.layer_norm_eps
        if self.tp is not None:
            return self._finish_tp(x_q, ctx, tanh_residual_base)
        if self._fused_block_ok(x_q):
            plain = self.opts.plain
            if self.opts.w8a8:
                # the weights quantized once per set of weights; the tanh
                # residual after the kernel, as JAX adds it (no tanh form)
                wo8, wos, w18, w1s, w28, w2s = derived_weights(
                    self, "w8a8", [self.attn_out.weight, self.ffn_in.weight, self.ffn_out.weight],
                    lambda: FB.quantize_block_weights(self.attn_out.weight, self.ffn_in.weight,
                                                      self.ffn_out.weight))
                fn = FB.fused_block_w8a8_plain if plain else FB.fused_block_w8a8
                y = fn(x_q, ctx, wo8, wos, self.attn_out.bias, self.attn_ln.weight,
                       self.attn_ln.bias, w18, w1s, self.ffn_in.bias, w28, w2s,
                       self.ffn_out.bias, self.ffn_ln.weight, self.ffn_ln.bias, eps=eps)
                return y if tanh_residual_base is None else tanh_residual_base + torch.tanh(y)
            args = (
                x_q, ctx, self.attn_out.weight, self.attn_out.bias,
                self.attn_ln.weight, self.attn_ln.bias, self.ffn_in.weight,
                self.ffn_in.bias, self.ffn_out.weight, self.ffn_out.bias,
                self.ffn_ln.weight, self.ffn_ln.bias,
            )
            if tanh_residual_base is not None:
                fn = FB.fused_block_tanh_plain if plain else FB.fused_block_tanh
                return fn(tanh_residual_base, *args, eps=eps)
            fn = FB.fused_block_plain if plain else FB.fused_block
            return fn(*args, eps=eps)
        x = self.attn_ln(x_q + self.attn_out(ctx))
        y = self.ffn_ln(x + self.ffn_out(F.gelu(self.ffn_in(x))))
        if tanh_residual_base is not None:
            y = tanh_residual_base + torch.tanh(y)
        return y

    def _finish_train(self, x_q, ctx, seed, remat: str, dropout: bool):
        """The training block: BlockTrainFn where the width gate of the JAX
        _fused_block_bwd_ok holds (lane-aligned widths), else the same
        expression in plain autograd on the same seed's masks.  ``seed``:
        its dropout seed, drawn before (None at rate 0)."""
        cfg = self.cfg
        d = cfg.hidden_size
        rate = cfg.hidden_dropout_prob if dropout else 0.0
        args = (self.attn_out.weight, self.attn_out.bias, self.attn_ln.weight,
                self.attn_ln.bias, self.ffn_in.weight, self.ffn_in.bias, self.ffn_out.weight,
                self.ffn_out.bias, self.ffn_ln.weight, self.ffn_ln.bias)
        if BT.kernel_ok(d, cfg.intermediate_size) and x_q.shape[-1] == d:
            if self.tp is not None:
                return BT.BlockTrainTPFn.apply(x_q, ctx.to(x_q.dtype), *args, rate,
                                               cfg.layer_norm_eps, seed, remat,
                                               self.opts.plain, self.tp)
            return BT.BlockTrainFn.apply(x_q, ctx.to(x_q.dtype), *args, rate,
                                         cfg.layer_norm_eps, seed, remat, self.opts.plain)
        masks = BT.seed_masks(seed, x_q.numel() // d, d, rate, x_q.device)
        tp = {} if self.tp is None else dict(reduce=lambda t: TP.reduce_from_model(t, self.tp),
                                             copy=lambda t: TP.copy_to_model(t, self.tp))
        y = BT.block_train_fwd_plain(x_q.reshape(-1, d), ctx.reshape(-1, ctx.shape[-1]).to(
            x_q.dtype), *args, *masks, rate=rate, eps=cfg.layer_norm_eps, **tp)[0]
        return y.reshape(x_q.shape)

    def _train_draws(self, x, bias, gen):
        """The layer's dropout draws from ``gen`` (None: none), in the order
        the layer makes them: the attention's (ops/attention.attention_draw),
        then the block's seed."""
        if gen is None:
            return None, None
        cfg = self.cfg
        attn = attention_draw(x, bias, self.heads, cfg.attention_probs_dropout_prob, gen,
                              self.opts.sp, self.tp)
        return attn, D.draw_seed(gen, x.device) if cfg.hidden_dropout_prob > 0.0 else None

    def _train(self, x, bias, attn_draw, seed, remat: str, dropout: bool):
        """The layer's training pass on its draws (``dropout``: the config's
        rates, else 0)."""
        rate = self.cfg.attention_probs_dropout_prob if dropout else 0.0
        x_in = x if self.tp is None else TP.copy_to_model(x, self.tp)
        ctx = attention_train(x_in, self.query, self.key, self.value, bias, self.heads, rate,
                              attn_draw, remat, self.opts.plain, sp=self.opts.sp, tp=self.tp)
        return self._finish_train(x, ctx, seed, remat, dropout)

    def forward(self, x, bias, return_kv: bool = False, tanh_residual_base=None, *,
                quantize: bool = False, train: bool = False, gen=None):
        """With ``return_kv`` also this layer's K/V ([B, L, H*D] each), or
        with ``quantize`` as well their int8 decode cache ((k8, ks), (v8,
        vs)), emitted by the flash launch on the flash route."""
        if return_kv and quantize:
            ctx, kq, vq = mha_merged_quantize(self.query(x), self.key(x), self.value(x), bias,
                                              self.heads, plain=self.opts.plain,
                                              sp=self.opts.sp)
            return self._finish(x, ctx), (kq, vq)
        if train:
            # the draws come first, so that every remat mode advances gen
            # alike and a recompute replays them
            draws = self._train_draws(x, bias, gen)
            if self.opts.remat == "full":
                # the whole layer one recompute region (JAX's nn.remat with no
                # policy), its kernels keeping everything inside it
                y = checkpoint(self._train, x, bias, *draws, "none", gen is not None,
                               use_reentrant=False, preserve_rng_state=False)
            else:
                y = self._train(x, bias, *draws, self.opts.remat, gen is not None)
            return y if tanh_residual_base is None else tanh_residual_base + torch.tanh(y)
        k_raw, v_raw = self.key(x), self.value(x)
        ctx = mha_merged(self.query(x), k_raw, v_raw, bias, self.heads, plain=self.opts.plain,
                         sp=self.opts.sp)
        y = self._finish(x, ctx, tanh_residual_base)
        return (y, (k_raw, v_raw)) if return_kv else y

    def decode(self, x_t, k_all, v_all, spec):
        """x_t [B, 1, D]; k_all/v_all: the unified merged cache (or int8
        (values, scales) pairs); spec: a DecodeStepSpec."""
        ctx = decode_mha(self.query(x_t), k_all, v_all, spec, self.heads, plain=self.opts.plain)
        return self._finish(x_t, ctx)


class TransformerEncoder(nn.Module):
    """Stack of TransformerLayers (BertEncoder equivalent)."""

    def __init__(self, cfg: TransformerConfig, opts: Options):
        super().__init__()
        self.cfg = cfg
        self.opts = opts
        self.layer = nn.ModuleList(
            [TransformerLayer(cfg, opts) for _ in range(cfg.num_hidden_layers)]
        )

    def pipelined(self, deterministic: bool) -> bool:
        """Whether the full-sequence forward runs through the GPipe
        schedule (the JAX _pp_eligible): a pp group (Options.pp), a layer
        count that divides over its stages, and a deterministic pass (eval,
        or training without a dropout generator) or both dropout rates 0
        (dropout draws do not ride the pipeline's payload)."""
        pp, cfg = self.opts.pp, self.cfg
        return (pp is not None and cfg.num_hidden_layers % pp.size == 0
                and (deterministic or (cfg.hidden_dropout_prob == 0.0
                                       and cfg.attention_probs_dropout_prob == 0.0)))

    def forward(self, x, bias, tanh_residual_base=None, *, train: bool = False, gen=None):
        """With ``tanh_residual_base`` return ``base + tanh(stack(x))``; the
        epilogue runs inside the last layer (the fused-block kernel's
        tanh form where the block gate holds; plain autograd in training).
        ``train``/``gen``: see TransformerLayer.forward.  Where ``pipelined``
        holds the stack runs over the pp group's stages
        (parallel/pipeline.py); the cached encode and decode methods below
        keep the single-stage layout, as in JAX."""
        if self.pipelined(deterministic=not train or gen is None):
            from vitxtgqa_tpu_torch.parallel.pipeline import pipeline_encoder_apply

            return pipeline_encoder_apply(self.layer, x, bias, self.opts.pp,
                                          self.opts.pp_microbatches, tanh_residual_base,
                                          train=train, gen=gen)
        last = len(self.layer) - 1
        for i, layer in enumerate(self.layer):
            x = layer(x, bias, tanh_residual_base=tanh_residual_base if i == last else None,
                      train=train, gen=gen)
        return x

    def encode_with_cache(self, x, bias, quantize: bool = False):
        """(final hidden, [(k, v)] per layer) — K/V are each layer's raw
        merged projections [B, L, H*D], the decode-cache layout; with
        ``quantize`` each entry is the ((k8, ks), (v8, vs)) int8 cache of
        quantize_cache, emitted by the flash launch (the serving decode
        keeps the separate quantize_cache pass, as JAX does)."""
        kvs = []
        for layer in self.layer:
            x, kv = layer(x, bias, return_kv=True, quantize=quantize)
            kvs.append(kv)
        return x, kvs

    def decode_step(self, x_t, dec_cache: List[Tuple], step: int,
                    spec: DecodeStepSpec, write_offset: int):
        """One cached decode step; this step's K/V rows are written at
        ``write_offset + step`` of the unified cache IN PLACE (the JAX
        version returns an updated copy).  An int8 cache gets the row
        quantized per token, bit for bit as quantize_kv does.  Returns
        (y_t [B, 1, D], dec_cache)."""
        pos = write_offset + step

        def write(cache, x_new):
            if isinstance(cache, tuple):
                vals, scales = cache
                q8, sc = quantize_kv(x_new)
                vals[:, pos: pos + 1] = q8
                scales[:, pos: pos + 1] = sc.to(scales.dtype)
            else:
                cache[:, pos: pos + 1] = x_new.to(cache.dtype)

        for layer, (ck, cv) in zip(self.layer, dec_cache):
            write(ck, layer.key(x_t))
            write(cv, layer.value(x_t))
            x_t = layer.decode(x_t, ck, cv, spec)
        return x_t, dec_cache

    def quantize_cache(self, kvs):
        """[(k, v)] merged caches -> [((k8, ks), (v8, vs))] int8."""
        return [(quantize_kv(k), quantize_kv(v)) for k, v in kvs]

    def fused_decode_ok(self, x: torch.Tensor) -> bool:
        """Whether the greedy decode over activations ``x`` [B, ...] takes
        the single-kernel decode step (ops/decode_step.py): the JAX gate
        (fused decode on, int8 cache, not W8A8, a kernel backend, batch <=
        the cap), with a CUDA tensor for the TPU backend.  It does not read
        ``opts.plain``: the oracle model takes the same branch through the
        plain versions."""
        o = self.opts
        return (o.fused_decode and o.kv_cache_int8 and not o.w8a8 and x.is_cuda
                and x.shape[0] <= o.fused_decode_max_batch)

    def _weight_stacks(self):
        stack = lambda ts: torch.stack([t.detach() for t in ts])
        vec = lambda ts: stack(ts).float()[:, None, :]
        ls = self.layer
        stacks = {}
        for short, attr in (("q", "query"), ("k", "key"), ("v", "value"),
                            ("o", "attn_out"), ("1", "ffn_in"), ("2", "ffn_out")):
            stacks["w" + short] = stack([getattr(l, attr).weight for l in ls])
            stacks["b" + short] = vec([getattr(l, attr).bias for l in ls])
        for i, attr in (("1", "attn_ln"), ("2", "ffn_ln")):
            stacks["s" + i] = vec([getattr(l, attr).weight for l in ls])
            stacks["g" + i] = vec([getattr(l, attr).bias for l in ls])
        return stacks

    def fused_decode_prep(self, kvs):
        """Pack the layer weights and the per-layer int8 caches for the
        single-kernel decode step.

        kvs: [((k8, ks), (v8, vs))] from quantize_cache.  Returns (stacks,
        kv8 [L, B, Lp, 2*H*D] int8, kvsc [L, B, 2, Lp] f32, buffers): the
        stacks hold the weights in nn.Linear layout [L, out, in] and the
        biases and LayerNorm parameters as float32 [L, 1, width], built once
        per set of weights (derived_weights); buffers are the step's
        preallocated outputs and scratch on CUDA (None elsewhere)."""
        stacks = derived_weights(self, "stacks", list(self.parameters()), self._weight_stacks)
        kv8 = torch.stack([torch.cat([k8, v8], dim=-1) for (k8, _), (v8, _) in kvs])
        kvsc = torch.stack([torch.stack([ks, vs], dim=1) for (_, ks), (_, vs) in kvs])
        buffers = None
        if kv8.is_cuda and not self.opts.plain:
            n_layers, b = kv8.shape[:2]
            buffers = DS.step_buffers(n_layers, b, self.cfg.hidden_size,
                                      self.cfg.intermediate_size, kv8.device,
                                      self.cfg.num_attention_heads)
        return stacks, kv8, kvsc, buffers

    def fused_decode_step_apply(self, stacks, x_t, kv8, kvsc, step: int,
                                key_mask, write_offset: int, buffers=None):
        """One decode step through the single-kernel path; commits this
        step's quantized K/V rows at ``write_offset + step`` of kv8 / kvsc
        IN PLACE (one copy per packed array; the JAX version returns updated
        copies).  Returns (y_t [B, 1, D], kv8, kvsc); on CUDA y_t lives in
        ``buffers`` and is overwritten by the next step."""
        if self.opts.plain:
            out = DS.fused_decode_step_plain(
                x_t, stacks, kv8, kvsc, key_mask, step, write_offset,
                self.cfg.num_attention_heads, self.cfg.layer_norm_eps)
        else:
            out = DS.fused_decode_step(
                x_t, stacks, kv8, kvsc, key_mask, step, write_offset,
                self.cfg.num_attention_heads, self.cfg.layer_norm_eps, buffers=buffers)
        y, row8, rowsc = out
        pos = write_offset + step
        kv8[:, :, pos] = row8[:, :, 0]
        kvsc[:, :, :, pos] = rowsc[..., 0]
        return y, kv8, kvsc


class BertEmbeddings(nn.Module):
    """Word + position + token-type embeddings, then LayerNorm.  Under
    ``tp`` (a ModelGroup that divides the vocabulary) the word embeddings
    are a rank's rows of it, looked up vocabulary-parallel
    (tensor_parallel.vocab_lookup)."""

    def __init__(self, cfg: TransformerConfig, tp=None):
        super().__init__()
        d = cfg.hidden_size
        self.dropout_prob = cfg.hidden_dropout_prob
        self.tp = tp if TP.divides(tp, cfg.vocab_size) else None
        self.word_embeddings = nn.Embedding(cfg.vocab_size // (self.tp.size if self.tp else 1), d)
        if self.tp:
            TP.mark(self.word_embeddings.weight, 0)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, d)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, d)
        self.LayerNorm = LayerNorm(d, eps=cfg.layer_norm_eps)

    def forward(self, input_ids, gen=None):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)[None, :]
        words = (self.word_embeddings(input_ids) if self.tp is None
                 else TP.vocab_lookup(self.word_embeddings.weight, input_ids, self.tp))
        x = (
            words
            + self.position_embeddings(pos)
            + self.token_type_embeddings(torch.zeros_like(input_ids))
        )
        return D.dropout(self.LayerNorm(x), self.dropout_prob, gen)


class TextEncoder(nn.Module):
    """Question encoder: BertEmbeddings + N layers (reference TextBert)."""

    def __init__(self, cfg: TransformerConfig, opts: Options):
        super().__init__()
        self.embeddings = BertEmbeddings(cfg, opts.tp)
        self.encoder = TransformerEncoder(cfg, opts)

    def forward(self, txt_inds, txt_mask, train: bool = False, gen=None):
        bias = ((1.0 - txt_mask) * NEG_INF)[:, None, None, :]
        return self.encoder(self.embeddings(txt_inds, gen), bias, train=train, gen=gen)


class PrevPredEmbeddings(nn.Module):
    """Decoder-slot embeddings from previous predictions.  ``vocab``: the
    fixed-vocabulary classifier's (FixedVocabClassifier.vocab), whose
    table rows the answer slots gather: None where the table is whole, or
    (model group, answer count) where it holds a rank's rows."""

    MAX_DEC_LENGTH = 100
    MAX_TYPE_NUM = 5

    def __init__(self, cfg: TransformerConfig, vocab=None):
        super().__init__()
        self.vocab = vocab
        d, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.dropout_prob = cfg.hidden_dropout_prob
        self.position_embeddings = nn.Embedding(self.MAX_DEC_LENGTH, d)
        self.token_type_embeddings = nn.Embedding(self.MAX_TYPE_NUM, d)
        self.ans_layer_norm = LayerNorm(d, eps=eps)
        self.ocr_layer_norm = LayerNorm(d, eps=eps)
        self.emb_layer_norm = LayerNorm(d, eps=eps)

    def tables(self, ans_emb, ocr_emb, float32_answers: bool = False):
        """LayerNormed tables ([V, D], [B, N, D]); loop-invariant during
        decode, so computed once before it.  The answer table is in the OCR
        table's dtype, or float32 where ``float32_answers`` (the
        teacher-forced pass: every decoder slot of the batch that names an
        answer gathers its row, so the gather's backward adds hundreds of
        contributions into a row, which bf16 would round at every add).
        A rank's rows of the table (``vocab``) give a partial gradient of the
        LayerNorm, summed over the model group."""
        ln = self.ans_layer_norm
        ans = ln.float32(ans_emb, self.vocab[0] if self.vocab else None)
        if not float32_answers:
            ans = ans.to(ln.weight.dtype).to(ocr_emb.dtype)
        return ans, self.ocr_layer_norm(ocr_emb)

    def embed(self, ans, ocr, prev_inds, position_offset: int = 0, gen=None):
        """Gather decoder-slot embeddings from prepared tables; prev_inds
        [B, S] index the joint [fixed vocab | OCR copy] space; ``gen``: the
        training dropout of the (position, type) embedding.  A rank's rows
        of the answer table (``vocab``) are gathered vocabulary-parallel,
        from the table as given (the float32 LayerNorm output in
        training)."""
        b, s = prev_inds.shape
        if self.vocab is None:
            ans_num = ans.shape[0]
            from_ans = ans[prev_inds.clamp(0, ans_num - 1)]
        else:
            tp, ans_num = self.vocab
            from_ans = TP.vocab_lookup(ans, prev_inds.clamp(0, ans_num - 1), tp)
        is_ocr = prev_inds >= ans_num
        from_ans = from_ans.to(ocr.dtype)
        ocr_idx = (prev_inds - ans_num).clamp(0, ocr.shape[1] - 1)
        from_ocr = torch.gather(ocr, 1, ocr_idx[..., None].expand(b, s, ocr.shape[2]))
        raw = torch.where(is_ocr[..., None], from_ocr, from_ans)
        positions = torch.arange(s, device=prev_inds.device)[None, :] + position_offset
        emb = self.position_embeddings(positions) + self.token_type_embeddings(is_ocr.long())
        return raw + D.dropout(self.emb_layer_norm(emb), self.dropout_prob, gen)


class OcrPtrNet(nn.Module):
    """Dynamic OCR-copy scores.  Keeps the reference quirk of ADDING the raw
    0/1 OCR mask to the scores (valid slots get +1).  ``plain``: the int8-key
    route runs its kernel's plain version on any device (Options.plain).
    Under ``tp`` (a ModelGroup that divides query_key_size) the query and
    key are column-parallel: a rank's scores are a partial sum, summed over
    the group in float32 before the mask (the int8 keys, which a model
    mesh never runs, take the whole width only)."""

    def __init__(self, hidden_size: int, query_key_size: int = 0, plain: bool = False,
                 tp=None):
        super().__init__()
        qk = query_key_size or hidden_size
        self.qk = qk
        self.plain = plain
        self.tp = tp if TP.divides(tp, qk) else None
        n = self.tp.size if self.tp else 1
        self.query = Linear(hidden_size, qk // n)
        self.key = Linear(hidden_size, qk // n)
        if self.tp:
            for lin in (self.query, self.key):
                TP.mark(lin.weight, 0)
                TP.mark(lin.bias, 0)

    def _in(self, x):
        return x if self.tp is None else TP.copy_to_model(x, self.tp)

    def keys(self, key_inputs):
        """Project the OCR keys (a rank's columns under ``tp``);
        loop-invariant during decode."""
        return self.key(self._in(key_inputs))

    def scores_from_keys(self, query_inputs, k, attention_mask):
        """``k``: the projected keys [B, N, QK], or int8 per-token-scaled
        keys (k8, ks) in the quantize_kv layout, which take the
        ptr_scores_int8 kernel on a CUDA tensor with one query row and a
        lane-aligned width (the JAX gate) and are dequantized elsewhere."""
        q = self.query(self._in(query_inputs))
        if isinstance(k, tuple):
            k8, ks = k
            if q.is_cuda and q.shape[1] == 1 and self.qk % 128 == 0:
                fn = PS.ptr_scores_int8_plain if self.plain else PS.ptr_scores_int8
                return fn(q, k8, ks, attention_mask.float().contiguous())
            k = dequantize_kv(k8, ks, dtype=q.dtype)
        scores = torch.einsum("bsd,bnd->bsn", q.float(), k.float()) / math.sqrt(self.qk)
        if self.tp is not None:
            scores = TP.reduce_from_model(scores, self.tp)
        return scores + attention_mask[:, None, :].float()

    def forward(self, query_inputs, key_inputs, attention_mask):
        return self.scores_from_keys(query_inputs, self.keys(key_inputs), attention_mask)


class FixedVocabClassifier(nn.Module):
    """Linear classifier whose weight doubles as the fixed-answer embedding
    table (reference: classifier.module.weight).  Under ``tp`` (a
    ModelGroup that divides out_dim) it holds a rank's answer rows (and
    their biases): its input comes through copy_to_model and its score
    columns are all-gathered along the vocabulary; ``vocab`` is then (tp,
    out_dim) for PrevPredEmbeddings, else None."""

    def __init__(self, out_dim: int, in_dim: int = 768, tp=None):
        super().__init__()
        self.tp = tp if TP.divides(tp, out_dim) else None
        self.vocab = None if self.tp is None else (self.tp, out_dim)
        self.module = Linear(in_dim, out_dim // (self.tp.size if self.tp else 1))
        if self.tp:
            TP.mark(self.module.weight, 0)
            TP.mark(self.module.bias, 0)

    def forward(self, x):
        if self.tp is not None:
            x = TP.copy_to_model(x, self.tp)
        scores = torch.matmul(x.float(), self.module.weight.float().t()) + self.module.bias.float()
        return scores if self.tp is None else TP.gather_from_model(scores, self.tp)

    def table(self) -> torch.Tensor:
        """[out_dim, in_dim] view of the classifier weight (a rank's rows
        under ``tp``)."""
        return self.module.weight
