"""Pre-LN transformer encoder (BERT-base family) in PyTorch — the text arm.

Counterpart of ``lance_distributed_training_tpu/models/transformer.py``.
Parameters are f32 and compute runs in ``dtype`` (bf16 by default), as the
Flax modules' ``dtype=bf16, param_dtype=f32`` do. The details that make the
two compute the same function:

* LayerNorm epsilon 1e-6 (Flax's default), statistics in f32;
* GELU with the tanh approximation (``flax.linen.gelu``'s default);
* the MLM head is tied to the token embedding and runs in f32;
  ``head="none"`` returns the final hidden states instead (CLIP's text
  tower).

With ``num_experts > 0`` every ``moe_every``-th block (block ``i`` with
``i % moe_every == moe_every - 1``) replaces its dense MLP by a
switch-routed :class:`.moe.MoEMLP`, as the JAX encoder does.

With ``remat`` each block's call goes through
:func:`torch.utils.checkpoint.checkpoint` (non-reentrant), the
counterpart of the JAX encoder's ``nn.remat(EncoderBlock)``: the backward
runs each block's forward again rather than keeping its activations. It
adds no parameter; the recomputed forward gives the same bits (the
kernels and the plain ops are deterministic), so the gradients are those
of the run without it.

Tensor parallelism (``parallel/layout.shard_model_`` sets it up
from the layout plan): with ``tp_group`` set, a block's attention holds
``heads / tp`` local heads (column-parallel query, key and value, a
row-parallel output projection whose partial products are summed in f32
over the group and rounded once) and its MLP a column-parallel
``mlp_in`` and a row-parallel ``mlp_out``; with ``vocab_group`` set the
encoder's token embedding holds a contiguous block of the vocabulary
(the lookup masked to it and summed over the group) and the tied head
returns the logits of that block only (``vocab_cross_entropy`` and
``vocab_argmax`` reduce them over the group). Where the degree does not
divide the heads but divides the width (JAX's rules then keep ``query``,
``key`` and ``value`` whole and split ``out`` on its input), ``out_group``
is set instead: every rank of the group computes the whole attention
alike and the row-parallel ``out`` takes this rank's block of its input
features. The regions follow Megatron-LM:
:func:`..parallel.comm.copy_to` where a replicated tensor enters a split
computation, :func:`..parallel.comm.scatter_to` where a tensor every rank
holds whole enters it as blocks, :func:`..parallel.comm.reduce_from`
where it leaves.

Weights initialise as Flax's do (LeCun-normal dense kernels, zero biases,
``N(0, 1/vocab)`` embeddings, ``N(0, 0.02)`` positions) from an explicit
``torch.Generator``; :mod:`.convert` loads a Flax parameter tree instead.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..parallel import comm

__all__ = ["TransformerEncoder", "SelfAttention", "EncoderBlock",
           "bert_base", "bert_small", "gpt_base", "gpt_small",
           "dot_product_attention", "run_blocks", "vocab_cross_entropy",
           "vocab_argmax"]

LN_EPS = 1e-6
# Flax's lecun_normal draws a normal truncated to two standard deviations,
# rescaled so that the truncated distribution has the requested variance.
_TRUNC_STD = 0.87962566103423978


def dot_product_attention(q, k, v, mask=None, dtype=torch.bfloat16,
                          causal=False):
    """Dense softmax attention, q/k/v ``[B, H, S, D]`` → ``[B, H, S, D]``:
    scores and softmax in f32, products in ``dtype``. ``causal`` adds the
    lower-triangular mask on top of any boolean ``mask``."""
    d = q.shape[-1]
    scores = torch.matmul(q.to(dtype), k.to(dtype).transpose(-1, -2)).float()
    scores = scores / math.sqrt(d)
    neg = torch.finfo(torch.float32).min
    if causal:
        s_q, s_k = scores.shape[-2], scores.shape[-1]
        tri = torch.ones(s_q, s_k, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~tri, neg)
    if mask is not None:
        scores = scores.masked_fill(~mask.to(torch.bool), neg)
    weights = torch.softmax(scores, dim=-1)
    return torch.matmul(weights.to(dtype), v.to(dtype))


def _lecun_normal_(weight: torch.Tensor, fan_in: int,
                   generator: torch.Generator) -> None:
    std = 1.0 / math.sqrt(fan_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)


class _Dense(nn.Linear):
    """``nn.Linear`` with f32 parameters that computes in ``dtype``."""

    def __init__(self, in_features: int, out_features: int, dtype):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype

    def reset_from(self, generator: torch.Generator) -> None:
        _lecun_normal_(self.weight, self.in_features, generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))

    def row_parallel(self, x, group):
        """The layer over an input split along its features over
        ``group`` (this rank's block of the weight's columns): the partial
        products summed in f32 over the group, the bias added, rounded to
        ``dtype`` once."""
        dt = self.compute_dtype
        partial = F.linear(x.to(dt), self.weight.to(dt))
        return (comm.reduce_from(partial.float(), group)
                + self.bias).to(dt)


class _LayerNorm(nn.LayerNorm):
    """LayerNorm with epsilon 1e-6, statistics in f32, output in ``dtype``."""

    def __init__(self, features: int, dtype):
        super().__init__(features, eps=LN_EPS)
        self.compute_dtype = dtype

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(self.compute_dtype)


class SelfAttention(nn.Module):
    """Multi-head self-attention; ``attention_fn`` (e.g. the flash kernels
    of :func:`..ops.flash.make_flash_attention`) replaces the dense core.
    Under ``tp_group`` the heads are split; under ``out_group`` they stay
    whole and only ``out`` is split (the module's docstring)."""

    def __init__(self, hidden: int, num_heads: int, dtype=torch.bfloat16,
                 attention_fn: Optional[Callable] = None, causal: bool = False):
        super().__init__()
        if hidden % num_heads:
            raise ValueError(f"hidden {hidden} not divisible by {num_heads} heads")
        self.num_heads = num_heads  # this rank's heads under tp_group
        self.head_dim = hidden // num_heads
        self.dtype = dtype
        self.attention_fn = attention_fn
        self.causal = causal
        self.tp_group = None  # set: the heads are split over this group
        self.out_group = None  # set: only out's input is split over it
        self.query = _Dense(hidden, hidden, dtype)
        self.key = _Dense(hidden, hidden, dtype)
        self.value = _Dense(hidden, hidden, dtype)
        self.out = _Dense(hidden, hidden, dtype)

    def forward(self, x, mask=None, segment_ids=None):
        b, s, _ = x.shape
        hd = self.head_dim
        x = comm.copy_to(x, self.tp_group)

        def heads(t):  # [B, S, nh*hd] -> [B, nh, S, hd]
            return t.view(b, s, self.num_heads, hd).transpose(1, 2)

        q, k, v = heads(self.query(x)), heads(self.key(x)), heads(self.value(x))
        if self.attention_fn is not None:
            if segment_ids is not None:
                out = self.attention_fn(q, k, v, mask=mask,
                                        segment_ids=segment_ids)
            else:
                out = self.attention_fn(q, k, v, mask=mask)
        else:
            out = dot_product_attention(q, k, v, mask=mask, dtype=self.dtype,
                                        causal=self.causal)
        out = out.transpose(1, 2).reshape(b, s, self.num_heads * hd)
        if self.tp_group is not None:
            return self.out.row_parallel(out, self.tp_group)
        if self.out_group is not None:
            return self.out.row_parallel(
                comm.scatter_to(out, self.out_group), self.out_group)
        return self.out(out)


class EncoderBlock(nn.Module):
    """Pre-LN block: attention and a GELU MLP, each residual; the MLP is a
    switch-routed :class:`.moe.MoEMLP` when ``num_experts > 0``."""

    def __init__(self, hidden: int, num_heads: int, mlp_dim: int,
                 dtype=torch.bfloat16, attention_fn: Optional[Callable] = None,
                 num_experts: int = 0, causal: bool = False,
                 capacity_factor: float = 1.25):
        super().__init__()
        self.ln_attn = _LayerNorm(hidden, dtype)
        self.attn = SelfAttention(hidden, num_heads, dtype, attention_fn, causal)
        self.ln_mlp = _LayerNorm(hidden, dtype)
        self.tp_group = None  # set: the MLP's hidden units are split
        self.moe = None
        if num_experts > 0:
            from .moe import MoEMLP

            self.moe = MoEMLP(hidden, num_experts, mlp_dim, capacity_factor,
                              dtype)
        else:
            self.mlp_in = _Dense(hidden, mlp_dim, dtype)
            self.mlp_out = _Dense(mlp_dim, hidden, dtype)

    def forward(self, x, mask=None, segment_ids=None):
        x = x + self.attn(self.ln_attn(x), mask, segment_ids)
        if self.moe is not None:
            return x + self.moe(self.ln_mlp(x))
        y = comm.copy_to(self.ln_mlp(x), self.tp_group)
        y = F.gelu(self.mlp_in(y), approximate="tanh")
        if self.tp_group is not None:
            return x + self.mlp_out.row_parallel(y, self.tp_group)
        return x + self.mlp_out(y)


def run_blocks(layers, x, *args, remat: bool = False):
    """``x`` through each block of ``layers``; with ``remat`` (and a graph
    being recorded) each block is checkpointed, its forward run again in
    the backward."""
    for layer in layers:
        if remat and torch.is_grad_enabled():
            x = checkpoint(layer, x, *args, use_reentrant=False)
        else:
            x = layer(x, *args)
    return x


class TransformerEncoder(nn.Module):
    """Pre-LN BERT-style encoder with a tied MLM head.

    ``forward(input_ids, attention_mask, segment_ids=None,
    position_ids=None)`` → f32 logits ``[B, S, vocab]``, or with
    ``head="none"`` the final hidden states ``[B, S, H]`` in ``dtype``. Packed rows carry
    ``segment_ids`` (1-based, 0 = dead) and ``position_ids`` (restarting
    per sequence): positions are gathered from ``pos_embed``; an
    ``attention_fn`` takes the segment ids straight through, the dense path
    lowers them to a block mask (same live segment). ``remat``
    rematerializes each block (the module's docstring). The model is built
    on ``device`` and initialised from ``generator`` (a fresh
    ``torch.Generator`` seeded with 0 when none is given)."""

    def __init__(self, vocab_size: int, hidden_size: int = 768,
                 num_layers: int = 12, num_heads: int = 12,
                 mlp_dim: int = 3072, max_len: int = 512,
                 dtype=torch.bfloat16, attention_fn: Optional[Callable] = None,
                 remat: bool = False, num_experts: int = 0,
                 moe_every: int = 2, capacity_factor: float = 1.25,
                 causal: bool = False, head: str = "mlm", device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if head not in ("mlm", "none"):
            raise ValueError(f"head must be 'mlm' or 'none', got {head!r}")
        self.vocab_size = vocab_size
        self.head = head
        self.hidden_size = hidden_size
        self.max_len = max_len
        self.dtype = dtype
        self.attention_fn = attention_fn
        self.remat = remat
        self.causal = causal
        self.tok_embed = nn.Embedding(vocab_size, hidden_size)
        self.vocab_group = None  # set: tok_embed holds a vocabulary block
        self.vocab_start = 0  # its first token id
        self.pos_embed = nn.Parameter(torch.empty(max_len, hidden_size))
        self.layers = nn.ModuleList(
            EncoderBlock(hidden_size, num_heads, mlp_dim, dtype, attention_fn,
                         num_experts if num_experts > 0
                         and i % moe_every == moe_every - 1 else 0,
                         causal, capacity_factor)
            for i in range(num_layers)
        )
        self.ln_final = _LayerNorm(hidden_size, dtype)
        self.reset_parameters(generator)
        if device is not None:
            self.to(device)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        with torch.no_grad():
            self.tok_embed.weight.normal_(0.0, 1.0 / math.sqrt(self.vocab_size),
                                          generator=generator)
            self.pos_embed.normal_(0.0, 0.02, generator=generator)
        from .moe import MoEMLP

        for module in self.modules():
            if isinstance(module, (_Dense, MoEMLP)):
                module.reset_from(generator)
            elif isinstance(module, _LayerNorm):
                nn.init.ones_(module.weight)
                nn.init.zeros_(module.bias)

    def forward(self, input_ids, attention_mask=None, segment_ids=None,
                position_ids=None):
        b, s = input_ids.shape
        x = self.embed_tokens(input_ids).to(self.dtype)
        if position_ids is not None:
            x = x + self.pos_embed[position_ids.long()].to(self.dtype)
        else:
            x = x + self.pos_embed[:s].to(self.dtype)
        mask = None
        if attention_mask is not None:
            mask = attention_mask[:, None, None, :].to(torch.bool)
        if segment_ids is not None and self.attention_fn is None:
            from ..ops.flash import segment_attention_mask

            mask, segment_ids = segment_attention_mask(segment_ids), None
        elif segment_ids is not None:
            mask = None
        x = run_blocks(self.layers, x, mask, segment_ids, remat=self.remat)
        x = self.ln_final(x)
        if self.head == "none":
            return x
        x = comm.copy_to(x.float(), self.vocab_group)
        return torch.matmul(x, self.tok_embed.weight.t())

    def embed_tokens(self, ids):
        """The f32 embeddings of ``ids``; under ``vocab_group`` each rank
        looks up the ids of its block (the others give zero rows) and the
        rows are summed over the group, which adds zeros only."""
        return vocab_embedding(ids, self.tok_embed.weight, self.vocab_group,
                               self.vocab_start)


def vocab_embedding(ids, weight, group, start: int):
    """``weight[ids]``; with ``group``, ``weight`` is the block of rows from
    ``start`` of a table split over the group."""
    if group is None:
        return F.embedding(ids, weight)
    rows = weight.shape[0]
    mine = (ids >= start) & (ids < start + rows)
    local = F.embedding((ids - start).clamp(0, rows - 1), weight)
    return comm.reduce_from(local * mine[..., None].to(local.dtype), group)


class _VocabCrossEntropy(torch.autograd.Function):
    """Megatron-LM's cross-entropy over logits split along the vocabulary:
    the max, the target's logit and the sum of exponentials reduced over
    the group, the gradient (softmax minus the one-hot) formed locally."""

    @staticmethod
    def forward(ctx, logits, targets, group, start):
        rows = logits.shape[-1]
        top = comm.all_reduce(logits.max(-1).values, group, op="max")
        shifted = logits - top[:, None]
        mine = (targets >= start) & (targets < start + rows)
        local = (targets - start).clamp(0, rows - 1)
        picked = shifted.gather(1, local[:, None])[:, 0] * mine
        picked = comm.all_reduce(picked, group)
        exp = shifted.exp()
        total = comm.all_reduce(exp.sum(-1), group)
        ctx.save_for_backward(exp, total, local, mine)
        return total.log() - picked

    @staticmethod
    def backward(ctx, grad):
        exp, total, local, mine = ctx.saved_tensors
        g = exp / total[:, None]
        g.scatter_add_(1, local[:, None], -mine[:, None].to(g.dtype))
        return g * grad[:, None], None, None, None


def vocab_cross_entropy(logits, targets, model):
    """Per-position cross-entropy of f32 ``logits [N, V]`` (this rank's
    vocabulary block under ``model.vocab_group``) against ``targets
    [N]``."""
    group = getattr(model, "vocab_group", None)
    if group is None:
        return F.cross_entropy(logits, targets, reduction="none")
    return _VocabCrossEntropy.apply(logits, targets, group,
                                    model.vocab_start)


def vocab_argmax(logits, model):
    """``logits.argmax(-1)`` over the whole vocabulary: under
    ``model.vocab_group`` each rank's block maximum and its global id are
    gathered, and the first block holding the largest value wins, as
    ``argmax`` picks the first maximum."""
    group = getattr(model, "vocab_group", None)
    if group is None:
        return logits.argmax(-1)
    index = logits.argmax(-1)
    values = logits.gather(-1, index[..., None])[..., 0]
    values = comm.all_gather(values.float()[None], group)
    ids = comm.all_gather((index + model.vocab_start)[None], group)
    best = values.argmax(0, keepdim=True)
    return ids.gather(0, best)[0]


bert_base = partial(TransformerEncoder, hidden_size=768, num_layers=12,
                    num_heads=12, mlp_dim=3072)
bert_small = partial(TransformerEncoder, hidden_size=256, num_layers=4,
                     num_heads=4, mlp_dim=1024)
gpt_base = partial(TransformerEncoder, hidden_size=768, num_layers=12,
                   num_heads=12, mlp_dim=3072, causal=True)
gpt_small = partial(TransformerEncoder, hidden_size=256, num_layers=4,
                    num_heads=4, mlp_dim=1024, causal=True)
