"""CLIP-style dual-tower contrastive model in PyTorch — the mixed-modal arm.

Counterpart of ``lance_distributed_training_tpu/models/clip.py`` (the
BASELINE configuration "LAION-subset image+caption → CLIP contrastive"):

* the image tower is the port's :class:`~.resnet.ResNet` with its f32 head
  as the projection to ``embed_dim`` (its BatchNorm synchronised over a
  process group as for classification, :func:`~.resnet.set_sync_group`);
* the text tower is :class:`~.transformer.TransformerEncoder` with
  ``head="none"``, mean-pooled over the valid positions (the count floored
  at 1) and projected by an f32 ``text_proj``;
* both embeddings are L2-normalised (the norm floored at 1e-6), and
  ``logit_scale`` starts at ``log(1/0.07)`` and is returned exponentiated.

:func:`clip_contrastive_loss` is the symmetric InfoNCE over the ``[B, B]``
logits of the GLOBAL batch. The JAX step gets that from its sharded batch,
where the similarity product makes XLA all-gather both embeddings. Here a
``group`` all-gathers them with an autograd function whose backward sums
each process's gradient of the gathered rows over the group and keeps its
own rows: every process computes the same global loss, so its rows receive
``world`` times their gradient, which DDP's mean over the group brings back
to the gradient of the one global loss.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..parallel import comm
from .resnet import BasicBlock, BottleneckBlock, ResNet
from .transformer import TransformerEncoder, _lecun_normal_

__all__ = ["CLIP", "clip_contrastive_loss", "clip_resnet50_bert",
           "clip_tiny", "gather_with_grad", "retrieval_top1"]


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    mask = mask.to(x.dtype)[..., None]
    return (x * mask).sum(dim=1) / torch.clamp(mask.sum(dim=1), min=1.0)


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-6)


class CLIP(nn.Module):
    """``forward(images NCHW, input_ids, attention_mask)`` → ``(img_emb,
    txt_emb, logit_scale)``: f32 ``[B, embed_dim]`` unit rows and a scalar.
    The model is built on ``device`` and initialised from ``generator``
    (image tower, then text tower, then ``text_proj``)."""

    def __init__(self, embed_dim: int = 512,
                 image_stage_sizes: tuple = (3, 4, 6, 3),
                 image_block=BottleneckBlock, vocab_size: int = 30522,
                 text_hidden: int = 512, text_layers: int = 6,
                 text_heads: int = 8, text_mlp_dim: int = 2048,
                 max_len: int = 77, dtype=torch.bfloat16, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        # Built and drawn on the CPU (the generator's device), then moved.
        self.image_tower = ResNet(image_stage_sizes, image_block,
                                  num_classes=embed_dim, dtype=dtype,
                                  generator=generator)
        self.text_tower = TransformerEncoder(
            vocab_size, hidden_size=text_hidden, num_layers=text_layers,
            num_heads=text_heads, mlp_dim=text_mlp_dim, max_len=max_len,
            dtype=dtype, head="none", generator=generator)
        self.text_proj = nn.Linear(text_hidden, embed_dim)
        _lecun_normal_(self.text_proj.weight, text_hidden, generator)
        with torch.no_grad():
            self.text_proj.bias.zero_()
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))
        if device is not None:
            self.to(device)  # keeps the image tower's channels_last

    def forward(self, images, input_ids, attention_mask):
        img = self.image_tower(images)
        hidden = self.text_tower(input_ids, attention_mask)
        txt = self.text_proj(_masked_mean(hidden.float(), attention_mask))
        return _l2_normalize(img), _l2_normalize(txt), self.logit_scale.exp()


class _GatherWithGrad(torch.autograd.Function):
    """``all_gather`` along dim 0 whose backward all-reduces (sums) the
    gathered gradient over the group and returns this process's rows."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.rank = dist.get_rank(group)
        ctx.rows = x.shape[0]
        return comm.all_gather(x, group)

    @staticmethod
    def backward(ctx, grad):
        grad = comm.all_reduce(grad, ctx.group)
        lo = ctx.rank * ctx.rows
        return grad[lo:lo + ctx.rows], None


def gather_with_grad(x: torch.Tensor, group) -> torch.Tensor:
    """The group's rows of ``x`` in rank order, differentiable (see the
    module's docstring for the gradient's scale)."""
    return _GatherWithGrad.apply(x, group)


def clip_contrastive_loss(img_emb, txt_emb, logit_scale,
                          group=None) -> torch.Tensor:
    """Symmetric InfoNCE over the global batch: ``group`` gathers every
    process's embeddings first, so both softmax directions see every
    negative."""
    if group is not None:
        img_emb = gather_with_grad(img_emb, group)
        txt_emb = gather_with_grad(txt_emb, group)
    logits = logit_scale * img_emb @ txt_emb.t()
    labels = torch.arange(logits.shape[0], device=logits.device)
    return 0.5 * (F.cross_entropy(logits, labels)
                  + F.cross_entropy(logits.t(), labels))


def retrieval_top1(img_emb, txt_emb) -> torch.Tensor:
    """Per image: 1.0 where its own caption scores highest among the
    batch's captions."""
    logits = img_emb @ txt_emb.t()
    return (logits.argmax(dim=-1)
            == torch.arange(logits.shape[0], device=logits.device)).float()


clip_resnet50_bert = partial(
    CLIP, embed_dim=512, image_stage_sizes=(3, 4, 6, 3),
    image_block=BottleneckBlock, text_hidden=512, text_layers=6,
)
clip_tiny = partial(
    CLIP, embed_dim=64, image_stage_sizes=(1, 1, 1, 1), image_block=BasicBlock,
    vocab_size=1000, text_hidden=64, text_layers=2, text_heads=2,
    text_mlp_dim=128, max_len=16,
)
