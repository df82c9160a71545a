"""Vision Transformer in PyTorch — the second classification family.

Counterpart of ``lance_distributed_training_tpu/models/vit.py``: the image
is cut into patches by one strided convolution (``patch_embed``, an f32
``[H, 3, p, p]`` weight over the channels-last NCHW view that the
classification task hands its model, computing in ``dtype``), an f32
``pos_embed [seq, H]`` is added in ``dtype``, then the transformer's
:class:`~.transformer.EncoderBlock` s run with no mask, the tokens are
mean-pooled, and an f32 LayerNorm (epsilon 1e-6) and an f32 head give the
logits. There is no class token, so the sequence is the patch grid.
``remat`` rematerializes each block, as the JAX module's field does; the
classification task does not set it, as in JAX.

The position table's rows are the patches of an ``image_size`` image, so
the model is built for one image size, as the Flax module's parameters
are for the size it was initialised with. Weights initialise as Flax's do
(LeCun-normal kernels, zero biases, ``N(0, 0.02)`` positions) from an
explicit ``torch.Generator``.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .transformer import LN_EPS, EncoderBlock, _lecun_normal_, run_blocks

__all__ = ["ViT", "vit_tiny", "vit_small", "vit_base"]


class ViT(nn.Module):
    """``forward(images NCHW) → f32 logits [B, num_classes]``."""

    def __init__(self, num_classes: int, image_size: int = 224,
                 patch_size: int = 16, hidden_size: int = 384,
                 num_layers: int = 12, num_heads: int = 6,
                 mlp_dim: int = 1536, dtype=torch.bfloat16,
                 remat: bool = False, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self._check_size(image_size, image_size, patch_size)
        self.patch_size = patch_size
        self.hidden_size = hidden_size
        self.dtype = dtype
        self.remat = remat
        self.patch_embed = nn.Conv2d(3, hidden_size, patch_size,
                                     stride=patch_size)
        seq = (image_size // patch_size) ** 2
        self.pos_embed = nn.Parameter(torch.empty(seq, hidden_size))
        self.layers = nn.ModuleList(
            EncoderBlock(hidden_size, num_heads, mlp_dim, dtype)
            for _ in range(num_layers))
        self.ln_final = nn.LayerNorm(hidden_size, eps=LN_EPS)
        self.head = nn.Linear(hidden_size, num_classes)
        self.reset_parameters(generator)
        if device is not None:
            self.to(device)

    @staticmethod
    def _check_size(h: int, w: int, p: int) -> None:
        if h % p or w % p:
            raise ValueError(f"image {h}x{w} not divisible by patch {p}")

    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        from .transformer import _Dense, _LayerNorm

        if generator is None:
            generator = torch.Generator().manual_seed(0)
        _lecun_normal_(self.patch_embed.weight,
                       3 * self.patch_size * self.patch_size, generator)
        with torch.no_grad():
            self.patch_embed.bias.zero_()
            self.pos_embed.normal_(0.0, 0.02, generator=generator)
        for module in self.layers.modules():
            if isinstance(module, _Dense):
                module.reset_from(generator)
            elif isinstance(module, _LayerNorm):
                nn.init.ones_(module.weight)
                nn.init.zeros_(module.bias)
        nn.init.ones_(self.ln_final.weight)
        nn.init.zeros_(self.ln_final.bias)
        _lecun_normal_(self.head.weight, self.hidden_size, generator)
        with torch.no_grad():
            self.head.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        p = self.patch_size
        self._check_size(h, w, p)
        dt = self.dtype
        x = F.conv2d(x.to(dt), self.patch_embed.weight.to(dt),
                     self.patch_embed.bias.to(dt), stride=p)
        # [B, H, h/p, w/p] → the patch grid in row-major order, [B, seq, H].
        x = x.permute(0, 2, 3, 1).reshape(b, (h // p) * (w // p),
                                          self.hidden_size)
        x = x + self.pos_embed.to(dt)
        x = run_blocks(self.layers, x, remat=self.remat)
        x = F.layer_norm(x.mean(dim=1).float(), (self.hidden_size,),
                         self.ln_final.weight, self.ln_final.bias, LN_EPS)
        return self.head(x)


vit_tiny = partial(ViT, hidden_size=64, num_layers=2, num_heads=2,
                   mlp_dim=128, patch_size=8)
vit_small = partial(ViT, hidden_size=384, num_layers=12, num_heads=6,
                    mlp_dim=1536)
vit_base = partial(ViT, hidden_size=768, num_layers=12, num_heads=12,
                   mlp_dim=3072)
