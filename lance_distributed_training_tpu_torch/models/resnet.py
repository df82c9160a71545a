"""ResNet family (18/34/50/101/152) in PyTorch — the classification arm.

Counterpart of ``lance_distributed_training_tpu/models/resnet.py``. The
module takes an NCHW-logical batch in ``channels_last`` memory (the K1
kernel's NHWC output, permuted without a copy) and returns f32 logits.
Parameters are f32, convolutions and BatchNorm compute in ``dtype`` (bf16 by
default), the head is an f32 ``Linear``. Module names follow torchvision
(``conv1``, ``bn1``, ``layerN.i.convK``, ``downsample.0/1``, ``fc``), so
:mod:`.convert` maps a Flax tree onto them as the inverse of the JAX
package's ``torchvision_resnet_to_flax``.

What makes the two compute the same function:

* symmetric explicit padding: 7×7/s2 pad 3, 3×3 pad 1, max-pool 3/s2 pad 1,
  the 1×1 projection unpadded; the stride sits on the 3×3 conv;
* each block's last BatchNorm scale starts at zero;
* BatchNorm as Flax computes it, not as torch does: statistics in f32 with
  the *biased* batch variance, running statistics updated as
  ``0.9 · running + 0.1 · batch`` (Flax momentum 0.9), epsilon 1e-5;
* the mean pool over H and W in ``dtype``, then the head in f32.

Under data parallelism the statistics are those of the global batch, as in
the JAX step, where the batch is one array sharded over devices: with a
process group set (:func:`set_sync_group`) each BatchNorm all-reduces the
per-channel sum and sum of squares forward, and the two gradient sums
backward, as SyncBatchNorm does.

Weights initialise as Flax's do (LeCun-normal conv and dense kernels, zero
biases, unit or zero BN scales) from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import comm

__all__ = ["BatchNorm2d", "BasicBlock", "BottleneckBlock", "ResNet",
           "RESNETS", "resnet18", "resnet34", "resnet50", "resnet101",
           "resnet152", "set_sync_group"]

BN_MOMENTUM = 0.9  # Flax convention: running = m · running + (1 - m) · batch
BN_EPS = 1e-5
_TRUNC_STD = 0.87962566103423978  # see transformer._lecun_normal_


def _lecun_normal_(weight: torch.Tensor, fan_in: int,
                   generator: Optional[torch.Generator]) -> None:
    std = 1.0 / math.sqrt(fan_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)


class _SyncBatchNormFn(torch.autograd.Function):
    """Training-mode BatchNorm over the global batch of a process group:
    forward all-reduces ``[sum, sum of squares, count]``, backward
    ``[Σ dy, Σ dy·x̂]``. Returns the output and the batch mean and biased
    variance (for the running statistics)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        xf = x.float()
        c = xf.shape[1]
        dims = (0, 2, 3)
        stats = torch.cat([
            xf.sum(dims), (xf * xf).sum(dims),
            torch.full((1,), xf.numel() // c, dtype=torch.float32,
                       device=x.device),
        ])
        stats = comm.all_reduce(stats, group)
        n = stats[-1]
        mean = stats[:c] / n
        var = torch.clamp(stats[c:2 * c] / n - mean * mean, min=0.0)
        invstd = torch.rsqrt(var + eps)
        y = (xf - mean[:, None, None]) * (invstd * weight)[:, None, None]
        y = (y + bias[:, None, None]).to(x.dtype)
        ctx.save_for_backward(x, weight, mean, invstd, n)
        ctx.group = group
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, invstd, n = ctx.saved_tensors
        dims = (0, 2, 3)
        dyf = dy.float()
        xhat = (x.float() - mean[:, None, None]) * invstd[:, None, None]
        sum_dy = dyf.sum(dims)
        sum_dy_xhat = (dyf * xhat).sum(dims)
        # The parameters' gradients stay local: DDP averages them.
        grad_weight, grad_bias = sum_dy_xhat.clone(), sum_dy.clone()
        sums = comm.all_reduce(torch.cat([sum_dy, sum_dy_xhat]), ctx.group)
        c = sum_dy.shape[0]
        g_dy, g_dy_xhat = sums[:c], sums[c:]
        dx = (weight * invstd / n)[:, None, None] * (
            n * dyf - g_dy[:, None, None] - xhat * g_dy_xhat[:, None, None])
        return dx.to(x.dtype), grad_weight, grad_bias, None, None


class BatchNorm2d(nn.Module):
    """Flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over NCHW: f32
    scale, bias and running statistics; output in the input's dtype.

    Training uses the batch statistics (the library's BatchNorm kernel in
    one process, :class:`_SyncBatchNormFn` across a process group) and
    updates the running statistics with the biased batch variance; eval
    uses the running statistics."""

    def __init__(self, features: int, zero_scale: bool = False):
        super().__init__()
        self.momentum = BN_MOMENTUM
        self.eps = BN_EPS
        self.zero_scale = zero_scale
        self.weight = nn.Parameter(torch.zeros(features) if zero_scale
                                   else torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.process_group = None  # set for global-batch statistics

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.weight.fill_(0.0 if self.zero_scale else 1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        if self.process_group is not None:
            y, mean, var = _SyncBatchNormFn.apply(
                x, self.weight, self.bias, self.eps, self.process_group)
        else:
            y, mean, invstd = torch.native_batch_norm(
                x, self.weight, self.bias, None, None, True, 0.0, self.eps)
            with torch.no_grad():
                var = torch.clamp(invstd.reciprocal().square() - self.eps,
                                  min=0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
        return y


class _Conv(nn.Conv2d):
    """Bias-free ``nn.Conv2d`` with f32 weights that computes in ``dtype``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: int = 0, dtype=torch.bfloat16):
        super().__init__(cin, cout, k, stride=stride, padding=padding,
                         bias=False)
        self.compute_dtype = dtype

    def reset_from(self, generator: Optional[torch.Generator]) -> None:
        _lecun_normal_(self.weight, self.weight[0].numel(), generator)

    def forward(self, x):
        dt = self.compute_dtype
        return F.conv2d(x.to(dt), self.weight.to(dt), None, self.stride,
                        self.padding)


class BasicBlock(nn.Module):
    """3×3 + 3×3 residual block (ResNet-18/34)."""

    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int, dtype):
        super().__init__()
        self.conv1 = _Conv(cin, filters, 3, stride, 1, dtype)
        self.bn1 = BatchNorm2d(filters)
        self.conv2 = _Conv(filters, filters, 3, 1, 1, dtype)
        self.bn2 = BatchNorm2d(filters, zero_scale=True)
        self.downsample = None
        if stride != 1 or cin != filters:
            self.downsample = nn.Sequential(
                _Conv(cin, filters, 1, stride, 0, dtype), BatchNorm2d(filters))

    def forward(self, x):
        y = F.relu_(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu_(y.add_(residual))


class BottleneckBlock(nn.Module):
    """1×1 → 3×3 → 1×1 bottleneck (ResNet-50/101/152)."""

    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int, dtype):
        super().__init__()
        out = filters * 4
        self.conv1 = _Conv(cin, filters, 1, 1, 0, dtype)
        self.bn1 = BatchNorm2d(filters)
        self.conv2 = _Conv(filters, filters, 3, stride, 1, dtype)
        self.bn2 = BatchNorm2d(filters)
        self.conv3 = _Conv(filters, out, 1, 1, 0, dtype)
        self.bn3 = BatchNorm2d(out, zero_scale=True)
        self.downsample = None
        if stride != 1 or cin != out:
            self.downsample = nn.Sequential(
                _Conv(cin, out, 1, stride, 0, dtype), BatchNorm2d(out))

    def forward(self, x):
        y = F.relu_(self.bn1(self.conv1(x)))
        y = F.relu_(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu_(y.add_(residual))


class ResNet(nn.Module):
    """NCHW (channels_last) ResNet; returns f32 logits ``[B, num_classes]``."""

    def __init__(self, stage_sizes: Sequence[int], block_cls, num_classes: int,
                 num_filters: int = 64, dtype=torch.bfloat16, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.dtype = dtype
        self.conv1 = _Conv(3, num_filters, 7, 2, 3, dtype)
        self.bn1 = BatchNorm2d(num_filters)
        cin = num_filters
        for i, count in enumerate(self.stage_sizes):
            blocks = []
            for j in range(count):
                stride = 2 if i > 0 and j == 0 else 1
                block = block_cls(cin, num_filters * 2 ** i, stride, dtype)
                cin = num_filters * 2 ** i * block_cls.expansion
                blocks.append(block)
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
        self.fc = nn.Linear(cin, num_classes)
        self.reset_parameters(generator)
        self.to(device=device, memory_format=torch.channels_last)

    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        """Flax's initialisation, drawn from ``generator`` in module
        order."""
        for module in self.modules():
            if isinstance(module, _Conv):
                module.reset_from(generator)
            elif isinstance(module, BatchNorm2d):
                module.reset_parameters()
        _lecun_normal_(self.fc.weight, self.fc.in_features, generator)
        with torch.no_grad():
            self.fc.bias.zero_()

    def layers(self):
        return [getattr(self, f"layer{i + 1}")
                for i in range(len(self.stage_sizes))]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu_(self.bn1(self.conv1(x.to(self.dtype))))
        x = F.max_pool2d(x, 3, 2, 1)
        for layer in self.layers():
            x = layer(x)
        x = x.mean(dim=(2, 3))
        return self.fc(x.float())


def set_sync_group(model: nn.Module, group) -> None:
    """Take BatchNorm statistics over ``group``'s global batch (``None``:
    this process's batch)."""
    for module in model.modules():
        if isinstance(module, BatchNorm2d):
            module.process_group = group


resnet18 = partial(ResNet, (2, 2, 2, 2), BasicBlock)
resnet34 = partial(ResNet, (3, 4, 6, 3), BasicBlock)
resnet50 = partial(ResNet, (3, 4, 6, 3), BottleneckBlock)
resnet101 = partial(ResNet, (3, 4, 23, 3), BottleneckBlock)
resnet152 = partial(ResNet, (3, 8, 36, 3), BottleneckBlock)
RESNETS = {"resnet18": resnet18, "resnet34": resnet34, "resnet50": resnet50,
           "resnet101": resnet101, "resnet152": resnet152}
