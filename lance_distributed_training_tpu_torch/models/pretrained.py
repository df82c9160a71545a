"""torchvision pretrained weights → the port's ResNet (transfer learning).

Counterpart of ``lance_distributed_training_tpu/models/pretrained.py``. The
reference fine-tunes a pretrained torchvision ResNet-50 with a fresh ``fc``
head (``modelling/classification.py:6-10`` of the reference). The port's
:class:`~.resnet.ResNet` already uses torchvision's names and layouts
(``conv1``, ``bn1``, ``layer<i>.<j>.conv<k>``/``bn<k>``,
``downsample.0/1``, ``fc``), so the mapping is the identity; what this
module keeps of the JAX importer is its checks, with its messages:

* every model tensor must be in the checkpoint (``KeyError``);
* every shape must be equal (``ValueError``; the shapes are reported in
  the JAX model's layout, HWIO for a convolution, as the JAX importer
  reports them after its transpose);
* no checkpoint key may be left unmapped except ``num_batches_tracked``,
  which the port's BatchNorm does not have (``ValueError``);
* ``fc`` is imported only when its shape matches the model's; otherwise
  the model keeps its seeded fresh head, the reference's fc swap.

Values are copied into the existing parameters and buffers in place, so
that their device, ``channels_last`` layout and the optimizer's references
survive. Nothing is downloaded: a checkpoint is a local ``torch.save``
file.
"""

from __future__ import annotations

import os
from typing import Mapping

import torch

__all__ = ["load_torch_state_dict", "load_torchvision_resnet"]

# torchvision stage sizes (models/resnet.py's constructors).
_STAGES = {
    "resnet18": (2, 2, 2, 2),
    "resnet34": (3, 4, 6, 3),
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
    "resnet152": (3, 8, 36, 3),
}


def load_torch_state_dict(path: str) -> dict[str, torch.Tensor]:
    """Read a ``torch.save``'d checkpoint into ``{key: float32 tensor}``
    on the CPU.

    Accepts a bare ``state_dict`` and the ``{"state_dict": ...}`` /
    ``{"model": ...}`` wrappers, and strips ``module.`` (DDP) prefixes."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"pretrained checkpoint not found: {path}")
    obj = torch.load(path, map_location="cpu", weights_only=True)
    for wrapper in ("state_dict", "model"):
        if isinstance(obj, dict) and wrapper in obj and isinstance(
                obj[wrapper], dict):
            obj = obj[wrapper]
    out = {}
    for key, value in obj.items():
        if key.startswith("module."):
            key = key[len("module."):]
        if isinstance(value, torch.Tensor):
            out[key] = value.detach().to(torch.float32)
    return out


def _jax_layout(key: str, shape) -> tuple:
    """``shape`` as the JAX importer reports it: a convolution's OIHW as
    HWIO."""
    shape = tuple(shape)
    if key.endswith(".weight") and len(shape) == 4:
        return (shape[2], shape[3], shape[1], shape[0])
    return shape


def load_torchvision_resnet(model: torch.nn.Module,
                            state_dict: Mapping[str, torch.Tensor],
                            model_name: str = "resnet50") -> None:
    """Copy a torchvision ResNet ``state_dict`` into ``model`` (a
    :class:`~.resnet.ResNet`) in place, with the JAX importer's coverage
    rules (the module's docstring). ``fc`` is imported only when its shape
    matches; otherwise the model's fresh head stays."""
    if model_name not in _STAGES:
        raise ValueError(
            f"pretrained import supports {sorted(_STAGES)}; got {model_name!r}"
        )
    used = set()
    targets = []
    fc_w = state_dict.get("fc.weight")
    import_head = (fc_w is not None
                   and tuple(fc_w.shape) == tuple(model.fc.weight.shape))
    for key, target in model.state_dict(keep_vars=True).items():
        if key.startswith("fc.") and not import_head:
            continue
        if key not in state_dict:
            raise KeyError(f"pretrained checkpoint is missing {key!r}")
        value = state_dict[key]
        if tuple(value.shape) != tuple(target.shape):
            raise ValueError(
                f"{key!r}: checkpoint shape "
                f"{_jax_layout(key, value.shape)} != model shape "
                f"{_jax_layout(key, target.shape)} (after layout transform)"
            )
        used.add(key)
        targets.append((target, value))
    if not import_head:
        # A fresh head: its keys count as consumed, so coverage stays clean.
        used.update(k for k in ("fc.weight", "fc.bias") if k in state_dict)
    leftover = sorted(k for k in state_dict if k not in used
                      and not k.endswith("num_batches_tracked"))
    if leftover:
        raise ValueError(
            f"pretrained checkpoint has {len(leftover)} unmapped keys "
            f"(wrong architecture for {model_name}?): {leftover[:8]}..."
        )
    with torch.no_grad():
        for target, value in targets:
            target.copy_(value.to(device=target.device, dtype=target.dtype))
