"""Flax parameters → this package's modules, so that the two packages can
be run on identical weights.

The JAX package's encoder keeps its parameters as a nested dict
(``layer_<i>/attn/query/kernel`` …) with Flax layouts: dense kernels are
``[in, out]`` and the attention projections ``DenseGeneral`` kernels
``[hidden, heads, head_dim]``. ``torch_state_dict_from_flax`` maps such a
tree, as numpy arrays, onto the port's module names and layouts; the BERT
and GPT presets share it (causality is not a parameter).

``resnet_state_dict_from_flax`` maps a Flax ResNet's ``{"params",
"batch_stats"}`` onto :class:`.resnet.ResNet`, whose names are
torchvision's: conv kernels HWIO → OIHW, BatchNorm ``scale``/``bias``/
``mean``/``var`` → ``weight``/``bias``/``running_mean``/``running_var``, the
dense head ``[in, out]`` → ``fc`` ``[out, in]``. It is the inverse of the
JAX package's ``torchvision_resnet_to_flax``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

__all__ = ["torch_state_dict_from_flax", "load_flax_params",
           "resnet_state_dict_from_flax", "load_flax_resnet"]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _dense(prefix: str, tree: Mapping, out: dict) -> None:
    kernel = np.asarray(tree["kernel"], dtype=np.float32)
    out[f"{prefix}.weight"] = _t(kernel.reshape(kernel.shape[0], -1).T)
    out[f"{prefix}.bias"] = _t(np.asarray(tree["bias"]).reshape(-1))


def _norm(prefix: str, tree: Mapping, out: dict) -> None:
    out[f"{prefix}.weight"] = _t(tree["scale"])
    out[f"{prefix}.bias"] = _t(tree["bias"])


def torch_state_dict_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """A Flax ``TransformerEncoder`` parameter tree (optionally wrapped in
    ``{"params": ...}``) → a ``state_dict`` for
    :class:`.transformer.TransformerEncoder`. MoE blocks are not ported."""
    if "params" in params and "tok_embed" not in params:
        params = params["params"]
    out: dict[str, torch.Tensor] = {
        "tok_embed.weight": _t(params["tok_embed"]["embedding"]),
        "pos_embed": _t(params["pos_embed"]),
    }
    layer_names = sorted(
        (k for k in params if k.startswith("layer_")),
        key=lambda k: int(k.split("_", 1)[1]),
    )
    for name in layer_names:
        i = int(name.split("_", 1)[1])
        layer = params[name]
        if "moe" in layer:
            raise NotImplementedError("MoE blocks are not yet ported")
        p = f"layers.{i}"
        _norm(f"{p}.ln_attn", layer["ln_attn"], out)
        _norm(f"{p}.ln_mlp", layer["ln_mlp"], out)
        for proj in ("query", "key", "value", "out"):
            _dense(f"{p}.attn.{proj}", layer["attn"][proj], out)
        _dense(f"{p}.mlp_in", layer["mlp_in"], out)
        _dense(f"{p}.mlp_out", layer["mlp_out"], out)
    _norm("ln_final", params["ln_final"], out)
    return out


def load_flax_params(model: torch.nn.Module, params: Mapping) -> None:
    """Copy a Flax parameter tree into ``model`` in place (strict: every
    parameter of the model must be present, and nothing else)."""
    state = torch_state_dict_from_flax(params)
    model.load_state_dict(state, strict=True)


def _conv(prefix: str, tree: Mapping, out: dict) -> None:
    kernel = np.asarray(tree["kernel"], dtype=np.float32)  # HWIO
    out[f"{prefix}.weight"] = _t(np.transpose(kernel, (3, 2, 0, 1)))


def _batch_norm(prefix: str, params: Mapping, stats: Mapping,
                out: dict) -> None:
    out[f"{prefix}.weight"] = _t(params["scale"])
    out[f"{prefix}.bias"] = _t(params["bias"])
    out[f"{prefix}.running_mean"] = _t(stats["mean"])
    out[f"{prefix}.running_var"] = _t(stats["var"])


def resnet_state_dict_from_flax(variables: Mapping,
                                stage_sizes) -> dict[str, torch.Tensor]:
    """A Flax ResNet's ``{"params": ..., "batch_stats": ...}`` (numpy
    leaves) → a ``state_dict`` for :class:`.resnet.ResNet` with
    ``stage_sizes`` stages. Flax blocks are numbered in order over all
    stages (``BottleneckBlock_<k>``); their ``Conv_<i>``/``BatchNorm_<i>``
    are torchvision's ``conv<i+1>``/``bn<i+1>``."""
    params, stats = variables["params"], variables["batch_stats"]
    out: dict[str, torch.Tensor] = {}
    _conv("conv1", params["conv_init"], out)
    _batch_norm("bn1", params["norm_init"], stats["norm_init"], out)
    block_names = [k for k in params
                   if k.startswith(("BasicBlock_", "BottleneckBlock_"))]
    block_names.sort(key=lambda k: int(k.rsplit("_", 1)[1]))
    if len(block_names) != sum(stage_sizes):
        raise ValueError(f"{len(block_names)} Flax blocks for stages "
                         f"{tuple(stage_sizes)}")
    flat = 0
    for stage, count in enumerate(stage_sizes):
        for block in range(count):
            name = block_names[flat]
            bp, bs = params[name], stats[name]
            prefix = f"layer{stage + 1}.{block}"
            convs = sorted(k for k in bp if k.startswith("Conv_"))
            for i in range(len(convs)):
                _conv(f"{prefix}.conv{i + 1}", bp[f"Conv_{i}"], out)
                _batch_norm(f"{prefix}.bn{i + 1}", bp[f"BatchNorm_{i}"],
                            bs[f"BatchNorm_{i}"], out)
            if "conv_proj" in bp:
                _conv(f"{prefix}.downsample.0", bp["conv_proj"], out)
                _batch_norm(f"{prefix}.downsample.1", bp["norm_proj"],
                            bs["norm_proj"], out)
            flat += 1
    out["fc.weight"] = _t(np.asarray(params["head"]["kernel"]).T)
    out["fc.bias"] = _t(params["head"]["bias"])
    return out


def load_flax_resnet(model: torch.nn.Module, variables: Mapping) -> None:
    """Copy a Flax ResNet's variables into ``model`` in place (strict)."""
    state = resnet_state_dict_from_flax(variables, model.stage_sizes)
    model.load_state_dict(state, strict=True)
