"""Flax parameters → this package's modules, so that the two packages can
be run on identical weights.

The JAX package's encoder keeps its parameters as a nested dict
(``layer_<i>/attn/query/kernel`` …) with Flax layouts: dense kernels are
``[in, out]`` and the attention projections ``DenseGeneral`` kernels
``[hidden, heads, head_dim]``. ``torch_state_dict_from_flax`` maps such a
tree, as numpy arrays, onto the port's module names and layouts; the BERT
and GPT presets share it (causality is not a parameter). A switch-MoE
block's ``moe`` subtree (``router`` dense, ``w_in``/``b_in``/``w_out``/
``b_out`` in the port's layouts already) maps onto its ``moe`` module.
``vit_state_dict_from_flax`` maps a Flax ViT (the patch convolution's
kernel HWIO → OIHW, the same blocks, an f32 LayerNorm and head) and
``clip_state_dict_from_flax`` a Flax CLIP (the ResNet image tower with its
``batch_stats``, the encoder text tower, ``text_proj`` and
``logit_scale``).

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
           "resnet_state_dict_from_flax", "load_flax_resnet",
           "vit_state_dict_from_flax", "clip_state_dict_from_flax",
           "load_flax_vit", "load_flax_clip"]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _dense(prefix: str, tree: Mapping, out: dict) -> None:
    kernel = np.asarray(tree["kernel"], dtype=np.float32)
    out[f"{prefix}.weight"] = _t(kernel.reshape(kernel.shape[0], -1).T)
    out[f"{prefix}.bias"] = _t(np.asarray(tree["bias"]).reshape(-1))


def _norm(prefix: str, tree: Mapping, out: dict) -> None:
    out[f"{prefix}.weight"] = _t(tree["scale"])
    out[f"{prefix}.bias"] = _t(tree["bias"])


def _blocks(params: Mapping, out: dict, prefix: str = "") -> None:
    """Every ``layer_<i>`` encoder block of ``params`` → ``layers.<i>``."""
    layer_names = sorted(
        (k for k in params if k.startswith("layer_")),
        key=lambda k: int(k.split("_", 1)[1]),
    )
    for name in layer_names:
        i = int(name.split("_", 1)[1])
        layer = params[name]
        p = f"{prefix}layers.{i}"
        _norm(f"{p}.ln_attn", layer["ln_attn"], out)
        _norm(f"{p}.ln_mlp", layer["ln_mlp"], out)
        for proj in ("query", "key", "value", "out"):
            _dense(f"{p}.attn.{proj}", layer["attn"][proj], out)
        if "moe" in layer:
            moe = layer["moe"]
            _dense(f"{p}.moe.router", moe["router"], out)
            for leaf in ("w_in", "b_in", "w_out", "b_out"):
                out[f"{p}.moe.{leaf}"] = _t(moe[leaf])
        else:
            _dense(f"{p}.mlp_in", layer["mlp_in"], out)
            _dense(f"{p}.mlp_out", layer["mlp_out"], out)


def torch_state_dict_from_flax(params: Mapping,
                               prefix: str = "") -> dict[str, torch.Tensor]:
    """A Flax ``TransformerEncoder`` parameter tree (optionally wrapped in
    ``{"params": ...}``) → a ``state_dict`` for
    :class:`.transformer.TransformerEncoder`, its names under ``prefix``."""
    if "params" in params and "tok_embed" not in params:
        params = params["params"]
    out: dict[str, torch.Tensor] = {
        f"{prefix}tok_embed.weight": _t(params["tok_embed"]["embedding"]),
        f"{prefix}pos_embed": _t(params["pos_embed"]),
    }
    _blocks(params, out, prefix)
    _norm(f"{prefix}ln_final", params["ln_final"], out)
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


def vit_state_dict_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """A Flax ``ViT`` parameter tree (optionally wrapped in ``{"params":
    ...}``) → a ``state_dict`` for :class:`.vit.ViT`."""
    if "params" in params and "patch_embed" not in params:
        params = params["params"]
    out: dict[str, torch.Tensor] = {}
    _conv("patch_embed", params["patch_embed"], out)
    out["patch_embed.bias"] = _t(params["patch_embed"]["bias"])
    out["pos_embed"] = _t(params["pos_embed"])
    _blocks(params, out)
    _norm("ln_final", params["ln_final"], out)
    _dense("head", params["head"], out)
    return out


def load_flax_vit(model: torch.nn.Module, params: Mapping) -> None:
    """Copy a Flax ViT's parameters into ``model`` in place (strict)."""
    model.load_state_dict(vit_state_dict_from_flax(params), strict=True)


def clip_state_dict_from_flax(variables: Mapping,
                              image_stage_sizes) -> dict[str, torch.Tensor]:
    """A Flax ``CLIP``'s ``{"params": ..., "batch_stats": ...}`` → a
    ``state_dict`` for :class:`.clip.CLIP` whose image tower has
    ``image_stage_sizes`` stages."""
    params, stats = variables["params"], variables["batch_stats"]
    image = resnet_state_dict_from_flax(
        {"params": params["image_tower"],
         "batch_stats": stats["image_tower"]}, image_stage_sizes)
    out = {f"image_tower.{k}": v for k, v in image.items()}
    out.update(torch_state_dict_from_flax(params["text_tower"],
                                          prefix="text_tower."))
    _dense("text_proj", params["text_proj"], out)
    out["logit_scale"] = _t(params["logit_scale"])
    return out


def load_flax_clip(model: torch.nn.Module, variables: Mapping) -> None:
    """Copy a Flax CLIP's variables into ``model`` in place (strict)."""
    state = clip_state_dict_from_flax(variables,
                                      model.image_tower.stage_sizes)
    model.load_state_dict(state, strict=True)
