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

``pipelined_state_dict_from_flax`` maps the pipelined masked-LM's tree
(``blocks`` stacked ``[L, ...]``, ``tok_embed``, ``pos_embed``,
``ln_scale``, ``ln_bias``) onto :class:`.tasks.PipelinedMaskedLM`.

:func:`flax_leaf_view` is the other direction, for the layout plan
(``parallel/sharding.py``): a port parameter's Flax path, its Flax shape
and, for each Flax dimension, the port dimension it lies on (``None``
where a Flax dimension is split out of a port one and cannot shard
alone). :func:`flax_named_shapes` lists a model's parameters with what
the view needs.

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
           "pipelined_state_dict_from_flax", "flax_leaf_view",
           "flax_named_shapes",
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


def pipelined_state_dict_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """The pipelined masked-LM's Flax tree (optionally wrapped in
    ``{"params": ...}``): ``blocks`` (each leaf stacked ``[L, ...]``) and
    the top-level ``tok_embed [vocab, H]``, ``pos_embed``, ``ln_scale`` and
    ``ln_bias`` → a ``state_dict`` for :class:`.tasks.PipelinedMaskedLM`
    (``blocks.<module path>`` stacked ``[L, ...]`` in the port's layouts)."""
    if "params" in params and "blocks" not in params:
        params = params["params"]
    blocks = params["blocks"]
    layers = np.asarray(blocks["ln_attn"]["scale"]).shape[0]
    per_layer = [{} for _ in range(layers)]
    for i in range(layers):
        one = _tree_index(blocks, i)
        _blocks({"layer_0": one}, per_layer[i])
    out = {name.replace("layers.0.", "blocks.", 1):
           torch.stack([per_layer[i][name] for i in range(layers)])
           for name in per_layer[0]}
    for leaf in ("tok_embed", "pos_embed", "ln_scale", "ln_bias"):
        out[leaf] = _t(params[leaf])
    return out


def _tree_index(tree: Mapping, i: int):
    if isinstance(tree, Mapping):
        return {k: _tree_index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


_FLAX_NORM = {"weight": "scale", "bias": "bias"}


def _block_view(rest: str, shape: tuple, heads: int):
    """``(flax tail, flax shape, dims)`` of a parameter of one encoder
    block (``rest`` relative to the block)."""
    parts = rest.split(".")
    if parts[0] in ("ln_attn", "ln_mlp"):
        return f"{parts[0]}/{_FLAX_NORM[parts[1]]}", shape, (0,)
    if parts[0] == "attn":
        proj, leaf = parts[1], parts[2]
        if proj == "out":
            if leaf == "weight":
                return "attn/out/kernel", (shape[1], shape[0]), (1, 0)
            return "attn/out/bias", shape, (0,)
        hd = shape[0] // heads
        if leaf == "weight":
            # [heads*hd, in] ← [in, heads, hd]: heads are contiguous rows.
            return (f"attn/{proj}/kernel", (shape[1], heads, hd),
                    (1, 0, None))
        return f"attn/{proj}/bias", (heads, hd), (0, None)
    if parts[0] in ("mlp_in", "mlp_out"):
        if parts[1] == "weight":
            return f"{parts[0]}/kernel", (shape[1], shape[0]), (1, 0)
        return f"{parts[0]}/bias", shape, (0,)
    if parts[0] == "moe":
        if parts[1] == "router":
            if parts[2] == "weight":
                return "moe/router/kernel", (shape[1], shape[0]), (1, 0)
            return "moe/router/bias", shape, (0,)
        return f"moe/{parts[1]}", shape, tuple(range(len(shape)))
    raise KeyError(f"no Flax leaf for block parameter {rest!r}")


def _resnet_view(name: str, shape: tuple, stage_sizes, bottleneck: bool):
    """``(flax path, flax shape, dims)`` of a ResNet parameter (torchvision
    names; convolutions OIHW ← HWIO)."""
    def conv(path):
        o, i, kh, kw = shape
        return f"{path}/kernel", (kh, kw, i, o), (2, 3, 1, 0)

    def norm(path, leaf):
        return f"{path}/{_FLAX_NORM[leaf]}", shape, (0,)

    parts = name.split(".")
    if parts[0] == "conv1":
        return conv("conv_init")
    if parts[0] == "bn1":
        return norm("norm_init", parts[1])
    if parts[0] == "fc":
        if parts[1] == "weight":
            return "head/kernel", (shape[1], shape[0]), (1, 0)
        return "head/bias", shape, (0,)
    stage, block = int(parts[0][len("layer"):]) - 1, int(parts[1])
    flat = sum(stage_sizes[:stage]) + block
    prefix = (f"{'BottleneckBlock' if bottleneck else 'BasicBlock'}_{flat}")
    sub = parts[2]
    if sub == "downsample":
        if parts[3] == "0":
            return conv(f"{prefix}/conv_proj")
        return norm(f"{prefix}/norm_proj", parts[4])
    k = int(sub[-1]) - 1
    if sub.startswith("conv"):
        return conv(f"{prefix}/Conv_{k}")
    return norm(f"{prefix}/BatchNorm_{k}", parts[3])


def flax_leaf_view(name: str, shape: tuple, *, kind: str = "encoder",
                   heads: int = 1, stage_sizes=(), bottleneck: bool = False):
    """``(flax path, flax shape, dims)`` of the port parameter ``name`` of
    full shape ``shape`` in a model of ``kind`` (``encoder``, ``vit``,
    ``clip``, ``resnet`` or ``pipelined``): ``dims[i]`` is the port
    dimension Flax dimension ``i`` lies on. ``heads`` splits the attention
    projections' ``[heads*hd]`` rows; ``stage_sizes``/``bottleneck`` name a
    ResNet's blocks."""
    if kind == "resnet":
        return _resnet_view(name, shape, stage_sizes, bottleneck)
    if kind == "clip":
        tower, _, rest = name.partition(".")
        if tower == "image_tower":
            path, fshape, dims = _resnet_view(rest, shape, stage_sizes,
                                              bottleneck)
            return f"image_tower/{path}", fshape, dims
        if tower == "text_tower":
            path, fshape, dims = flax_leaf_view(rest, shape, heads=heads)
            return f"text_tower/{path}", fshape, dims
        if name == "text_proj.weight":
            return "text_proj/kernel", (shape[1], shape[0]), (1, 0)
        if name == "text_proj.bias":
            return "text_proj/bias", shape, (0,)
        if name == "logit_scale":
            return "logit_scale", shape, ()
        raise KeyError(f"no Flax leaf for CLIP parameter {name!r}")
    if kind == "pipelined":
        if name.startswith("blocks."):
            tail, fshape, dims = _block_view(name[len("blocks."):],
                                             shape[1:], heads)
            return (f"blocks/{tail}", (shape[0], *fshape),
                    (0, *(None if d is None else d + 1 for d in dims)))
        return name, shape, tuple(range(len(shape)))
    if name.startswith("layers."):
        _, i, rest = name.split(".", 2)
        tail, fshape, dims = _block_view(rest, shape, heads)
        return f"layer_{i}/{tail}", fshape, dims
    if name == "tok_embed.weight":
        return "tok_embed/embedding", shape, (0, 1)
    if name == "pos_embed":
        return "pos_embed", shape, tuple(range(len(shape)))
    if name.startswith("ln_final."):
        return f"ln_final/{_FLAX_NORM[name.split('.')[1]]}", shape, (0,)
    if kind == "vit":
        if name == "patch_embed.weight":
            o, i, kh, kw = shape
            return "patch_embed/kernel", (kh, kw, i, o), (2, 3, 1, 0)
        if name == "patch_embed.bias":
            return "patch_embed/bias", shape, (0,)
        if name == "head.weight":
            return "head/kernel", (shape[1], shape[0]), (1, 0)
        if name == "head.bias":
            return "head/bias", shape, (0,)
    raise KeyError(f"no Flax leaf for {kind} parameter {name!r}")


def flax_named_shapes(model: torch.nn.Module) -> list:
    """``(name, full shape, view attributes)`` of each parameter of a FULL
    port model, in ``named_parameters`` order, for
    :func:`..parallel.sharding.plan_model`."""
    from .clip import CLIP
    from .resnet import ResNet
    from .transformer import SelfAttention, TransformerEncoder
    from .vit import ViT

    heads = next((m.num_heads for m in model.modules()
                  if isinstance(m, SelfAttention)), 1)
    attrs: dict = {"heads": heads}
    resnet = (model if isinstance(model, ResNet) else
              model.image_tower if isinstance(model, CLIP) else None)
    if resnet is not None:
        attrs.update(stage_sizes=resnet.stage_sizes,
                     bottleneck=type(resnet.layer1[0]).__name__
                     .startswith("Bottleneck"))
    if isinstance(model, CLIP):
        attrs["kind"] = "clip"
    elif isinstance(model, ResNet):
        attrs["kind"] = "resnet"
    elif isinstance(model, ViT):
        attrs["kind"] = "vit"
    elif isinstance(model, TransformerEncoder):
        attrs["kind"] = "encoder"
    else:
        attrs["kind"] = "pipelined"
    return [(name, tuple(p.shape), attrs)
            for name, p in model.named_parameters()]
