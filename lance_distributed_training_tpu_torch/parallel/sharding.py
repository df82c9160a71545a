"""Where each parameter lives: the partition rules and the layout plan.

Counterpart of ``lance_distributed_training_tpu/parallel/sharding.py``. The
tables (``TRANSFORMER_RULES``, ``RESNET_RULES``, ``PIPELINE_RULES``), the
task-to-rules choice and the clamp logic (``_fit_spec``, ``_fsdp_spec``,
``partition_specs`` with its fsdp / zero / zero-level policy,
``grad_partition_specs``, ``batch_partition_spec``) are copied as they
are: a rule is a ``(regex, PartitionSpec)`` pair matched (``re.search``)
against the "/"-joined Flax path of a leaf, the first hit clamped to the
leaf and the mesh wins, and an unmatched leaf is replicated.

The JAX function walks a pytree; here the tree is flat, ``{path: shape}``,
and the mesh is ``{axis: size}``. The rules match Flax paths and Flax
layouts (``attn/query/kernel`` is ``[in, heads, head_dim]``), while the
port's modules have their own names and the ``[out, in]`` weight layout,
so :func:`plan_model` computes the plan per port parameter through
:func:`..models.convert.flax_leaf_view`, which names each parameter's
Flax path, Flax shape and the port dimension of each Flax dimension. The
result is, per parameter, the sharded port dimension and mesh axis of the
parameter, of its optimizer moments and of its gradient accumulator
(:class:`LeafPlan`), the same dimension over the same axis as the JAX
``partition_specs`` / ``state_shardings`` give the Flax leaf.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Optional, Sequence, Tuple

__all__ = [
    "P",
    "TRANSFORMER_RULES",
    "RESNET_RULES",
    "PIPELINE_RULES",
    "rules_for_task",
    "partition_specs",
    "grad_partition_specs",
    "batch_partition_spec",
    "LeafPlan",
    "plan_model",
    "plan_bytes",
    "MOMENTS_PATH",
    "ACCUM_PATH",
]


class P(tuple):
    """A partition spec: one mesh axis name (or ``None``, or a tuple of
    names) a dimension, trailing dimensions replicated."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


# (path-tail regex, spec). First match wins. Kernel layouts follow flax:
# DenseGeneral(features=(heads, head_dim)) kernel is [in, heads, head_dim];
# the attn out projection kernel is [H_in, H_out].
TRANSFORMER_RULES: Tuple[Tuple[str, P], ...] = (
    # Column-parallel QKV: shard the head axis.
    (r"attn/(query|key|value)/kernel$", P(None, "model", None)),
    (r"attn/(query|key|value)/bias$", P("model", None)),
    # Row-parallel output projection: contract over the (sharded) input.
    (r"attn/out/kernel$", P("model", None)),
    (r"attn/out/bias$", P()),
    # Column-parallel MLP in, row-parallel MLP out.
    (r"mlp_in/kernel$", P(None, "model")),
    (r"mlp_in/bias$", P("model")),
    (r"mlp_out/kernel$", P("model", None)),
    (r"mlp_out/bias$", P()),
    # Vocab-parallel embedding; the tied head inherits it.
    (r"tok_embed/embedding$", P("model", None)),
    # Expert parallelism: the MoE expert dim rides the same 'model' axis;
    # the router stays replicated (unmatched).
    (r"moe/w_(in|out)$", P("model", None, None)),
    (r"moe/b_(in|out)$", P("model", None)),
)

# The ResNets are pure data-parallel: every parameter replicated.
RESNET_RULES: Tuple[Tuple[str, P], ...] = ()

# Pipelined transformer (models/tasks masked_lm_pp): the stacked block
# params' leading layer axis shards over 'pipe'; everything else replicated.
PIPELINE_RULES: Tuple[Tuple[str, P], ...] = (
    (r"blocks/", P("pipe")),
)

# The Flax paths of a parameter's optimizer moments and of its gradient
# accumulator in a TrainState (``optax.MultiSteps`` keeps the accumulator
# under ``opt_state/acc_grads``), as ``partition_specs`` sees them.
MOMENTS_PATH = "opt_state/inner_opt_state/0/trace"
ACCUM_PATH = "opt_state/acc_grads"


def rules_for_task(task_name: str,
                   model_name: Optional[str] = None) -> Tuple[Tuple[str, P], ...]:
    """Default partition rules per task family (and, for classification,
    per model family: ViT layers are transformer blocks, ResNets are DP).
    ``causal_lm`` gets none: it stays replicated under the model axis."""
    if task_name == "masked_lm_pp":
        return PIPELINE_RULES
    if task_name in ("masked_lm", "contrastive"):
        return TRANSFORMER_RULES
    if task_name == "classification" and (model_name or "").startswith("vit"):
        return TRANSFORMER_RULES
    return RESNET_RULES


def _fit_spec(spec: P, shape: Sequence[int], mesh: dict) -> P:
    """Clamp a spec to this leaf/mesh: drop axes missing from the mesh, of
    size 1, not dividing the dimension, or beyond the leaf's rank."""
    if len(spec) > len(shape):
        return P()
    out = []
    for dim, axis in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if axis is None:
            out.append(None)
            continue
        names = axis if isinstance(axis, tuple) else (axis,)
        sizes = []
        ok = True
        for name in names:
            if name not in mesh or mesh[name] == 1:
                ok = False
                break
            sizes.append(mesh[name])
        if not ok or dim % int(math.prod(sizes)) != 0:
            out.append(None)
        else:
            out.append(axis)
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def _fsdp_spec(shape: Sequence[int], mesh: dict, axis: str,
               min_size: int) -> Optional[P]:
    """Fully-sharded spec for one leaf: shard its largest ``axis``-divisible
    dimension over ``axis``; None when the leaf is too small, the axis is
    absent/trivial, or no dimension divides."""
    if axis not in mesh or mesh[axis] == 1:
        return None
    if not shape or int(math.prod(shape)) < min_size:
        return None
    size = mesh[axis]
    for d in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if shape[d] % size == 0:
            out = [None] * (d + 1)
            out[d] = axis
            return P(*out)
    return None


def partition_specs(leaves: dict, rules: Sequence[Tuple[str, P]], mesh: dict,
                    *, fsdp_axis: Optional[str] = None,
                    fsdp_min_size: int = 16384,
                    zero_axis: Optional[str] = None,
                    zero_paths: Sequence[str] = ("opt_state",),
                    zero_level: int = 1,
                    grads_paths: Sequence[str] = ("acc_grads",)) -> dict:
    """``{path: shape}`` → ``{path: P}``, the JAX function's policy: the
    first rule whose pattern ``re.search``-es the path, clamped by
    :func:`_fit_spec`, else replicated. A leaf the rules leave replicated
    shards its largest divisible dimension over ``fsdp_axis`` (params and
    optimizer state alike), or with ``zero_axis`` only when it lies under
    ``zero_paths``: at ``zero_level`` 1 the moments only (not a leaf
    crossing a ``grads_paths`` segment, the accumulator), at level 2 the
    accumulator too. Leaves under ``fsdp_min_size`` elements stay
    replicated."""
    compiled = [(re.compile(pat), spec) for pat, spec in rules]

    def _crosses(name: str, segments: Sequence[str]) -> bool:
        parts = name.split("/")
        return any(seg in parts for seg in segments)

    def assign(name, shape):
        spec = P()
        for pat, s in compiled:
            if pat.search(name):
                spec = _fit_spec(s, shape, mesh)
                break
        if not any(a is not None for a in spec):
            if fsdp_axis is not None:
                fs = _fsdp_spec(shape, mesh, fsdp_axis, fsdp_min_size)
                if fs is not None:
                    return fs
            if zero_axis is not None and any(
                name == p or name.startswith(p + "/") for p in zero_paths
            ):
                is_grads = _crosses(name, grads_paths)
                if (not is_grads) or zero_level >= 2:
                    zs = _fsdp_spec(shape, mesh, zero_axis, fsdp_min_size)
                    if zs is not None:
                        return zs
        return spec

    return {name: assign(name, tuple(shape)) for name, shape in leaves.items()}


def grad_partition_specs(leaves: dict, mesh: dict, *, axis: str = "data",
                         min_size: int = 16384) -> dict:
    """ZeRO-2's in-flight half: each gradient leaf sharded on its largest
    ``axis``-divisible dimension (the accumulator's and the moments'
    layout under ``zero_level >= 2``); small leaves stay replicated."""
    out = {}
    for name, shape in leaves.items():
        spec = _fsdp_spec(tuple(shape), mesh, axis, min_size)
        out[name] = spec if spec is not None else P()
    return out


def batch_partition_spec(ndim: int, *, data_axis: str = "data",
                         seq_axis: Optional[str] = None) -> P:
    """Spec for one batch leaf: leading dim over ``data``; rank-2 token
    arrays additionally sharded over ``seq_axis`` when given."""
    if seq_axis is not None and ndim == 2:
        return P(data_axis, seq_axis)
    return P(data_axis)


# ------------------------------------------------------- the port's plan


@dataclasses.dataclass(frozen=True)
class LeafPlan:
    """One port parameter's layout. Each of ``param``, ``moment`` and
    ``accum`` is ``None`` (replicated) or ``(axis, dim)``: the mesh axis
    that shards it and the PORT dimension it shards (contiguous blocks in
    axis-index order). ``flax_path`` and the three Flax specs are what the
    JAX plan gives the same leaf."""

    name: str
    shape: tuple  # the full (unsharded) port shape
    flax_path: str
    flax_shape: tuple
    param: Optional[tuple]
    moment: Optional[tuple]
    accum: Optional[tuple]
    specs: tuple  # (param P, moment P, accum P) on the Flax leaf

    def local_shape(self, which: str, mesh: dict) -> tuple:
        """The shape a rank holds of ``which`` (param, moment, accum)."""
        layout = getattr(self, which)
        shape = list(self.shape)
        if layout is not None:
            axis, dim = layout
            shape[dim] //= mesh[axis]
        return tuple(shape)


def _port_layout(spec: P, dims: Sequence[Optional[int]]) -> Optional[tuple]:
    """The ``(axis, port dim)`` of a Flax spec with at most one sharded
    dimension, through ``dims`` (Flax dim → port dim)."""
    sharded = [(d, a) for d, a in enumerate(spec) if a is not None]
    if not sharded:
        return None
    if len(sharded) > 1:
        raise ValueError(f"spec {spec} shards more than one dimension")
    d, axis = sharded[0]
    if isinstance(axis, tuple):
        raise ValueError(f"spec {spec} shards over several axes")
    port_dim = dims[d]
    if port_dim is None:
        raise ValueError(f"spec {spec} shards a dimension the port lacks")
    return axis, port_dim


def plan_model(named_shapes, rules, mesh: dict, *, fsdp: bool = False,
               zero_level: int = 0, fsdp_min_size: int = 16384,
               view=None) -> dict:
    """``{port name: LeafPlan}`` for ``named_shapes`` (``(name, shape,
    attrs)`` of the FULL model, as :func:`..models.convert.flax_named_shapes`
    gives them) under ``rules`` on ``mesh`` (``{axis: size}``), with
    ``fsdp`` over the data axis or ZeRO at ``zero_level`` (1 or 2; 0 off),
    as the JAX trainer asks ``state_shardings`` for them."""
    if view is None:
        from ..models.convert import flax_leaf_view as view
    views = {}
    for name, shape, attrs in named_shapes:
        path, flax_shape, dims = view(name, tuple(shape), **attrs)
        views[name] = (tuple(shape), path, tuple(flax_shape), dims)
    leaves = {}
    for name, (_, path, flax_shape, _) in views.items():
        leaves[f"params/{path}"] = flax_shape
        leaves[f"{MOMENTS_PATH}/{path}"] = flax_shape
        leaves[f"{ACCUM_PATH}/{path}"] = flax_shape
    specs = partition_specs(
        leaves, rules, mesh, fsdp_axis="data" if fsdp else None,
        fsdp_min_size=fsdp_min_size,
        zero_axis="data" if zero_level else None,
        zero_level=zero_level or 1)
    plan = {}
    for name, (shape, path, flax_shape, dims) in views.items():
        triple = (specs[f"params/{path}"], specs[f"{MOMENTS_PATH}/{path}"],
                  specs[f"{ACCUM_PATH}/{path}"])
        plan[name] = LeafPlan(name, shape, path, flax_shape,
                              *(_port_layout(s, dims) for s in triple),
                              specs=triple)
    return plan


def plan_bytes(plan: dict, mesh: dict, *, moments: int, accum: bool,
               itemsize: int = 4) -> dict:
    """The bytes a rank holds under ``plan``: its parameters, its
    ``moments`` optimizer tensors a parameter (SGD with momentum 1, AdamW
    2) and, with ``accum``, its gradient accumulator."""
    def size(leaf, which):
        return math.prod(leaf.local_shape(which, mesh)) * itemsize

    params = sum(size(leaf, "param") for leaf in plan.values())
    state = moments * sum(size(leaf, "moment") for leaf in plan.values())
    acc = sum(size(leaf, "accum") for leaf in plan.values()) if accum else 0
    return {"params": params, "optimizer_state": state, "accumulator": acc,
            "total": params + state + acc}
