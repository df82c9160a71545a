"""Applying the layout plan: the sharded model and the sharded train state.

The plan (``parallel/sharding.plan_model``) names, for each parameter,
the mesh axis and port dimension that split the parameter, its optimizer
moments and its gradient accumulator. This module lays a model and its
train state out accordingly; every layout is a re-layout of the same
values, and the losses track the data-parallel run's.

* ``'model'`` (tensor and expert parallelism) and ``'pipe'`` (the
  pipeline's stacked blocks): :func:`shard_model_` keeps this rank's
  contiguous block of the parameter in the module and tells the modules
  (attention heads, MLP units, the vocabulary, the experts, the pipeline
  stage) which group computes the rest. The optimizer updates the local
  block, whose moments and accumulator are local too. A degree that
  divides the width but not the heads splits an attention's ``out``
  alone (JAX's ``_fit_spec`` keeps the heads whole): its ``query``,
  ``key`` and ``value`` are replicated over ``'model'`` like a
  LayerNorm, their gradients alike on every model rank.
* ``'data'`` under ``fsdp``: :class:`ShardedState` keeps each large
  parameter's block (a leaf of at least 16384 elements, its largest
  divisible dimension, as JAX ``_fsdp_spec``) as the persistent tensor the
  optimizer updates, and gathers the whole parameters unit by unit, as
  FSDP2 does: a unit is an encoder block, a ResNet block or a ViT block
  (:func:`fsdp_units`), and the root unit is every other large leaf (the
  embeddings, the tied head, the final norms and projections). The root
  is gathered for the whole micro-step. A unit's leaves are all-gathered
  into the module's parameters before its forward and freed after it
  (the storage resized to nothing, so that what autograd saved of them
  refills with them); they are gathered again before its backward (a
  hook on its output's gradient), which also covers ``--remat``'s
  recomputation, and once its gradients are complete they are
  reduce-scattered into the blocks' layout and freed. The root's
  gradients, the tied ``tok_embed``'s two contributions among them, are
  reduce-scattered after the whole backward. A rank thus holds at most
  the root and two units whole, of the parameters and of the unscattered
  gradients; :attr:`ShardedState.peaks` counts both.
* ``'data'`` under ZeRO: the parameters stay whole in the module; the
  optimizer updates a view of this rank's block of each large parameter,
  so its moments are blocks. Level 1 keeps the accumulator whole (each
  micro-step's gradients are all-reduced into it) and level 2 keeps its
  block (each micro-step's gradients are reduce-scattered into it, JAX's
  ``grad_partition_specs`` constraint). After the update each rank's
  block is all-gathered into every rank's parameter.

Replicated gradients are averaged over the batch group (the data and
sequence ranks: those that hold the same model shard and pipeline stage),
as DDP averages them. The global gradient norm of ``--log_grad_norm`` and
of clipping is the norm of the whole logical gradient: each split leaf's
squared norm is summed over its group first. :meth:`ShardedState.full_state`
gathers the whole state in the data-parallel format (the module's
``state_dict`` names, the optimizer's ``state_dict``, the accumulator
list) on every rank; :meth:`ShardedState.host_state` gathers the same
format to rank 0's host one leaf at a time (a checkpoint: no rank's
device holds more than its blocks and one gathered leaf), and
:meth:`ShardedState.load_full_state` cuts a rank's blocks from it on the
host and moves only the blocks.
"""

from __future__ import annotations

import dataclasses
import weakref
from functools import partial
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from . import comm

__all__ = ["shard_model_", "ShardedState", "block_of", "fsdp_units"]


def block_of(t: torch.Tensor, dim: int, index: int, parts: int):
    """Block ``index`` of ``parts`` of ``t`` along ``dim`` (a view)."""
    n = t.shape[dim] // parts
    return t.narrow(dim, index * n, n)


def _owner(module: nn.Module, name: str):
    *path, leaf = name.split(".")
    for part in path:
        module = getattr(module, part)
    return module, leaf


def _split(plan: dict, names, axis: str) -> bool:
    """Whether the plan splits every one of ``names`` over ``axis``;
    raises when it splits some of them only (the port's modules compute
    either all of a layer's split or none of it)."""
    hits = [plan[n].param is not None and plan[n].param[0] == axis
            for n in names]
    if any(hits) and not all(hits):
        raise NotImplementedError(
            f"the plan splits only some of {list(names)} over {axis!r}; "
            "the port splits a layer's parameters together")
    return all(hits)


def _attention_split(plan: dict, prefix: str) -> Optional[str]:
    """How the plan splits an attention's projections over ``'model'``:
    ``"heads"`` (all four: ``query``, ``key`` and ``value`` by heads,
    ``out`` on its input), ``"out"`` (``out`` alone, on its input: JAX's
    rules at a degree that divides the width but not the heads) or
    ``None``. Any other partial plan raises, naming the leaves it splits;
    no rule of JAX's produces one."""
    names = [f"{prefix}{p}.weight" for p in ("query", "key", "value", "out")]
    split = [n for n in names if plan[n].param is not None
             and plan[n].param[0] == "model"]
    if not split:
        return None
    if split == names:
        return "heads"
    if split == names[3:] and plan[names[3]].param == ("model", 1):
        return "out"
    raise NotImplementedError(
        f"the plan splits {split} of {names} over 'model'; the port splits "
        "all four (by heads) or out alone (on its input)")


def shard_model_(model: nn.Module, plan: dict, topo) -> None:
    """Keep this rank's block of every parameter ``plan`` splits over
    ``'model'`` or ``'pipe'`` (``model`` is the FULL model, built alike on
    every rank), and set the modules' groups (``topo``:
    :class:`.comm.Topology`)."""
    from ..models.moe import MoEMLP
    from ..models.tasks import PipelinedMaskedLM
    from ..models.transformer import (EncoderBlock, SelfAttention,
                                      TransformerEncoder)

    for name, leaf in plan.items():
        if leaf.param is None or leaf.param[0] not in ("model", "pipe"):
            continue
        axis, dim = leaf.param
        owner, attr = _owner(model, name)
        full = getattr(owner, attr)
        local = block_of(full.data, dim, topo.index[axis],
                         topo.size[axis]).clone()
        setattr(owner, attr, nn.Parameter(local))
    mp = topo.size["model"]
    group = topo.group["model"]
    for mname, module in model.named_modules():
        prefix = f"{mname}." if mname else ""
        if isinstance(module, SelfAttention):
            split = _attention_split(plan, prefix)
            if split == "heads":
                module.tp_group = group
                module.num_heads //= mp
            elif split == "out":
                module.out_group = group
        elif isinstance(module, EncoderBlock) and module.moe is None:
            if _split(plan, [f"{prefix}mlp_in.weight",
                             f"{prefix}mlp_out.weight"], "model"):
                module.tp_group = group
        elif isinstance(module, MoEMLP):
            if _split(plan, [f"{prefix}{p}" for p in
                             ("w_in", "b_in", "w_out", "b_out")], "model"):
                module.expert_group = group
                module.expert_start = (topo.index["model"]
                                       * module.w_in.shape[0])
        if isinstance(module, TransformerEncoder):
            if _split(plan, [f"{prefix}tok_embed.weight"], "model"):
                module.vocab_group = group
                module.vocab_start = (topo.index["model"]
                                      * module.tok_embed.weight.shape[0])
        if isinstance(module, PipelinedMaskedLM):
            names = [f"{prefix}blocks.{n}"
                     for n, _ in module.blocks.named_parameters()]
            if _split(plan, names, "pipe"):
                module.pipe_group = topo.group["pipe"]
                module.pipe_ranks = topo.ranks["pipe"]
                module.stage = topo.index["pipe"]
            module.data = topo.size["data"]


def fsdp_units(model: nn.Module) -> list:
    """``[(prefix, module)]``: the modules whose large leaves ``fsdp``
    gathers together, in the model's module order: each encoder block
    (the text encoders' and the ViTs') and each ResNet block (a CLIP's
    towers included). Everything else is the root unit."""
    from ..models.resnet import BasicBlock, BottleneckBlock
    from ..models.transformer import EncoderBlock

    return [(f"{name}.", module) for name, module in model.named_modules()
            if isinstance(module, (EncoderBlock, BasicBlock,
                                   BottleneckBlock))]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _hook(ref, method: str, *args):
    """A :class:`ShardedState` hook, through the weak reference ``ref``
    (a no-op once the state is gone)."""
    state = ref()
    return None if state is None else getattr(state, method)(*args)


@dataclasses.dataclass(eq=False)
class _Unit:
    """The fsdp leaves gathered together (``module`` ``None``: the
    root), with their indices among the state's entries."""
    module: Optional[nn.Module]
    entries: list
    indices: list
    nbytes: int
    gathered: bool = False
    ready: int = 0  # leaves whose gradient of this backward is complete


@dataclasses.dataclass(eq=False)
class _Entry:
    name: str
    param: nn.Parameter  # the module's (a local block under model/pipe)
    master: torch.Tensor  # what the optimizer updates
    master_layout: Optional[tuple]  # (axis, dim) of master, or None
    shard: bool  # fsdp: master is a block of the data axis
    view: bool  # zero: master is a view of param's block
    reduce_layout: Optional[tuple]  # layout of a micro-step's gradient
    accum_layout: Optional[tuple]


class ShardedState:
    """The train state of ``model`` (already :func:`shard_model_`-ed)
    under ``plan`` on ``topo``, with ``grad_accum`` micro-steps an
    update. Build the optimizer over :attr:`masters` (in the module's
    parameter order, as a data-parallel run builds it over
    ``model.parameters()``)."""

    def __init__(self, model: nn.Module, plan: dict, topo,
                 grad_accum: int = 1):
        self.model, self.plan, self.topo = model, plan, topo
        self.grad_accum = max(int(grad_accum), 1)
        self.entries: list[_Entry] = []
        for name, p in model.named_parameters():
            leaf = plan[name]
            layout = leaf.param
            shard = layout is not None and layout[0] == "data"
            moment = leaf.moment
            view = (not shard and moment is not None
                    and moment[0] == "data")
            if shard:
                master = nn.Parameter(self._block(p.data, layout).clone())
                p.untyped_storage().resize_(0)
                master_layout = layout
            elif view:
                master = self._block(p.data, moment)
                master_layout = moment
            else:
                master, master_layout = p, layout
            accum = leaf.accum
            if self.grad_accum > 1:
                reduce_layout = accum
            else:
                reduce_layout = master_layout
            self.entries.append(_Entry(name, p, master, master_layout, shard,
                                       view, reduce_layout, accum))
        self.masters = [e.master for e in self.entries]
        self.peaks = {"gathered_params": 0, "whole_grads": 0,
                      "checkpoint_leaf": 0}
        self._live = {"gathered_params": 0, "whole_grads": 0}
        self._reduced: dict = {}  # entry index -> its reduced gradient
        self._counted: set = set()  # entries whose whole gradient is live
        self.units: list = []
        self.root: Optional[_Unit] = None
        self._active = False
        if any(e.shard for e in self.entries):
            self._build_units()

    # ----------------------------------------------------------- layouts

    def _block(self, t: torch.Tensor, layout):
        axis, dim = layout
        return block_of(t, dim, self.topo.index[axis], self.topo.size[axis])

    def _gather(self, t: torch.Tensor, layout) -> torch.Tensor:
        if layout is None or self.topo.size[layout[0]] == 1:
            return t
        axis, dim = layout
        return comm.all_gather(t, self.topo.group[axis], dim)

    def _accum_held(self, e: _Entry) -> Optional[tuple]:
        """The layout of the accumulator a rank holds: a data-axis block
        where the plan splits it so, else the module parameter's."""
        if e.accum_layout is not None and e.accum_layout[0] == "data":
            return e.accum_layout
        return self.plan[e.name].param

    def new_accum(self) -> list:
        """Zeroed accumulators, each in its held layout: a data-axis block
        is the master's shape, anything else the module parameter's."""
        out = []
        for e in self.entries:
            held = self._accum_held(e)
            data = held is not None and held[0] == "data"
            out.append(torch.zeros(e.master.shape if data else e.param.shape,
                                   dtype=e.master.dtype,
                                   device=e.master.device))
        return out

    # ------------------------------------------------------------ a step

    # ------------------------------------------------------ fsdp units

    def _build_units(self) -> None:
        """The units of :func:`fsdp_units` that hold fsdp leaves, with
        their hooks, and the root of the rest."""
        index = {e.name: i for i, e in enumerate(self.entries)}
        taken = set()
        # The hooks reach this state through a weak reference and name
        # units by index: a parameter's hook lives in the tensor's C++
        # autograd metadata, where a strong reference back to the model
        # would make a cycle the garbage collector cannot see.
        ref = weakref.ref(self)
        for prefix, module in fsdp_units(self.model):
            mine = [index[prefix + n] for n, _ in module.named_parameters()
                    if self.entries[index[prefix + n]].shard]
            if not mine:
                continue
            taken.update(mine)
            u = len(self.units)
            module.register_forward_pre_hook(
                partial(_hook, ref, "_pre_forward", u))
            module.register_forward_hook(
                partial(_hook, ref, "_post_forward", u))
            self.units.append(self._unit(module, mine))
        self.root = self._unit(None, [i for i, e in enumerate(self.entries)
                                      if e.shard and i not in taken])
        owner = {i: u for u, unit in enumerate(self.units)
                 for i in unit.indices}
        for i, e in enumerate(self.entries):
            if e.shard:
                e.param.register_post_accumulate_grad_hook(
                    partial(_hook, ref, "_grad_ready", owner.get(i), i))

    def _unit(self, module, indices: list) -> _Unit:
        entries = [self.entries[i] for i in indices]
        return _Unit(module, entries, indices,
                     sum(_nbytes(e.param) for e in entries))

    def _count(self, key: str, delta: int) -> None:
        self._live[key] += delta
        self.peaks[key] = max(self.peaks[key], self._live[key])

    def _fill(self, unit: _Unit) -> None:
        """The unit's whole leaves back in the module's parameters: each
        block all-gathered into the parameter's own storage, so that the
        tensors autograd saved of it hold the values again."""
        if unit.gathered:
            return
        for e in unit.entries:
            full = self._gather(e.master.data, e.master_layout)
            storage = e.param.untyped_storage()
            if storage.nbytes() != _nbytes(full):
                storage.resize_(_nbytes(full))
            e.param.data.copy_(full)
            del full
        unit.gathered = True
        self._count("gathered_params", unit.nbytes)

    def _free(self, unit: _Unit) -> None:
        if not unit.gathered:
            return
        for e in unit.entries:
            e.param.untyped_storage().resize_(0)
        unit.gathered = False
        self._count("gathered_params", -unit.nbytes)

    def _pre_forward(self, u: int, module, args) -> None:
        if self._active:
            self._fill(self.units[u])

    def _post_forward(self, u: int, module, args, output) -> None:
        """Free the unit after its forward, and gather it again before its
        backward. A forward inside the backward is ``--remat``'s
        recomputation: its leaves stay for the backward that follows."""
        if not self._active or torch._C._current_graph_task_id() != -1:
            return
        self._free(self.units[u])
        if (torch.is_grad_enabled() and isinstance(output, torch.Tensor)
                and output.requires_grad):
            output.register_hook(partial(_hook, weakref.ref(self),
                                         "_pre_backward", u))

    def _pre_backward(self, u: int, grad) -> None:
        self._fill(self.units[u])

    def _grad_ready(self, u: Optional[int], i: int, param) -> None:
        """A leaf's gradient of this backward is complete: counted whole;
        the unit's last one reduce-scatters them all, in parameter order,
        and frees the unit (the root's wait for :meth:`reduce_grads`)."""
        if i not in self._counted:
            self._counted.add(i)
            self._count("whole_grads", _nbytes(param.grad))
        if u is None:
            return
        unit = self.units[u]
        unit.ready += 1
        if unit.ready < len(unit.entries):
            return
        unit.ready = 0
        for j, e in zip(unit.indices, unit.entries):
            self._reduced[j] = self._reduce(e, e.param.grad)
            self._count("whole_grads", -_nbytes(e.param.grad))
            self._counted.discard(j)
            e.param.grad = None
        self._free(unit)

    # ------------------------------------------------------------ a step

    def gather_params(self) -> None:
        """fsdp: the root unit whole in the module for the micro-step (the
        units gather at their own forwards)."""
        if self.root is not None:
            self._active = True
            self._fill(self.root)

    def release_params(self) -> None:
        """fsdp: every gathered leaf freed (after an eval)."""
        if self.root is not None:
            for unit in self.units + [self.root]:
                self._free(unit)

    def _reduce(self, e: _Entry, g: torch.Tensor) -> torch.Tensor:
        """One micro-step gradient averaged over the batch group, in the
        entry's reduce layout."""
        topo = self.topo
        n = topo.batch_size
        data = (e.reduce_layout is not None
                and e.reduce_layout[0] == "data")
        if n > 1:
            if data:
                if topo.group["seq"] is not None:
                    g = comm.all_reduce(g, topo.group["seq"])
                return comm.reduce_scatter(g, topo.group["data"],
                                           e.reduce_layout[1]) / n
            return comm.all_reduce(g, topo.batch_group) / n
        return self._block(g, e.reduce_layout) if data else g

    def reduce_grads(self) -> list:
        """The micro-step's gradients averaged over the batch group, each
        in its reduce layout (a block along the data axis where the
        accumulator, or without one the master, is a block); the module's
        gradients and fsdp's gathered parameters are freed. The units'
        fsdp gradients were reduced as each unit's backward ended; the
        rest are reduced here, in parameter order."""
        out = []
        for i, e in enumerate(self.entries):
            if i in self._reduced:
                out.append(self._reduced.pop(i))
                continue
            g = e.param.grad
            if g is None:
                g = torch.zeros(e.param.shape, dtype=e.param.dtype,
                                device=e.param.device)
            out.append(self._reduce(e, g))
            e.param.grad = None
        if self.root is not None:
            self.release_params()
            self._counted.clear()
            self._live["whole_grads"] = 0
            for unit in self.units:
                unit.ready = 0
        return out

    def set_master_grads(self, grads: list, layouts: str = "reduce") -> None:
        """Each master's gradient from ``grads`` (in the ``reduce`` or
        ``accum`` layouts): a whole gradient of a ZeRO view is cut to its
        block."""
        for e, g in zip(self.entries, grads):
            have = getattr(e, f"{layouts}_layout")
            if e.view and not (have is not None and have[0] == "data"):
                g = self._block(g, e.master_layout)
            e.master.grad = g

    def after_update(self) -> None:
        """ZeRO: each rank's updated block into every rank's parameter."""
        for e in self.entries:
            if e.view:
                e.param.data.copy_(self._gather(e.master.data.contiguous(),
                                                e.master_layout))

    def global_norm(self, grads: list, layouts: str = "reduce"
                    ) -> torch.Tensor:
        """``optax.global_norm`` of the logical gradient whose blocks are
        ``grads`` (in the ``reduce``, ``accum`` or ``master`` layouts):
        each split leaf's squared norm summed over its group, then the
        2-norm of the leaves' norms."""
        norms = [n.float() for n in torch._foreach_norm(grads)]
        by_axis: dict = {}
        for i, e in enumerate(self.entries):
            layout = getattr(e, f"{layouts}_layout")
            if layout is not None and self.topo.size[layout[0]] > 1:
                by_axis.setdefault(layout[0], []).append(i)
        for axis, idx in by_axis.items():
            sq = torch.stack([norms[i] for i in idx]) ** 2
            total = comm.all_reduce(sq, self.topo.group[axis]).sqrt()
            for j, i in enumerate(idx):
                norms[i] = total[j]
        return torch.linalg.vector_norm(torch.stack(norms))

    # --------------------------------------------------- whole state

    def _whole(self, leaf, optimizer=None, accum: Optional[list] = None):
        """The whole state in the data-parallel format, each leaf through
        ``leaf(tensor, layout)`` (its block and the layout it is a block
        of, or ``None``), in one fixed order on every rank: the
        parameters, the buffers, each optimizer tensor, the accumulator.
        The model's ``state_dict`` alone without ``optimizer``, else
        ``(model state_dict, optimizer state_dict, accumulator list)``."""
        params = {e.name: (leaf(e.master.data, e.master_layout) if e.shard
                           else leaf(e.param.data,
                                     self.plan[e.name].param))
                  for e in self.entries}
        model = {key: params[key] if key in params else leaf(value, None)
                 for key, value in self.model.state_dict().items()}
        if optimizer is None:
            return model
        opt = optimizer.state_dict()
        opt_state = {}
        for i, e in enumerate(self.entries):
            saved = opt["state"].get(i)
            if saved is None:
                continue
            opt_state[i] = {
                k: (leaf(v, e.master_layout if v.dim() > 0 else None)
                    if torch.is_tensor(v) else v)
                for k, v in saved.items()}
        full_accum = None
        if accum is not None:
            full_accum = [leaf(a, self._accum_held(e))
                          for e, a in zip(self.entries, accum)]
        return (model, {"state": opt_state,
                        "param_groups": opt["param_groups"]}, full_accum)

    def full_params(self) -> dict:
        """The whole model's ``state_dict`` (the parameters gathered, the
        buffers as they are). Collective: every rank calls it; every rank
        gets it."""
        return self._whole(self._gather)

    def full_state(self, optimizer, accum: Optional[list]) -> tuple:
        """``(model state_dict, optimizer state_dict, accumulator list)``
        of the whole state in the data-parallel format. Collective: every
        rank calls it; every rank gets it."""
        return self._whole(self._gather, optimizer, accum)

    def _leaf_to_host(self, t: torch.Tensor, layout) -> Optional[torch.Tensor]:
        """The whole leaf whose block under ``layout`` is ``t``, on rank
        0's host (``None`` elsewhere): gathered over the group of rank 0
        along the layout's axis (the other groups hold replicas and send
        nothing), or rank 0's own copy of a replicated leaf."""
        me = dist.get_rank() if dist.is_initialized() else 0
        if layout is None or self.topo.size[layout[0]] == 1:
            return t.detach().cpu() if me == 0 else None  # ldt: ignore[LDT1714] -- a checkpoint's leaf, bound for the host
        axis, dim = layout
        if 0 not in self.topo.ranks[axis]:
            return None
        whole = comm.gather_to_host(t.detach(), self.topo.group[axis], 0,
                                    dim)
        if whole is not None:
            self.peaks["checkpoint_leaf"] = max(
                self.peaks["checkpoint_leaf"], _nbytes(whole))
        return whole

    def host_state(self, optimizer, accum: Optional[list]):
        """:meth:`full_state` on rank 0's host, ``None`` on the other
        ranks, gathered one leaf at a time: rank 0 copies each whole leaf
        to its host before the next is gathered, so that no rank's device
        holds more than its blocks and one gathered leaf. Collective:
        every rank calls it."""
        whole = self._whole(self._leaf_to_host, optimizer, accum)
        me = dist.get_rank() if dist.is_initialized() else 0
        return whole if me == 0 else None

    def load_full_state(self, model_state: dict, optimizer, opt_state: dict,
                        accum: Optional[list], saved_accum) -> None:
        """This rank's blocks of a whole state (:meth:`full_state`'s
        format, on the host) into the model, the optimizer and ``accum``:
        each block is cut on the host and only the block moves."""
        with torch.no_grad():
            for e in self.entries:
                full = model_state[e.name]
                leaf = self.plan[e.name].param
                if e.shard:
                    e.master.data.copy_(self._block(full, e.master_layout))
                elif leaf is not None and leaf[0] in ("model", "pipe"):
                    e.param.data.copy_(self._block(full, leaf))
                else:
                    e.param.data.copy_(full)
            params = {e.name for e in self.entries}
            rest = {k: v for k, v in model_state.items() if k not in params}
            if rest:
                self.model.load_state_dict(rest, strict=False)
        local = {"param_groups": opt_state["param_groups"], "state": {}}
        for i, saved in opt_state["state"].items():
            e = self.entries[int(i)]
            local["state"][int(i)] = {
                k: (self._block(v, e.master_layout).clone()
                    if torch.is_tensor(v) and v.dim() > 0
                    and e.master_layout is not None else v)
                for k, v in saved.items()}
        optimizer.load_state_dict(local)
        if accum is not None and saved_accum is not None:
            with torch.no_grad():
                for e, acc, full in zip(self.entries, accum, saved_accum):
                    layout = self._accum_held(e)
                    acc.copy_(full if layout is None or self.topo.size[
                        layout[0]] == 1 else self._block(full, layout))

    def materialize(self) -> None:
        """fsdp: the whole parameters back in the module for good (after
        training, so that the returned model holds them; the units' hooks
        stop gathering and freeing)."""
        if self.root is not None:
            for unit in self.units + [self.root]:
                self._fill(unit)
            self._active = False

    def unit_bytes(self) -> dict:
        """fsdp: the whole bytes of the root unit and of the largest
        unit, and the number of units; the bound of :attr:`peaks`'
        gathered parameters and whole gradients is ``root + 2 *
        largest``."""
        if self.root is None:
            return {"root": 0, "largest": 0, "units": 0}
        return {"root": self.root.nbytes,
                "largest": max((u.nbytes for u in self.units), default=0),
                "units": len(self.units)}

    def held_bytes(self, optimizer, accum: Optional[list]) -> dict:
        """The bytes this rank holds between steps: its parameters (fsdp:
        the blocks), its optimizer moments (0-d counters aside) and its
        accumulator."""
        def size(t):
            return t.numel() * t.element_size()

        params = sum(size(e.master) if e.shard else size(e.param)
                     for e in self.entries)
        state = sum(size(v) for s in optimizer.state.values()
                    for v in s.values() if torch.is_tensor(v) and v.dim() > 0)
        acc = sum(size(a) for a in accum) if accum is not None else 0
        return {"params": params, "optimizer_state": state,
                "accumulator": acc, "total": params + state + acc}

