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
  block, whose moments and accumulator are local too.
* ``'data'`` under ``fsdp``: :class:`ShardedState` keeps each large
  parameter's block (a leaf of at least 16384 elements, its largest
  divisible dimension, as JAX ``_fsdp_spec``) as the persistent tensor the
  optimizer updates. Before a micro-step's forward the blocks are
  all-gathered into the module's parameters; after its backward the
  gradients are reduce-scattered into the blocks' layout and the gathered
  parameters are freed. (The gather is one per parameter a micro-step,
  not per layer in the forward and again in the backward as FSDP2's
  hooks do: the peak holds the whole model, the state between steps only
  the blocks.)
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
list), which checkpoints hold and a data-parallel run restores;
:meth:`ShardedState.load_full_state` takes a rank's blocks from it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from . import comm

__all__ = ["shard_model_", "ShardedState", "block_of"]


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
            if _split(plan, [f"{prefix}{p}.weight" for p in
                             ("query", "key", "value", "out")], "model"):
                module.tp_group = group
                module.num_heads //= mp
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


@dataclasses.dataclass
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
                p.data = p.data.new_empty(0)
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

    def gather_params(self) -> None:
        """fsdp: every parameter whole in the module for the forward."""
        for e in self.entries:
            if e.shard:
                e.param.data = self._gather(e.master.data, e.master_layout)

    def reduce_grads(self) -> list:
        """The micro-step's gradients averaged over the batch group, each
        in its reduce layout (a block along the data axis where the
        accumulator, or without one the master, is a block); the module's
        gradients and fsdp's gathered parameters are freed."""
        topo = self.topo
        n = topo.batch_size
        seq = topo.group["seq"]
        out = []
        for e in self.entries:
            g = e.param.grad
            if g is None:
                g = torch.zeros(e.param.shape, dtype=e.param.dtype,
                                device=e.param.device)
            if n > 1:
                if e.reduce_layout is not None and e.reduce_layout[0] == "data":
                    if seq is not None:
                        g = comm.all_reduce(g, seq)
                    g = comm.reduce_scatter(g, topo.group["data"],
                                            e.reduce_layout[1]) / n
                else:
                    g = comm.all_reduce(g, topo.batch_group) / n
            elif e.reduce_layout is not None and e.reduce_layout[0] == "data":
                g = self._block(g, e.reduce_layout)
            out.append(g)
            e.param.grad = None
            if e.shard:
                e.param.data = e.param.data.new_empty(0)
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

    def full_params(self) -> dict:
        """The whole model's ``state_dict`` (the parameters gathered, the
        buffers as they are). Collective: every rank calls it; every rank
        gets it."""
        state = {}
        for e in self.entries:
            if e.shard:
                state[e.name] = self._gather(e.master.data, e.master_layout)
            else:
                state[e.name] = self._gather(e.param.data, self.plan[
                    e.name].param)
        return {key: state.get(key, value)
                for key, value in self.model.state_dict().items()}

    def full_state(self, optimizer, accum: Optional[list]) -> tuple:
        """``(model state_dict, optimizer state_dict, accumulator list)``
        of the whole state in the data-parallel format. Collective: every
        rank calls it; every rank gets it."""
        full_sd = self.full_params()
        opt = optimizer.state_dict()
        opt_state = {}
        for i, e in enumerate(self.entries):
            saved = opt["state"].get(i)
            if saved is None:
                continue
            opt_state[i] = {
                k: (self._gather(v, e.master_layout)
                    if torch.is_tensor(v) and v.dim() > 0 else v)
                for k, v in saved.items()}
        full_opt = {"state": opt_state, "param_groups": opt["param_groups"]}
        full_accum = None
        if accum is not None:
            full_accum = [self._gather(a, self._accum_held(e))
                          for e, a in zip(self.entries, accum)]
        return full_sd, full_opt, full_accum

    def load_full_state(self, model_state: dict, optimizer, opt_state: dict,
                        accum: Optional[list], saved_accum) -> None:
        """This rank's blocks of a whole state (:meth:`full_state`'s
        format) into the model, the optimizer and ``accum``."""
        with torch.no_grad():
            for e in self.entries:
                full = model_state[e.name].to(e.master.device)
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
                    full = full.to(acc.device)
                    acc.copy_(full if layout is None or self.topo.size[
                        layout[0]] == 1 else self._block(full, layout))

    def materialize(self) -> None:
        """fsdp: the whole parameters back in the module (after training,
        so that the returned model holds them)."""
        for e in self.entries:
            if e.shard:
                e.param.data = self._gather(e.master.data, e.master_layout)

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

