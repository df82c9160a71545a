"""Switch-routed Mixture-of-Experts MLP in PyTorch.

Counterpart of ``lance_distributed_training_tpu/models/moe.py``: top-1
routing by an f32 router, a fixed capacity ``max(1, int(capacity_factor ·
T / E))`` a expert, a token's place in its expert's queue counted over the
tokens in order, tokens past capacity given a zero output (the block's
residual carries them), and the Switch load-balance term ``E · Σ_e frac_e ·
mean_prob_e``.

The JAX module expresses dispatch and combine as einsums over a dense
``[T, E, C]`` tensor. Every sum in those einsums has exactly one nonzero
term, so this module computes the same values by index: the expert
queues are a gather of the tokens (a sentinel row of zeros fills the empty
slots), the output a gather of the queues (a sentinel zero row for the
tokens past capacity) times the winner's probability rounded to ``dtype``,
as the JAX combine weight is. At BERT-base, sequence 512, batch 32 the
dense tensor would hold 335 M elements a layer; the index form holds the
``[E, C, H]`` queues only.

Across processes (``process_group``, set by :func:`set_moe_group`) the
routing is the global batch's, as in the JAX step, where the batch is one
array sharded over processes in rank order: each process all-gathers the
per-expert counts, offsets its queue positions by the counts of the lower
ranks, takes the capacity from the global token count and the load-balance
fractions from the global counts. Its share of the term is scaled by the
group's size, so that the mean over processes is the global term and DDP's
mean of the gradients is its gradient. The eval routes alike: every
process evaluates its share of each global eval batch.

On a ring of processes (``seq_parts > 1``: the group's ranks, in order,
are ``data_index * seq_parts + seq_index`` and each holds sequence block
``seq_index`` of every row of its data share) the global order is the
JAX one, row-major over the global ``[B, S]`` batch: each process
all-gathers the per-row, per-expert counts of its block, ``[rows, E]``,
and offsets a token's place by the counts of the lower data shares, of
the earlier rows of its share (every block) and of the lower blocks of
its own row.

Expert parallelism (``expert_group``, set by
``parallel/layout.shard_model_`` from the layout plan): the
experts are split over the ``'model'`` axis, each rank holding ``E / tp``
of them (``w_in``, ``b_in``, ``w_out``, ``b_out``; the router stays
replicated). The ranks of a model group hold the same tokens and route
them alike; each fills and runs its own experts' queues, and the gathered
outputs, zero for the tokens of other ranks' experts, are summed over the
group (an all-reduce of the combine), so each token's row is its one
expert's output, exactly. The gate's product with the winner's
probability comes after the sum, as in the single-process module, and the
expert path's input gradient is summed over the group
(``comm.copy_to``): the values, forward and backward, are those of the
module holding every expert. An all-reduce of ``[T, H]`` rather than an
all-to-all because the ranks already hold every token (the batch is split
over data, not over model) and no token needs to move to reach its
expert.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..parallel import comm

__all__ = ["MoEMLP", "moe_aux_loss", "set_moe_group"]

_TRUNC_STD = 0.87962566103423978  # see transformer._lecun_normal_


class MoEMLP(nn.Module):
    """``[B, S, H] → [B, S, H]``. Parameters are f32 (``router`` an
    ``[E, H]`` linear map, ``w_in [E, H, M]``, ``b_in [E, M]``, ``w_out
    [E, M, H]``, ``b_out [E, H]``); the experts compute in ``dtype``. After
    each forward ``aux`` holds this process's share of the load-balance
    term (a scalar with its gradient)."""

    def __init__(self, hidden: int, num_experts: int, mlp_dim: int,
                 capacity_factor: float = 1.25, dtype=torch.bfloat16):
        super().__init__()
        from .transformer import _Dense

        self.num_experts = num_experts
        self.capacity_factor = capacity_factor
        self.dtype = dtype
        self.router = _Dense(hidden, num_experts, torch.float32)
        e = num_experts
        self.w_in = nn.Parameter(torch.empty(e, hidden, mlp_dim))
        self.b_in = nn.Parameter(torch.zeros(e, mlp_dim))
        self.w_out = nn.Parameter(torch.empty(e, mlp_dim, hidden))
        self.b_out = nn.Parameter(torch.zeros(e, hidden))
        self.process_group = None  # set for global-batch routing
        self.seq_parts = 1  # ring positions in process_group's order
        self.expert_group = None  # set: the experts are split over it
        self.expert_start = 0  # this rank's first expert
        self.aux: Optional[torch.Tensor] = None

    def reset_from(self, generator: torch.Generator) -> None:
        """Flax's initialisation of the experts: LeCun-normal kernels, whose
        fan-in for an ``[E, in, out]`` kernel is ``E · in``, and zero
        biases. The router is a dense layer and is reset as one."""
        with torch.no_grad():
            for w in (self.w_in, self.w_out):
                e, fan, _ = w.shape
                std = 1.0 / math.sqrt(e * fan) / _TRUNC_STD
                nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                      generator=generator)
            self.b_in.zero_()
            self.b_out.zero_()

    def _offsets(self, running: torch.Tensor, rows: int):
        """``(queue offset [E, T] of each local token, global counts [E],
        processes)`` for the local running counts ``running [E, T]`` of
        ``rows`` rows (the local tokens in row-major order)."""
        group = self.process_group
        if group is None:
            return torch.zeros_like(running[:, :1]), running[:, -1], 1
        e, t = running.shape
        ends = running.view(e, rows, t // rows)[:, :, -1]
        per_row = torch.diff(ends, dim=1, prepend=torch.zeros_like(ends[:, :1]))
        world = dist.get_world_size(group)
        me = dist.get_rank(group)
        parts = self.seq_parts
        every = comm.all_gather(per_row.t().contiguous()[None], group)
        every = every.view(world // parts, parts, rows, e)  # [data, seq, r, E]
        d, s = divmod(me, parts)
        lower_data = every[:d].sum((0, 1, 2))  # [E]
        # Earlier rows of this share, every block, less those of this
        # block (which the local running count already holds), plus the
        # lower blocks of each token's own row.
        rows_all = every[d].sum(0)  # [rows, E]
        earlier = (rows_all.cumsum(0) - rows_all) - (
            every[d, s].cumsum(0) - every[d, s])
        lower_blocks = every[d, :s].sum(0)
        per_row_offset = lower_data[None, :] + earlier + lower_blocks
        offset = per_row_offset.t().repeat_interleave(t // rows, dim=1)
        return offset, every.sum((0, 1, 2)), world

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, h = x.shape
        t, e = b * s, self.num_experts
        tokens = x.reshape(t, h)
        probs = torch.softmax(self.router(tokens), dim=-1)  # f32 [T, E]
        expert_prob, expert_index = probs.max(dim=-1)
        # Each expert's running count over the tokens, [E, T]: the scan
        # runs along the contiguous dimension (over [T, E] along T it takes
        # the card's slow outer-dimension scan).
        experts = torch.arange(e, device=x.device)[:, None]
        running = (expert_index[None, :] == experts).cumsum(1)
        offset, counts, world = self._offsets(running, b)
        capacity = max(1, int(self.capacity_factor * (t * world) / e))
        # 1-based place of each token in its expert's (global) queue.
        pick = expert_index[None, :]
        position = (running.gather(0, pick)[0]
                    + offset.expand(e, t).gather(0, pick)[0])
        group = self.expert_group
        held = self.w_in.shape[0]  # this rank's experts
        local = expert_index - self.expert_start
        sentinel = held * capacity
        kept = (position <= capacity) & (local >= 0) & (local < held)
        slot = torch.where(kept, local * capacity + position - 1,
                           torch.full_like(position, sentinel))
        # The token each queue slot holds (``t``, a zero row, when empty);
        # the sentinel slot collects the overflow (and, under expert
        # parallelism, the other ranks' tokens) and is dropped.
        token_of_slot = torch.full((sentinel + 1,), t, dtype=torch.long,
                                   device=x.device)
        token_of_slot.scatter_(0, slot, torch.arange(t, device=x.device))
        dt = self.dtype
        # index_select, not advanced indexing: its backward is an
        # index_add (the sentinel rows take the duplicates and are
        # dropped), where indexing's backward sorts the indices first.
        routed = comm.copy_to(tokens, group)
        padded = torch.cat([routed.to(dt), routed.new_zeros(1, h, dtype=dt)])
        expert_in = padded.index_select(0, token_of_slot[:sentinel]).view(
            held, capacity, h)
        hidden = F.gelu(torch.bmm(expert_in, self.w_in.to(dt))
                        + self.b_in[:, None, :].to(dt), approximate="tanh")
        out = (torch.bmm(hidden, self.w_out.to(dt))
               + self.b_out[:, None, :].to(dt))
        out = torch.cat([out.reshape(sentinel, h), out.new_zeros(1, h)])
        y = comm.reduce_from(out.index_select(0, slot), group)
        y = y * expert_prob.to(dt)[:, None]
        frac = counts.float() / (t * world)
        self.aux = e * torch.sum(frac * probs.sum(0) / (t * world)) * world
        return y.view(b, s, h)


def set_moe_group(model: nn.Module, group, seq_parts: int = 1) -> None:
    """Route ``model``'s MoE layers over ``group``'s global batch
    (``None``: this process's batch); ``seq_parts`` ring
    positions split each row of a data share (the module's docstring)."""
    for module in model.modules():
        if isinstance(module, MoEMLP):
            module.process_group = group
            module.seq_parts = seq_parts


def moe_aux_loss(model: nn.Module) -> Optional[torch.Tensor]:
    """The sum of the load-balance terms of ``model``'s MoE layers from
    their last forward, or ``None`` for a model without MoE layers."""
    terms = [m.aux for m in model.modules()
             if isinstance(m, MoEMLP) and m.aux is not None]
    return torch.stack(terms).sum() if terms else None
