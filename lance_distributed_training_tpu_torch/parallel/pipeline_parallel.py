"""Pipeline parallelism: the GPipe microbatched stage pipeline.

Counterpart of ``lance_distributed_training_tpu/parallel/pipeline_parallel.py``.
The model is a stack of identical stages whose parameters carry a leading
stage axis, split over the ``'pipe'`` ranks (each holds ``L / n_stages``
layers, :func:`stack_stage_params`). :func:`pipeline_apply` runs JAX's
schedule: ``n_micro + n_stages - 1`` ticks; at tick ``t`` stage 0 takes
microbatch ``t`` (zeros after the last one), every other stage the
activation that came from the previous stage, each stage applies its
layers, and every activation moves one hop down the stage ring
(:func:`..parallel.comm.shift`; the last stage's wraps to stage 0, which
ignores it). The last stage emits microbatch ``t - (n_stages - 1)`` at
tick ``t``; its outputs are the result, broadcast to every stage, so the
loss code does not know about the pipeline. Gradients come from autograd
through the same ticks: each shift's backward sends the gradient one hop
back. Every rank runs the same ticks and the same shifts, stage 0
included (its input is a ``where`` of the fed microbatch and the
incoming activation, as in JAX), so the ranks' backward passes meet in
the same order.

It composes with data parallelism: each data group runs its own pipeline
on its share of the batch.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from . import comm

__all__ = ["pipeline_apply", "stack_stage_params"]


def stack_stage_params(params_list):
    """Stack per-stage (or per-layer) parameter dicts into one dict with a
    leading stage axis (split it over ``'pipe'``)."""
    return {name: torch.stack([p[name] for p in params_list])
            for name in params_list[0]}


class _FromLast(torch.autograd.Function):
    """The last stage's tensor on every stage; backward, only the last
    stage keeps the gradient (the loss is computed on every stage alike,
    and counts once)."""

    @staticmethod
    def forward(ctx, x, group, last, is_last):
        ctx.is_last = is_last
        return comm.broadcast(x, last, group)

    @staticmethod
    def backward(ctx, grad):
        return (grad if ctx.is_last else torch.zeros_like(grad)), None, None, None


def pipeline_apply(stage_fn: Callable, stacked_params, x: torch.Tensor,
                   n_microbatches: int, *, pipe_group=None,
                   pipe_ranks: Optional[list] = None, stage: int = 0,
                   data: int = 1) -> torch.Tensor:
    """Run ``x`` (this data group's share of the batch, ``[b, ...]``)
    through the pipeline of the ranks ``pipe_ranks`` (global ranks in
    stage order; this rank is stage ``stage``). ``stage_fn(params, h)``
    is one stage's compute on ``stacked_params`` (this stage's slice, its
    leading axis kept); input and output shapes match. ``data`` is the
    number of data groups: the global batch ``b * data`` must divide into
    ``n_microbatches * data``. Without a group the stages are this one.
    Returns the result ``[b, ...]`` on every stage."""
    n_stages = len(pipe_ranks) if pipe_ranks else 1
    b = x.shape[0] * data
    if b % (n_microbatches * data):
        raise ValueError(
            f"batch {b} not divisible by n_microbatches*data="
            f"{n_microbatches * data}"
        )
    mb = x.shape[0] // n_microbatches
    micro = x.reshape((n_microbatches, mb) + tuple(x.shape[1:]))
    if n_stages > 1:
        # The embeddings' gradient arrives on stage 0 only: summed over
        # the stages, every stage holds it.
        micro = comm.copy_to(micro, pipe_group)
    ticks = n_microbatches + n_stages - 1
    nxt = pipe_ranks[(stage + 1) % n_stages] if n_stages > 1 else None
    prev = pipe_ranks[(stage - 1) % n_stages] if n_stages > 1 else None
    first = torch.tensor(stage == 0, device=x.device)
    zeros = torch.zeros_like(micro[0])
    act = zeros
    outs = []
    for t in range(ticks):
        feed = micro[t] if t < n_microbatches else zeros
        inp = torch.where(first, feed, act)
        out = stage_fn(stacked_params, inp)
        outs.append(out)
        if n_stages > 1 and t < ticks - 1:
            act = comm.shift(out, pipe_group, nxt, prev)
    finished = torch.stack(outs[n_stages - 1:])  # [n_micro, mb, ...]
    if n_stages > 1:
        finished = _FromLast.apply(finished, pipe_group, pipe_ranks[-1],
                                   stage == n_stages - 1)
    return finished.reshape(x.shape)
