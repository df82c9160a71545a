"""Ring attention — sequence/context parallelism.

Counterpart of ``lance_distributed_training_tpu/parallel/ring_attention.py``.
The sequence splits into ``size`` blocks. Queries stay where they are; key
and value blocks, with their key mask, pass around the ring, and each query
block folds each key block into f32 running statistics (max, sum,
accumulator) with K5 (:mod:`..ops.ring_attention`), so the result is exact
softmax attention.

Two transports carry the blocks:

* :class:`InProcessRing` — one process holds all ``size`` positions on its
  one device, as the JAX package holds a mesh of ``size`` virtual devices in
  one process. At ring step ``t`` query block ``i`` folds key block
  ``(i - t) mod size``, the order that ``ppermute`` with
  ``perm (i -> i+1)`` gives; the rotation is an index shift, not a copy,
  and one launch of the forward (and of dQ, and of dK/dV) folds all
  ``size`` steps with its running statistics (or gradient totals) on
  chip.
* :class:`ProcessRing` — one position per process, over a
  ``torch.distributed`` group: each step posts the next block's transfer
  (``batch_isend_irecv``, one hop) before the step's fold and waits after
  it; the statistics stay in device memory between the hops.

The backward (:class:`_RingAttention`) turns the ring again: dQ accumulates
at home, and each block's dK/dV partials travel with it and arrive home
after ``size`` hops (the transpose of ``ppermute`` is the reverse hop); in
one process the dQ and dK/dV launches add them up in the same ring-step
order.
Both transports sum every gradient in the same order, so on the CPU they
agree bit for bit.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from . import comm

from ..ops.ring_attention import (
    finalize,
    ring_fold_bwd_dkv,
    ring_fold_bwd_dq,
    ring_fold_fwd,
    row_lse,
)

__all__ = ["InProcessRing", "ProcessRing", "RingAttention", "ring_attention",
           "make_ring_attention"]


class InProcessRing:
    """All ``size`` ring positions in this process: the blocks stay put and
    step ``t`` shifts which key block each query block folds."""

    def __init__(self, size: int):
        if size < 1:
            raise ValueError(f"ring size must be >= 1, got {size}")
        self.size = size
        self.positions = size
        self.fold_steps = size  # ring steps one launch of a kernel folds

    def shift(self, step: int) -> int:
        return step

    def pass_on(self, tensors):
        return None

    def receive(self, tensors, pending):
        return tensors


class ProcessRing:
    """One ring position per process of ``group``, whose members, in ring
    order, are the global ranks ``ranks``. A block moves one hop a step,
    from rank ``ranks[i]`` to ``ranks[i + 1]``."""

    def __init__(self, group, ranks: Sequence[int]):
        self.group = group
        self.ranks = list(ranks)
        self.size = len(self.ranks)
        self.index = self.ranks.index(dist.get_rank())
        self.next = self.ranks[(self.index + 1) % self.size]
        self.prev = self.ranks[(self.index - 1) % self.size]
        self.positions = 1
        self.fold_steps = 1

    def shift(self, step: int) -> int:
        return 0

    def pass_on(self, tensors):
        """Post the sends of ``tensors`` to the next rank and the receives
        of the previous rank's; returns what :meth:`receive` waits on.
        Ranks that share a card exchange through the host, at once
        (``parallel/comm.py``)."""
        if comm.host_staged() and tensors and tensors[0].is_cuda:
            return [], [comm.send_recv(t, self.next, self.prev, self.group)
                        for t in tensors]
        recv = [torch.empty_like(t) for t in tensors]
        ops = [dist.P2POp(dist.isend, t, self.next, self.group)
               for t in tensors]
        ops += [dist.P2POp(dist.irecv, r, self.prev, self.group)
                for r in recv]
        return dist.batch_isend_irecv(ops), recv

    def receive(self, tensors, pending):
        works, recv = pending
        for work in works:
            work.wait()
        return recv


def _key_mask(mask, b: int, s: int, device) -> torch.Tensor:
    """uint8 ``[B, S]`` key validity from a ``[B,1,1,S]`` (or ``[B, S]``)
    boolean mask; all valid when ``mask`` is None."""
    if mask is None:
        return torch.ones((b, s), dtype=torch.uint8, device=device)
    return mask.reshape(mask.shape[0], mask.shape[-1]).to(
        device=device, dtype=torch.uint8).contiguous()


class _RingAttention(torch.autograd.Function):
    """Forward: K5 ``ring_fwd`` over the ring, ``ring.fold_steps`` steps a
    launch, the last launch writing the output; keeps q, k, v, the mask,
    the output and the per-row LSE. Backward: ``delta = rowsum(dO * O)`` as
    a plain op, then ``ring_bwd_dq`` and ``ring_bwd_dkv``
    ``ring.fold_steps`` steps a launch. When one launch folds the whole
    ring, the running statistics and the gradient totals never leave the
    kernels."""

    @staticmethod
    def forward(ctx, q, k, v, mask, ring):
        b, h, s, _ = q.shape
        m = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
        acc = None  # fresh carries, on chip, when one launch folds the ring
        if ring.fold_steps < ring.size:
            m.fill_(float("-inf"))
            l.zero_()
            acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        out = torch.empty_like(q)
        blocks = (k, v, mask)
        for step in range(0, ring.size, ring.fold_steps):
            last = step + ring.fold_steps == ring.size
            # The next block's transfer is in flight during this fold.
            pending = None if last else ring.pass_on(blocks)
            ring_fold_fwd(q, *blocks, m, l, acc, ring.positions,
                          ring.shift(step), out=out if last else None,
                          steps=ring.fold_steps)
            if pending is not None:
                blocks = ring.receive(blocks, pending)
        lse = row_lse(m, l)
        ctx.save_for_backward(q, k, v, mask, out, lse)
        ctx.ring = ring
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, mask, out, lse = ctx.saved_tensors
        ring = ctx.ring
        do = do.contiguous()
        delta = (do.float() * out.float()).sum(-1)
        if ring.fold_steps == ring.size:
            dq = dk = dv = None
            dq_out = torch.empty_like(q)
            grads = (torch.empty_like(k), torch.empty_like(v))
        else:
            dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
            dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
            dv = torch.zeros_like(dk)
            dq_out = grads = None
        blocks = (k, v, mask)
        for step in range(0, ring.size, ring.fold_steps):
            last = step + ring.fold_steps == ring.size
            pending = None if last else ring.pass_on(blocks)
            ring_fold_bwd_dq(q, *blocks, lse, delta, do, dq, ring.positions,
                             ring.shift(step), steps=ring.fold_steps,
                             out=dq_out)
            ring_fold_bwd_dkv(q, *blocks, lse, delta, do, dk, dv,
                              ring.positions, ring.shift(step),
                              steps=ring.fold_steps, out=grads)
            if grads is None:
                # The block's partials travel on with it; after `size` hops
                # each block's arrive home.
                partials = ring.pass_on((dk, dv))
                dk, dv = ring.receive((dk, dv), partials)
            if pending is not None:
                blocks = ring.receive(blocks, pending)
        if grads is None:
            dq_out = dq.to(q.dtype)
            grads = (dk.to(k.dtype), dv.to(v.dtype))
        return dq_out, *grads, None, None


def ring_attention(q, k, v, mask=None, ring=None) -> torch.Tensor:
    """Exact attention over a sequence laid out on ``ring``.

    :class:`InProcessRing`: q/k/v are the whole ``[B, H, S, D]`` sequence,
    ``S`` divisible by the ring's size. :class:`ProcessRing`: they are this
    process's block ``[B, H, S/size, D]``. ``mask`` is the KEY validity of
    the same positions, ``[B, 1, 1, S]`` bool (all valid when None); it
    travels the ring with k/v. Differentiable in q, k and v."""
    if ring is None:
        raise ValueError("ring_attention needs a ring (InProcessRing or "
                         "ProcessRing)")
    mask = _key_mask(mask, q.shape[0], q.shape[2], q.device)
    return _RingAttention.apply(q.contiguous(), k.contiguous(),
                                v.contiguous(), mask, ring)


class RingAttention:
    """``attention_fn(q, k, v, mask=None, dtype=None)`` for
    :class:`..models.transformer.SelfAttention`, the counterpart of what
    JAX's ``make_ring_attention`` returns. With a :class:`ProcessRing`, q/k/v
    are this process's sequence block; otherwise they are the whole
    sequence, folded by an :class:`InProcessRing` of ``size``. On the CPU a sequence that does
    not split into ``size`` blocks takes exact dense attention, as JAX's
    does; on the card it raises, since the trainer never makes one and K5
    is the only attention this path may run there."""

    def __init__(self, size: int, ring: Optional[ProcessRing] = None):
        if ring is not None and ring.size != size:
            raise ValueError(f"process ring of {ring.size} ranks for "
                             f"seq_parallelism {size}")
        self.size = size
        self.ring = ring

    def __call__(self, q, k, v, mask=None, dtype=None):
        ring = self.ring
        if ring is None:
            if q.shape[2] % self.size:
                if q.device.type != "cpu":
                    raise ValueError(
                        f"sequence {q.shape[2]} does not split into "
                        f"{self.size} ring blocks")
                from ..models.transformer import dot_product_attention

                return dot_product_attention(q, k, v, mask=mask,
                                             dtype=q.dtype)
            ring = InProcessRing(self.size)
        return ring_attention(q, k, v, mask, ring).to(q.dtype)


def make_ring_attention(seq_parallelism: int,
                        ring: Optional[ProcessRing] = None) -> RingAttention:
    """The ``attention_fn`` of a ``seq_parallelism``-way ring: in this
    process, or over ``ring``'s processes."""
    return RingAttention(seq_parallelism, ring)
